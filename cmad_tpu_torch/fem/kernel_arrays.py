"""Static FE assembly arrays on the problem's device.

Port of ``cmad_tpu/fem/kernel_arrays.py`` (parity: reference
``cmad/fem/kernel_arrays.py``). Mesh-sized index arrays, the geometry
cache, the assembled COO pattern with its dedup scatter, and the
embedded-BC sparsity, built once per problem, with the segment-sum plans
(``ops/segment_sum.py``) of every fixed sum of the FE path: the element
residual scatter (which is also the transpose of the U gather), the COO
dedup, the COO rows and the Neumann side scatter. The JAX package passes
them as one pytree so that they cross ``jit`` as traced arguments; here
they are tensors on the device the FE problem runs on, and the Dirichlet
arrays and the IP coordinates of the body forces stay on the host, where
the prescribed values and the loads are evaluated.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import torch

from cmad_tpu_torch.fem.dof import DBCArrays, build_dbc_arrays
from cmad_tpu_torch.fem.neumann import (
    NeumannSideArrays,
    build_neumann_side_arrays,
)
from cmad_tpu_torch.fem.sparse_solve import (
    EmbeddedSparsity,
    build_embedded_sparsity,
)
from cmad_tpu_torch.ops.segment_sum import (
    SegmentPlan,
    plan_from_offsets,
    plan_from_target,
)
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.fe_problem import FEProblem


@dataclass(frozen=True)
class FEKernelArrays:
    """Static mesh-derived arrays read by the FE kernels."""

    u_gather_eq_by_block: dict[str, tuple[Tensor, ...]]
    r_scatter_eq_by_block: dict[str, tuple[Tensor, ...]]
    # per block and field: the plan of the flat eq indices (the residual
    # scatter; its gather is the U gather)
    eq_plan_by_block: dict[str, tuple[SegmentPlan, ...]]
    coo_rows: Tensor
    coo_cols: Tensor
    coo_dedup_scatter: Tensor
    coo_dedup_plan: SegmentPlan
    coo_row_plan: SegmentPlan
    coo_col_plan: SegmentPlan
    geometry_cache: dict[str, dict]
    embedded_sparsity: EmbeddedSparsity
    prescribed_indices: Tensor
    dbc_arrays: DBCArrays
    # None without Neumann BCs
    neumann_side_arrays: NeumannSideArrays | None
    # per block with a body force: its IP coordinates (E*Q, 3), float64
    body_force_coords_by_block: dict[str, np.ndarray]


def build_fe_kernel_arrays(fe_problem: "FEProblem") -> FEKernelArrays:
    from cmad_tpu_torch.fem.assembly import (
        assembled_coo_pattern,
        element_eq_indices,
    )

    mesh = fe_problem.mesh
    dof_map = fe_problem.dof_map
    dev = fe_problem.device
    num_residuals = fe_problem.gr.num_residuals
    num_fields = len(dof_map.field_layouts)

    def on(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    n_dofs = dof_map.num_total_dofs
    u_gather, r_scatter, eq_plans = {}, {}, {}
    for block in fe_problem.evaluators_by_block:
        conn = mesh.connectivity[mesh.element_blocks[block]]
        n_elems = conn.shape[0]
        gathers = []
        for fi in range(num_fields):
            nd = int(dof_map.num_dofs_per_basis_fn[fi])
            eq = element_eq_indices(conn, dof_map, fi)
            gathers.append(on(eq.reshape(n_elems, -1, nd)))
        u_gather[block] = tuple(gathers)
        r_scatter[block] = tuple(
            on(element_eq_indices(conn, dof_map,
                                  fe_problem.field_idx_per_block[r]))
            for r in range(num_residuals))
        eq_plans[block] = tuple(
            plan_from_target(element_eq_indices(conn, dof_map, fi), n_dofs,
                             dev)
            for fi in range(num_fields))

    body_coords = {}
    if fe_problem.forcing_fns_by_block_idx:
        body_coords = {
            b: geom["per_elem"]["coords_ip"].reshape(-1, 3).to(
                torch.float64).cpu().numpy()
            for b, geom in fe_problem.geometry_cache.items()}

    rows, cols, dedup = assembled_coo_pattern(fe_problem)
    indptr = np.searchsorted(rows, np.arange(n_dofs + 1), side="left")

    return FEKernelArrays(
        u_gather_eq_by_block=u_gather,
        r_scatter_eq_by_block=r_scatter,
        eq_plan_by_block=eq_plans,
        coo_rows=on(rows),
        coo_cols=on(cols),
        coo_dedup_scatter=on(dedup),
        coo_dedup_plan=plan_from_target(dedup, rows.shape[0], dev),
        coo_row_plan=plan_from_offsets(indptr, dev),
        coo_col_plan=plan_from_target(cols, n_dofs, dev),
        geometry_cache=fe_problem.geometry_cache,
        embedded_sparsity=build_embedded_sparsity(fe_problem, rows, cols),
        prescribed_indices=on(dof_map.prescribed_indices),
        dbc_arrays=build_dbc_arrays(dof_map),
        neumann_side_arrays=build_neumann_side_arrays(
            mesh, dof_map, fe_problem.resolved_neumann_bcs,
            fe_problem.side_quadrature, dev),
        body_force_coords_by_block=body_coords)
