"""Element + global FE assembly, block path.

Port of the block path of ``cmad_tpu/fem/assembly.py`` (parity:
reference ``cmad/fem/assembly.py``). A COUPLED block whose evaluators
carry ``block_R_and_K_and_xi`` / ``block_R`` (``fem/j2_block.py``,
``fem/coupled_block.py``) evaluates the whole element block in one batched call; its element
residuals scatter into the global vector and its element matrices stream
out in the ``(block, r, s)`` COO emit order, deduplicated into the pattern
of :func:`assembled_coo_pattern`. That function rebuilds the identical
with-duplicates ``(rows, cols)`` stream from the same eq-index helper
the scatter uses, so the pattern and the data cannot drift apart.

Both sums, and the gathers of U, go through the segment-sum plans of
``fem/kernel_arrays.py`` (``ops/segment_sum.py``): each target adds its
entries in ascending entry order, on the card (the ``segment_sum``
kernel) as on the CPU (``index_add_``), so R and K are the same bits from
run to run, and the reverse sweep's transposes are too.

The generic per-IP assembly (nested per-element and per-IP evaluation
for CLOSED_FORM blocks and the COUPLED blocks neither block path takes)
is not ported yet (ROADMAP queue 1, items 11 and 19); neither are
Neumann loads (item 8).
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch

from cmad_tpu_torch.fem.dof import GlobalDofMap, GlobalFieldLayout
from cmad_tpu_torch.fem.elements import EntityType
from cmad_tpu_torch.fem.sparse_solve import CooMatrix
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.ops.segment_sum import segment_gather, segment_sum
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.fe_problem import FEProblem
    from cmad_tpu_torch.fem.kernel_arrays import FEKernelArrays


def params_by_block_from_models(fe_problem: "FEProblem") -> dict:
    return {name: model.parameters.values
            for name, model in fe_problem.models_by_block.items()}


def element_basis_fns(layout: GlobalFieldLayout,
                      connectivity_block: np.ndarray) -> np.ndarray:
    """Per-element global basis-fn indices for a VERTEX-anchored field."""
    fe = layout.finite_element
    if not fe.vertex_only():
        raise NotImplementedError(
            f"field {layout.name!r}: assembly supports VERTEX DOFs only")
    vpd = fe.dofs_per_entity.get(EntityType.VERTEX, 0)
    if vpd == 0:
        raise NotImplementedError(
            f"field {layout.name!r} has no VERTEX DOFs")
    n_elems, n_verts = connectivity_block.shape
    m = np.arange(vpd)
    return (connectivity_block.astype(np.intp)[:, :, None] * vpd
            + m[None, None, :]).reshape(n_elems, n_verts * vpd)


def element_eq_indices(connectivity_block: np.ndarray,
                       dof_map: GlobalDofMap, field_idx: int) -> np.ndarray:
    """(n_elems, n_dofs_per_elem * ncomp) flat global eq indices,
    basis-fn-major / component-minor."""
    layout = dof_map.field_layouts[field_idx]
    bf = element_basis_fns(layout, connectivity_block)
    nd = int(dof_map.num_dofs_per_basis_fn[field_idx])
    k = np.arange(nd)
    eq = (dof_map.block_offsets[field_idx] + bf[:, :, None] * nd
          + k[None, None, :])
    return eq.reshape(connectivity_block.shape[0], -1).astype(np.intp)


def gather_element_U(U_global: Tensor, fe_arrays: "FEKernelArrays",
                     block_name: str) -> list[Tensor]:
    """Per-field (n_elems, n_dofs_per_elem, ncomp) coefficient gathers;
    their transpose is the residual scatter's segment sum."""
    return [segment_gather(U_global, plan).reshape(eq.shape)
            for eq, plan in zip(fe_arrays.u_gather_eq_by_block[block_name],
                                fe_arrays.eq_plan_by_block[block_name],
                                strict=True)]


def _block_evaluators(fe_problem, block_name, xi_prev_per_block):
    evaluators = fe_problem.evaluators_by_block[block_name]
    if fe_problem.modes_by_block[block_name] != GlobalResidualMode.COUPLED \
            or "block_R" not in evaluators:
        raise NotImplementedError(
            f"block {block_name!r}: only the COUPLED block paths are "
            "ported (fem/j2_block.py, fem/coupled_block.py); the generic "
            "per-IP assembly waits for ROADMAP queue 1, items 11 and 19")
    if xi_prev_per_block is None:
        raise ValueError(
            f"COUPLED block {block_name!r} requires xi_prev_per_block")
    return evaluators


def _scatter_residual(fe_problem, fe_arrays, block_name, R_e: Tensor):
    field = fe_problem.field_idx_per_block[0]
    plan = fe_arrays.eq_plan_by_block[block_name][field]
    return segment_sum(R_e.reshape(-1), plan)


def assemble_element_block(fe_problem: "FEProblem",
                           fe_arrays: "FEKernelArrays",
                           params_by_block: Mapping[str, dict],
                           block_name: str, U_global: Tensor,
                           U_prev_global: Tensor, t: float,
                           xi_prev_per_block: Tensor | None = None):
    """One block's (R contribution, COO vals, xi_solved).

    ``R`` is a full-length global vector (zeros off-block) so blocks sum;
    ``vals`` stream in (r, s) order matching
    :func:`assembled_coo_pattern`.
    """
    evaluators = _block_evaluators(fe_problem, block_name,
                                   xi_prev_per_block)
    U_elem = gather_element_U(U_global, fe_arrays, block_name)
    U_prev_elem = gather_element_U(U_prev_global, fe_arrays, block_name)
    R_e, K_e, xi_solved = evaluators["block_R_and_K_and_xi"](
        params_by_block[block_name], U_elem[0], U_prev_elem[0],
        fe_arrays.geometry_cache[block_name], None, t, xi_prev_per_block)
    R = _scatter_residual(fe_problem, fe_arrays, block_name, R_e)
    n_elems = R_e.shape[0]
    return R, K_e.reshape(n_elems, -1).reshape(-1), xi_solved


def assemble_element_block_residual(fe_problem, fe_arrays, params_by_block,
                                    block_name, U_global, U_prev_global,
                                    t, xi_prev_per_block=None) -> Tensor:
    """Residual-only block assembly (no tangent)."""
    evaluators = _block_evaluators(fe_problem, block_name,
                                   xi_prev_per_block)
    U_elem = gather_element_U(U_global, fe_arrays, block_name)
    U_prev_elem = gather_element_U(U_prev_global, fe_arrays, block_name)
    R_e = evaluators["block_R"](
        params_by_block[block_name], U_elem[0], U_prev_elem[0],
        fe_arrays.geometry_cache[block_name], None, t, xi_prev_per_block)
    return _scatter_residual(fe_problem, fe_arrays, block_name, R_e)


def assemble_global(fe_problem, fe_arrays, params_by_block, U_global,
                    U_prev_global, t, xi_prev_by_block=None):
    """(K deduped, R, xi_solved_by_block) over all element blocks.

    Convention: ``R(U) = R_int(U) - F_ext``; the Newton driver solves
    ``K dU = -R``.
    """
    xi_prev = xi_prev_by_block or {}
    R = None
    vals_all = []
    xi_solved_by_block: dict[str, Tensor] = {}

    for block_name in fe_problem.evaluators_by_block:
        R_b, vals, xi_solved = assemble_element_block(
            fe_problem, fe_arrays, params_by_block, block_name,
            U_global, U_prev_global, t,
            xi_prev_per_block=xi_prev.get(block_name))
        R = R_b if R is None else R + R_b
        vals_all.append(vals)
        xi_solved_by_block[block_name] = xi_solved

    vals = torch.cat(vals_all)
    unique = segment_sum(vals, fe_arrays.coo_dedup_plan)
    K = CooMatrix(unique, fe_arrays.coo_rows, fe_arrays.coo_cols,
                  fe_arrays.coo_row_plan, fe_arrays.coo_col_plan,
                  fe_problem.dof_map.num_total_dofs)
    return K, R, xi_solved_by_block


def assemble_global_residual(fe_problem, fe_arrays, params_by_block,
                             U_global, U_prev_global, t,
                             xi_prev_by_block=None) -> Tensor:
    """R(U) only (same value as assemble_global's R)."""
    xi_prev = xi_prev_by_block or {}
    R = None
    for block_name in fe_problem.evaluators_by_block:
        R_b = assemble_element_block_residual(
            fe_problem, fe_arrays, params_by_block, block_name,
            U_global, U_prev_global, t,
            xi_prev_per_block=xi_prev.get(block_name))
        R = R_b if R is None else R + R_b
    return R


def assembled_coo_pattern(fe_problem):
    """With-duplicates (rows, cols) in the (block, r, s) emit order, plus
    the deduped pattern and dedup scatter.

    Single source of truth shared by assembly and the embedded-BC
    sparsity cache, so the emit order can never drift from the data.
    Returns (unique_rows, unique_cols, dedup_scatter).
    """
    mesh = fe_problem.mesh
    dof_map = fe_problem.dof_map
    num_blocks = fe_problem.gr.num_residuals

    rows_all, cols_all = [], []
    for block_name in fe_problem.evaluators_by_block:
        conn = mesh.connectivity[mesh.element_blocks[block_name]]
        n_elems = conn.shape[0]
        eqs = [element_eq_indices(conn, dof_map,
                                  fe_problem.field_idx_per_block[r])
               for r in range(num_blocks)]
        for r in range(num_blocks):
            for s in range(num_blocks):
                nr, ns = eqs[r].shape[1], eqs[s].shape[1]
                rows_all.append(np.broadcast_to(
                    eqs[r][:, :, None], (n_elems, nr, ns)).ravel())
                cols_all.append(np.broadcast_to(
                    eqs[s][:, None, :], (n_elems, nr, ns)).ravel())
    rows = np.concatenate(rows_all)
    cols = np.concatenate(cols_all)

    order = np.lexsort((cols, rows))
    sr, sc = rows[order], cols[order]
    new_group = np.empty(rows.shape[0], dtype=bool)
    new_group[0] = True
    new_group[1:] = (sr[1:] != sr[:-1]) | (sc[1:] != sc[:-1])
    segment = (np.cumsum(new_group) - 1).astype(np.intp)
    dedup_scatter = np.empty(rows.shape[0], dtype=np.intp)
    dedup_scatter[order] = segment
    return (sr[new_group].astype(np.intp), sc[new_group].astype(np.intp),
            dedup_scatter)
