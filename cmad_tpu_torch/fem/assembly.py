"""Element + global FE assembly, block path.

Port of ``cmad_tpu/fem/assembly.py`` (parity: reference
``cmad/fem/assembly.py``). Every block's evaluators carry
``block_R_and_K_and_xi`` / ``block_R``: the J2 block
(``fem/j2_block.py``), the point-batch block (``fem/coupled_block.py``)
or the generic per-point block (``fem/generic_block.py``, CLOSED_FORM
blocks and the COUPLED blocks the other two decline), each evaluating
the whole element block in one batched call. Its element residuals
scatter into the global vector and its element matrices stream out in
the ``(block, r, s)`` COO emit order, deduplicated into the pattern of
:func:`assembled_coo_pattern`. That function rebuilds the identical
with-duplicates ``(rows, cols)`` stream from the same eq-index helper
the scatter uses, so the pattern and the data cannot drift apart. A
CLOSED_FORM block has no state: it takes no ``xi_prev`` and returns
none, and :func:`assemble_global` leaves it out of ``xi_solved_by_block``
(the drivers echo its initial state forward, as the JAX package's do).

Both sums, and the gathers of U, go through the segment-sum plans of
``fem/kernel_arrays.py`` (``ops/segment_sum.py``): each target adds its
entries in ascending entry order, on the card (the ``segment_sum``
kernel) as on the CPU (``index_add_``), so R and K are the same bits from
run to run, and the reverse sweep's transposes are too.

External loads enter R as ``R = R_int - F_ext``: each block subtracts
its body force ``N (x) f(x_ip, t) w dv`` from its element residuals, and
the surface fluxes (``fem/neumann.py``) are added after the volume walk,
as the JAX package adds them. A load depends on (x, t) only, so
:func:`external_loads` evaluates them once per time, on the host over
all of their points, and every assembly at that time (a step's Newton
iterations, line-search probes and residual pair, and the sensitivity
sweeps' re-assemblies) reads the same tensors.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import TYPE_CHECKING

import numpy as np
import torch

from cmad_tpu_torch.fem.dof import GlobalDofMap, GlobalFieldLayout
from cmad_tpu_torch.fem.elements import EntityType
from cmad_tpu_torch.fem.neumann import assemble_side_neumann
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


def external_loads(fe_problem: "FEProblem", fe_arrays: "FEKernelArrays",
                   t: float):
    """``(R_neumann | None, {block: f_ip (E, Q, ncomp)})``: the surface-flux
    vector and each block's body force at its IPs, at time ``t``. Each is
    evaluated once for a time, its host values copied to the device once,
    and kept until an assembly asks for another time."""
    t = float(t)
    cache = fe_problem.load_cache
    if cache.get("t") != t:
        cache.clear()
        side = fe_arrays.neumann_side_arrays
        neumann = None if side is None else assemble_side_neumann(
            side, fe_problem.resolved_neumann_bcs, t)
        fn = (fe_problem.forcing_fns_by_block_idx or {}).get(0)
        body = {} if fn is None else {
            block: _body_force_at_ips(fe_problem, fe_arrays, fn, block,
                                      coords, t)
            for block, coords in fe_arrays.body_force_coords_by_block.items()}
        cache.update(t=t, neumann=neumann, body=body)
    return cache["neumann"], cache["body"]


def _body_force_at_ips(fe_problem, fe_arrays, fn, block, coords, t):
    """The body force ``fn(coords, t)`` at the block's IPs, (E, Q,
    ncomp) on the problem's device."""
    E, Q = fe_arrays.geometry_cache[block]["per_elem"]["iso_jac_det"].shape
    vals = np.asarray(fn(coords, t), dtype=np.float64)
    if vals.shape != (E * Q, int(fe_problem.gr._num_eqs[0])):
        raise ValueError(f"forcing fn returned {vals.shape} at {E * Q} "
                         f"points of block {block!r}")
    return torch.as_tensor(vals.reshape(E, Q, -1), dtype=fe_problem.dtype,
                           device=fe_problem.device)


def _block_evaluators(fe_problem, block_name, xi_prev_per_block):
    """The block's evaluators and the state they take: ``xi_prev`` for a
    COUPLED block (required), None for a CLOSED_FORM one."""
    evaluators = fe_problem.evaluators_by_block[block_name]
    if fe_problem.modes_by_block[block_name] != GlobalResidualMode.COUPLED:
        return evaluators, None
    if xi_prev_per_block is None:
        raise ValueError(
            f"COUPLED block {block_name!r} requires xi_prev_per_block")
    return evaluators, xi_prev_per_block


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
    """One block's (R contribution, COO vals, xi_solved | None).

    ``R`` is a full-length global vector (zeros off-block) so blocks sum;
    ``vals`` stream in (r, s) order matching
    :func:`assembled_coo_pattern`.
    """
    evaluators, xi_prev = _block_evaluators(fe_problem, block_name,
                                            xi_prev_per_block)
    U_elem = gather_element_U(U_global, fe_arrays, block_name)
    U_prev_elem = gather_element_U(U_prev_global, fe_arrays, block_name)
    f_ip = external_loads(fe_problem, fe_arrays, t)[1].get(block_name)
    R_e, K_e, xi_solved = evaluators["block_R_and_K_and_xi"](
        params_by_block[block_name], U_elem[0], U_prev_elem[0],
        fe_arrays.geometry_cache[block_name], f_ip, t, xi_prev)
    R = _scatter_residual(fe_problem, fe_arrays, block_name, R_e)
    n_elems = R_e.shape[0]
    return R, K_e.reshape(n_elems, -1).reshape(-1), xi_solved


def assemble_element_block_residual(fe_problem, fe_arrays, params_by_block,
                                    block_name, U_global, U_prev_global,
                                    t, xi_prev_per_block=None) -> Tensor:
    """Residual-only block assembly (no tangent)."""
    evaluators, xi_prev = _block_evaluators(fe_problem, block_name,
                                            xi_prev_per_block)
    U_elem = gather_element_U(U_global, fe_arrays, block_name)
    U_prev_elem = gather_element_U(U_prev_global, fe_arrays, block_name)
    f_ip = external_loads(fe_problem, fe_arrays, t)[1].get(block_name)
    R_e = evaluators["block_R"](
        params_by_block[block_name], U_elem[0], U_prev_elem[0],
        fe_arrays.geometry_cache[block_name], f_ip, t, xi_prev)
    return _scatter_residual(fe_problem, fe_arrays, block_name, R_e)


def assemble_global(fe_problem, fe_arrays, params_by_block, U_global,
                    U_prev_global, t, xi_prev_by_block=None):
    """(K deduped, R, xi_solved_by_block) over all element blocks;
    ``xi_solved_by_block`` holds the COUPLED blocks only.

    Convention: ``R(U) = R_int(U) - F_ext`` with body forces folded per
    element and surface fluxes added after the volume walk; the Newton
    driver solves ``K dU = -R``.
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
        if xi_solved is not None:
            xi_solved_by_block[block_name] = xi_solved
    R = _with_neumann(fe_problem, fe_arrays, R, t)

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
    return _with_neumann(fe_problem, fe_arrays, R, t)


def _with_neumann(fe_problem, fe_arrays, R: Tensor, t) -> Tensor:
    neumann = external_loads(fe_problem, fe_arrays, t)[0]
    return R if neumann is None else R + neumann.to(R.dtype)


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
