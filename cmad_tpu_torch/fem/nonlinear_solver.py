"""Global FE Newton, primal.

Port of the primal of ``cmad_tpu/fem/nonlinear_solver.py`` (parity:
reference ``cmad/fem/nonlinear_solver.py:46-542``). The JAX package's
``lax.while_loop`` Newton (assemble -> embedded-BC enforce -> linear
solve -> line search reusing the trial assembly) is a Python loop here
that reads ``||r||`` on the host once per iteration:

- the carry is ``(r, K_data, U, xi)``, and the line search's accepted
  probe returns its own ``(r, K_data, xi)``, so an accepted step costs
  no extra assembly;
- the inner tolerance follows the Eisenstat-Walker forcing term when the
  linear solver asks for ``adaptive rtol``;
- the line search is the FE's nonmonotone Armijo search
  (``util/line_search.py``, one point).

The whole loop runs under ``torch.no_grad()``: the primal records
nothing for autograd, and the J2 block's ``SoaStep`` runs its forward
alone, which on CUDA tensors is one ``j2_soa_step`` launch per assembly.

The implicit-function rule of the converged solve (``_fe_newton_solve_ad``
and ``_fe_solution_at_ad`` in the JAX package) comes with the gradient
slice (ROADMAP queue 1, item 17); the host-loop driver and the
tunnel-only chunked Newton are not ported.
"""
from __future__ import annotations

from collections.abc import Mapping
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch import config
from cmad_tpu_torch.fem.assembly import assemble_global
from cmad_tpu_torch.fem.fe_problem import FEProblem
from cmad_tpu_torch.fem.kernel_arrays import FEKernelArrays
from cmad_tpu_torch.fem.sparse_solve import (
    _csr_operator,
    _embedded_bc_enforce,
    _embedded_residual,
    jax_cg,
    jax_cg_two_level,
    scipy_lu,
)
from cmad_tpu_torch.typing import Tensor
from cmad_tpu_torch.util.line_search import (
    DEFAULT_LINE_SEARCH_SETTINGS,
    line_search,
)

# FE global Newton defaults to the NON-MONOTONE acceptance policy: the
# merit ||r|| transiently increases at elastic/plastic switches on the
# convergent path; a monotone best-merit fallback takes damped steps
# exactly there.
FE_LINE_SEARCH_DEFAULTS: dict[str, Any] = {
    **DEFAULT_LINE_SEARCH_SETTINGS, "nonmonotone": True,
}

DEFAULT_LINEAR_SOLVER_SETTINGS: dict[str, Any] = {
    "type": "direct", "rtol": 1.0e-10, "max iters": None, "restart": 20,
    "preconditioner": {"type": "jacobi"},
}


def default_nonlinear_settings(
        dtype: torch.dtype = config.DEFAULT_DTYPE) -> dict[str, Any]:
    abs_tol, rel_tol = config.newton_tols("fe_global", dtype)
    return {"max iters": 20, "abs tol": abs_tol, "rel tol": rel_tol,
            "print convergence": False,
            "line search": FE_LINE_SEARCH_DEFAULTS}


def get_two_level_pattern(fe_problem: FEProblem,
                          target_nodes_per_aggregate: int = 48):
    """Build (once per problem, host-side) and cache the aggregation
    prolongator with its coarse-contraction plan for the two-level arm:
    rigid-body slots for the single displacement field."""
    cached = fe_problem.two_level_patterns.get(target_nodes_per_aggregate)
    if cached is not None:
        return cached
    from cmad_tpu_torch.fem.two_level import build_two_level_pattern

    comps = [int(c) for c in fe_problem.dof_map.num_dofs_per_basis_fn]
    if comps != [3]:
        raise NotImplementedError(
            f"two_level for the layout with components {comps}: only the "
            "single displacement field (3/node) is ported; the mixed u-p "
            "pattern waits for ROADMAP queue 1, item 22")
    sp = fe_problem.embedded_sparsity
    pattern = build_two_level_pattern(
        np.asarray(fe_problem.mesh.nodes, dtype=np.float64),
        np.asarray(fe_problem.dof_map.prescribed_indices),
        fe_problem.dof_map.num_total_dofs, sp.indptr_np, sp.col_indices_np,
        target_nodes_per_aggregate=target_nodes_per_aggregate)
    fe_problem.two_level_patterns[target_nodes_per_aggregate] = pattern
    return pattern


def solve_linear(K_data: Tensor, fe_problem: FEProblem,
                 fe_arrays: FEKernelArrays, rhs: Tensor,
                 settings: dict[str, Any],
                 rtol_override: float | None = None,
                 stats: dict | None = None) -> Tensor:
    """Dispatch on ``settings['type']`` (``direct`` | ``cg``) and, for
    ``cg``, the preconditioner (``jacobi`` | ``two_level``).
    ``rtol_override`` replaces the static rtol of the iterative arms (the
    inexact-Newton forcing term). ``stats["cg_iters"]`` collects each CG
    solve's iteration count. The other arms of the JAX package raise,
    naming the ROADMAP item that ports them."""
    sparsity = fe_arrays.embedded_sparsity
    kind = settings["type"]
    if settings.get("equilibrate", "auto") not in ("auto", False):
        raise NotImplementedError(
            "linear solver 'equilibrate' (for mixed layouts) is not "
            "ported yet: ROADMAP queue 1, item 22")
    if settings.get("solve dtype") == "mixed":
        raise NotImplementedError(
            "linear solver 'solve dtype: mixed' (the f32 Krylov inside "
            "f64 refinement) is not ported yet: ROADMAP queue 1, item 13")

    if kind == "direct":
        return scipy_lu(K_data, sparsity, rhs)

    rtol = settings["rtol"] if rtol_override is None else rtol_override
    precon_spec = settings.get("preconditioner", {"type": "jacobi"})
    precon = precon_spec["type"]
    if kind == "cg":
        if precon == "jacobi":
            return jax_cg(K_data, sparsity, rhs, rtol=rtol,
                          max_iters=settings["max iters"], stats=stats)
        if precon == "two_level":
            pattern = get_two_level_pattern(
                fe_problem, precon_spec.get("aggregate nodes", 48))
            return jax_cg_two_level(
                K_data, sparsity, rhs, pattern, rtol=rtol,
                max_iters=settings["max iters"], stats=stats)
        if precon == "chebyshev":
            raise NotImplementedError(
                "cg + chebyshev is not ported yet: ROADMAP queue 1, item "
                "13")
        raise ValueError(
            f"unknown cg preconditioner {precon!r}; this build supports "
            "'jacobi' and 'two_level'")
    if kind == "gmres":
        raise NotImplementedError(
            "the gmres arms (jacobi, two_level, block) are not ported "
            "yet: ROADMAP queue 1, item 22")
    raise ValueError(
        f"unknown linear solver type {kind!r}; expected 'direct', 'cg', "
        "or 'gmres'")


def _fe_newton_primal(fe_problem, fe_arrays, params_by_block, U_prev,
                      xi_prev_by_block, t, nls, lss,
                      stats: dict | None = None):
    """The Newton of one quasi-static step from ``U_prev``; returns
    ``(U*, xi*_by_block)``. ``stats``, when given, receives the Newton
    iterations (``newton_iters``), the assemblies (``assemblies``: one
    per K1 launch on the card) and each CG solve's iterations
    (``cg_iters``)."""
    stats = {} if stats is None else stats
    stats.setdefault("newton_iters", 0)
    stats.setdefault("assemblies", 0)
    max_iters = nls["max iters"]
    abs_tol, rel_tol = nls["abs tol"], nls["rel tol"]
    ls = {**FE_LINE_SEARCH_DEFAULTS, **nls.get("line search", {})}
    ls_max_evals = ls["max evals"]

    presc_idx = fe_arrays.prescribed_indices
    presc_vals = torch.as_tensor(
        fe_problem.dof_map.evaluate_prescribed_values(fe_arrays.dbc_arrays,
                                                      float(t)),
        dtype=U_prev.dtype, device=U_prev.device)
    sparsity = fe_arrays.embedded_sparsity

    def assemble_enforced(U):
        stats["assemblies"] += 1
        K, R, xi = assemble_global(
            fe_problem, fe_arrays, params_by_block, U, U_prev, t,
            xi_prev_by_block=xi_prev_by_block)
        K_data, K_ii = _embedded_bc_enforce(K, presc_idx)
        r = _embedded_residual(R, K, U, presc_idx, presc_vals, K_ii)
        return r, K_data, xi

    r, K_data, xi = assemble_enforced(U_prev)
    norm = float(torch.linalg.norm(r))
    R0 = max(norm, abs_tol)
    if nls["print convergence"]:
        print(f" > (1) Newton: abs ||R|| = {norm:.6e} "
              f"rel ||R|| = {norm / R0:.6e}")
    adaptive = bool(lss.get("adaptive rtol", False)) \
        and lss["type"] in ("cg", "gmres")

    U = U_prev
    norm_prev = 10.0 * norm
    i = 0
    while i < max_iters and norm >= abs_tol and norm >= rel_tol * R0:
        rtol_k = None
        if adaptive:
            # Eisenstat-Walker choice 2 forcing term: the inner solve's
            # tolerance follows the observed Newton contraction
            rtol_k = min(max(0.9 * (norm / norm_prev) ** 2, lss["rtol"]),
                         1e-2)
        dU = solve_linear(K_data, fe_problem, fe_arrays, -r, lss,
                          rtol_override=rtol_k, stats=stats)
        if ls_max_evals > 0:
            r_sq = r @ r

            def probe(alpha):
                r_t, K_t, xi_t = assemble_enforced(U + alpha * dU)
                _, matvec = _csr_operator(K_t, sparsity)
                return (0.5 * (r_t @ r_t), r_t @ matvec(dU),
                        (r_t, K_t, xi_t))

            alpha, (r, K_data, xi) = line_search(
                probe, 0.5 * r_sq, -r_sq, ls, (r, K_data, xi))
            U = U + alpha * dU
        else:
            U = U + dU
            r, K_data, xi = assemble_enforced(U)
        norm_prev = norm
        norm = float(torch.linalg.norm(r))
        i += 1
        if nls["print convergence"]:
            print(f" > ({i + 1}) Newton: abs ||R|| = {norm:.6e} "
                  f"rel ||R|| = {norm / R0:.6e}")
    stats["newton_iters"] += i
    return U, xi


def fe_newton_solve(fe_problem: FEProblem,
                    params_by_block: Mapping[str, dict],
                    U_prev, xi_prev_by_block=None, t: float = 0.0,
                    nonlinear_solver_settings: dict | None = None,
                    linear_solver_settings: dict | None = None,
                    stats: dict | None = None):
    """Public quasi-static Newton driver; see module docstring.

    Initial iterate is U_prev (warm start); the current-step boundary
    targets enter through the embedded residual's coupling term.
    ``xi_prev_by_block`` holds each block's state in the carrier layout
    its evaluators take (``fem/xi_carrier.py``). Returns
    ``(U_star, xi_star_by_block)``, primal only (no autograd)."""
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    U_prev = torch.as_tensor(U_prev, dtype=fe_problem.dtype,
                             device=fe_problem.device)
    with torch.no_grad():
        return _fe_newton_primal(
            fe_problem, fe_problem.kernel_arrays, params_by_block, U_prev,
            dict(xi_prev_by_block or {}), t, nls, lss, stats)
