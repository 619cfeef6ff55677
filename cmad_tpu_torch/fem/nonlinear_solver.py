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

The implicit-function rule of the converged solve is two
``torch.autograd.Function`` classes, the JAX package's ``custom_jvp`` rules
``_fe_newton_solve_ad`` and ``_fe_solution_at_ad``:

- :class:`FeNewtonSolve` (:func:`fe_newton_solve_ad`): the forward is the
  Newton above;
- :class:`FeSolutionAt` (:func:`fe_solution_at`): the forward is one
  assembly at a known solution ``U*``, which recovers xi*; ``U*`` is
  data, its incoming gradient dropped.

Both backwards are :func:`_ift_backward`, the transpose of the JAX
package's ``_ift_tangents``: the cotangent on U* is ``U_bar + (dxi/dU)^T
xi_bar``; ``K^T lambda`` = that cotangent is solved with the step's own
linear-solver arm at its static rtol, on the transposed data; the inputs'
cotangents are ``-(dr/d(p, U_prev, xi_prev))^T lambda + (dxi/d(.))^T
xi_bar``, from ``torch.autograd.grad`` of one assembly at U* with grad
enabled (on the card that assembly launches ``j2_soa_step`` through
``SoaStep``, whose backward is the closed-form transpose). Every
parameter tensor is an explicit input of the Function (the leaves of the
per-block parameter trees), never captured by a closure.

The backward has derivatives of its own (a backward with
``create_graph``): it then builds its graph, with the transpose solve
differentiable (``sparse_solve.LinearSolve``) and :class:`FeNewtonSolve`'s
U* its own saved output, so a double backward sees U* move with the
inputs through this same rule: the Hessians of ``fem/stepped_adjoint.py``
and of the scan driver. :class:`FeSolutionAt` holds U* as data, so its
second derivatives in the inputs miss U*'s motion (the JAX package's
``_fe_solution_at_ad`` drops its tangent alike); its backward is still
exactly linear in the incoming cotangents, which is all the stepped
HVP's tangent sweep asks of it. The host-loop driver and the tunnel-only
chunked Newton are not ported.
"""
from __future__ import annotations

import time
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
    cg_unique,
    linear_solve,
    lu_unique,
)
from cmad_tpu_torch.ops.segment_sum import segment_sum
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


def linear_solver(fe_problem: FEProblem, fe_arrays: FEKernelArrays,
                  settings: dict[str, Any],
                  rtol_override: float | None = None,
                  stats: dict | None = None):
    """``solve(unique, b)``, the arm ``settings`` names, on the
    deduplicated CSR data ``unique`` (outside autograd): dispatch on
    ``settings['type']`` (``direct`` | ``cg``) and, for ``cg``, the
    preconditioner (``jacobi`` | ``two_level``). ``rtol_override``
    replaces the static rtol of the iterative arms (the inexact-Newton
    forcing term). ``stats["cg_iters"]`` collects each CG solve's
    iteration count. The other arms of the JAX package raise, naming the
    ROADMAP item that ports them."""
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
        return lambda unique, b: lu_unique(unique, sparsity, b)

    rtol = settings["rtol"] if rtol_override is None else rtol_override
    precon_spec = settings.get("preconditioner", {"type": "jacobi"})
    precon = precon_spec["type"]
    if kind == "cg":
        if precon == "jacobi":
            max_iters = settings["max iters"]
            return lambda unique, b: cg_unique(unique, sparsity, b, rtol,
                                               max_iters, stats)
        if precon == "two_level":
            max_iters = settings["max iters"]
            pattern = get_two_level_pattern(
                fe_problem, precon_spec.get("aggregate nodes", 48))
            return lambda unique, b: cg_unique(unique, sparsity, b, rtol,
                                               max_iters, stats, pattern)
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


def solve_linear(K_data: Tensor, fe_problem: FEProblem,
                 fe_arrays: FEKernelArrays, rhs: Tensor,
                 settings: dict[str, Any],
                 rtol_override: float | None = None,
                 stats: dict | None = None,
                 transpose: bool = False) -> Tensor:
    """``K^-1 rhs`` (``K^-T rhs`` with ``transpose``) for the embedded-BC
    data ``K_data``, through the arm of :func:`linear_solver`;
    differentiable in ``K_data`` and ``rhs`` to any order
    (``sparse_solve.linear_solve``: the backward is the transpose solve
    through the same arm)."""
    sparsity = fe_arrays.embedded_sparsity
    solve = linear_solver(fe_problem, fe_arrays, settings, rtol_override,
                          stats)
    unique = segment_sum(K_data, sparsity.dedup_plan)
    if transpose:
        unique = unique[sparsity.transpose]
    return linear_solve(unique, rhs, sparsity, solve)


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


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _flatten_tree(tree) -> tuple[list[Tensor], Any]:
    """The tensor leaves of a nested dict (in its insertion order) and a
    function that rebuilds the tree from a list of leaves."""
    leaves: list[Tensor] = []

    def walk(node):
        if isinstance(node, Mapping):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, Tensor):
            leaves.append(node)
            return len(leaves) - 1
        return ("const", node)

    skeleton = walk(tree)

    def rebuild(new_leaves):
        def fill(node):
            if isinstance(node, dict):
                return {k: fill(v) for k, v in node.items()}
            if isinstance(node, tuple):
                return node[1]
            return new_leaves[node]
        return fill(skeleton)

    return leaves, rebuild


class _IftSpec:
    """The static side of one implicit-function rule: problem, arrays,
    time, settings, the block order of xi and the parameter-tree
    rebuilder; ``profile``, when a dict, receives the backward's
    synchronized host times and its solve's CG iterations."""

    def __init__(self, fe_problem, fe_arrays, t, nls, lss, blocks, rebuild,
                 n_params, profile=None):
        self.fe_problem, self.fe_arrays, self.t = fe_problem, fe_arrays, t
        self.nls, self.lss = nls, lss
        self.blocks, self.rebuild, self.n_params = blocks, rebuild, n_params
        self.profile = profile

    def unpack(self, inputs):
        """(U_prev, {block: xi_prev}, param leaves) from the flat inputs."""
        U_prev = inputs[0]
        nb = len(self.blocks)
        xi_prev = dict(zip(self.blocks, inputs[1:1 + nb], strict=True))
        return U_prev, xi_prev, list(inputs[1 + nb:1 + nb + self.n_params])


def _embedded_r_and_xi(spec: _IftSpec, params_by_block, U, U_prev,
                       xi_prev_by_block):
    """(r, K_data, xi_by_block): the embedded residual at ``U`` and the
    state it solves for."""
    fe, fa = spec.fe_problem, spec.fe_arrays
    presc_idx = fa.prescribed_indices
    pv = torch.as_tensor(
        fe.dof_map.evaluate_prescribed_values(fa.dbc_arrays, float(spec.t)),
        dtype=U.dtype, device=U.device)
    K, R, xi = assemble_global(fe, fa, params_by_block, U, U_prev, spec.t,
                               xi_prev_by_block=xi_prev_by_block)
    K_data, K_ii = _embedded_bc_enforce(K, presc_idx)
    return _embedded_residual(R, K, U, presc_idx, pv, K_ii), K_data, xi


def _ift_backward(spec: _IftSpec, U_star: Tensor, inputs, grads, needs,
                  U_moves: bool = True):
    """The transpose of the IFT tangents at ``U_star``: the cotangents of
    ``inputs = (U_prev, *xi_prev, *param leaves)`` (those ``needs`` marks)
    from those of ``(U*, *xi*)``.

    Under a backward that builds a graph (``create_graph``, so
    ``torch.is_grad_enabled()``), the result is itself differentiable, in
    the incoming cotangents and in the inputs: the assembly is evaluated
    at the saved tensors plus zero leaves, the partial derivatives are
    taken by those leaves (U* held fixed), every ``autograd.grad`` builds
    its graph, and the transpose solve is the differentiable
    ``solve_linear``. With ``U_moves`` the saved ``U_star`` is the
    Function's output, so the next order sees U* move with the inputs
    through this same rule; without it (:class:`FeSolutionAt`, whose U*
    is data) U* stays fixed. Otherwise the inputs are detached and the
    result builds no graph."""
    prof = spec.profile
    dev = U_star.device
    create = torch.is_grad_enabled()
    g_U, g_xi = grads[0], list(grads[1:])
    if prof is not None:
        _sync(dev)
        t0 = time.perf_counter()
    with torch.enable_grad():
        if create:
            dU = torch.zeros_like(U_star, requires_grad=True)
            Us = (U_star if U_moves else U_star.detach()) + dU
            leaves = [torch.zeros_like(v, requires_grad=True) if n else None
                      for v, n in zip(inputs, needs, strict=True)]
            at = [v if d is None else v + d
                  for v, d in zip(inputs, leaves, strict=True)]
        else:
            dU = Us = U_star.detach().requires_grad_(True)
            at = [v.detach().requires_grad_(bool(n))
                  for v, n in zip(inputs, needs, strict=True)]
            leaves = [v if n else None for v, n in zip(at, needs,
                                                       strict=True)]
        Up, xps, lvs = spec.unpack(at)
        r, K_data, xi = _embedded_r_and_xi(spec, spec.rebuild(lvs), Us, Up,
                                           xps)
        xi_out = [xi[b] for b in spec.blocks]
        xi_pairs = [(x, g) for x, g in zip(xi_out, g_xi, strict=True)
                    if g is not None and x.requires_grad]
        if g_U is None:
            cot_U = torch.zeros_like(U_star)
        else:
            cot_U = g_U if create else g_U.detach()
        if xi_pairs:
            (d,) = torch.autograd.grad(
                [x for x, _ in xi_pairs], [dU], [g for _, g in xi_pairs],
                retain_graph=True, allow_unused=True, create_graph=create)
            if d is not None:
                cot_U = cot_U + d
        if prof is not None:
            _sync(dev)
            t1 = time.perf_counter()
        # the CG counts of this solve, and of the transpose solves a
        # higher order makes through it, land in the profile's list
        solve_stats = {} if prof is None else {
            "cg_iters": prof.setdefault("cg_iters", [])}
        lam = solve_linear(K_data if create else K_data.detach(),
                           spec.fe_problem, spec.fe_arrays, cot_U, spec.lss,
                           stats=solve_stats, transpose=True)
        if prof is not None:
            _sync(dev)
            t2 = time.perf_counter()
        idx = [i for i, v in enumerate(leaves) if v is not None]
        out: list[Tensor | None] = [None] * len(inputs)
        if idx:
            got = torch.autograd.grad(
                [r, *(x for x, _ in xi_pairs)], [leaves[i] for i in idx],
                [-lam, *(g for _, g in xi_pairs)], allow_unused=True,
                create_graph=create)
            for i, gi in zip(idx, got, strict=True):
                out[i] = gi
    if prof is not None:
        _sync(dev)
        t3 = time.perf_counter()
        prof["assembly_s"] = prof.get("assembly_s", 0.0) + (t1 - t0) \
            + (t3 - t2)
        prof["solve_s"] = prof.get("solve_s", 0.0) + (t2 - t1)
        prof["assemblies"] = prof.get("assemblies", 0) + 1
    return out


class FeNewtonSolve(torch.autograd.Function):
    """``(U*, *xi*) = FeNewtonSolve.apply(spec, U_prev, *xi_prev,
    *param_leaves)``: the converged Newton step, with the
    implicit-function rule as its backward (the JAX package's
    ``_fe_newton_solve_ad``)."""

    @staticmethod
    def forward(ctx, spec: _IftSpec, *inputs):
        U_prev, xi_prev, leaves = spec.unpack(inputs)
        newton: dict = {}
        with torch.no_grad():
            U, xi = _fe_newton_primal(
                spec.fe_problem, spec.fe_arrays, spec.rebuild(leaves),
                U_prev, xi_prev, spec.t, spec.nls, spec.lss, newton)
        if spec.profile is not None:
            prof = spec.profile
            prof["newton_iters"] = prof.get("newton_iters", 0) \
                + newton["newton_iters"]
            prof["newton_assemblies"] = prof.get("newton_assemblies", 0) \
                + newton["assemblies"]
            prof.setdefault("newton_cg_iters", []).extend(
                newton.get("cg_iters", []))
        if U is U_prev:         # converged at the start: a new tensor
            U = U.clone()
        ctx.spec = spec
        ctx.save_for_backward(U, *inputs)
        return (U, *(xi[b] for b in spec.blocks))

    @staticmethod
    def backward(ctx, *grads):
        U_star, *inputs = ctx.saved_tensors
        return (None, *_ift_backward(ctx.spec, U_star, inputs, grads,
                                     ctx.needs_input_grad[1:]))


class FeSolutionAt(torch.autograd.Function):
    """``(U*, *xi*) = FeSolutionAt.apply(spec, U_star, U_prev, *xi_prev,
    *param_leaves)``: the converged step AS IF solved, given its known
    solution ``U_star`` (one assembly recovers xi*), with the same
    implicit-function rule as :class:`FeNewtonSolve` (the JAX package's
    ``_fe_solution_at_ad``). ``U_star`` is data: its gradient is
    dropped, and the rule's own derivatives hold it fixed."""

    @staticmethod
    def forward(ctx, spec: _IftSpec, U_star: Tensor, *inputs):
        U_prev, xi_prev, leaves = spec.unpack(inputs)
        with torch.no_grad():
            _r, _K, xi = _embedded_r_and_xi(spec, spec.rebuild(leaves),
                                            U_star, U_prev, xi_prev)
        ctx.spec = spec
        ctx.save_for_backward(U_star, *inputs)
        return (U_star.clone(), *(xi[b] for b in spec.blocks))

    @staticmethod
    def backward(ctx, *grads):
        U_star, *inputs = ctx.saved_tensors
        return (None, None, *_ift_backward(ctx.spec, U_star, inputs, grads,
                                           ctx.needs_input_grad[2:],
                                           U_moves=False))


def _ift_inputs(fe_problem, params_by_block, U_prev, xi_prev_by_block, t,
                nonlinear_solver_settings, linear_solver_settings, profile):
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    blocks = fe_problem.state_blocks()
    leaves, rebuild = _flatten_tree(dict(params_by_block))
    spec = _IftSpec(fe_problem, fe_problem.kernel_arrays, float(t), nls, lss,
                    blocks, rebuild, len(leaves), profile)
    xi_prev = dict(xi_prev_by_block or {})
    return spec, [U_prev, *(xi_prev[b] for b in blocks), *leaves]


def fe_newton_solve_ad(fe_problem: FEProblem,
                       params_by_block: Mapping[str, dict], U_prev,
                       xi_prev_by_block, t: float,
                       nonlinear_solver_settings: dict | None = None,
                       linear_solver_settings: dict | None = None,
                       profile: dict | None = None):
    """:func:`fe_newton_solve` with the implicit-function rule:
    ``(U*, xi*_by_block)`` differentiable in the parameter tensors,
    ``U_prev`` and ``xi_prev_by_block`` (carrier layout); the states are
    those of the blocks that have one (``FEProblem.state_blocks``)."""
    spec, inputs = _ift_inputs(fe_problem, params_by_block, U_prev,
                               xi_prev_by_block, t, nonlinear_solver_settings,
                               linear_solver_settings, profile)
    U, *xi = FeNewtonSolve.apply(spec, *inputs)
    return U, dict(zip(spec.blocks, xi, strict=True))


def fe_solution_at(fe_problem: FEProblem,
                   params_by_block: Mapping[str, dict], U_prev,
                   xi_prev_by_block, t: float, U_star: Tensor,
                   nonlinear_solver_settings: dict | None = None,
                   linear_solver_settings: dict | None = None,
                   profile: dict | None = None):
    """The step through its stored solution ``U_star``: ``(U*,
    xi*_by_block)`` with the same derivative as
    :func:`fe_newton_solve_ad`, at the cost of one assembly forward."""
    spec, inputs = _ift_inputs(fe_problem, params_by_block, U_prev,
                               xi_prev_by_block, t, nonlinear_solver_settings,
                               linear_solver_settings, profile)
    U, *xi = FeSolutionAt.apply(spec, U_star, *inputs)
    return U, dict(zip(spec.blocks, xi, strict=True))


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
