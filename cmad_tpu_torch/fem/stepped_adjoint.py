"""Checkpointed per-step FE value-and-gradient (stepped adjoint).

Port of ``build_fe_stepped_value_and_grad`` of
``cmad_tpu/fem/stepped_adjoint.py``: the objective J of a quasi-static
drive and its gradient with respect to the flat active-parameter vector,
one step at a time (a discrete adjoint with checkpoints at step
boundaries):

- forward sweep: each step's Newton (``fem/nonlinear_solver.py``, under
  ``torch.no_grad()``) and the QoI's step contribution; each step's
  converged ``(U_k, xi_k)`` is stored;
- reverse sweep: for each step from the last, ``torch.autograd.grad`` of
  the step map ``(params_flat, U_{k-1}, xi_{k-1}) -> (U_k, xi_k, j_k)``
  against the cotangents carried back from step k + 1 (and 1 for
  ``j_k``). With ``reuse_primal`` (the default) the step map runs through
  the stored solution (:class:`~cmad_tpu_torch.fem.nonlinear_solver.FeSolutionAt`:
  one assembly forward; the implicit-function rule's backward is one
  assembly linearized at U*_k and one transpose solve); otherwise it
  re-solves Newton (:class:`~cmad_tpu_torch.fem.nonlinear_solver.FeNewtonSolve`).
  The parameter cotangent is added up on the host in float64.

``checkpoint_offload`` keeps the checkpoints in (pinned) host memory
between the sweeps, so the device holds O(1) of them. The parameter
overlay maps the flat vector to the per-block trees inside the reverse
step, so every parameter tensor reaches the rule as an explicit input.

Second derivatives (:func:`build_fe_stepped_hvp`,
:func:`build_fe_stepped_hessian`) are reverse-over-reverse, step by step:
one primal sweep for all directions, then per step a tangent of the step
map (the derivative of its vector-Jacobian product in the cotangent) and,
from the last step, the double backward of the step's cotangent-weighted
outputs through the RE-SOLVING rule (:class:`FeNewtonSolve`, whose
backward is differentiable; :class:`FeSolutionAt` holds U* as data and
would drop how it moves).

Not ported: ``steps_per_dispatch`` (windows of steps in one device
program, for a remote TPU link's dispatch latency; the math is that of
one step at a time), accepted and logged as a no-op; the ``fe_arrays``
override (an element-sharded re-placement, ROADMAP queue 1, item 25).
"""
from __future__ import annotations

import logging
import time
from collections.abc import Callable, Mapping, Sequence
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch.fem.driver import log_dispatch_knobs
from cmad_tpu_torch.fem.fe_problem import FEProblem
from cmad_tpu_torch.fem.nonlinear_solver import (
    DEFAULT_LINEAR_SOLVER_SETTINGS,
    _fe_newton_primal,
    _sync,
    default_nonlinear_settings,
    fe_newton_solve_ad,
    fe_solution_at,
)
from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block
from cmad_tpu_torch.typing import Tensor

log = logging.getLogger(__name__)


def build_fe_stepped_value_and_grad(
        fe_problem: FEProblem,
        params_by_block_of_flat: Callable[[Tensor], Mapping[str, dict]],
        qoi,
        nonlinear_solver_settings: dict[str, Any] | None = None,
        linear_solver_settings: dict[str, Any] | None = None,
        reuse_primal: bool = True,
        checkpoint_offload: bool = False,
        steps_per_dispatch: int | None = None):
    """``value_and_grad(params_flat, state_init, t_schedule, stats=None)
    -> (float J, np.ndarray grad)`` with one forward and one reverse step
    per time step.

    ``params_by_block_of_flat`` maps the flat active-parameter vector to
    the per-block parameter trees (differentiably); ``qoi`` is an FEQoI,
    or None for a drive whose gradient is zero. ``state_init`` is
    ``(U0, {block: xi0 (E, Q, n_xi)})``. ``stats``, when a dict, receives
    ``forward`` and ``reverse`` lists with one entry per step, each with
    host times taken around synchronized work: the forward's Newton
    counts (``newton_iters``, ``assemblies``, ``cg_iters``), its wall and
    QoI seconds; the reverse's wall, the implicit-function rule's
    assembly seconds (the assembly at U* with grad, and its transposes),
    its transpose solves' seconds and CG iterations, and the rest (the
    QoI's forward and backward, the overlay)."""
    log_dispatch_knobs(log, steps_per_dispatch=steps_per_dispatch)
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    fe_arrays = fe_problem.kernel_arrays
    dev, dtype = fe_problem.device, fe_problem.dtype
    blocks = list(fe_problem.evaluators_by_block)

    def contribution(params_by_block, U, U_prev, xi, xi_prev, t, t_prev):
        if qoi is None:
            return U.new_zeros(())
        return qoi.step_contribution(params_by_block, fe_arrays)(
            U, U_prev, xi, xi_prev, t, t_prev)

    def store(U, xi):
        if not checkpoint_offload:
            return U, xi

        def host(v):
            v = v.detach().to("cpu", copy=True)
            return v.pin_memory() if torch.cuda.is_available() else v

        return host(U), {b: host(v) for b, v in xi.items()}

    def load(ckpt):
        U, xi = ckpt
        if not checkpoint_offload:
            return U, xi
        return U.to(dev), {b: v.to(dev) for b, v in xi.items()}

    def value_and_grad(params_flat, state_init, t_schedule: Sequence[float],
                       stats: dict | None = None):
        ts = [float(t) for t in t_schedule]
        params_flat = torch.as_tensor(params_flat, dtype=dtype, device=dev)
        U_prev = torch.as_tensor(state_init[0], dtype=dtype, device=dev)
        xi_prev = pack_xi_by_block(
            fe_problem, {b: torch.as_tensor(v, dtype=dtype, device=dev)
                         for b, v in state_init[1].items()}, layout="aos")

        # forward sweep, checkpoints at step boundaries
        states = [store(U_prev, xi_prev)]
        J = 0.0
        with torch.no_grad():
            params = params_by_block_of_flat(params_flat)
            for k in range(1, len(ts)):
                step_stats: dict = {}
                t0 = time.perf_counter()
                U, xi_solved = _fe_newton_primal(
                    fe_problem, fe_arrays, params, U_prev, xi_prev, ts[k],
                    nls, lss, step_stats)
                xi = {**xi_prev, **xi_solved}
                if stats is not None:
                    _sync(dev)
                    t1 = time.perf_counter()
                J += float(contribution(params, U, U_prev, xi, xi_prev,
                                        ts[k], ts[k - 1]))
                if stats is not None:
                    t2 = time.perf_counter()
                    stats.setdefault("forward", []).append(
                        {**step_stats, "wall_s": t2 - t0,
                         "qoi_s": t2 - t1})
                U_prev, xi_prev = U, xi
                states.append(store(U, xi))

        # reverse sweep
        grad = np.zeros(params_flat.shape[0], dtype=np.float64)
        U_last, xi_last = load(states[-1])
        cot_U = torch.zeros_like(U_last)
        cot_xi = {b: torch.zeros_like(v) for b, v in xi_last.items()}
        for k in range(len(ts) - 1, 0, -1):
            prof = {} if stats is not None else None
            if stats is not None:
                _sync(dev)
            t0 = time.perf_counter()
            U0, x0 = load(states[k - 1])
            U_star, _ = load(states[k])
            p = params_flat.detach().requires_grad_(True)
            U0 = U0.detach().requires_grad_(True)
            x0 = {b: v.detach().requires_grad_(True) for b, v in x0.items()}
            with torch.enable_grad():
                params = params_by_block_of_flat(p)
                if reuse_primal:
                    U, xi_solved = fe_solution_at(
                        fe_problem, params, U0, x0, ts[k], U_star, nls, lss,
                        profile=prof)
                else:
                    U, xi_solved = fe_newton_solve_ad(
                        fe_problem, params, U0, x0, ts[k], nls, lss,
                        profile=prof)
                xi = {**x0, **xi_solved}
                j = contribution(params, U, U0, xi, x0, ts[k], ts[k - 1])
            outs = [U, *(xi[b] for b in blocks)]
            cots = [cot_U, *(cot_xi[b] for b in blocks)]
            if j.requires_grad:
                outs.append(j)
                cots.append(torch.ones_like(j))
            wrt = [p, U0, *(x0[b] for b in blocks)]
            got = torch.autograd.grad(outs, wrt, cots, allow_unused=True)
            got = [torch.zeros_like(w) if g is None else g
                   for w, g in zip(wrt, got, strict=True)]
            grad += got[0].detach().cpu().numpy().astype(np.float64)
            cot_U = got[1].detach()
            cot_xi = {b: g.detach() for b, g in zip(blocks, got[2:],
                                                    strict=True)}
            if stats is not None:
                _sync(dev)
                wall = time.perf_counter() - t0
                stats.setdefault("reverse", []).append(
                    {"wall_s": wall, "assembly_s": prof.get("assembly_s", 0.0),
                     "solve_s": prof.get("solve_s", 0.0),
                     "cg_iters": prof.get("cg_iters", []),
                     "rest_s": wall - prof.get("assembly_s", 0.0)
                     - prof.get("solve_s", 0.0)})
        return J, grad

    return value_and_grad


def _grad_or_zeros(outs, wrt, cots, **kwargs) -> list[Tensor]:
    """``torch.autograd.grad`` over the pairs whose output requires grad,
    with zeros where an input is unused."""
    pairs = [(o, c) for o, c in zip(outs, cots, strict=True)
             if o.requires_grad and c is not None]
    if not pairs:
        return [torch.zeros_like(w) for w in wrt]
    got = torch.autograd.grad([o for o, _ in pairs], wrt,
                              [c for _, c in pairs], allow_unused=True,
                              **kwargs)
    return [torch.zeros_like(w) if g is None else g
            for w, g in zip(wrt, got, strict=True)]


def _dot(a: Sequence[Tensor], b: Sequence[Tensor]) -> Tensor:
    return sum((x * y).sum() for x, y in zip(a, b, strict=True))


def build_fe_stepped_hvp(
        fe_problem: FEProblem,
        params_by_block_of_flat: Callable[[Tensor], Mapping[str, dict]],
        qoi,
        nonlinear_solver_settings: dict[str, Any] | None = None,
        linear_solver_settings: dict[str, Any] | None = None):
    """Hessian-vector products of the stepped objective, a step at a time
    (the JAX package's ``build_fe_stepped_hvp``, there forward-over-
    reverse; here reverse-over-reverse, the same ``H v``).

    - **primal sweep**, once for every direction: each step's Newton under
      ``torch.no_grad()`` and J, the converged ``(U_k, xi_k)`` stored;
    - **tangent sweep**: per step, the step map through its stored
      solution (:class:`FeSolutionAt`), its vector-Jacobian product with
      a cotangent ``u`` built with ``create_graph``, and the tangent
      ``(U_dot_k, xi_dot_k, j_dot_k)`` as the derivative of that product
      in ``u`` along ``(v, U_dot_{k-1}, xi_dot_{k-1})`` (one such
      derivative per direction, on one graph);
    - **reverse sweep**, from the last step: the step map re-solved
      (:class:`FeNewtonSolve`), ``g = d(c . f_k)/d(p, U_{k-1}, xi_{k-1})``
      with ``create_graph`` for the carried cotangent ``c`` (the
      gradient's), then per direction the derivative of ``g . (v, U_dot,
      xi_dot) + c_dot . f_k``: its parameter part adds up to ``H v``, the
      rest is the next ``c_dot``.

    Returns ``hvp(params_flat, state_init, t_schedule, v, stats=None) ->
    (float J, np.ndarray grad, np.ndarray Hv)``; ``v`` may be an
    ``(n, m)`` matrix of ``m`` directions, and ``Hv`` is then ``(n, m)``.
    ``hvp._with_jdot`` returns ``((J, grad, Hv), J_dot)`` with ``J_dot``
    the tangent sweep's directional derivative of J (one per direction),
    which equals ``grad . v``. ``stats``, when a dict, receives
    ``forward``, ``tangent`` and ``reverse`` lists with one entry per step
    (synchronized host seconds; the forward's and the re-solves' Newton
    and CG counts)."""
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    fe_arrays = fe_problem.kernel_arrays
    dev, dtype = fe_problem.device, fe_problem.dtype
    blocks = list(fe_problem.evaluators_by_block)

    def step_outputs(p, U0, x0, t, t_prev, U_star=None, profile=None):
        """``[U, *xi, j]`` of the step from ``(U0, x0)`` at parameters
        ``p``: through the stored solution when ``U_star`` is given,
        else re-solved."""
        params = params_by_block_of_flat(p)
        if U_star is None:
            U, xi_solved = fe_newton_solve_ad(fe_problem, params, U0, x0, t,
                                              nls, lss, profile=profile)
        else:
            U, xi_solved = fe_solution_at(fe_problem, params, U0, x0, t,
                                          U_star, nls, lss, profile=profile)
        xi = {**x0, **xi_solved}
        j = (U.new_zeros(()) if qoi is None else
             qoi.step_contribution(params, fe_arrays)(U, U0, xi, x0, t,
                                                      t_prev))
        return [U, *(xi[b] for b in blocks), j]

    def leaves(p, U0, x0):
        return ([p.detach().requires_grad_(True),
                 U0.detach().requires_grad_(True)]
                + [x0[b].detach().requires_grad_(True) for b in blocks])

    def clock(stats):
        if stats is not None:
            _sync(dev)
        return time.perf_counter()

    def hvp_with_jdot(params_flat, state_init, t_schedule: Sequence[float],
                      v, stats: dict | None = None):
        ts = [float(t) for t in t_schedule]
        params_flat = torch.as_tensor(params_flat, dtype=dtype, device=dev)
        V = torch.as_tensor(v, dtype=dtype, device=dev)
        single = V.dim() == 1
        V = V.reshape(params_flat.shape[0], -1)
        m = V.shape[1]
        U_prev = torch.as_tensor(state_init[0], dtype=dtype, device=dev)
        xi_prev = pack_xi_by_block(
            fe_problem, {b: torch.as_tensor(x, dtype=dtype, device=dev)
                         for b, x in state_init[1].items()}, layout="aos")

        # primal sweep, once for every direction
        states = [(U_prev, xi_prev)]
        J = 0.0
        with torch.no_grad():
            params = params_by_block_of_flat(params_flat)
            for k in range(1, len(ts)):
                step_stats: dict = {}
                t0 = clock(stats)
                U, xi_solved = _fe_newton_primal(
                    fe_problem, fe_arrays, params, U_prev, xi_prev, ts[k],
                    nls, lss, step_stats)
                xi = {**xi_prev, **xi_solved}
                if qoi is not None:
                    J += float(qoi.step_contribution(params, fe_arrays)(
                        U, U_prev, xi, xi_prev, ts[k], ts[k - 1]))
                if stats is not None:
                    stats.setdefault("forward", []).append(
                        {**step_stats, "wall_s": clock(stats) - t0})
                U_prev, xi_prev = U, xi
                states.append((U, xi))

        # tangent sweep: (U_dot_k, xi_dot_k) per direction
        zero_state = [torch.zeros_like(states[0][0])] + [
            torch.zeros_like(states[0][1][b]) for b in blocks]
        tangents = [[list(zero_state) for _ in range(m)]]
        J_dot = np.zeros(m)
        for k in range(1, len(ts)):
            t0 = clock(stats)
            (U0, x0), (U_star, _) = states[k - 1], states[k]
            wrt = leaves(params_flat, U0, x0)
            with torch.enable_grad():
                outs = step_outputs(wrt[0], wrt[1],
                                    dict(zip(blocks, wrt[2:], strict=True)),
                                    ts[k], ts[k - 1], U_star=U_star)
                us = [torch.zeros_like(o, requires_grad=True) for o in outs]
                g = _grad_or_zeros(outs, wrt, us, create_graph=True)
                step_tangents = []
                for c in range(m):
                    s = _dot(g, [V[:, c], *tangents[k - 1][c]])
                    d = (_grad_or_zeros([s], us, [torch.ones_like(s)],
                                        retain_graph=True)
                         if s.requires_grad
                         else [torch.zeros_like(u) for u in us])
                    J_dot[c] += float(d[-1])
                    step_tangents.append([x.detach() for x in d[:-1]])
            tangents.append(step_tangents)
            del g, outs, us
            if stats is not None:
                stats.setdefault("tangent", []).append(
                    {"wall_s": clock(stats) - t0})

        # reverse sweep
        grad = np.zeros(params_flat.shape[0], dtype=np.float64)
        hv = np.zeros((params_flat.shape[0], m), dtype=np.float64)
        cot = [torch.zeros_like(z) for z in zero_state]
        cot_dot = [[torch.zeros_like(z) for z in zero_state]
                   for _ in range(m)]
        for k in range(len(ts) - 1, 0, -1):
            prof = {} if stats is not None else None
            t0 = clock(stats)
            U0, x0 = states[k - 1]
            wrt = leaves(params_flat, U0, x0)
            with torch.enable_grad():
                outs = step_outputs(wrt[0], wrt[1],
                                    dict(zip(blocks, wrt[2:], strict=True)),
                                    ts[k], ts[k - 1], profile=prof)
                g = _grad_or_zeros(outs, wrt, [*cot, torch.ones_like(
                    outs[-1])], create_graph=True)
                for c in range(m):
                    s = _dot(g, [V[:, c], *tangents[k - 1][c]]) \
                        + _dot(outs[:-1], cot_dot[c])
                    d = (_grad_or_zeros([s], wrt, [torch.ones_like(s)],
                                        retain_graph=True)
                         if s.requires_grad
                         else [torch.zeros_like(w) for w in wrt])
                    hv[:, c] += d[0].detach().cpu().numpy().astype(
                        np.float64)
                    cot_dot[c] = [x.detach() for x in d[1:]]
            grad += g[0].detach().cpu().numpy().astype(np.float64)
            cot = [x.detach() for x in g[1:]]
            del g, outs
            if stats is not None:
                wall = clock(stats) - t0
                stats.setdefault("reverse", []).append(
                    {"wall_s": wall,
                     "newton_iters": prof.get("newton_iters", 0),
                     "newton_cg_iters": prof.get("newton_cg_iters", []),
                     "assembly_s": prof.get("assembly_s", 0.0),
                     "solve_s": prof.get("solve_s", 0.0),
                     "cg_iters": prof.get("cg_iters", [])})
        if single:
            return (J, grad, hv[:, 0]), float(J_dot[0])
        return (J, grad, hv), J_dot

    def hvp(params_flat, state_init, t_schedule, v, stats=None):
        (J, grad, hv), _ = hvp_with_jdot(params_flat, state_init,
                                         t_schedule, v, stats)
        return J, grad, hv

    hvp._with_jdot = hvp_with_jdot  # the consistency hook
    return hvp


def build_fe_stepped_hessian(
        fe_problem: FEProblem,
        params_by_block_of_flat: Callable[[Tensor], Mapping[str, dict]],
        qoi,
        nonlinear_solver_settings: dict[str, Any] | None = None,
        linear_solver_settings: dict[str, Any] | None = None):
    """The full ``(n_active, n_active)`` Hessian as the stepped HVP of
    every unit direction at once (one primal sweep, one tangent and one
    reverse sweep carrying ``n_active`` directions), symmetrized; the
    largest entry of ``|H - H^T|`` is returned beside it, a cheap check.

    Returns ``hessian(params_flat, state_init, t_schedule, stats=None) ->
    (np.ndarray H, float max_asym)``; ``hessian.with_gradient`` returns
    ``(J, grad, H, max_asym)``."""
    hvp = build_fe_stepped_hvp(
        fe_problem, params_by_block_of_flat, qoi,
        nonlinear_solver_settings=nonlinear_solver_settings,
        linear_solver_settings=linear_solver_settings)

    def with_gradient(params_flat, state_init, t_schedule, stats=None):
        n = int(torch.as_tensor(params_flat).shape[0])
        J, grad, H = hvp(params_flat, state_init, t_schedule, np.eye(n),
                         stats)
        H = np.asarray(H).reshape(n, n)
        max_asym = float(np.max(np.abs(H - H.T))) if n else 0.0
        return J, grad, 0.5 * (H + H.T), max_asym

    def hessian(params_flat, state_init, t_schedule, stats=None):
        _J, _g, H, max_asym = with_gradient(params_flat, state_init,
                                            t_schedule, stats)
        return H, max_asym

    hessian.with_gradient = with_gradient
    return hessian
