"""The material-point deck commands: ``primal``, ``objective``,
``gradient``, ``hessian`` and ``calibrate``.

Port of the MP arms of ``cmad_tpu/cli/{primal,objective,gradient,
hessian,calibrate}.py`` (parity: reference
``cmad/cli/{primal,objective,gradient,hessian,calibrate}.py``). Each
``run_*_mp`` takes a deck path (read with PyYAML and validated with
jsonschema) or the deck as a dict (neither needed), with ``out_dir`` in
place of the deck's ``output.path`` when given, builds the problem on
``device`` (the card unless the caller asks for the CPU), computes, and
writes what the JAX package's command writes.

The primal pass (:func:`run_primal_pass`) is a Python loop over the
steps with the deck's Newton settings (``make_newton_solve_with_stats``,
each step's iterations and final residual into ``solver.json``), where
the JAX package scanned the steps in one ``lax.scan``; it reads the
trajectory back to the host once, after the last step. The sensitivity
commands go through ``cli/sensitivity.py``.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cmad_tpu_torch import config
from cmad_tpu_torch.cli.calibrate import (
    active_param_paths,
    optimize_status,
    resolve_initial_guess,
)
from cmad_tpu_torch.cli.common import (
    Deck,
    MPProblem,
    build_mp_problem,
    resolve_output,
    with_out_dir,
)
from cmad_tpu_torch.cli.sensitivity import build_sensitivity_driver
from cmad_tpu_torch.io.writers import (
    write_cauchy,
    write_grad,
    write_hessian,
    write_J,
    write_opt_history,
    write_opt_params,
    write_opt_status,
    write_resolved_deck,
    write_solver_log,
    write_xi,
)
from cmad_tpu_torch.models.nonlinear_solver import (
    make_newton_solve_with_stats,
)
from cmad_tpu_torch.objectives.mp_objective import MPDrive, to_host


def _problem(deck: Deck, subcommand: str, out_dir, dtype,
             device) -> MPProblem:
    return build_mp_problem(with_out_dir(deck, out_dir), subcommand,
                            dtype=dtype, device=device)


def run_primal_pass(model, F: np.ndarray, newton_kwargs: dict[str, Any],
                    qoi=None, cuda_graphs: bool = True):
    """One forward pass; returns (cauchy, xi_trajectory, solver_log, J).

    ``cauchy``: (3, 3, N+1), zero at step 0; ``xi_trajectory``: (N+1,
    num_dofs); ``solver_log``: per-step {iters, final_residual}; ``J``
    accumulates the QoI when one is supplied (``cmad objective``). On the
    card the Newton replays CUDA graphs unless ``cuda_graphs`` is False
    (the same bits, eager).
    """
    p = model.parameters
    abs_tol, rel_tol = config.clamp_newton_tols(
        float(newton_kwargs["abs_tol"]), float(newton_kwargs["rel_tol"]),
        "mp_local", p.dtype)
    solve = make_newton_solve_with_stats(
        model.residual_fun,
        max_iters=int(newton_kwargs["max_iters"]),
        abs_tol=abs_tol, rel_tol=rel_tol, cuda_graphs=cuda_graphs)
    params = p.values
    drive = MPDrive(F, p.dtype, p.device)

    xi = model.init_xi(p.dtype, p.device)
    xis = [xi]
    sigmas = [torch.zeros((3, 3), dtype=p.dtype, device=p.device)]
    iters, norms = [xi.new_zeros(0)], [xi.new_zeros(0)]
    J = torch.zeros((), dtype=p.dtype, device=p.device)
    with torch.no_grad():
        for step in range(1, drive.num_steps + 1):
            U, U_prev = drive.U(step), drive.U(step - 1)
            xi_prev = xi
            xi, it, res = solve(xi_prev, xi_prev, params, U, U_prev)
            sigmas.append(model.cauchy_fun(xi, xi_prev, params, U, U_prev))
            if qoi is not None:
                J = J + qoi.qoi_fun(xi, xi_prev, params, U, U_prev,
                                    qoi.data_at_step(step),
                                    qoi.weight_at_step(step))
            xis.append(xi)
            iters.append(it.to(p.dtype)[None])
            norms.append(res[None])
        xi_traj, sigma, its, norm, J_h = to_host(
            torch.stack(xis), torch.stack(sigmas, dim=-1), torch.cat(iters),
            torch.cat(norms), J)
    solver_log = [{"iters": int(i), "final_residual": float(r)}
                  for i, r in zip(its, norm, strict=True)]
    return sigma, xi_traj, solver_log, float(J_h)


def _write_trajectory(problem: MPProblem, cauchy, xi_traj, solver_log
                      ) -> tuple:
    out, prefix, fmt = resolve_output(problem.resolved)
    write_cauchy(out, prefix, cauchy, fmt)
    write_xi(out, prefix, xi_traj, problem.model.layout, fmt)
    write_solver_log(out, prefix, solver_log)
    write_resolved_deck(out, prefix, problem.resolved)
    return out, prefix


def run_primal_mp(deck: Deck, out_dir=None, *,
                  dtype: torch.dtype = config.DEFAULT_DTYPE,
                  device=config.DEFAULT_DEVICE) -> int:
    """``cmad primal``: ``cauchy``, ``xi`` (and its per-variable
    files), ``solver.json`` and ``deck.resolved.yaml``, when the deck has
    an ``output`` section."""
    from cmad_tpu_torch.util.profiling import maybe_trace

    problem = _problem(deck, "primal", out_dir, dtype, device)
    with maybe_trace(problem.resolved):
        cauchy, xi_traj, solver_log, _J = run_primal_pass(
            problem.model, problem.F, problem.resolved["solver"]["newton"])
    if "output" in problem.resolved:
        _write_trajectory(problem, cauchy, xi_traj, solver_log)
    return 0


def run_objective_mp(deck: Deck, out_dir=None, *,
                     dtype: torch.dtype = config.DEFAULT_DTYPE,
                     device=config.DEFAULT_DEVICE) -> int:
    """``cmad objective``: the primal's files and ``J.json``."""
    problem = _problem(deck, "objective", out_dir, dtype, device)
    cauchy, xi_traj, solver_log, J = run_primal_pass(
        problem.model, problem.F, problem.resolved["solver"]["newton"],
        qoi=problem.qoi)
    out, prefix = _write_trajectory(problem, cauchy, xi_traj, solver_log)
    write_J(out, prefix, J)
    return 0


def sensitivity_driver(problem: MPProblem, subcommand: str):
    """The deck's sensitivity driver for ``subcommand`` and the canonical
    active parameters it starts from."""
    driver = build_sensitivity_driver(
        problem.resolved["sensitivity"], problem.qoi, problem.F,
        problem.resolved["solver"]["newton"], subcommand=subcommand)
    return driver, problem.parameters.flat_active_values(
        return_canonical=True)


def run_gradient_mp(deck: Deck, out_dir=None, *,
                    dtype: torch.dtype = config.DEFAULT_DTYPE,
                    device=config.DEFAULT_DEVICE) -> int:
    """``cmad gradient``: ``J.json``, ``grad`` and
    ``deck.resolved.yaml``."""
    problem = _problem(deck, "gradient", out_dir, dtype, device)
    driver, x = sensitivity_driver(problem, "gradient")
    result = driver.evaluate_grad(x)
    out, prefix, fmt = resolve_output(problem.resolved)
    write_resolved_deck(out, prefix, problem.resolved)
    write_J(out, prefix, result.J)
    write_grad(out, prefix, result.grad, fmt)
    return 0


def run_hessian_mp(deck: Deck, out_dir=None, *,
                   dtype: torch.dtype = config.DEFAULT_DTYPE,
                   device=config.DEFAULT_DEVICE) -> int:
    """``cmad hessian`` (``direct_adjoint`` or ``jvp``): ``J.json``,
    ``grad``, ``hess`` and ``deck.resolved.yaml``."""
    problem = _problem(deck, "hessian", out_dir, dtype, device)
    driver, x = sensitivity_driver(problem, "hessian")
    result = driver.evaluate_hess(x)
    out, prefix, fmt = resolve_output(problem.resolved)
    write_resolved_deck(out, prefix, problem.resolved)
    write_J(out, prefix, result.J)
    write_grad(out, prefix, result.grad, fmt)
    write_hessian(out, prefix, result.hessian, fmt)
    return 0


def run_calibrate_mp(deck: Deck, out_dir=None, *,
                     dtype: torch.dtype = config.DEFAULT_DTYPE,
                     device=config.DEFAULT_DEVICE) -> int:
    """``cmad calibrate``: scipy's minimize over the canonical active
    parameters with the deck's first-order strategy;
    ``opt_history.json``, ``opt_params.yaml``, ``opt_status.json`` and
    ``deck.resolved.yaml``."""
    from scipy.optimize import minimize

    problem = _problem(deck, "calibrate", out_dir, dtype, device)
    parameters = problem.parameters
    driver, x_deck = sensitivity_driver(problem, "calibrate")

    optimizer = problem.resolved["optimizer"]
    x0 = resolve_initial_guess(optimizer["initial_guess"], x_deck)
    log_params = optimizer["log_params"]

    history: list[dict[str, Any]] = []

    def fun(x):
        r = driver.evaluate_grad(x)
        entry: dict[str, Any] = {
            "J": float(r.J),
            "grad_norm": float(np.linalg.norm(r.grad)),
        }
        if log_params:
            entry["params"] = parameters.flat_active_values(
                return_canonical=False).tolist()
        history.append(entry)
        return r.J, r.grad

    result = minimize(
        fun, x0, jac=True,
        method=optimizer["algorithm"],
        bounds=[tuple(b) for b in parameters.opt_bounds],
        options=optimizer["options"])

    parameters.set_active_values_from_flat(result.x, are_canonical=True)

    out, prefix, _fmt = resolve_output(problem.resolved)
    write_resolved_deck(out, prefix, problem.resolved)
    write_opt_history(
        out, prefix, history,
        active_param_paths(parameters) if log_params else None)
    write_opt_params(out, prefix, problem.resolved["parameters"],
                     parameters.values)
    write_opt_status(out, prefix, optimize_status(result))
    return 0
