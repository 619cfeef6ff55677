"""Quasi-static time-loop drivers: the scan trajectory and the stepped
drive.

Port of ``cmad_tpu/fem/driver.py`` (parity: reference
``cmad/fem/driver.py``):

- :func:`build_fe_quasistatic_trajectory` is the JAX package's ``scan``
  driver, the deck's default: a loop over the steps with the FE Newton's
  implicit-function rule (:class:`FeNewtonSolve`) on the autograd tape and
  the QoI added up along it, so ``torch.autograd.grad`` of its J is the
  whole trajectory's gradient and a double backward its Hessian;
- :func:`fe_quasistatic_drive_stepped` runs the full FE Newton per step
  on the problem's device, then the TRUE embedded residual of the
  converged state and of the step's start (one residual assembly each),
  so an iteration-capped Newton cannot ship a silently wrong history: the
  pair goes into the solver log and a step far above its tolerances
  warns. It is also the scan driver's primal: without a tape, the
  trajectory runs the same Newton per step, so the JAX package's
  ``fe_quasistatic_drive`` and ``fe_history_solver_log`` (a recorded
  history's residual pairs, which its traced scan could not report) come
  out of this one loop with the same bits.

The per-IP state stays in the component-major carrier layout
(``fem/xi_carrier.py``) for the whole drive: packed once here, unpacked
to the AoS ``FEState`` view once per step.

``max_iters_per_dispatch`` and ``steps_per_dispatch``, which answer a
remote TPU link's per-execution ceiling and its dispatch latency (the
math is that of one step per dispatch), are accepted and logged as
no-ops. The host driver is not ported (ROADMAP queue 1, item 18).
"""
from __future__ import annotations

import logging
import time
import warnings
from collections.abc import Sequence

import numpy as np
import torch

from cmad_tpu_torch.fem.assembly import (
    assemble_global,
    params_by_block_from_models,
)
from cmad_tpu_torch.fem.fe_problem import FEProblem, FEState
from cmad_tpu_torch.fem.nonlinear_solver import (
    DEFAULT_LINEAR_SOLVER_SETTINGS,
    default_nonlinear_settings,
    fe_newton_solve,
    fe_newton_solve_ad,
)
from cmad_tpu_torch.fem.sparse_solve import (
    _embedded_bc_enforce,
    _embedded_residual,
)
from cmad_tpu_torch.fem.xi_carrier import (
    pack_xi_by_block,
    unpack_xi_by_block,
)

log = logging.getLogger(__name__)


def log_dispatch_knobs(logger, **knobs) -> None:
    """Log each TPU-link dispatch knob that is set as ignored: here every
    Newton iteration and every step is its own set of launches, so a
    window of steps or a cap on one program's iterations changes
    nothing."""
    for name, value in knobs.items():
        if value is not None:
            logger.info("%s=%s ignored: it batches or bounds device "
                        "programs on a remote TPU link; each step here is "
                        "its own set of launches, with the same math",
                        name, value)


def _residual_norm(fe_problem, params_by_block, U, U_prev, xi_prev,
                   t: float) -> float:
    """||r|| of the embedded residual at ``U`` for the step from
    ``(U_prev, xi_prev)`` to time ``t``."""
    fe_arrays = fe_problem.kernel_arrays
    presc_idx = fe_arrays.prescribed_indices
    pv = torch.as_tensor(
        fe_problem.dof_map.evaluate_prescribed_values(fe_arrays.dbc_arrays,
                                                      t),
        dtype=U.dtype, device=U.device)
    with torch.no_grad():
        K, R, _ = assemble_global(fe_problem, fe_arrays, params_by_block, U,
                                  U_prev, t, xi_prev_by_block=xi_prev)
        _, K_ii = _embedded_bc_enforce(K, presc_idx)
        r = _embedded_residual(R, K, U, presc_idx, pv, K_ii)
        return float(torch.linalg.norm(r))


def _check_step(nls, i: int, t: float, norm: float, norm0: float,
                what: str) -> None:
    """Warn when step ``i`` ended far above its Newton tolerances."""
    if (norm >= 100.0 * float(nls["abs tol"])
            and norm >= 100.0 * float(nls["rel tol"]) * norm0):
        warnings.warn(
            f"{what} at step {i} (t={t}) has ||R|| = {norm:.3e} (||R0|| = "
            f"{norm0:.3e}), far above abs tol {float(nls['abs tol']):.1e} / "
            f"rel {float(nls['rel tol']):.1e} — likely an iteration-cap "
            "exit; check the linear-solver configuration",
            RuntimeWarning, stacklevel=3)


def build_fe_quasistatic_trajectory(
        fe_problem: FEProblem,
        nonlinear_solver_settings: dict | None = None,
        linear_solver_settings: dict | None = None):
    """``trajectory(params_by_block, state_init, t_schedule,
    qoi_step_contribution=None) -> (U_steps, xi_steps_by_block, J)``.

    ``state_init`` is ``(U0, {block: xi0 (E, Q, n_xi)})``; the outputs are
    the converged ``U`` of every step after the first time (a list), each
    block's state per step in the carrier layout (``fem/xi_carrier.py``;
    :func:`~cmad_tpu_torch.fem.xi_carrier.unpack_xi_by_block` gives the AoS
    view) and J, the sum of ``qoi_step_contribution(U, U_prev, xi, xi_prev,
    t, t_prev)`` over the steps (a zero tensor without one). Each step is
    :func:`fe_newton_solve_ad`: differentiable in the parameter tensors of
    ``params_by_block`` and in ``state_init`` to any order when autograd
    records."""
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    dev, dtype = fe_problem.device, fe_problem.dtype

    def trajectory(params_by_block, state_init, t_schedule: Sequence[float],
                   qoi_step_contribution=None):
        ts = [float(t) for t in t_schedule]
        U = torch.as_tensor(state_init[0], dtype=dtype, device=dev)
        xi = pack_xi_by_block(
            fe_problem, {b: torch.as_tensor(v, dtype=dtype, device=dev)
                         for b, v in state_init[1].items()}, layout="aos")
        J = torch.zeros((), dtype=dtype, device=dev)
        U_steps: list = []
        xi_steps: dict[str, list] = {b: [] for b in xi}
        for k in range(1, len(ts)):
            if nls["print convergence"]:
                print(f"ON PRIMAL STEP ({k}) at t={ts[k]:.6e}")
            U_new, xi_solved = fe_newton_solve_ad(
                fe_problem, params_by_block, U, xi, ts[k], nls, lss)
            # only COUPLED blocks evolve; the rest echo forward
            xi_new = {**xi, **xi_solved}
            if qoi_step_contribution is not None:
                J = J + qoi_step_contribution(U_new, U, xi_new, xi, ts[k],
                                              ts[k - 1])
            U, xi = U_new, xi_new
            U_steps.append(U)
            for b, v in xi.items():
                xi_steps[b].append(v)
        return U_steps, xi_steps, J

    return trajectory


def fe_quasistatic_drive_stepped(fe_problem: FEProblem,
                                 t_schedule: Sequence[float],
                                 nonlinear_solver_settings: dict | None = None,
                                 linear_solver_settings: dict | None = None,
                                 U_init=None, xi_init_by_block=None,
                                 max_iters_per_dispatch: int | None = None,
                                 steps_per_dispatch: int | None = None,
                                 stats: list | None = None):
    """Stepped drive: one FE Newton per time step, then the step's true
    residual pair.

    Returns ``(FEState, solver_log)`` with per-step
    ``{"final_residual", "initial_residual"}`` entries. ``stats``, when
    given, receives one dict per step (``fem/nonlinear_solver.py``:
    Newton iterations, assemblies, CG iterations per solve; here also
    the two residual assemblies of the pair, and ``wall_s``, the step's
    host seconds up to its residual pair, which the host reads, so the
    device has finished the step).
    """
    if len(t_schedule) < 2:
        raise ValueError(
            f"t_schedule needs >= 2 entries; got {len(t_schedule)}")
    log_dispatch_knobs(log, max_iters_per_dispatch=max_iters_per_dispatch,
                       steps_per_dispatch=steps_per_dispatch)
    nls = {**default_nonlinear_settings(fe_problem.dtype),
           **(nonlinear_solver_settings or {})}
    lss = {**DEFAULT_LINEAR_SOLVER_SETTINGS,
           **(linear_solver_settings or {})}
    params = params_by_block_from_models(fe_problem)
    state = FEState.from_problem(fe_problem, t_init=float(t_schedule[0]),
                                 U_init=None if U_init is None
                                 else np.asarray(U_init),
                                 xi_init_by_block=xi_init_by_block)
    dev, dtype = fe_problem.device, fe_problem.dtype

    U = torch.as_tensor(state.U_at(0), dtype=dtype, device=dev)
    xi = pack_xi_by_block(
        fe_problem, {b: torch.as_tensor(state.xi_at(0, b), dtype=dtype,
                                        device=dev)
                     for b in fe_problem.models_by_block}, layout="aos")
    solver_log: list[dict[str, float]] = []
    for i, t in enumerate([float(x) for x in t_schedule[1:]], start=1):
        step_stats: dict = {}
        t_start = time.perf_counter()
        U_new, xi_solved = fe_newton_solve(
            fe_problem, params, U, xi, t, nls, lss, stats=step_stats)
        xi_new = {**xi, **xi_solved}
        norm = _residual_norm(fe_problem, params, U_new, U, xi, t)
        norm0 = _residual_norm(fe_problem, params, U, U, xi, t)
        step_stats["assemblies"] += 2
        step_stats["wall_s"] = time.perf_counter() - t_start
        U, xi = U_new, xi_new
        state.append(U.cpu().numpy(),
                     {b: v.cpu().numpy() for b, v in
                      unpack_xi_by_block(fe_problem, xi).items()}, t_new=t)
        solver_log.append({"final_residual": norm,
                           "initial_residual": norm0})
        if stats is not None:
            stats.append(step_stats)
        _check_step(nls, i, t, norm, norm0, "stepped FE Newton")
    return state, solver_log
