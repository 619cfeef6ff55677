"""The FE deck commands: ``primal``, ``objective``, ``gradient``,
``hessian`` and ``calibrate``.

Port of ``cmad_tpu/cli/fe_subcommands.py`` (parity: reference
``cmad/cli/{primal,objective,gradient,hessian,calibrate}.py``, FE
branches). Each ``run_*_fe`` takes a deck path (read with PyYAML and
validated with jsonschema) or the deck as a dict (neither needed), with
``out_dir`` in place of the deck's ``output.path`` when given, builds the
problem on ``device`` (the card unless the caller asks for the CPU),
computes, and writes what the JAX package's command writes.

The driver is the deck's ``global residual.driver``:

- ``scan`` (the default): the trajectory with the FE Newton's rule on
  the autograd tape (``fem/driver.py``); the gradient is
  ``torch.autograd.grad`` of J and the Hessian its double backward. Its
  primal and objective need no tape and run the per-step drive, which
  gives the trajectory's bits;
- ``stepped``: the per-step drive, the stepped adjoint and the stepped
  Hessian (``fem/stepped_adjoint.py``);
- ``host`` is not ported (ROADMAP queue 1, item 18, its remainder); the
  sensitivity commands reject it as the JAX package does.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch import config
from cmad_tpu_torch.cli.calibrate import (
    active_param_paths,
    optimize_status,
    resolve_initial_guess,
)
from cmad_tpu_torch.cli.common import Deck, resolve_output, with_out_dir
from cmad_tpu_torch.cli.fe_common import (
    FEProblemBundle,
    build_fe_cases,
    build_fe_J_of_params_flat,
    build_fe_problem_from_deck,
    build_fe_stepped_hessian_fn,
    build_fe_stepped_vg,
    fe_driver,
    fe_primal_drive,
    nonlinear_settings,
)
from cmad_tpu_torch.io.fe_writers import (
    resolve_fe_output_plan,
    write_fe_active_params,
    write_fe_exodus,
    write_fe_opt_params,
)
from cmad_tpu_torch.io.writers import (
    write_grad,
    write_hessian,
    write_J,
    write_opt_history,
    write_opt_status,
    write_resolved_deck,
    write_solver_log,
)


def _bundle(deck: Deck, subcommand: str, out_dir, dtype,
            device) -> FEProblemBundle:
    return build_fe_problem_from_deck(with_out_dir(deck, out_dir),
                                      subcommand, dtype=dtype,
                                      device=device)


def _resolve_restart(bundle: FEProblemBundle):
    """(t_schedule, U_init, xi_init_by_block) honoring a top-level
    ``restart: {file: ...}`` section: the schedule keeps its t0-anchored
    shape but resumes at the checkpoint time, dropping already-solved
    steps."""
    schedule = bundle.t_schedule.tolist()
    if "restart" not in bundle.resolved:
        return schedule, None, None
    from cmad_tpu_torch.io.restart import (
        check_restart_compatible,
        read_restart,
    )

    U0, xi0, t0 = read_restart(Path(bundle.resolved["restart"]["file"]))
    check_restart_compatible(bundle.fe_problem, U0, xi0)
    eps = 1e-12 * max(1.0, abs(schedule[-1]))
    remaining = [t for t in schedule if t > t0 + eps]
    if not remaining:
        raise ValueError(
            f"restart checkpoint is at t = {t0}, at or beyond the "
            f"deck's final step time {schedule[-1]} — nothing to solve")
    return [t0, *remaining], U0, xi0


def accumulate_qoi_over_history(bundle: FEProblemBundle, state, qoi,
                                t_schedule=None) -> float:
    """The sum of the QoI's step contributions over a recorded
    trajectory (``t_schedule``: the bundle's by default)."""
    if qoi is None:
        return 0.0
    from cmad_tpu_torch.fem.assembly import params_by_block_from_models
    from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block

    fe = bundle.fe_problem
    closure = qoi.step_contribution(params_by_block_from_models(fe),
                                    fe.kernel_arrays)
    ts = [float(t) for t in (bundle.t_schedule if t_schedule is None
                             else t_schedule)]

    def at(k):
        U = torch.as_tensor(state.U_at(k), dtype=fe.dtype, device=fe.device)
        xi = pack_xi_by_block(fe, {b: torch.as_tensor(
            state.xi_at(k, b), dtype=fe.dtype, device=fe.device)
            for b in fe.models_by_block}, layout="aos")
        return U, xi

    J = 0.0
    with torch.no_grad():
        U_prev, xi_prev = at(0)
        for k in range(1, len(ts)):
            U, xi = at(k)
            J += float(closure(U, U_prev, xi, xi_prev, ts[k], ts[k - 1]))
            U_prev, xi_prev = U, xi
    return J


def run_primal_fe(deck: Deck, out_dir=None, *,
                  dtype: torch.dtype = config.DEFAULT_DTYPE,
                  device=config.DEFAULT_DEVICE) -> int:
    """``cmad primal``: the drive, then ``solver.json``, the Exodus
    trajectory, ``restart.npz`` when asked, ``deck.resolved.yaml``, and
    ``J.json`` when the deck has a QoI, or the QoI's own file for one
    that writes a primal output (``fe_load_match`` with an
    ``output_file``)."""
    from cmad_tpu_torch.util.profiling import maybe_trace

    bundle = _bundle(deck, "primal", out_dir, dtype, device)
    qoi = bundle.qoi
    write_qoi = qoi if qoi is not None and qoi.produces_primal_output() \
        else None
    t_schedule, U_init, xi_init = _resolve_restart(bundle)
    with maybe_trace(bundle.resolved):
        state, solver_log = fe_primal_drive(bundle, None, t_schedule,
                                            U_init, xi_init)
        J = accumulate_qoi_over_history(
            bundle, state, None if write_qoi is not None else qoi,
            t_schedule)

    if "output" not in bundle.resolved:
        return 0
    out, prefix, _fmt = resolve_output(bundle.resolved)
    write_solver_log(out, prefix, solver_log)
    output = bundle.resolved["output"]
    if output.get("write restart", False):
        from cmad_tpu_torch.io.restart import write_restart

        last = len(t_schedule) - 1
        write_restart(out / f"{prefix}restart.npz", state.U_at(last),
                      {b: state.xi_at(last, b)
                       for b in bundle.fe_problem.models_by_block},
                      t_schedule[-1])
    if output.get("write exodus", True):
        plan = resolve_fe_output_plan(output, bundle.fe_problem)
        if "exodus filename" not in output:
            name = bundle.resolved["problem"].get("name") or (
                "fe" if isinstance(deck, dict) else Path(deck).stem)
            output["exodus filename"] = f"{name}.exo"
        write_fe_exodus(out, prefix, bundle.fe_problem, state, plan,
                        output["exodus filename"])
    write_resolved_deck(out, prefix, bundle.resolved)
    if write_qoi is not None:
        write_qoi.write_primal_outputs(bundle.fe_problem, state)
    elif qoi is not None:
        write_J(out, prefix, float(J))
    return 0


def fe_objective(bundle: FEProblemBundle) -> float:
    """J of the deck: each load case driven by :func:`fe_primal_drive`
    over its own schedule, its QoI summed over the recorded history, and
    the cases' weighted sum."""
    J = 0.0
    for _name, w, ts_case, qoi_c in build_fe_cases(bundle):
        state, _ = fe_primal_drive(bundle, t_schedule=ts_case)
        J += w * accumulate_qoi_over_history(bundle, state, qoi_c, ts_case)
    return J


def run_objective_fe(deck: Deck, out_dir=None, *,
                     dtype: torch.dtype = config.DEFAULT_DTYPE,
                     device=config.DEFAULT_DEVICE) -> int:
    """``cmad objective``: ``J.json`` and ``deck.resolved.yaml``."""
    bundle = _bundle(deck, "objective", out_dir, dtype, device)
    J = fe_objective(bundle)
    out, prefix, _fmt = resolve_output(bundle.resolved)
    write_resolved_deck(out, prefix, bundle.resolved)
    write_J(out, prefix, J)
    return 0


def _require_sensitivity_driver(bundle: FEProblemBundle,
                                subcommand: str) -> str:
    """The sensitivity commands run the scan and stepped drivers only;
    ``host`` is primal-only, as in the JAX package."""
    driver = bundle.resolved["residuals"]["global residual"].get(
        "driver", "scan")
    if driver not in ("scan", "stepped"):
        raise ValueError(
            f"residuals.global residual: driver {driver!r} is not "
            f"available for the {subcommand} subcommand — FE "
            "sensitivities run through the scan trajectory ('scan', the "
            "default) or the per-step checkpointed adjoint ('stepped'); "
            "the host driver is primal-only")
    return driver


def fe_value_and_grad(bundle: FEProblemBundle,
                      subcommand: str = "gradient"):
    """``(params_flat_init, vg)`` with ``vg(params_flat) -> (J, grad)``
    through the deck's driver (numpy gradient)."""
    if _require_sensitivity_driver(bundle, subcommand) == "stepped":
        params_flat, state_init, ts, vg_stepped = build_fe_stepped_vg(bundle)

        def vg(x):
            return vg_stepped(x, state_init, ts)

        return params_flat, vg
    params_flat, state_init, J_of = build_fe_J_of_params_flat(bundle)

    def vg(x):
        p = torch.as_tensor(x, dtype=params_flat.dtype,
                            device=params_flat.device).detach().clone()
        p.requires_grad_(True)
        J = J_of(p, state_init)
        (g,) = torch.autograd.grad(J, p)
        return float(J.detach()), g.detach().cpu().numpy().astype(np.float64)

    return params_flat, vg


def fe_hessian(bundle: FEProblemBundle, stats: dict | None = None):
    """``(H, max_asym)`` at the deck's parameters through its driver: the
    stepped Hessian (``stats`` receives its sweeps), or the scan
    trajectory's double backward (one gradient graph, a backward of each
    of its entries)."""
    if _require_sensitivity_driver(bundle, "hessian") == "stepped":
        params_flat, state_init, ts, hessian_fn = \
            build_fe_stepped_hessian_fn(bundle)
        return hessian_fn(params_flat, state_init, ts, stats)
    params_flat, state_init, J_of = build_fe_J_of_params_flat(bundle)
    p = params_flat.detach().clone().requires_grad_(True)
    J = J_of(p, state_init)
    (g,) = torch.autograd.grad(J, p, create_graph=True)
    n = int(p.shape[0])
    cols = [torch.autograd.grad(g[j], p, retain_graph=j < n - 1,
                                allow_unused=True)[0] for j in range(n)]
    H = np.stack([np.zeros(n) if c is None else
                  c.detach().cpu().numpy().astype(np.float64)
                  for c in cols], axis=1) if n else np.zeros((0, 0))
    max_asym = float(np.max(np.abs(H - H.T))) if n else 0.0
    return 0.5 * (H + H.T), max_asym


def run_gradient_fe(deck: Deck, out_dir=None, *,
                    dtype: torch.dtype = config.DEFAULT_DTYPE,
                    device=config.DEFAULT_DEVICE) -> int:
    """``cmad gradient``: ``grad`` and ``deck.resolved.yaml``."""
    bundle = _bundle(deck, "gradient", out_dir, dtype, device)
    params_flat, vg = fe_value_and_grad(bundle)
    _J, grad = vg(params_flat)
    out, prefix, fmt = resolve_output(bundle.resolved)
    write_resolved_deck(out, prefix, bundle.resolved)
    write_grad(out, prefix, grad, fmt)
    return 0


def run_hessian_fe(deck: Deck, out_dir=None, *,
                   dtype: torch.dtype = config.DEFAULT_DTYPE,
                   device=config.DEFAULT_DEVICE,
                   stats: dict | None = None) -> int:
    """``cmad hessian``: ``hess`` and ``deck.resolved.yaml``. ``stats``
    receives the stepped Hessian's per-step sweeps
    (``fem/stepped_adjoint.py build_fe_stepped_hvp``)."""
    bundle = _bundle(deck, "hessian", out_dir, dtype, device)
    hess, _max_asym = fe_hessian(bundle, stats)
    out, prefix, fmt = resolve_output(bundle.resolved)
    write_resolved_deck(out, prefix, bundle.resolved)
    write_hessian(out, prefix, np.asarray(hess), fmt)
    return 0


def run_calibrate_fe(deck: Deck, out_dir=None, *,
                     dtype: torch.dtype = config.DEFAULT_DTYPE,
                     device=config.DEFAULT_DEVICE) -> int:
    """``cmad calibrate``: scipy's minimize over the canonical active
    parameters with the deck's driver's gradient; ``opt_history.json``,
    ``opt_params.yaml``, ``active_params.json``, ``opt_status.json`` and
    ``deck.resolved.yaml``."""
    from scipy.optimize import minimize

    bundle = _bundle(deck, "calibrate", out_dir, dtype, device)
    params_flat, vg = fe_value_and_grad(bundle, "calibrate")
    models = bundle.fe_problem.models_by_block
    optimizer = bundle.resolved["optimizer"]
    log_params = optimizer["log_params"]

    def set_block_params(x):
        offset = 0
        for model in models.values():
            n = model.parameters.num_active_params
            model.parameters.set_active_values_from_flat(
                x[offset:offset + n], are_canonical=True)
            offset += n

    history: list[dict[str, Any]] = []

    def fun(x):
        J, g = vg(x)
        g = np.asarray(g, dtype=np.float64)
        entry: dict[str, Any] = {"J": float(J),
                                 "grad_norm": float(np.linalg.norm(g))}
        if log_params:
            set_block_params(x)
            entry["params"] = _active_values(models)
        history.append(entry)
        return float(J), g

    bounds_list = [b for m in models.values()
                   if m.parameters.num_active_params
                   for b in m.parameters.opt_bounds]
    result = minimize(
        fun,
        resolve_initial_guess(optimizer["initial_guess"],
                              params_flat.detach().cpu().numpy()
                              .astype(np.float64)),
        jac=True, method=optimizer["algorithm"],
        bounds=[tuple(b) for b in bounds_list] if bounds_list else None,
        options=optimizer["options"])
    set_block_params(result.x)

    out, prefix, _fmt = resolve_output(bundle.resolved)
    materials = bundle.resolved["residuals"]["local residual"]["materials"]
    write_resolved_deck(out, prefix, bundle.resolved)
    write_opt_history(out, prefix, history,
                      _active_paths(models) if log_params else None)
    write_fe_opt_params(out, prefix, materials,
                        {b: m.parameters.values for b, m in models.items()})
    write_fe_active_params(out, prefix, dict(zip(
        _active_paths(models), _active_values(models), strict=True)))
    write_opt_status(out, prefix, optimize_status(result))
    return 0


def _active_values(models) -> list[float]:
    return [float(v) for m in models.values()
            for v in m.parameters.flat_active_values()]


def _active_paths(models) -> list[str]:
    return [f"{block}.{p}" for block, m in models.items()
            for p in active_param_paths(m.parameters)]
