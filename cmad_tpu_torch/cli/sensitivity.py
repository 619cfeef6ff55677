"""Sensitivity-strategy dispatcher of ``gradient``, ``hessian`` and
``calibrate`` (material point).

Port of ``cmad_tpu/cli/sensitivity.py`` (parity: reference
``cmad/cli/sensitivity.py:35-180``): one ``evaluate_grad`` /
``evaluate_hess`` surface over the MPObjective family and the autograd
:class:`MPJVPObjective`, with the per-command strategy rules. The
``jvp`` strategy's Newton takes the deck's ``solver.newton`` settings,
raised to the f32 floor in float32 (``config.clamp_newton_tols``); the
objective family solves at ``make_newton_solve``'s defaults, as in the
JAX package.
"""
from __future__ import annotations

import sys
from typing import Any, Protocol

import numpy as np

from cmad_tpu_torch import config
from cmad_tpu_torch.models.nonlinear_solver import make_newton_solve
from cmad_tpu_torch.objectives.mp_jvp_objective import MPJVPObjective
from cmad_tpu_torch.objectives.mp_objective import (
    MPAdjointObjective,
    MPDirectAdjointObjective,
    MPDirectObjective,
    MPObjective,
)
from cmad_tpu_torch.typing import GradientResult, HessianResult


class SensitivityDriver(Protocol):
    def evaluate_grad(self, x) -> GradientResult: ...
    def evaluate_hess(self, x) -> HessianResult: ...


class _ObjectiveFamilyDriver:
    def __init__(self, objective: MPObjective) -> None:
        self._obj = objective

    def evaluate_grad(self, x) -> GradientResult:
        result = self._obj.evaluate(x)
        if isinstance(result, HessianResult):
            return GradientResult(J=result.J, grad=result.grad)
        return result

    def evaluate_hess(self, x) -> HessianResult:
        result = self._obj.evaluate(x)
        assert isinstance(result, HessianResult), (
            f"evaluate_hess on {type(self._obj).__name__}: factory should "
            f"have prevented this")
        return result


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy().astype(np.float64)


class _JVPDriver:
    def __init__(self, qoi, global_state,
                 newton_kwargs: dict[str, Any]) -> None:
        model = qoi.model()
        abs_tol, rel_tol = config.clamp_newton_tols(
            float(newton_kwargs["abs_tol"]),
            float(newton_kwargs["rel_tol"]), "mp_local",
            model.parameters.dtype)
        update_fun = make_newton_solve(
            model.residual_fun,
            max_iters=int(newton_kwargs["max_iters"]),
            abs_tol=abs_tol, rel_tol=rel_tol, cuda_graphs=True)
        self._obj = MPJVPObjective(qoi, global_state, update_fun)

    def evaluate_grad(self, x) -> GradientResult:
        J, grad = self._obj.evaluate_objective_and_grad(np.asarray(x))
        return GradientResult(J=float(J), grad=_numpy(grad))

    def evaluate_hess(self, x) -> HessianResult:
        J, grad = self._obj.evaluate_objective_and_grad(np.asarray(x))
        H = self._obj.evaluate_hessian(np.asarray(x))
        return HessianResult(J=float(J), grad=_numpy(grad),
                             hessian=_numpy(H))


def build_sensitivity_driver(
        sensitivity_section: dict[str, Any],
        qoi,
        global_state,
        newton_kwargs: dict[str, Any],
        subcommand: str) -> SensitivityDriver:
    stype = sensitivity_section["type"]

    if subcommand == "hessian" and stype in ("adjoint", "direct"):
        raise ValueError(
            f"sensitivity.type: 'cmad hessian' requires 'direct_adjoint' "
            f"or 'jvp'; got {stype!r}")
    if subcommand == "calibrate" and stype == "direct_adjoint":
        raise ValueError(
            f"sensitivity.type: 'cmad calibrate' accepts 'adjoint', "
            f"'direct', or 'jvp' (first-order only); got {stype!r}")
    if subcommand == "gradient" and stype == "direct_adjoint":
        print("warning: sensitivity.type=direct_adjoint computes a Hessian "
              "as a side effect; prefer 'adjoint', 'direct', or 'jvp' for "
              "gradient-only work", file=sys.stderr)

    if stype == "adjoint":
        return _ObjectiveFamilyDriver(MPAdjointObjective(qoi, global_state))
    if stype == "direct":
        return _ObjectiveFamilyDriver(MPDirectObjective(qoi, global_state))
    if stype == "direct_adjoint":
        return _ObjectiveFamilyDriver(
            MPDirectAdjointObjective(qoi, global_state))
    if stype == "jvp":
        return _JVPDriver(qoi, global_state, newton_kwargs)
    raise ValueError(f"sensitivity.type: unknown value {stype!r}")
