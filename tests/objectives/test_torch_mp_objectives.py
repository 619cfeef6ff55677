"""cmad_tpu_torch's material-point objectives against cmad_tpu's.

The round-trip deck's model (``SmallRateElasticPlastic``, plane stress,
E = 200e3, nu = 0.3, Y under a log transform, S and D under bounds), built
in both packages from the same deck ``parameters`` section, on a 6-step
eps_xx ramp to 1.5% (through yield). The data are the port's own primal
at the deck's values (it spares a JAX drive); both packages evaluate at
1.1x those values, in float64 on the CPU:

- each strategy against cmad_tpu: J to 1e-10 and the gradient to 1e-9
  relative, the Hessians to 1e-9 relative. adjoint, direct and
  direct_adjoint are held to cmad_tpu's same strategy. The port's jvp
  objective is held to cmad_tpu's adjoint J and gradient and its
  direct-adjoint Hessian: on this drive cmad_tpu's own jvp objective
  gives the same J, its gradient to 1.6e-16 and its Hessian to 4.6e-15 of
  their largest entries, and compiling it would cost 36 s of the test
  budget. The JAX objectives share one compiled Newton solve (each
  compiles its own otherwise: the same program);
- the port's strategies against each other at
  ``tests/objectives/test_strategy_agreement.py``'s tolerances, on this
  deck, and adjoint and jvp on ``uniaxial_calibration`` (per-row
  weights, sliced per step by the jvp objective);
- ``gradcheck`` and ``gradgradcheck`` of the jvp objective, whose
  Hessian is reverse over reverse through the implicit solve's
  ``backward``.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cmad_tpu.io.params_builder import build_parameters as jax_params
from cmad_tpu.models.deformation_types import DefType as JaxDefType
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.objectives.mp_objective import (
    MPAdjointObjective as JaxAdjoint,
    MPDirectAdjointObjective as JaxDirectAdjoint,
    MPDirectObjective as JaxDirect,
)
from cmad_tpu.qois.calibration import Calibration as JaxCalibration
from cmad_tpu_torch.cli.mp_subcommands import run_primal_pass
from cmad_tpu_torch.io.params_builder import build_parameters
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.nonlinear_solver import make_newton_solve
from cmad_tpu_torch.models.small_elastic_plastic import SmallElasticPlastic
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.objectives.mp_jvp_objective import MPJVPObjective
from cmad_tpu_torch.objectives.mp_objective import (
    MPAdjointObjective,
    MPDirectAdjointObjective,
    MPDirectObjective,
)
from cmad_tpu_torch.qois.calibration import Calibration
from cmad_tpu_torch.qois.uniaxial_calibration import UniaxialCalibration

from tests.support.torch_mp import params_section, ramp_F

torch.set_num_threads(1)

F64 = torch.float64
J_RTOL, GRAD_RTOL, HESS_RTOL = 1e-10, 1e-9, 1e-9
STRATEGIES = ["adjoint", "direct", "direct_adjoint", "jvp"]
WEIGHT = np.diag([1.0, 1.0, 0.0])
NEWTON = {"max_iters": 10, "abs_tol": 1e-14, "rel_tol": 1e-14}


def _offset(parameters):
    """1.1x the active values; returns the canonical start."""
    truth = parameters.flat_active_values(False)
    parameters.set_active_values_from_flat(1.1 * truth, False)
    return parameters.flat_active_values(return_canonical=True)


def _port_qoi(F, data=None):
    model = SmallRateElasticPlastic(
        build_parameters(params_section(), dtype=F64, device="cpu"),
        def_type=DefType.PLANE_STRESS)
    if data is None:
        data = run_primal_pass(model, F, NEWTON)[0]
    return Calibration(model, data, WEIGHT), data


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def results():
    """Each strategy's (J, grad, H or None) through both packages."""
    F = ramp_F(2)
    qoi, data = _port_qoi(F)
    x0 = _offset(qoi.model().parameters)
    port = {}
    for name, cls in (("adjoint", MPAdjointObjective),
                      ("direct", MPDirectObjective),
                      ("direct_adjoint", MPDirectAdjointObjective)):
        r = cls(qoi, F).evaluate(x0)
        port[name] = (r.J, r.grad, getattr(r, "hessian", None))
    jvp = MPJVPObjective(qoi, F, make_newton_solve(qoi.model().residual_fun))
    J, g = jvp.evaluate_objective_and_grad(x0)
    port["jvp"] = (float(J), g.numpy(), jvp.evaluate_hessian(x0).numpy())
    port["jvp_J"] = float(jvp.evaluate_objective(x0))

    jm = JaxRate(jax_params(params_section()),
                 def_type=JaxDefType.PLANE_STRESS)
    jq = JaxCalibration(jm, data, WEIGHT)
    jx0 = _offset(jm.parameters)
    assert np.array_equal(jx0, x0)
    ref, solve = {}, None
    for name, cls in (("adjoint", JaxAdjoint), ("direct", JaxDirect),
                      ("direct_adjoint", JaxDirectAdjoint)):
        obj = cls(jq, F)
        solve = obj._solve = solve or obj._solve
        r = obj.evaluate(jx0)
        ref[name] = (r.J, np.asarray(r.grad),
                     None if not hasattr(r, "hessian") else r.hessian)
    ref["jvp"] = (*ref["adjoint"][:2], ref["direct_adjoint"][2])
    return port, ref


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_strategy_matches_jax(results, strategy):
    port, ref = results
    (J, g, H), (J_ref, g_ref, H_ref) = port[strategy], ref[strategy]
    assert J > 0.0
    assert abs(J - J_ref) <= J_RTOL * abs(J_ref)
    assert _rel(g, g_ref) <= GRAD_RTOL
    if H is not None:
        assert H.shape == (3, 3)
        assert _rel(H, H_ref) <= HESS_RTOL


def test_port_strategies_agree(results):
    """The port's four strategies against each other, at
    test_strategy_agreement.py's tolerances."""
    port, _ = results
    J, g, _h = port["adjoint"]
    assert np.isclose(J, port["direct"][0], rtol=1e-10)
    assert np.isclose(J, port["jvp"][0], rtol=1e-8)
    assert np.isclose(J, port["jvp_J"], rtol=1e-8)
    assert np.allclose(g, port["direct"][1], rtol=1e-8)
    assert np.allclose(g, port["jvp"][1], rtol=1e-6)
    assert np.allclose(port["direct_adjoint"][1], port["jvp"][1],
                       rtol=1e-6)
    assert np.allclose(port["direct_adjoint"][2], port["jvp"][2],
                       rtol=1e-6, atol=1e-10)


def test_uniaxial_weights_per_step_agree_across_strategies():
    """``uniaxial_calibration`` (weights broadcast per row over the
    steps, so the jvp objective slices them per step) on the total-form
    model in uniaxial stress: the adjoint and the jvp objectives agree."""
    F = ramp_F(1, num_steps=6, last=0.012)
    model = SmallElasticPlastic(
        build_parameters(params_section(), dtype=F64, device="cpu"),
        def_type=DefType.UNIAXIAL_STRESS)
    _c, xi, _log, _J = run_primal_pass(model, F, NEWTON)
    stretch = xi[:, model.layout.slc("off-axis stretches")] - 1.0
    data = np.vstack([_c[0, 0], stretch.T])
    qoi = UniaxialCalibration(model, data, np.array([[1.0], [1e4], [1e4]]))
    x0 = _offset(model.parameters)
    adj = MPAdjointObjective(qoi, F).evaluate(x0)
    jvp = MPJVPObjective(qoi, F, make_newton_solve(model.residual_fun))
    J, g = jvp.evaluate_objective_and_grad(x0)
    assert adj.J > 0.0
    assert np.isclose(adj.J, float(J), rtol=1e-8)
    assert np.allclose(adj.grad, g.numpy(), rtol=1e-6)


@pytest.mark.parametrize("check", ["gradcheck", "gradgradcheck"])
def test_jvp_objective_autograd_checks(check):
    """The jvp objective's gradient and Hessian against central
    differences (``torch.autograd``'s checks in their fast mode, f64) on
    one step through yield."""
    F = ramp_F(2, num_steps=1, last=0.004)
    qoi, _data = _port_qoi(F)
    x0 = _offset(qoi.model().parameters)
    jvp = MPJVPObjective(qoi, F, make_newton_solve(qoi.model().residual_fun))
    x = torch.tensor(x0, dtype=F64, requires_grad=True)
    fn = getattr(torch.autograd, check)
    assert fn(jvp.objective, (x,), eps=1e-6, atol=1e-5, rtol=1e-4,
              fast_mode=True)
