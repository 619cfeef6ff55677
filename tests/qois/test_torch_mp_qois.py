"""cmad_tpu_torch's material-point QoIs against cmad_tpu's.

``calibration`` on ``SmallRateElasticPlastic`` in plane stress and
``uniaxial_calibration`` on it in uniaxial stress, each built in both
packages from the same deck ``parameters`` section: at random states,
displacement gradients, data and weights (``numpy.random.default_rng``),
every evaluator of the QoI contract
(``J``, its first derivatives in xi, xi_prev, U, U_prev and the flat
parameters, the three second-derivative blocks, ``dJ_dparams_active``)
through the port and through cmad_tpu, in float64. Tolerance:
``max|port - ref| <= 1e-12 * max(1, max|ref|)`` per evaluator. The JAX
side evaluates every evaluator of a QoI in one compiled function (a
compile per QoI, not per evaluator).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.io.params_builder import build_parameters as jax_params
from cmad_tpu.models.deformation_types import DefType as JaxDefType
from cmad_tpu.models.global_fields import mp_U_from_F as jax_U
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.qois.calibration import Calibration as JaxCalibration
from cmad_tpu.qois.uniaxial_calibration import (
    UniaxialCalibration as JaxUniaxial,
)
from cmad_tpu_torch.io.params_builder import build_parameters
from cmad_tpu_torch.io.registry import resolve_qoi
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.global_fields import mp_U_from_F
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.qois.calibration import Calibration
from cmad_tpu_torch.qois.uniaxial_calibration import UniaxialCalibration

from tests.support.torch_mp import params_section

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12
N_STEPS = 6
STEP = 4  # the step whose data and weight the evaluators see
EVALUATORS = ["J", "dJ_dxi", "dJ_dxi_prev", "dJ_du", "dJ_du_prev",
              "dJ_dparams_flat", "hess_xi_xi", "hess_xi_params_flat",
              "hess_params_params_flat", "dJ_dparams_active"]
_FLAT = {"dJ_dparams_flat", "hess_xi_params_flat",
         "hess_params_params_flat"}


def _inputs(case, n_dofs, nd, seed):
    """Random (xi, xi_prev, F, F_prev, data, weight) as numpy."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(0.0, 150.0 if case == "calibration" else 1e-3, n_dofs)
    xi_prev = 0.9 * xi + rng.normal(0.0, 1.0, n_dofs) * abs(xi).mean() / 10
    xi[6], xi_prev[6] = 0.01, 0.005
    xi[7:] = 1.0 + rng.normal(0.0, 1e-3, n_dofs - 7)
    xi_prev[7:] = 1.0 + rng.normal(0.0, 1e-3, n_dofs - 7)
    F = np.eye(nd) + rng.normal(0.0, 2e-3, (nd, nd))
    F_prev = np.eye(nd) + rng.normal(0.0, 2e-3, (nd, nd))
    if case == "calibration":
        data = rng.normal(0.0, 100.0, (3, 3, N_STEPS + 1))
        weight = np.abs(rng.normal(1.0, 0.3, (3, 3)))
    else:
        data = rng.normal(0.0, 1e-3, (3, N_STEPS + 1))
        data[0] = rng.normal(0.0, 100.0, N_STEPS + 1)
        weight = np.array([[1.0], [1.0e4], [1.0e4]])
    return xi, xi_prev, F, F_prev, data, weight


def _build(case):
    """(jax qoi, port qoi, inputs) of ``case``."""
    section = params_section()
    if case == "calibration":
        jm = JaxRate(jax_params(section), def_type=JaxDefType.PLANE_STRESS)
        tm = SmallRateElasticPlastic(
            build_parameters(section, dtype=F64, device="cpu"),
            def_type=DefType.PLANE_STRESS)
        jq_cls, tq_cls = JaxCalibration, Calibration
    else:
        jm = JaxRate(jax_params(section),
                     def_type=JaxDefType.UNIAXIAL_STRESS)
        tm = SmallRateElasticPlastic(
            build_parameters(section, dtype=F64, device="cpu"),
            def_type=DefType.UNIAXIAL_STRESS)
        jq_cls, tq_cls = JaxUniaxial, UniaxialCalibration
    xi, xi_prev, F, F_prev, data, weight = _inputs(
        case, tm.num_dofs, tm.ndims, seed=7 if case == "calibration" else 8)
    return (jq_cls(jm, data, weight), tq_cls(tm, data, weight),
            (xi, xi_prev, F, F_prev))


def _call(qoi, name, xi, xi_prev, U, U_prev, p_flat):
    data, weight = qoi.data_at_step(STEP), qoi.weight_at_step(STEP)
    if name == "dJ_dparams_active":
        return qoi.dJ_dparams_active(xi, xi_prev, U, U_prev, data, weight)
    params = p_flat if name in _FLAT else qoi.model().parameters.values
    return getattr(qoi, name)(xi, xi_prev, params, U, U_prev, data, weight)


def _leaves(out):
    """An evaluator's output as numpy arrays (a U derivative: its
    field and its gradient field)."""
    if hasattr(out, "grad_fields"):
        return [np.asarray(out.fields["u"]), np.asarray(out.grad_fields["u"])]
    return [np.asarray(out)]


@pytest.fixture(scope="module", params=["calibration",
                                        "uniaxial_calibration"])
def evaluations(request):
    """Every evaluator of one QoI through both packages."""
    jq, tq, (xi, xi_prev, F, F_prev) = _build(request.param)

    def jax_all(x, xp, f, fp):
        U, U_prev = jax_U(f), jax_U(fp)
        p_flat = jq.model().flat_params()
        return [_call(jq, n, x, xp, U, U_prev, p_flat) for n in EVALUATORS]

    ref = jax.jit(jax_all)(*map(jnp.asarray, (xi, xi_prev, F, F_prev)))
    t = [torch.as_tensor(a, dtype=F64) for a in (xi, xi_prev, F, F_prev)]
    U, U_prev = mp_U_from_F(t[2]), mp_U_from_F(t[3])
    p_flat = tq.model().flat_params()
    out = [_call(tq, n, t[0], t[1], U, U_prev, p_flat) for n in EVALUATORS]
    return request.param, tq, dict(zip(EVALUATORS, zip(out, ref)))


@pytest.mark.parametrize("name", EVALUATORS)
def test_mp_qoi_evaluator_matches_jax(evaluations, name):
    _case, _tq, pairs = evaluations
    port, ref = pairs[name]
    for a, b in zip(_leaves(port), _leaves(ref), strict=True):
        assert a.shape == b.shape
        scale = max(1.0, float(np.abs(b).max(initial=0.0)))
        assert float(np.abs(a - b).max(initial=0.0)) <= RTOL * scale


def test_mp_qoi_data_hooks(evaluations):
    """The per-step data and weight, on the model's device: the
    calibration weight is one (3, 3) mask for every step; the uniaxial
    weight is broadcast per row over the steps, and ``update_data``
    replaces the data the hooks read."""
    case, tq, _pairs = evaluations
    data = tq.data()
    assert torch.equal(tq.data_at_step(STEP), torch.as_tensor(
        data[..., STEP]))
    w = tq.weight_at_step(STEP)
    if case == "calibration":
        assert torch.equal(w, torch.as_tensor(tq.weight()))
        return
    assert tq.weight().shape == data.shape
    assert torch.equal(w, torch.tensor([1.0, 1.0e4, 1.0e4], dtype=F64))
    tq.update_data(2.0 * data)
    assert torch.equal(tq.data_at_step(STEP),
                       torch.as_tensor(2.0 * data[..., STEP]))
    with pytest.raises(AssertionError):
        tq.update_data(data[:, :-1])


def test_mp_qois_resolve_by_name():
    assert resolve_qoi("calibration") is Calibration
    assert resolve_qoi("uniaxial_calibration") is UniaxialCalibration
    assert Calibration.problem_type == "material_point"
