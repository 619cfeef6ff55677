"""cmad_tpu_torch's material-point models against cmad_tpu's.

The same numpy states and displacement gradients
(``numpy.random.default_rng``) go through the JAX models and the port's,
in float64: the residual ``C``, ``jac_xi`` and ``cauchy`` of
``SmallRateElasticPlastic`` (FULL_3D, PLANE_STRESS, UNIAXIAL_STRESS) and
``SmallElasticPlastic`` (FULL_3D), and ``jac_params_flat`` of the first,
at random states where some points are on the plastic branch and some
on the elastic one. Tolerance per row: ``max|port - ref| <= 1e-12 *
max(1, max|ref_row|)`` — the same f64 operations in the same order, so
only reassociation and libm differ. The kinematic, packing, hardening
and effective-stress helpers are compared the same way.
"""
from __future__ import annotations

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.models import kinematics as jax_kin
from cmad_tpu.models import var_types as jax_vt
from cmad_tpu.models.deformation_types import DefType as JaxDefType
from cmad_tpu.models.effective_stress import J2_effective_stress as jax_j2
from cmad_tpu.models.global_fields import GlobalFieldsAtPoint as JaxU
from cmad_tpu.models.hardening import (
    combined_hardening_fun as jax_hardening,
    get_hardening_funs as jax_hardening_funs,
)
from cmad_tpu.models.small_elastic_plastic import (
    SmallElasticPlastic as JaxTotal,
)
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu_torch import config
from cmad_tpu_torch.io.registry import registered_model_names, resolve_model
from cmad_tpu_torch.models import kinematics, var_types
from cmad_tpu_torch.models.deformation_types import DefType, def_type_ndims
from cmad_tpu_torch.models.effective_stress import (
    J2_effective_stress,
    conventional_effective_stress_fun,
)
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.hardening import (
    combined_hardening_fun,
    get_hardening_funs,
)
from cmad_tpu_torch.models.small_elastic_plastic import SmallElasticPlastic
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

from tests.support.problems import J2AnalyticalProblem
from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
K = 8  # points per case
CASES = [("rate", DefType.FULL_3D), ("rate", DefType.PLANE_STRESS),
         ("rate", DefType.UNIAXIAL_STRESS), ("total", DefType.FULL_3D)]
QUANTITIES = ["C", "jac_xi", "cauchy", "jac_params_flat"]
# jac_params_flat (a jacrev through the yield normal's grad) is the
# costly one to compile in JAX: checked on one case
WITH_PARAMS = ("rate", DefType.FULL_3D)


@pytest.fixture(scope="module")
def params():
    p = J2AnalyticalProblem().J2_parameters
    tp = parameters_from_numpy(jax.tree.map(np.asarray, p.values),
                               dtype=F64, device="cpu")
    return p, tp


def _states(form, def_type, n_dofs, seed):
    """K random (xi, xi_prev, grad_u, grad_u_prev): stresses (rate form)
    or plastic strains (total form) scaled so that about half the
    points are past the yield surface."""
    rng = np.random.default_rng(seed)
    nd = def_type_ndims(def_type)
    scale = 150.0 if form == "rate" else 1e-3
    xi = rng.normal(0.0, scale, size=(K, n_dofs))
    xi_prev = rng.normal(0.0, scale, size=(K, n_dofs))
    xi[:, 6] = np.abs(rng.normal(0.0, 0.01, size=K))
    xi_prev[:, 6] = 0.5 * xi[:, 6]
    xi[:, 7:] = 1.0 + rng.normal(0.0, 1e-3, size=(K, n_dofs - 7))
    xi_prev[:, 7:] = 1.0 + rng.normal(0.0, 1e-3, size=(K, n_dofs - 7))
    g = rng.normal(0.0, 2e-3, size=(K, nd, nd))
    g0 = rng.normal(0.0, 2e-3, size=(K, nd, nd))
    # from well inside the yield surface to well outside it
    f = np.linspace(0.05, 1.2, K)
    xi[:, :6] *= f[:, None]
    xi_prev[:, :6] *= f[:, None]
    return xi, xi_prev, g * f[:, None, None], g0 * f[:, None, None]


def _jax_eval(model, p, quantities, xi, xi_prev, g, g0):
    """The quantities per point in one compiled JAX function."""
    def per_point(x, xp, gg, gg0):
        U = JaxU({"u": jnp.zeros(gg.shape[-1])}, {"u": gg})
        U0 = JaxU({"u": jnp.zeros(gg.shape[-1])}, {"u": gg0})
        fns = {
            "C": lambda: model.residual_fun(x, xp, p.values, U, U0),
            "jac_xi": lambda: jax.jacfwd(model.residual_fun)(
                x, xp, p.values, U, U0),
            "cauchy": lambda: model.cauchy_fun(x, xp, p.values, U, U0),
            "jac_params_flat": lambda: jax.jacrev(
                model._res_flatp, argnums=2)(
                    x, xp, model.flat_params(), U, U0)}
        return tuple(fns[q]() for q in quantities)
    out = jax.jit(jax.vmap(per_point))(*map(jnp.asarray, (xi, xi_prev, g,
                                                          g0)))
    return dict(zip(quantities, (np.asarray(o) for o in out), strict=True))


def _torch_eval(model, tp, quantities, xi, xi_prev, g, g0):
    out = {q: [] for q in quantities}
    for k in range(K):
        x, xp = torch.tensor(xi[k]), torch.tensor(xi_prev[k])
        U = GlobalFieldsAtPoint({"u": torch.zeros(g.shape[-1], dtype=F64)},
                                {"u": torch.tensor(g[k])})
        U0 = GlobalFieldsAtPoint({"u": torch.zeros(g.shape[-1], dtype=F64)},
                                 {"u": torch.tensor(g0[k])})
        for q in quantities:
            if q == "jac_params_flat":
                out[q].append(model.jac_params_flat(
                    x, xp, model.flat_params(), U, U0))
            else:
                out[q].append(getattr(model, q)(x, xp, tp.values, U, U0))
    return {q: torch.stack(v).numpy() for q, v in out.items()}


@pytest.fixture(scope="module")
def evaluations(params):
    """Lazily, per case: (port, JAX, plastic-branch flags)."""
    p, tp = params
    cache = {}

    def get(case):
        if case not in cache:
            form, def_type = case
            jcls, tcls = ((JaxRate, SmallRateElasticPlastic)
                          if form == "rate"
                          else (JaxTotal, SmallElasticPlastic))
            jm = jcls(p, def_type=JaxDefType(int(def_type)))
            tm = tcls(tp, def_type=def_type)
            assert tm.num_dofs == jm.num_dofs
            inputs = _states(form, def_type, tm.num_dofs,
                             seed=10 + CASES.index(case))
            quantities = QUANTITIES if case == WITH_PARAMS \
                else QUANTITIES[:3]
            ref = _jax_eval(jm, p, quantities, *inputs)
            # the yield-function row decides the branch: plastic rows
            # carry f, elastic rows delta-alpha
            d_alpha = inputs[0][:, 6] - inputs[1][:, 6]
            plastic = ~np.isclose(ref["C"][:, 6], d_alpha, rtol=0,
                                  atol=1e-15)
            cache[case] = (_torch_eval(tm, tp, quantities, *inputs), ref,
                           plastic)
        return cache[case]

    return get


def _case_id(case):
    return f"{case[0]}-{case[1].name}"


@pytest.mark.parametrize(("case", "quantity"), [
    *((c, q) for c in CASES for q in QUANTITIES[:3]),
    (WITH_PARAMS, "jac_params_flat")],
    ids=lambda v: _case_id(v) if isinstance(v, tuple) else v)
def test_model_matches_jax(evaluations, case, quantity):
    got, ref, plastic = evaluations(case)
    assert 0 < plastic.sum() < K, "both branches must be exercised"
    a, b = got[quantity], ref[quantity]
    assert np.all(np.isfinite(a))
    # rows = the model's output components, columns = points x the rest
    assert_rows_close(np.moveaxis(a, 1, 0), np.moveaxis(b, 1, 0),
                      rtol=1e-12)


@pytest.mark.parametrize("def_type", [DefType.FULL_3D, DefType.PLANE_STRAIN,
                                      DefType.PLANE_STRESS,
                                      DefType.UNIAXIAL_STRESS])
def test_gather_F_matches_jax(def_type):
    rng = np.random.default_rng(int(def_type))
    nd = def_type_ndims(def_type)
    g = rng.normal(size=(nd, nd))
    s = 1.0 + rng.normal(0.0, 0.1, size=2)
    for idx in ((0, 1, 2) if def_type == DefType.UNIAXIAL_STRESS else (0,)):
        ref = jax_kin.gather_F(jnp.asarray(g), JaxDefType(int(def_type)),
                               jnp.asarray(s), idx)
        got = kinematics.gather_F(torch.tensor(g), def_type, torch.tensor(s),
                                  idx)
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    assert list(kinematics.off_axis_idx(1)) == [0, 2]


def test_sym_packing_and_hardening_match_jax():
    rng = np.random.default_rng(20)
    v6, v3 = rng.normal(size=(5, 6)), rng.normal(size=(5, 3))
    for v, nd in ((v6, 3), (v3, 2)):
        t = var_types.sym_tensor_from_vector(torch.tensor(v), nd)
        np.testing.assert_array_equal(
            t.numpy(), np.asarray(jax_vt.sym_tensor_from_vector(v, nd)))
        np.testing.assert_array_equal(
            var_types.vector_from_sym_tensor(t, nd).numpy(), v)
    sig = rng.normal(0.0, 100.0, size=(6, 3, 3))
    np.testing.assert_allclose(J2_effective_stress(torch.tensor(sig)).numpy(),
                               np.asarray(jax_j2(jnp.asarray(sig))),
                               rtol=1e-14)
    alpha = np.abs(rng.normal(size=7))
    hp = {"voce": {"S": 200.0, "D": 20.0}, "linear": {"K": 3.0}}
    np.testing.assert_allclose(
        combined_hardening_fun(torch.tensor(alpha), hp,
                               get_hardening_funs()).numpy(),
        np.asarray(jax_hardening(jnp.asarray(alpha), hp,
                                 jax_hardening_funs())), rtol=1e-14)


def test_later_effective_stresses_raise_naming_their_slice():
    assert conventional_effective_stress_fun("J2") is J2_effective_stress
    for name in ("hill", "barlat", "hosford", "hosford_principal"):
        with pytest.raises(NotImplementedError, match="item 21"):
            conventional_effective_stress_fun(name)
    with pytest.raises(NotImplementedError, match="unknown"):
        conventional_effective_stress_fun("tresca")


def test_registry_resolves_the_port_models():
    assert resolve_model("small_rate_elastic_plastic") \
        is SmallRateElasticPlastic
    assert resolve_model("small_elastic_plastic") is SmallElasticPlastic
    assert {"small_rate_elastic_plastic", "small_elastic_plastic"} <= set(
        registered_model_names())
    with pytest.raises(KeyError, match="no registered model"):
        resolve_model("no_such_model")


def test_init_xi_defaults_to_the_card(params):
    """``Model.init_xi`` matches the JAX layout's initial state on an
    explicit CPU request, and defaults to the card: without one it
    raises rather than running on the CPU."""
    p, tp = params
    for def_type in (DefType.FULL_3D, DefType.UNIAXIAL_STRESS):
        tm = SmallRateElasticPlastic(tp, def_type=def_type)
        jm = JaxRate(p, def_type=JaxDefType(int(def_type)))
        np.testing.assert_array_equal(
            tm.init_xi(F64, device="cpu").numpy(),
            np.asarray(jm.init_xi(jnp.float64)))
    default = inspect.signature(tm.init_xi).parameters["device"].default
    assert default == config.DEFAULT_DEVICE == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tm.init_xi()
