"""cmad_tpu_torch's reduced principal-Hosford and Hill local solves
(``ops/principal_return.py``, ``ops/hill_return.py``) against cmad_tpu's,
on the CPU in float64.

The same numpy displacement gradients go through both packages: a random
batch (a quarter of it scaled into the elastic range) and degenerate
trial states (no strain; uniaxial and equal-biaxial strain, whose trial
stress has a repeated pair, both yielding; a volumetric strain, whose
trial stress is spherical). The material is ``tests/ops/
test_principal_return.py``'s with a random material rotation; Hill's
coefficients are ``tests/fem/test_coupled_block_fastpath.py``'s.
Bounds:

- the reduced solves over two chained steps, both forms, principal at
  a = 8 and 100 and Hill: 1e-10 of each column's scale (both Newtons
  stop at the 1e-14 tolerance of the material-point solve from the same
  guess; the eigenvalues' determinant rounds differently), and 1e-9 at
  the two trial states with a repeated pair: there the clamp of the
  eigenvalues' Cardano argument splits the pair by about p sqrt(margin),
  and the reconstruction divides by that gap, in both packages;
- the strain tangent dxi/dg (the implicit-function rule in strain space
  here, ``jax.jacfwd`` through cmad_tpu's solve), principal at a = 100 in
  the rate form and Hill in the total form, at the same bounds. Hill's
  at no strain is NaN in cmad_tpu (its sqrt at a zero stress) and finite
  here;
- the reduced solve against the port's own generic 7-dof Newton: 1e-8
  relative, 1e-10 absolute (as ``tests/ops/test_principal_return.py``
  holds cmad_tpu's: the generic Newton resolves stress to about
  2 mu abs_tol);
- ``make_batched_return_map(specialize=True)`` takes the reduced solves:
  its state equals theirs bit for bit, its stress cmad_tpu's to 1e-10;
- ``gradcheck`` of each reduced solve, and ``gradgradcheck`` of the
  principal one (the notch deck's), in Y and along a strain direction (central differences of Newtons re-solved at
  1e-14, eps 1e-6; atol 1e-6 and 1e-5, as for the diagonal Hosford
  solve).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from torch.func import jacfwd, vmap

from cmad_tpu.models.global_fields import (
    GlobalFieldsAtPoint as JaxFields,
)
from cmad_tpu.models.small_elastic_plastic import (
    SmallElasticPlastic as JaxTotal,
)
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.ops.hill_return import make_hill_local_solve as jax_hill
from cmad_tpu.ops.principal_return import (
    make_principal_hosford_local_solve as jax_principal,
)
from cmad_tpu.parameters.parameters import Parameters as JaxParameters
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.small_elastic_plastic import SmallElasticPlastic
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.ops.hill_return import (
    hill_kind,
    make_hill_local_solve,
    make_hill_strain_solve,
)
from cmad_tpu_torch.ops.hosford_return import hosford_kind
from cmad_tpu_torch.ops.principal_return import (
    make_principal_hosford_local_solve,
    make_principal_hosford_strain_solve,
    principal_hosford_kind,
)
from cmad_tpu_torch.ops.return_map import make_batched_return_map
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-10
ROTATION = Rotation.random(1, random_state=13).as_matrix()[0]
HILL = {"F": 0.45, "G": 0.55, "H": 0.5, "L": 1.4, "M": 1.7, "N": 1.55}
MODELS = {"rate": (JaxRate, SmallRateElasticPlastic),
          "total": (JaxTotal, SmallElasticPlastic)}
# (yield, a): the local solves of each package
CASES = {("principal", 8.0): (jax_principal,
                              make_principal_hosford_local_solve),
         ("principal", 100.0): (jax_principal,
                                make_principal_hosford_local_solve),
         ("hill", None): (jax_hill, make_hill_local_solve)}
STRAIN_SOLVES = {"principal": make_principal_hosford_strain_solve,
                 "hill": make_hill_strain_solve}
# the tangents compared (a jacfwd through cmad_tpu's Newton compiles for
# several seconds)
TANGENT_CASES = {("principal", 100.0, "rate"), ("hill", None, "total")}
PAIR_RTOL = 1e-9
PAIRS = [17, 18]    # the uniaxial and equal-biaxial trial states


def _values(name, a=8.0, rotation=ROTATION):
    es = ({"hosford_principal": {"a": a}} if name == "principal"
          else {"hill": dict(HILL)})
    return {"rotation matrix": rotation,
            "elastic": {"E": 200e3, "nu": 0.3},
            "plastic": {
                "effective stress": es,
                "flow stress": {"initial yield": {"Y": 200.0},
                                "hardening": {"voce": {"S": 200.0,
                                                       "D": 20.0}}}}}


def _grads():
    rng = np.random.default_rng(0)
    g = rng.normal(0.0, 2.5e-3, size=(16, 3, 3))
    g[:4] *= 0.05
    degenerate = [np.zeros((3, 3)), np.diag([5e-3, 0.0, 0.0]),
                  np.diag([3e-3, 3e-3, 0.0]), 2e-3 * np.eye(3)]
    return np.concatenate([g, np.stack(degenerate)])


B = _grads().shape[0]


def _jax_fields(t):
    return JaxFields(fields={"u": jnp.zeros(3)}, grad_fields={"u": t})


def _fields(t):
    t = torch.as_tensor(t, dtype=F64)
    return GlobalFieldsAtPoint(fields={"u": t.new_zeros((t.shape[0], 3))},
                               grad_fields={"u": t})


def _sym6(g):
    s = 0.5 * (g + np.transpose(g, (0, 2, 1)))
    return np.stack([s[:, 0, 0], s[:, 0, 1], s[:, 0, 2], s[:, 1, 1],
                     s[:, 1, 2], s[:, 2, 2]], axis=-1)


def _close_rows(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-300)
    err = np.abs(got - ref) / scale
    generic = [i for i in range(got.shape[0]) if i not in PAIRS]
    assert err[generic].max() <= rtol, err[generic].max()
    assert err[PAIRS].max() <= PAIR_RTOL, err[PAIRS].max()


@pytest.fixture(scope="module")
def jax_runs():
    """cmad_tpu's reduced solves over two chained steps (g from rest,
    then 1.5 g from g), the stress after the first, and the strain
    tangent dxi/dg6 of the first step from rest (``jax.jacfwd`` through
    the solve), per case and form. The parameters are arguments of the
    jitted functions, so each yield and form compiles once."""
    g = _grads()
    out = {}
    for form, (jcls, _tcls) in MODELS.items():
        for name in ("principal", "hill"):
            model = jcls(JaxParameters(_values(name)))
            make = CASES[(name, 8.0 if name == "principal" else None)][0]
            solve = make(model, max_iters=40)

            def point(xi_prev, gu, gu0, values, solve=solve, model=model):
                xi = solve(xi_prev, xi_prev, values, _jax_fields(gu),
                           _jax_fields(gu0))
                return xi, model.cauchy_fun(xi, xi_prev, values,
                                            _jax_fields(gu),
                                            _jax_fields(gu0))

            def of_g6(g6, values, solve=solve):
                e = jnp.stack([jnp.stack([g6[0], g6[1], g6[2]]),
                               jnp.stack([g6[1], g6[3], g6[4]]),
                               jnp.stack([g6[2], g6[4], g6[5]])])
                xi0 = jnp.zeros(7)
                return solve(xi0, xi0, values, _jax_fields(e),
                             _jax_fields(jnp.zeros((3, 3))))

            step = jax.jit(jax.vmap(point, in_axes=(0, 0, 0, None)))
            tangent = jax.jit(jax.vmap(jax.jacfwd(of_g6),
                                       in_axes=(0, None)))
            for a in ((8.0, 100.0) if name == "principal" else (None,)):
                values = JaxParameters(_values(name, a or 8.0)).values
                xi1, sig1 = step(jnp.zeros((B, 7)), jnp.asarray(g),
                                 jnp.zeros((B, 3, 3)), values)
                xi2, _ = step(xi1, jnp.asarray(1.5 * g), jnp.asarray(g),
                              values)
                dxi = (tangent(jnp.asarray(_sym6(g)), values)
                       if (name, a, form) in TANGENT_CASES else None)
                out[name, a, form] = tuple(
                    None if v is None else np.asarray(v)
                    for v in (xi1, xi2, sig1, dxi))
    return g, out


def _port(name, a, form):
    tp = parameters_from_numpy(_values(name, a or 8.0), dtype=F64,
                               device="cpu")
    return tp, MODELS[form][1](tp)


@pytest.mark.parametrize("form", ["rate", "total"])
@pytest.mark.parametrize("case", sorted(CASES, key=str))
def test_reduced_solve_matches_cmad_tpu(jax_runs, case, form):
    g, ref = jax_runs
    name, a = case
    tp, model = _port(name, a, form)
    solve = CASES[case][1](model, max_iters=40)
    xi0 = torch.zeros(B, 7, dtype=F64)
    xi1 = solve(None, xi0, tp.values, _fields(g), _fields(np.zeros_like(g)))
    xi2 = solve(None, xi1, tp.values, _fields(1.5 * g), _fields(g))
    ref1, ref2, _sig1, _dxi = ref[name, a, form]
    plastic = ref1[:, 6] > 0
    # both branches, and the degenerate trial states: no strain and the
    # volumetric one stay elastic, the uniaxial and biaxial ones yield
    assert plastic[4:16].any() and (~plastic[:4]).all()
    assert list(plastic[16:]) == [False, True, True, False]
    _close_rows(xi1, ref1)
    _close_rows(xi2, ref2)


@pytest.mark.parametrize("name,a,form", sorted(TANGENT_CASES, key=str))
def test_strain_tangent_matches_jax_jacfwd(jax_runs, name, a, form):
    """dxi/dg6 from rest: the unknowns' tangent by the implicit-function
    rule, carried through the state's reconstruction."""
    g, ref = jax_runs
    tp, model = _port(name, a, form)
    solve = STRAIN_SOLVES[name](model, max_iters=40)
    g6 = torch.tensor(_sym6(g), dtype=F64)
    xi_prev = torch.zeros(B, 7, dtype=F64)
    x, x_prev = solve.unknowns(xi_prev, tp.values, g6)
    dx = solve.tangent(x, x_prev, tp.values, g6)
    de_dx, de_dg = vmap(jacfwd(solve.expand, argnums=(0, 3)),
                        in_dims=(0, 0, None, 0))(x, xi_prev, tp.values, g6)
    dxi = (de_dg + de_dx @ dx).reshape(B, -1)
    want = ref[name, a, form][3].reshape(B, -1)
    assert torch.isfinite(dxi).all()
    # Hill at no strain: cmad_tpu's tangent is NaN (its sqrt at a zero
    # stress), the port's that of the elastic map
    finite = np.isfinite(want).all(axis=1)
    assert finite.sum() == B - (name == "hill")
    # the pair rows measured 1.8e-10 of their columns' scale
    _close_rows(dxi[finite], want[finite])


@pytest.mark.parametrize("form", ["rate", "total"])
@pytest.mark.parametrize("name", ["principal", "hill"])
def test_reduced_solve_matches_the_generic_newton(jax_runs, name, form):
    g, _ref = jax_runs
    tp, model = _port(name, 8.0, form)
    reduced = make_batched_return_map(model, max_iters=40, specialize=True)
    generic = make_batched_return_map(model, max_iters=40)
    gu, zero = torch.tensor(g), torch.zeros(B, 3, 3, dtype=F64)
    xi0 = torch.zeros(B, 7, dtype=F64)
    xi_r, _ = reduced(xi0, gu, zero, tp.values)
    xi_g, _ = generic(xi0, gu, zero, tp.values)
    np.testing.assert_allclose(xi_r.numpy(), xi_g.numpy(), rtol=1e-8,
                               atol=1e-10)


@pytest.mark.parametrize("form", ["rate", "total"])
@pytest.mark.parametrize("name", ["principal", "hill"])
def test_batched_map_takes_the_reduced_solve(jax_runs, name, form):
    g, ref = jax_runs
    tp, model = _port(name, 100.0 if name == "principal" else None, form)
    a = 100.0 if name == "principal" else None
    step = make_batched_return_map(model, max_iters=40, specialize=True)
    gu, zero = torch.tensor(g), torch.zeros(B, 3, 3, dtype=F64)
    xi0 = torch.zeros(B, 7, dtype=F64)
    xi, sig = step(xi0, gu, zero, tp.values)
    solve = CASES[(name, a)][1](model, max_iters=40)
    assert torch.equal(xi, solve(None, xi0, tp.values, _fields(g),
                                 _fields(np.zeros_like(g))))
    _close_rows(sig.reshape(B, 9), ref[name, a, form][2].reshape(B, 9))


def test_kind_gates():
    for name, kind in (("principal", principal_hosford_kind),
                       ("hill", hill_kind)):
        for form, (_jcls, cls) in MODELS.items():
            tp = parameters_from_numpy(_values(name), dtype=F64,
                                       device="cpu")
            # any material rotation (the diagonal Hosford gate wants I)
            assert kind(cls(tp)) == form
            assert kind(cls(tp, effective_stress_fun=lambda s, p: s[0, 0])
                        ) is None
            assert hosford_kind(cls(tp)) is None
    j2 = _values("hill")
    j2["plastic"]["effective stress"] = {"J2": {}}
    tp = parameters_from_numpy(j2, dtype=F64, device="cpu")
    assert principal_hosford_kind(SmallRateElasticPlastic(tp)) is None
    assert hill_kind(SmallRateElasticPlastic(tp)) is None
    tp = parameters_from_numpy(_values("principal"), dtype=F64,
                               device="cpu")
    from cmad_tpu_torch.models.deformation_types import DefType
    assert principal_hosford_kind(SmallRateElasticPlastic(
        tp, def_type=DefType.PLANE_STRESS)) is None
    with pytest.raises(ValueError, match="Hill-reducible"):
        make_hill_strain_solve(SmallRateElasticPlastic(tp))


@pytest.mark.parametrize("name,form", [("principal", "total"),
                                       ("hill", "rate")])
def test_reduced_solve_gradcheck_and_gradgradcheck(name, form):
    tp, model = _port(name, 8.0, form)
    solve = STRAIN_SOLVES[name](model, max_iters=40, abs_tol=1e-14,
                                rel_tol=1e-14)
    g6 = torch.tensor(_sym6(_grads()[5:6] * 1.6), dtype=F64)
    xi_prev = torch.zeros(1, 7, dtype=F64)
    with torch.no_grad():
        assert float(solve(xi_prev, tp.values, g6)[0, 6]) > 0.0

    def f(Y, s):
        values = {**tp.values, "plastic": {
            **tp.values["plastic"], "flow stress": {
                **tp.values["plastic"]["flow stress"],
                "initial yield": {"Y": Y}}}}
        return solve(xi_prev, values, s * g6)

    inputs = (torch.tensor(200.0, dtype=F64, requires_grad=True),
              torch.tensor(1.0, dtype=F64, requires_grad=True))
    assert torch.autograd.gradcheck(f, inputs, eps=1e-6, atol=1e-6)
    if name == "principal":
        assert torch.autograd.gradgradcheck(f, inputs, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("form", ["rate", "total"])
@pytest.mark.parametrize("name", ["principal", "hill"])
def test_reduced_solve_gradcheck_in_the_previous_state(name, form):
    """The second of two chained steps, differentiated in the state the
    first left (plastic, with a material rotation): the whole previous
    state enters the trial state the residual recomputes and the state's
    reconstruction."""
    tp, model = _port(name, 8.0, form)
    solve = STRAIN_SOLVES[name](model, max_iters=40, abs_tol=1e-14,
                                rel_tol=1e-14)
    g = _grads()[5:6] * 1.6
    g1 = torch.tensor(_sym6(g), dtype=F64)
    # the rate form's rows are the strain increment, the total form's the
    # strain: the second step takes the strain from g to 1.5 g
    g2 = 0.5 * g1 if form == "rate" else 1.5 * g1
    with torch.no_grad():
        xi1 = solve(torch.zeros(1, 7, dtype=F64), tp.values, g1)
        assert float(xi1[0, 6]) > 0.0
        assert float(solve(xi1, tp.values, g2)[0, 6]) > float(xi1[0, 6])
    # the state scaled to order one, so one eps suits stress, plastic
    # strain and alpha alike
    scale = xi1.abs().clamp_min(1e-3)

    def f(z):
        return solve(z * scale, tp.values, g2) / scale

    z = (xi1 / scale).requires_grad_()
    assert torch.autograd.gradcheck(f, (z,), eps=1e-6, atol=1e-6)
    if (name, form) == ("principal", "total"):
        assert torch.autograd.gradgradcheck(f, (z,), eps=1e-6, atol=1e-5)
