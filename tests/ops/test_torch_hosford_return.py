"""cmad_tpu_torch's Hosford effective stress, reduced 4-dof Hosford Newton
and the Hosford branch of ``make_batched_return_map`` against cmad_tpu's,
on the CPU in float64.

The same numpy inputs go through both packages:

- ``hosford_effective_stress``, value and gradient (in the stress and in
  ``a``), at a = 8 and a = 100, on random stresses and on the states where
  the two packages' derivative rules differ: two equal diagonal stresses
  (``abs`` at 0: 1.0 in JAX, 0.0 in torch, multiplied by a zero power),
  two tied largest differences (``maximum`` splits a tie in halves in
  both) and a hydrostatic state (the double ``where``). Bound 1e-13
  relative: the same operations up to the order of a three-term sum;
- the reduced solve (``make_hosford_local_solve``) in the rate and total
  forms at a = 8 and a = 100 over two chained steps, 1e-12 of each row's
  scale: both Newtons stop at the 1e-14 tolerance of the material-point
  solve from the same guess;
- ``make_batched_return_map(model, specialize=True)``, the state and the
  stress, against cmad_tpu's reduced solve and ``cauchy_fun`` (what its
  batched map runs), at the same bound;
- ``gradcheck`` and ``gradgradcheck`` of the reduced solve in Y and
  along a strain direction (central differences of Newtons re-solved at
  1e-14, eps 1e-6; atol 1e-6 on the first and 1e-5 on the second
  derivatives, whose entries reach 1e2).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.models.effective_stress import (
    hosford_effective_stress as jax_hosford,
)
from cmad_tpu.models.global_fields import (
    GlobalFieldsAtPoint as JaxFields,
)
from cmad_tpu.models.small_elastic_plastic import (
    SmallElasticPlastic as JaxTotal,
)
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.ops.hosford_return import (
    make_hosford_local_solve as jax_local_solve,
)
from cmad_tpu.parameters.parameters import Parameters as JaxParameters
from cmad_tpu_torch.models.effective_stress import (
    conventional_effective_stress_fun,
    hosford_effective_stress,
)
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.small_elastic_plastic import SmallElasticPlastic
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.ops.hosford_return import (
    hosford_kind,
    make_hosford_local_solve,
    make_hosford_strain_solve,
)
from cmad_tpu_torch.ops.return_map import make_batched_return_map
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

torch.set_num_threads(1)

F64 = torch.float64
B = 24
PHI_RTOL = 1e-13
STATE_RTOL = 1e-12
MODELS = {"rate": (JaxRate, SmallRateElasticPlastic),
          "total": (JaxTotal, SmallElasticPlastic)}


def _values(a):
    """``tests/ops/test_hosford_return.py``'s material."""
    return {"rotation matrix": np.eye(3),
            "elastic": {"E": 200e3, "nu": 0.3},
            "plastic": {
                "effective stress": {"hosford": {"a": a}},
                "flow stress": {"initial yield": {"Y": 200.0},
                                "hardening": {"voce": {"S": 200.0,
                                                       "D": 20.0}}}}}


def _grads(n, seed, scale=2.5e-3):
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, scale, size=(n, 3, 3))
    return 0.5 * (eps + np.transpose(eps, (0, 2, 1)))


def _close_rows(got, ref, rtol):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    scale = np.maximum(np.abs(ref).max(axis=0), 1e-300)
    err = (np.abs(got - ref) / scale).max()
    assert err <= rtol, err


def _stresses():
    """Random stresses, then the special states: equal diagonals, tied
    largest differences (the two coincide for three values on a line),
    a hydrostatic state, and a zero stress."""
    rng = np.random.default_rng(7)
    s = rng.normal(0.0, 100.0, size=(6, 3, 3))
    s = 0.5 * (s + np.transpose(s, (0, 2, 1)))
    special = [np.diag([3.0, 1.0, 1.0]), np.diag([1.0, 3.0, 3.0]),
               np.diag([2.0, 2.0, -5.0]) + 0.3 * (np.ones((3, 3))
                                                    - np.eye(3)),
               np.diag([4.0, 4.0, 4.0]) + 0.1 * (np.ones((3, 3))
                                                   - np.eye(3)),
               np.zeros((3, 3))]
    return np.concatenate([s, np.stack(special)])


@pytest.mark.parametrize("a", [8.0, 100.0])
def test_hosford_effective_stress_matches_jax(a):
    sig = _stresses()

    def jax_phi(s, aa):
        return jax_hosford(s, {"effective stress": {"hosford": {"a": aa}}})

    j_phi = jax.vmap(jax_phi, in_axes=(0, None))(jnp.asarray(sig), a)
    j_ds = jax.vmap(jax.grad(jax_phi), in_axes=(0, None))(
        jnp.asarray(sig), a)
    j_da = jax.vmap(jax.grad(jax_phi, argnums=1), in_axes=(0, None))(
        jnp.asarray(sig), a)

    s = torch.tensor(sig, dtype=F64, requires_grad=True)
    at = torch.tensor(a, dtype=F64, requires_grad=True)
    assert conventional_effective_stress_fun("hosford") \
        is hosford_effective_stress
    phi = hosford_effective_stress(
        s, {"effective stress": {"hosford": {"a": at}}})
    ds = torch.autograd.grad(phi.sum(), s, retain_graph=True)[0]
    da = torch.stack([torch.autograd.grad(phi[i], at, retain_graph=True)[0]
                      for i in range(phi.shape[0])])

    for got, ref in ((phi, j_phi), (ds, j_ds), (da, j_da)):
        got, ref = got.detach().numpy(), np.asarray(ref)
        assert np.isfinite(got).all()
        scale = max(float(np.abs(ref).max()), 1.0)
        assert float(np.abs(got - ref).max()) <= PHI_RTOL * scale
    # the zero stress: phi 0 and every derivative 0 in both packages
    assert float(phi[-1]) == 0.0 and not ds[-1].any()


def test_other_anisotropic_forms_name_item_21():
    """The other anisotropic forms are in the dispatch table beside the
    diagonal Hosford one; an unknown name still raises."""
    from cmad_tpu_torch.models.effective_stress import (
        barlat_effective_stress,
        hill_effective_stress,
        hosford_principal_effective_stress,
    )
    for name, fun in (("hill", hill_effective_stress),
                      ("barlat", barlat_effective_stress),
                      ("hosford_principal",
                       hosford_principal_effective_stress)):
        assert conventional_effective_stress_fun(name) is fun
    with pytest.raises(NotImplementedError, match="unknown"):
        conventional_effective_stress_fun("tresca")


@pytest.fixture(scope="module")
def jax_reduced():
    """cmad_tpu's reduced solve over two chained steps, per form and a
    (g from rest, then 1.5 g from g), and its stress after the first
    step. The parameters are an argument of the jitted step, so each
    form compiles once for both values of a."""
    g = _grads(B, seed=0)

    def fields(t):
        return JaxFields(fields={"u": jnp.zeros(3)}, grad_fields={"u": t})

    out = {}
    for form, (jcls, _tcls) in MODELS.items():
        model = jcls(JaxParameters(_values(8.0)))
        solve = jax_local_solve(model, max_iters=40)

        def point(xi_prev, gu, gu0, values, solve=solve, model=model):
            xi = solve(xi_prev, xi_prev, values, fields(gu), fields(gu0))
            return xi, model.cauchy_fun(xi, xi_prev, values, fields(gu),
                                        fields(gu0))

        step = jax.jit(jax.vmap(point, in_axes=(0, 0, 0, None)))
        for a in (8.0, 100.0):
            values = JaxParameters(_values(a)).values
            xi1, sig1 = step(jnp.zeros((B, 7)), jnp.asarray(g),
                             jnp.zeros((B, 3, 3)), values)
            xi2, _sig2 = step(xi1, jnp.asarray(1.5 * g), jnp.asarray(g),
                              values)
            out[form, a] = tuple(np.asarray(v) for v in (xi1, xi2, sig1))
    return g, out


def _fields(t):
    t = torch.tensor(t, dtype=F64)
    return GlobalFieldsAtPoint(fields={"u": t.new_zeros((B, 3))},
                               grad_fields={"u": t})


@pytest.mark.parametrize("a", [8.0, 100.0])
@pytest.mark.parametrize("form", ["rate", "total"])
def test_reduced_solve_matches_jax(jax_reduced, form, a):
    g, ref = jax_reduced
    tp = parameters_from_numpy(_values(a), dtype=F64, device="cpu")
    model = MODELS[form][1](tp)
    assert hosford_kind(model) == form
    solve = make_hosford_local_solve(model, max_iters=40)
    xi0 = torch.zeros(B, 7, dtype=F64)
    xi1 = solve(xi0, xi0, tp.values, _fields(g), _fields(np.zeros_like(g)))
    xi2 = solve(xi1, xi1, tp.values, _fields(1.5 * g), _fields(g))
    ref1, ref2, _sig1 = ref[form, a]
    plastic = ref1[:, 6] > 0
    assert plastic.any() and (~plastic).any()
    _close_rows(xi1, ref1, STATE_RTOL)
    _close_rows(xi2, ref2, STATE_RTOL)


@pytest.mark.parametrize("form", ["rate", "total"])
def test_batched_hosford_branch_matches_jax(jax_reduced, form):
    """``make_batched_return_map(specialize=True)`` takes the reduced
    solve: its state and stress equal cmad_tpu's reduced solve's (the
    JAX package's batched map runs that solve with the same settings)."""
    g, ref = jax_reduced
    tp = parameters_from_numpy(_values(100.0), dtype=F64, device="cpu")
    step = make_batched_return_map(MODELS[form][1](tp), max_iters=40,
                                   specialize=True)
    xi, sig = step(torch.zeros(B, 7, dtype=F64), torch.tensor(g),
                   torch.zeros(B, 3, 3, dtype=F64), tp.values)
    ref1, _ref2, ref_sig = ref[form, 100.0]
    _close_rows(xi, ref1, STATE_RTOL)
    _close_rows(sig.reshape(B, 9), ref_sig.reshape(B, 9), STATE_RTOL)


def test_reduced_solve_gradcheck_and_gradgradcheck():
    """The implicit-function rules of the reduced solve, first and second
    order, in Y and along a strain direction, at a plastic point of the
    total form (the rate form's solve goes through the same rules)."""
    tp = parameters_from_numpy(_values(8.0), dtype=F64, device="cpu")
    solve = make_hosford_strain_solve(SmallElasticPlastic(tp), max_iters=40,
                                      abs_tol=1e-14, rel_tol=1e-14)
    g = _grads(1, seed=5, scale=4e-3)[0]
    g6 = torch.tensor([[g[0, 0], g[0, 1], g[0, 2], g[1, 1], g[1, 2],
                        g[2, 2]]], dtype=F64)
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
    assert torch.autograd.gradgradcheck(f, inputs, eps=1e-6, atol=1e-5)


@pytest.mark.parametrize("a_active", [True, False])
def test_deck_parameters_carry_the_hosford_leaf_in_cmad_tpu_order(a_active):
    """The deck's material with the Hosford exponent ``a`` active or not
    (and Y active): the flat order, names, sizes and active indices of
    ``cmad_tpu``'s ``ravel_pytree`` order, bit-equal values and canonical
    values."""
    from cmad_tpu.io.params_builder import (
        build_parameters as jax_build_parameters,
    )
    from cmad_tpu_torch.io.params_builder import build_parameters

    section = {
        "rotation matrix": np.eye(3).tolist(),
        "elastic": {"E": 1000.0, "nu": 0.25},
        "plastic": {
            "effective stress": {"hosford": {"a": {
                "value": 100.0, "active": a_active,
                "transform": {"bounds": [8.0, 200.0]}}}},
            "flow stress": {
                "initial yield": {"Y": {"value": 2.0, "active": True,
                                        "transform": {"log": 2.0}}},
                "hardening": {"voce": {"S": 10.0, "D": 2.0}}}}}
    jp = jax_build_parameters(section)
    tp = build_parameters(section, dtype=F64, device="cpu")
    assert tp._names == jp._names
    assert tp.flat_param_sizes == jp.flat_param_sizes
    np.testing.assert_array_equal(tp.active_idx, jp.active_idx)
    assert tp.num_active_params == jp.num_active_params == 1 + a_active
    np.testing.assert_array_equal(tp.flat_active_values(),
                                  jp.flat_active_values())
    np.testing.assert_allclose(tp.flat_active_values(True),
                               jp.flat_active_values(True), rtol=1e-15)
    assert float(tp.values["plastic"]["effective stress"]["hosford"]["a"]) \
        == 100.0
