"""cmad_tpu_torch's batched implicit-function Newton against cmad_tpu's.

The same numpy inputs (``numpy.random.default_rng``) go through the JAX
package's ``vmap`` of its ``while_loop`` Newton and through the port's
explicitly batched Newton, in float64, on the rate-form J2+Voce model.
Tolerances: states 1e-10 absolute (both converge to the model's
1e-14 relative Newton tolerance; the per-point linear solves differ in
rounding), gradients rtol 1e-8 (the implicit-function rule on both
sides, differing by the same rounding).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.models.global_fields import GlobalFieldsAtPoint as JaxU
from cmad_tpu.models.nonlinear_solver import (
    make_newton_solve_with_stats as jax_with_stats,
)
from cmad_tpu.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic as JaxRate,
)
from cmad_tpu.ops.return_map import (
    make_batched_return_map as jax_batched_return_map,
)
from cmad_tpu.parameters.parameters import Parameters as JaxParameters
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.nonlinear_solver import (
    batched_newton_solve,
    make_newton_solve,
    make_newton_solve_with_stats,
    newton_solve,
)
from cmad_tpu_torch.models.small_rate_elastic_plastic import (
    SmallRateElasticPlastic,
)
from cmad_tpu_torch.ops.return_map import make_batched_return_map
from cmad_tpu_torch.parameters.parameters import Parameters

torch.set_num_threads(1)

F64 = torch.float64
B = 64
VALUES = {
    "rotation matrix": np.eye(3),
    "elastic": {"E": 200e3, "nu": 0.3},
    "plastic": {
        "effective stress": {"J2": 0.0},
        "flow stress": {"initial yield": {"Y": 200.0},
                        "hardening": {"voce": {"S": 200.0, "D": 20.0}}}}}
# E, Y, S, D active: the flat active order is [E, D, S, Y]
FLAGS = {
    "rotation matrix": False, "elastic": {"E": True, "nu": False},
    "plastic": {"effective stress": {"J2": False},
                "flow stress": {"initial yield": {"Y": True},
                                "hardening": {"voce": {"S": True,
                                                       "D": True}}}}}
TRANSFORMS = jax.tree.map(lambda _: None, FLAGS)


@pytest.fixture(scope="module")
def models():
    jp = JaxParameters(VALUES, FLAGS, TRANSFORMS)
    tp = Parameters(VALUES, FLAGS, TRANSFORMS, dtype=F64, device="cpu")
    return (JaxRate(jp), jp), (SmallRateElasticPlastic(tp), tp)


def _increments(n, seed, scale=1.5e-3):
    rng = np.random.default_rng(seed)
    eps = rng.normal(0.0, scale, size=(n, 3, 3))
    return 0.5 * (eps + np.transpose(eps, (0, 2, 1)))


def _torch_U(g):
    g = torch.as_tensor(g, dtype=F64)
    return GlobalFieldsAtPoint({"u": g.new_zeros(g.shape[:-1])},
                               {"u": g})


def _jax_U(g):
    g = jnp.asarray(g)
    return JaxU({"u": jnp.zeros(g.shape[:-1])}, {"u": g})


def _batch():
    """A mixed elastic/plastic batch from rest with a point that is
    converged at the guess (0 iterations) and an elastic one (1)."""
    g = _increments(B, seed=0)
    g[0] = 0.0
    g[1] *= 0.05
    return np.zeros((B, 7)), g


@pytest.fixture(scope="module")
def jax_solve(models):
    """The JAX package's Newton vmapped over the batch: its
    ``while_loop`` runs until every lane is done, each lane keeping its
    carry once converged. (state, iterations) per point."""
    (jm, jp), _ = models
    xi0, g = _batch()
    stats = jax_with_stats(jm.residual_fun)
    x, iters, _ = jax.vmap(
        lambda x, gk: stats(x, x, jp.values, _jax_U(gk),
                            _jax_U(jnp.zeros((3, 3)))))(
        jnp.asarray(xi0), jnp.asarray(g))
    return np.asarray(x), np.asarray(iters)


def test_batched_newton_matches_jax(models, jax_solve):
    """The generic batched Newton on a mixed elastic/plastic batch from
    rest, against the JAX package's vmapped Newton."""
    _, (tm, tp) = models
    xi0, g = _batch()
    ref, _ = jax_solve
    x0 = torch.tensor(xi0)
    out = batched_newton_solve(
        tm.residual_fun, x0, x0, tp.values, _torch_U(g),
        _torch_U(np.zeros_like(g)), in_axes=(0, None, 0, 0))
    frac = float(np.mean(ref[:, 6] > 0))
    assert 0.3 < frac < 1.0
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-10)


def test_each_point_stops_at_its_own_convergence(models, jax_solve):
    """Points that need 0, 1 and several iterations in one batch: each
    gets the state and iteration count of its own unbatched solve, and
    the counts are those of the JAX package's vmapped ``while_loop``."""
    _, (tm, tp) = models
    xi0, g = _batch()
    _, ref_iters = jax_solve
    x0 = torch.tensor(xi0)
    stats = make_newton_solve_with_stats(tm.residual_fun,
                                         in_dims=(0, None, 0, 0))
    xb, itb, _ = stats(x0, x0, tp.values, _torch_U(g),
                       _torch_U(np.zeros_like(g)))
    np.testing.assert_array_equal(itb.numpy(), ref_iters)
    counts = set(itb.tolist())
    assert {0, 1} <= counts and max(counts) >= 3

    single = make_newton_solve_with_stats(tm.residual_fun)
    for k in range(6):
        xk, itk, _ = single(x0[k], x0[k], tp.values, _torch_U(g[k]),
                            _torch_U(np.zeros_like(g[k])))
        assert int(itk) == int(itb[k])
        np.testing.assert_allclose(xk.numpy(), xb[k].numpy(), rtol=0,
                                   atol=1e-12)


@pytest.fixture(scope="module")
def gradients(models):
    """Gradients of a weighted sum of sigma with respect to the active
    (E, Y, S, D), through the generic return map: JAX's ``jax.grad``
    and the port's backward, on one batch without and one with a
    zero-stress point (xi_prev = 0, zero strain)."""
    (jm, jp), (tm, tp) = models
    rng = np.random.default_rng(2)
    g = _increments(16, seed=3)
    w = rng.normal(size=(16, 3, 3))
    a0 = jp.flat_active_values()
    jstep = jax_batched_return_map(jm)
    tstep = make_batched_return_map(tm)
    out = {}
    g_zero = g.copy()
    g_zero[0] = 0.0
    n = g.shape[0]
    for label, gg in (("mixed", g), ("zero stress", g_zero)):
        ww = w

        def jloss(a, gg=gg, ww=ww):
            _, s = jstep(jnp.zeros((n, 7)), jnp.asarray(gg),
                         jnp.zeros((n, 3, 3)), jp.tree_with_flat_active(a))
            return jnp.sum(jnp.asarray(ww) * s)

        ref = np.asarray(jax.grad(jloss)(jnp.asarray(a0)))
        a = torch.tensor(a0, requires_grad=True)
        _, s = tstep(torch.zeros((n, 7), dtype=F64), torch.tensor(gg),
                     torch.zeros((n, 3, 3), dtype=F64),
                     tp.tree_with_flat_active(a))
        got = torch.autograd.grad((torch.tensor(ww) * s).sum(), a)[0]
        out[label] = (got.numpy(), ref)
    return out


def test_gradient_matches_jax_grad(gradients):
    got, ref = gradients["mixed"]
    assert np.all(np.isfinite(ref))
    np.testing.assert_allclose(got, ref, rtol=1e-8)


def test_gradient_at_zero_stress_matches_jax_grad(gradients):
    """At a zero-stress elastic point the yield normal is 0/0 in the
    primal; the unselected plastic branch then carries 0 * NaN into the
    reverse pass, and both packages give NaN for d/dE (ROADMAP section 3
    records this hazard of the reference). The other entries agree."""
    got, ref = gradients["zero stress"]
    np.testing.assert_array_equal(np.isnan(got), np.isnan(ref))
    assert np.isnan(ref[0]) and np.all(np.isfinite(ref[1:]))
    np.testing.assert_allclose(got[1:], ref[1:], rtol=1e-8)


def _solve_fn(tm):
    """(Y, S, D, grad_u) -> x*: the implicit-function solve with its
    inputs as leaves of the params dict and of U."""
    solve = make_newton_solve(tm.residual_fun, in_dims=(0, None, 0, 0))
    base = tm.parameters.values

    def fn(Y, S, D, g):
        params = {"rotation matrix": base["rotation matrix"],
                  "elastic": base["elastic"],
                  "plastic": {"effective stress": {"J2": 0.0},
                              "flow stress": {
                                  "initial yield": {"Y": Y},
                                  "hardening": {"voce": {"S": S, "D": D}}}}}
        x0 = torch.zeros((g.shape[0], 7), dtype=F64)
        return solve(x0, x0, params, GlobalFieldsAtPoint(
            {"u": g.new_zeros((g.shape[0], 3))}, {"u": g}),
            _torch_U(np.zeros((g.shape[0], 3, 3))))
    return fn


def _gradcheck_inputs(requires_grad=True):
    """Y, S, D and the displacement gradients of one plastic and one
    elastic point."""
    g = torch.tensor(np.stack([_increments(1, seed=4, scale=3e-3)[0],
                               _increments(1, seed=5, scale=1e-4)[0]]),
                     requires_grad=requires_grad)
    return (*(torch.tensor(v, dtype=F64, requires_grad=requires_grad)
              for v in (200.0, 200.0, 20.0)), g)


@pytest.mark.parametrize("order", ["gradcheck", "gradgradcheck"])
def test_implicit_rule_passes_gradcheck(models, order):
    """The autograd.Function's backward against finite differences;
    gradgradcheck differentiates the backward once more. ``fast_mode``
    checks a random projection of each Jacobian: every input and output
    still enters the check."""
    _, (tm, _tp) = models
    inputs = _gradcheck_inputs()
    fn = _solve_fn(tm)
    alpha = fn(*inputs).detach()[:, 6]
    assert alpha[0] > 0 and alpha[1] == 0
    check = getattr(torch.autograd, order)
    assert check(fn, inputs, fast_mode=True)


def test_implicit_rule_jvp_is_the_transpose_of_backward(models):
    """The forward rule under ``torch.func.jvp``: <w, J v> from the jvp
    equals <J^T w, v> from the backward, for a random direction v."""
    _, (tm, _tp) = models
    rng = np.random.default_rng(7)
    fn = _solve_fn(tm)
    primals = _gradcheck_inputs(requires_grad=False)
    tangents = tuple(torch.tensor(rng.normal(size=t.shape) * 1e-3 * (
        float(t.abs().max()) or 1.0)) for t in primals)
    out, jv = torch.func.jvp(fn, primals, tangents)
    w = torch.tensor(rng.normal(size=out.shape))
    ins = [t.clone().requires_grad_(True) for t in primals]
    grads = torch.autograd.grad((w * fn(*ins)).sum(), ins)
    lhs = float((w * jv).sum())
    rhs = float(sum((g * v).sum() for g, v in zip(grads, tangents)))
    assert lhs == pytest.approx(rhs, rel=1e-10)


def test_host_newton_solve_matches_batched(models):
    """The imperative host loop (``newton_solve``) lands on the batched
    solve's state for one plastic point."""
    _, (tm, tp) = models
    g = _increments(1, seed=6, scale=3e-3)[0]
    x0 = torch.zeros(7, dtype=F64)
    U, U0 = _torch_U(g), _torch_U(np.zeros((3, 3)))
    xi, iters, norm = newton_solve(tm, x0, x0, tp.values, U, U0)
    ref = make_newton_solve(tm.residual_fun)(x0, x0, tp.values, U, U0)
    assert 1 <= iters <= 10 and norm < 1e-10
    np.testing.assert_allclose(xi.numpy(), ref.numpy(), rtol=0, atol=1e-10)
