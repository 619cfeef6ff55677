"""cmad_tpu_torch's differentiable SoA step against cmad_tpu's.

``SoaStep`` carries the closed-form implicit linearization of the radial
return as a ``torch.autograd.Function`` (``jvp`` + ``backward``). These
tests hold it against the JAX ``custom_jvp`` rule of
``cmad_tpu.ops.j2_soa_ad.make_soa_step_ad(use_pallas=False)`` through
``jax.vjp`` / ``jax.jvp`` (rtol 1e-10: both rules evaluate the same
closed form, the reverse one transposed by hand here and by JAX there),
pin it with ``gradcheck`` / ``gradgradcheck`` in float64, and compare the
FE dispatch chain (pack, 8 steps, unpack) with the same chain in JAX.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.fem.xi_carrier import pack_xi as jax_pack_xi
from cmad_tpu.fem.xi_carrier import unpack_xi as jax_unpack_xi
from cmad_tpu.ops.j2_soa_ad import (
    consistent_tangent_rows as jax_tangent_rows,
    make_soa_step_ad as jax_make_soa_step_ad,
)
from cmad_tpu_torch.fem.xi_carrier import pack_xi, unpack_xi
from cmad_tpu_torch.ops.j2_radial_return import soa_step_scalars
from cmad_tpu_torch.ops.j2_soa_ad import (
    SoaStep,
    consistent_tangent_rows,
    make_soa_step_ad,
)

from tests.support.torch_port import assert_rows_close

torch.set_num_threads(1)

F64 = torch.float64
N = 64
SCALARS = np.array([200e3 / 2.6, 200e3 * 0.3 / (1.3 * 0.4), 200.0, 200.0,
                    20.0])  # mu, lambda of E = 200e3, nu = 0.3; Y, S, D


def _batch(n=N, seed=0, scale=0.4e-3):
    rng = np.random.default_rng(seed)
    xi = np.zeros((8, n))
    xi[:6] = rng.normal(0.0, 30.0, size=(6, n))
    xi[6] = np.abs(rng.normal(0.0, 0.005, size=n))
    de = np.zeros((8, n))
    de[:6] = rng.normal(0.0, scale, size=(6, n))
    return xi, de


def _t(a, grad=False):
    return torch.tensor(a, dtype=F64, requires_grad=grad)


@pytest.fixture(scope="module")
def data():
    xi, de = _batch()
    out = soa_step_scalars(_t(xi), _t(de), _t(SCALARS))
    frac = float((out[6] > _t(xi[6])).double().mean())
    assert 0.2 <= frac <= 0.8, frac
    return xi, de


def test_forward_equals_plain_step(data):
    xi, de = data
    out = make_soa_step_ad()(_t(xi), _t(de), _t(SCALARS))
    assert torch.equal(out, soa_step_scalars(_t(xi), _t(de), _t(SCALARS)))


@pytest.fixture(scope="module")
def vjps(data):
    xi, de = data
    ct = np.random.default_rng(1).normal(size=(8, N))
    _, pullback = jax.vjp(jax_make_soa_step_ad(use_pallas=False),
                          jnp.asarray(xi), jnp.asarray(de),
                          jnp.asarray(SCALARS))
    ref = pullback(jnp.asarray(ct))
    args = (_t(xi, True), _t(de, True), _t(SCALARS, True))
    out = SoaStep.apply(*args)
    got = torch.autograd.grad(out, args, grad_outputs=_t(ct))
    return ref, got


@pytest.mark.parametrize("arg", [0, 1, 2], ids=["xi", "de", "scalars"])
def test_vjp_matches_jax(vjps, arg):
    ref, got = vjps
    np.testing.assert_allclose(got[arg].numpy(), np.asarray(ref[arg]),
                               rtol=1e-10, atol=1e-10 * float(
                                   np.abs(np.asarray(ref[arg])).max()))


@pytest.mark.parametrize("which", ["xi", "de", "scalars", "all"])
def test_jvp_matches_jax(data, which):
    xi, de = data
    rng = np.random.default_rng(2)
    tangents = [np.zeros((8, N)), np.zeros((8, N)), np.zeros(5)]
    for i, name in enumerate(("xi", "de", "scalars")):
        if which in (name, "all"):
            tangents[i] = rng.normal(size=tangents[i].shape)
    primals = (xi, de, SCALARS)
    _, ref = jax.jvp(jax_make_soa_step_ad(use_pallas=False),
                     tuple(jnp.asarray(p) for p in primals),
                     tuple(jnp.asarray(t) for t in tangents))
    _, got = torch.func.jvp(SoaStep.apply,
                            tuple(_t(p) for p in primals),
                            tuple(_t(t) for t in tangents))
    assert_rows_close(got, ref, rtol=1e-10)


def _away_from_yield(n=16, seed=3):
    """Points whose trial state is at least 5% of Y from the yield
    surface, so the return map is smooth in a neighbourhood of each."""
    xi, de = _batch(n=256, seed=seed)
    mu, lam, Y, S, D = SCALARS
    tr = de[0] + de[3] + de[5]
    s = [xi[r] + 2.0 * mu * de[r] + (lam * tr if r in (0, 3, 5) else 0.0)
         for r in range(6)]
    p = (s[0] + s[3] + s[5]) / 3.0
    phi = np.sqrt(1.5 * ((s[0] - p) ** 2 + (s[3] - p) ** 2 + (s[5] - p) ** 2
                         + 2.0 * (s[1] ** 2 + s[2] ** 2 + s[4] ** 2)))
    f = phi - Y - S * (1.0 - np.exp(-D * xi[6]))
    far = np.abs(f) > 0.05 * Y
    pick = np.concatenate([np.flatnonzero(far & (f > 0))[:n // 2],
                           np.flatnonzero(far & (f < 0))[:n // 2]])
    assert pick.size == n
    return xi[:, pick], de[:, pick]


def _scaled_step():
    """SoaStep on O(1) inputs (state / 30, strain / 1e-3, scalars /
    their values) and O(1) outputs, so that finite differences with
    gradcheck's eps resolve every direction."""
    xs = torch.tensor([30.0] * 6 + [1e-3, 1.0], dtype=F64)[:, None]
    ds = torch.tensor([1e-3] * 6 + [1.0, 1.0], dtype=F64)[:, None]
    ss = _t(SCALARS)

    def f(xi_n, de_n, sc_n):
        return SoaStep.apply(xi_n * xs, de_n * ds, sc_n * ss) / xs
    return f, xs, ds, ss


@pytest.mark.parametrize("order", ["gradcheck", "gradgradcheck"])
def test_gradcheck_away_from_yield(order):
    xi, de = _away_from_yield()
    f, xs, ds, _ss = _scaled_step()
    args = (_t(xi / xs.numpy(), True), _t(de / ds.numpy(), True),
            _t(np.ones(5), True))
    if order == "gradcheck":
        assert torch.autograd.gradcheck(f, args, check_forward_ad=True)
    else:
        assert torch.autograd.gradgradcheck(f, args)


def test_backward_matches_autograd_through_plain_step(data):
    """The closed-form rule equals autograd through the 8 unrolled
    Newton iterations (converged to roundoff in f64)."""
    xi, de = data
    w = _t(np.random.default_rng(4).normal(size=(8, N)))
    a = (_t(xi, True), _t(de, True), _t(SCALARS, True))
    b = (_t(xi, True), _t(de, True), _t(SCALARS, True))
    ga = torch.autograd.grad((w * SoaStep.apply(*a)).sum(), a)
    gb = torch.autograd.grad((w * soa_step_scalars(*b)).sum(), b)
    for x, y in zip(ga, gb, strict=True):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-9,
                                   atol=1e-9 * float(y.abs().max()))


def test_consistent_tangent_rows_match_jax(data):
    xi, de = data
    out = soa_step_scalars(_t(xi), _t(de), _t(SCALARS))
    A, c, d = consistent_tangent_rows(out, _t(xi[6]), _t(SCALARS))
    jA, jc, jd = jax_tangent_rows(jnp.asarray(out.numpy()),
                                  jnp.asarray(xi[6]), jnp.asarray(SCALARS))
    assert float((c != 0).double().mean()) > 0.2
    assert_rows_close(torch.stack([A, c, *d]),
                      np.stack([jA, jc, *[np.asarray(r) for r in jd]]))


E, Q = 8, 8


def _fe_chain(xi_aos, de, sc, step, pack, unpack):
    xc = pack(xi_aos)
    for _ in range(8):
        xc = step(xc, de, sc)
    return unpack(xc, E, Q)


def test_fe_chain_value_and_grad_match_jax():
    """pack_xi -> 8 chained steps -> unpack_xi: the value, and the
    gradient of a weighted sum with respect to the strain increment and
    the material scalars."""
    rng = np.random.default_rng(5)
    xi_aos = np.zeros((E, Q, 7))
    xi_aos[..., :6] = rng.normal(0.0, 30.0, size=(E, Q, 6))
    de = np.zeros((8, E * Q))
    de[:6] = rng.normal(0.0, 6e-5, size=(6, E * Q))
    w = rng.normal(size=(E, Q, 7))
    jstep = jax_make_soa_step_ad(use_pallas=False)

    def jloss(de_, sc_):
        out = _fe_chain(jnp.asarray(xi_aos), de_, sc_, jstep, jax_pack_xi,
                        jax_unpack_xi)
        return jnp.sum(jnp.asarray(w) * out), out

    (jval, jout), (jg_de, jg_sc) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jnp.asarray(de),
                                             jnp.asarray(SCALARS))
    de_t, sc_t = _t(de, True), _t(SCALARS, True)
    out = _fe_chain(_t(xi_aos), de_t, sc_t, make_soa_step_ad(), pack_xi,
                    unpack_xi)
    val = (_t(w) * out).sum()
    g_de, g_sc = torch.autograd.grad(val, (de_t, sc_t))

    frac = float((out[..., 6] > 0).double().mean())
    assert 0.2 <= frac <= 0.8, frac
    assert out.shape == (E, Q, 7)
    assert_rows_close(out.reshape(-1, 7).T, np.asarray(jout).reshape(-1, 7).T)
    np.testing.assert_allclose(float(val), float(jval), rtol=1e-12)
    np.testing.assert_allclose(g_de.numpy(), np.asarray(jg_de), rtol=1e-10,
                               atol=1e-10 * float(np.abs(jg_de).max()))
    np.testing.assert_allclose(g_sc.numpy(), np.asarray(jg_sc), rtol=1e-10)


def test_xi_carrier_round_trip_matches_jax():
    xi_aos = np.random.default_rng(6).normal(size=(5, 4, 7))
    packed = pack_xi(_t(xi_aos))
    np.testing.assert_array_equal(packed.numpy(),
                                  np.asarray(jax_pack_xi(xi_aos)))
    np.testing.assert_array_equal(unpack_xi(packed, 5, 4).numpy(), xi_aos)
