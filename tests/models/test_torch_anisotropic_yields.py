"""cmad_tpu_torch's anisotropic effective stresses (Hill-1948, Barlat
Yld2004-18p, principal Hosford) against cmad_tpu's, on the CPU in
float64.

The same numpy stresses go through both packages: a random batch, then
exact degeneracies (a uniaxial and an equal-biaxial stress, integer
repeated pairs whose Cardano argument is exactly +-1, a spherical and a
zero stress). Bounds:

- values and gradients (``torch.func.grad`` against ``jax.grad``) 1e-12
  of each output's scale. The operations are the same but for the
  eigenvalues' determinant (the port's closed form, JAX's LU). The
  zero and spherical stresses go through principal Hosford only: Hill's
  and Barlat's sqrt and ``0 ** (1/a)`` have no derivative there, in
  either package;
- the derivative rules at the degeneracies agree with JAX's: ``abs`` at
  a zero difference (0 here, 1 in JAX) multiplies the derivative of a
  zero power, and the eigenvalues' clamp splits a tie in halves in both;
- principal Hosford equals the diagonal form on diagonal stresses, 1e-12
  relative (1e-10 where two diagonals are equal: the eigenvalues' clamp
  splits the pair by about p sqrt(margin)), and is frame invariant, 1e-12
  relative; Barlat with every coefficient 1 is
  principal Hosford (both transforms are the deviator), 1e-12 relative;
- ``gradgradcheck`` of each yield at generic stresses.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation

from cmad_tpu.models.effective_stress import (
    conventional_effective_stress_fun as jax_effective_stress_fun,
)
from cmad_tpu_torch.models.effective_stress import (
    barlat_effective_stress,
    conventional_effective_stress_fun,
    hill_effective_stress,
    hosford_effective_stress,
    hosford_principal_effective_stress,
)

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-12
PAIR_RTOL = 1e-10

HILL = {"F": 0.45, "G": 0.55, "H": 0.5, "L": 1.4, "M": 1.7, "N": 1.55}
BARLAT_KEYS = ("sp_12", "sp_13", "sp_21", "sp_23", "sp_31", "sp_32",
               "sp_44", "sp_55", "sp_66",
               "dp_12", "dp_13", "dp_21", "dp_23", "dp_31", "dp_32",
               "dp_44", "dp_55", "dp_66", "a")
# ``tests/models/test_yield_gradients.py``'s coefficients
BARLAT = dict(zip(BARLAT_KEYS,
                  (0.9, 1.1, 1.05, 0.95, 1.2, 0.8, 1.0, 1.1, 0.9,
                   1.1, 0.9, 0.95, 1.05, 0.85, 1.15, 1.0, 0.9, 1.1, 8.0),
                  strict=True))
CASES = {
    "hill": {"hill": HILL},
    "barlat": {"barlat": BARLAT},
    "principal-2": {"hosford_principal": {"a": 2.0}},
    "principal-8": {"hosford_principal": {"a": 8.0}},
    "principal-100": {"hosford_principal": {"a": 100.0}},
}
N_RANDOM = 12


def _stresses():
    rng = np.random.default_rng(3)
    s = rng.normal(0.0, 100.0, size=(N_RANDOM, 3, 3))
    s = 0.5 * (s + np.transpose(s, (0, 2, 1)))
    ones = np.ones((3, 3)) - np.eye(3)
    degenerate = [np.diag([150.0, 0.0, 0.0]), np.diag([100.0, 100.0, 0.0]),
                  20.0 * (2.0 * np.eye(3) + ones),     # 80, 20, 20
                  20.0 * (2.0 * np.eye(3) - ones),     # 60, 60, 0
                  30.0 * np.eye(3), np.zeros((3, 3))]
    return np.concatenate([s, np.stack(degenerate)])


def _torch_section(section):
    return {name: {k: torch.tensor(v, dtype=F64) for k, v in c.items()}
            for name, c in section.items()}


def _reference(case):
    """cmad_tpu's values and gradients on the stresses (the last two, the
    spherical and the zero stress, only for principal Hosford)."""
    section = CASES[case]
    name = next(iter(section))
    fun = jax_effective_stress_fun(name)

    def phi(s):
        return fun(s, {"effective stress": section})

    both = jax.jit(jax.vmap(jax.value_and_grad(phi)))
    return tuple(np.asarray(v) for v in both(jnp.asarray(_stresses())))


def _port(case, sig):
    section = CASES[case]
    fun = conventional_effective_stress_fun(next(iter(section)))
    plastic = {"effective stress": _torch_section(section)}

    def phi(s):
        return fun(s, plastic)

    s = torch.tensor(sig, dtype=F64)
    return (phi(s), torch.func.vmap(torch.func.grad(phi))(s))


def _close(got, ref, rtol=RTOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    scale = max(float(np.abs(ref).max()), 1.0)
    assert float(np.abs(got - ref).max()) <= rtol * scale


def test_dispatch_table_holds_every_conventional_form():
    assert conventional_effective_stress_fun("hill") is hill_effective_stress
    assert conventional_effective_stress_fun("barlat") \
        is barlat_effective_stress
    assert conventional_effective_stress_fun("hosford_principal") \
        is hosford_principal_effective_stress


@pytest.mark.parametrize("case", sorted(CASES))
def test_values_and_gradients_match_jax(case):
    phi_ref, grad_ref = _reference(case)
    phi, grad = _port(case, _stresses())
    keep = slice(None) if case.startswith("principal") else slice(0, -2)
    assert torch.isfinite(grad[keep]).all()
    _close(phi[keep], phi_ref[keep])
    _close(grad[keep], grad_ref[keep])
    if case.startswith("principal"):
        # the zero stress: phi 0 and every derivative 0, in both
        assert float(phi[-1]) == 0.0 and not grad[-1].any()
        # the spherical stress: the derivative of the differences only
        assert float(grad[-2].abs().max()) == 0.0


def test_principal_is_the_diagonal_form_on_diagonal_states():
    rng = np.random.default_rng(11)
    d = rng.normal(0.0, 100.0, size=(16, 3))
    d[:4, 1] = d[:4, 0]                        # equal diagonals
    sig = torch.diag_embed(torch.tensor(d, dtype=F64))
    for a in (2.0, 8.0, 100.0):
        at = torch.tensor(a, dtype=F64)
        p = hosford_principal_effective_stress(
            sig, {"effective stress": {"hosford_principal": {"a": at}}})
        q = hosford_effective_stress(
            sig, {"effective stress": {"hosford": {"a": at}}})
        err = ((p - q).abs() / q.abs())
        assert float(err[4:].max()) <= RTOL
        # equal diagonals: the clamp moves the pair by p sqrt(margin)
        # (measured 3.6e-12 at a = 2)
        assert float(err[:4].max()) <= PAIR_RTOL


def test_principal_is_frame_invariant_and_barlat_reduces_to_it():
    sig = torch.tensor(_stresses()[:N_RANDOM], dtype=F64)
    R = torch.tensor(Rotation.random(N_RANDOM, random_state=5).as_matrix(),
                     dtype=F64)
    ones = {k: torch.tensor(1.0, dtype=F64) for k in BARLAT_KEYS}
    for a in (2.0, 8.0, 100.0):
        plastic = {"effective stress": {"hosford_principal": {
            "a": torch.tensor(a, dtype=F64)}}}
        phi = hosford_principal_effective_stress(sig, plastic)
        turned = hosford_principal_effective_stress(R @ sig @ R.mT, plastic)
        assert float(((turned - phi).abs() / phi).max()) <= RTOL
        iso = barlat_effective_stress(sig, {"effective stress": {
            "barlat": {**ones, "a": torch.tensor(a, dtype=F64)}}})
        assert float(((iso - phi).abs() / phi).max()) <= RTOL


def test_gradients_finite_at_exact_degeneracies():
    """Rotated repeated pairs (the Cardano argument a rounding away from
    +-1) and, for Barlat with every coefficient 1, zero differences of
    the two transforms' eigenvalues."""
    R = Rotation.random(3, random_state=2).as_matrix()
    pairs = np.stack([r @ np.diag(v) @ r.T for r, v in zip(
        R, ([2.0, 2.0, -1.0], [5.0, -1.0, -1.0], [3.0, 3.0, 0.0]),
        strict=True)]) * 40.0
    sig = torch.tensor(np.concatenate([pairs, _stresses()[N_RANDOM:-2]]),
                       dtype=F64)
    ones = {k: torch.tensor(1.0, dtype=F64) for k in BARLAT_KEYS}
    sections = [_torch_section(CASES[c]) for c in sorted(CASES)]
    sections.append({"barlat": {**ones, "a": torch.tensor(8.0, dtype=F64)}})
    for section in sections:
        fun = conventional_effective_stress_fun(next(iter(section)))
        plastic = {"effective stress": section}
        grad = torch.func.vmap(torch.func.grad(
            lambda s, fun=fun, plastic=plastic: fun(s, plastic)))(sig)
        assert torch.isfinite(grad).all(), next(iter(section))


@pytest.mark.parametrize("case", ["hill", "barlat", "principal-8"])
def test_gradgradcheck(case):
    section = _torch_section(CASES[case])
    fun = conventional_effective_stress_fun(next(iter(section)))
    s = torch.tensor(_stresses()[:2] / 100.0, dtype=F64, requires_grad=True)

    def f(x):
        return fun(0.5 * (x + x.mT), {"effective stress": section})

    assert torch.autograd.gradcheck(f, (s,))
    assert torch.autograd.gradgradcheck(f, (s,))
