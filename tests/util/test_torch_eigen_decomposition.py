"""cmad_tpu_torch's closed-form symmetric 3x3 eigendecomposition
(``util/eigen_decomposition.py``) against cmad_tpu's
(``util/jax_eigen_decomposition.py``), on the CPU in float64.

The same numpy matrices go through both packages: a random batch, then
spherical states (the zero matrix and multiples of I) and exact repeated
pairs (integer matrices whose Cardano argument is exactly +-1, so both
packages clamp it to the same margin). Bounds:

- eigenvalues 1e-13 of each matrix's largest eigenvalue magnitude: the
  same operations but the determinant (the port's closed form, JAX's
  LU), which rounds differently; at a repeated pair both packages split
  the pair by about p sqrt(margin) (the clamp), 1e-5 absolute from the
  exact spectrum;
- on the random batch the eigenvectors equal cmad_tpu's to 1e-10, are
  orthonormal and right-handed and rebuild A to 1e-12 (at a degenerate
  state both packages fall back onto coordinate axes, which need not
  make a frame); the sorted
  order is ascending and pairs each eigenvalue with its vector;
- the gradient of a weighted sum of the eigenvalues against
  ``jax.grad``'s, 1e-12 of its scale, at the generic and the degenerate
  states (the clamp holds the derivative through ``r`` at 0 in both; the
  double ``where`` leaves the spherical states only the mean's
  derivative); and
  ``gradgradcheck`` at generic states.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch

from cmad_tpu.util.jax_eigen_decomposition import (
    compute_eigenvalues as jax_eigenvalues,
)
from cmad_tpu_torch.util.eigen_decomposition import (
    compute_deviator_eigenvalues,
    compute_eigen_decomposition,
    compute_eigenvalues,
    sorted_eigen_decomposition,
)

torch.set_num_threads(1)

F64 = torch.float64
EIG_RTOL = 1e-13
GRAD_RTOL = 1e-12
WEIGHTS = np.array([0.7, -1.3, 2.1])


def _random(n, seed):
    rng = np.random.default_rng(seed)
    A = rng.normal(0.0, 50.0, size=(n, 3, 3))
    return 0.5 * (A + np.transpose(A, (0, 2, 1)))


def _degenerate():
    """Spherical states and exact repeated pairs (integer arithmetic
    throughout: trace/3, J2 and det are exact, r = +-1)."""
    ones = np.ones((3, 3)) - np.eye(3)
    return np.stack([
        np.zeros((3, 3)), 3.0 * np.eye(3), -8.0 * np.eye(3),
        np.diag([2.0, 2.0, -1.0]), np.diag([-1.0, 2.0, 2.0]),
        np.diag([5.0, -4.0, 5.0]),
        2.0 * np.eye(3) + ones,          # eigenvalues 4, 1, 1
        2.0 * np.eye(3) - ones,          # eigenvalues 3, 3, 0
        4.0 * (np.eye(3) + ones),        # eigenvalues 12, 0, 0
    ])


def _matrices():
    return np.concatenate([_random(32, 0), _degenerate()])


def test_eigenvalues_match_cmad_tpu():
    A = _matrices()
    ref = np.asarray(jax_eigenvalues(jnp.asarray(A)))
    got = compute_eigenvalues(torch.tensor(A, dtype=F64)).numpy()
    scale = np.maximum(np.abs(ref).max(axis=-1, keepdims=True), 1.0)
    assert (np.abs(got - ref) / scale).max() <= EIG_RTOL
    # descending, and the known spectra of the degenerate states, to
    # the error of the clamp's margin: a pair splits by about
    # p sqrt(margin) (2.7e-7 of the scale at 12, 0, 0)
    assert (np.diff(got, axis=-1) <= 1e-12).all()
    np.testing.assert_allclose(
        got[32:], [[0, 0, 0], [3, 3, 3], [-8, -8, -8], [2, 2, -1],
                   [2, 2, -1], [5, 5, -4], [4, 1, 1], [3, 3, 0],
                   [12, 0, 0]], atol=1e-5)
    # the deviator's eigenvalues are traceless and shift-free
    dev = compute_deviator_eigenvalues(torch.tensor(A, dtype=F64))
    np.testing.assert_allclose(dev.sum(-1).numpy(), 0.0, atol=1e-11)


def test_decomposition_reconstructs_and_sorts():
    """On the random batch the vectors are cmad_tpu's, orthonormal and
    right-handed, and the pairs rebuild A. At the degenerate states the
    coordinate-axis fallback of both packages gives no frame to hold (it
    can be parallel to the other vector); they stay finite."""
    from cmad_tpu.util.jax_eigen_decomposition import (
        compute_eigen_decomposition as jax_decomposition,
    )

    A_np = _matrices()
    A = torch.tensor(A_np, dtype=F64)
    eigs, V = compute_eigen_decomposition(A)
    _ref_eigs, ref_V = jax_decomposition(jnp.asarray(A_np))
    assert np.abs(V.numpy() - np.asarray(ref_V))[:32].max() <= 1e-10
    assert torch.isfinite(V).all()
    V32 = V[:32]
    eye = torch.eye(3, dtype=F64)
    assert float((V32.mT @ V32 - eye).abs().max()) <= 1e-12
    assert float((torch.linalg.det(V32) - 1.0).abs().max()) <= 1e-12
    rebuilt = V @ torch.diag_embed(eigs) @ V.mT
    scale = A.abs().amax(dim=(-2, -1), keepdim=True).clamp_min(1.0)
    assert float(((rebuilt - A).abs() / scale)[:32].max()) <= 1e-12

    s_eigs, s_V = sorted_eigen_decomposition(A)
    assert (s_eigs.diff(dim=-1) >= 0).all()
    np.testing.assert_array_equal(s_eigs.numpy(), np.sort(eigs.numpy(), -1))
    # each sorted pair is still an eigen-pair
    resid = A @ s_V - s_V * s_eigs[..., None, :]
    assert float((resid.abs() / scale)[:32].max()) <= 1e-12


def test_gradients_match_jax_grad():
    A = _matrices()

    def jax_f(a):
        return jnp.dot(jax_eigenvalues(a), jnp.asarray(WEIGHTS))

    ref = np.asarray(jax.jit(jax.vmap(jax.grad(jax_f)))(jnp.asarray(A)))
    At = torch.tensor(A, dtype=F64, requires_grad=True)
    w = torch.tensor(WEIGHTS, dtype=F64)
    got = torch.autograd.grad((compute_eigenvalues(At) @ w).sum(), At)[0]
    got = got.numpy()
    assert np.isfinite(got).all()
    scale = np.maximum(np.abs(ref).max(axis=(-2, -1), keepdims=True), 1.0)
    assert (np.abs(got - ref) / scale).max() <= GRAD_RTOL
    # the spherical states: only the mean moves, sum(w) / 3 I, in both
    mean = WEIGHTS.sum() / 3.0 * np.eye(3)
    np.testing.assert_allclose(got[32:35], np.broadcast_to(mean, (3, 3, 3)),
                               rtol=1e-15)
    np.testing.assert_allclose(ref[32:35], got[32:35], rtol=1e-15)


def test_second_derivatives_gradgradcheck():
    A = torch.tensor(_random(3, 1) / 50.0, dtype=F64, requires_grad=True)
    w = torch.tensor(WEIGHTS, dtype=F64)

    def f(a):
        return compute_eigenvalues(0.5 * (a + a.mT)) @ w

    assert torch.autograd.gradcheck(f, (A,))
    assert torch.autograd.gradgradcheck(f, (A,))
