"""Closed-form symmetric 3x3 eigendecomposition, differentiable and
batched over leading dimensions.

Port of ``cmad_tpu/util/jax_eigen_decomposition.py`` (parity: reference
``cmad/util/jax_eigen_decomposition.py:86-171``): the deviator-based
trigonometric (Cardano) solution, with the same guards:

- a double ``where`` around the sqrt at J2 = 0 (a spherical state): the
  sqrt never sees 0, so neither reverse nor forward mode meets its
  infinite derivative, and the eigenvalues fall back onto the spherical
  solution;
- the cosine argument ``r`` held inside ``[-1 + margin, 1 - margin]``
  with a dtype-scaled margin (``max(1e-12, 8 eps)``: a fixed 1e-12 is
  below float32's eps and rounds away), so the acos derivative stays
  finite at a repeated pair. The bounds are ``torch.maximum`` and
  ``torch.minimum``, as JAX's ``clip`` is: at ``r`` exactly on a bound
  both packages split the derivative in halves (``torch.clamp`` would
  pass all of it).

The determinant is the closed form ``ops/linalg.det3`` (the JAX package
took an LU ``det``): no LU, safe under forward AD and ``vmap``, and it
can be captured in a CUDA graph. The two round differently, so near a
repeated pair, where the Cardano form amplifies a rounding of ``r`` by
``1/sqrt(1 - r^2)``, the packages' eigenvalues can differ by more than
their rounding; at an exact pair that lands on the margin they agree.
"""
from __future__ import annotations

import math

import torch

from cmad_tpu_torch.ops.linalg import det3
from cmad_tpu_torch.typing import Tensor

_TINY = 1e-30


def _eye(A: Tensor) -> Tensor:
    return torch.eye(3, dtype=A.dtype, device=A.device)


def _trace(A: Tensor) -> Tensor:
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)


def compute_deviator_eigenvalues(A: Tensor) -> Tensor:
    """Eigenvalues of dev(A) for symmetric ``A (..., 3, 3)``; returns
    ``(..., 3)`` in descending order."""
    q = _trace(A)[..., None, None] / 3.0
    B = A - q * _eye(A)
    # p^2 = tr(B^2)/6; theta from the normalized determinant
    J2 = torch.sum(B * B, dim=(-2, -1)) / 6.0
    nonzero = J2 > _TINY
    p_raw = torch.sqrt(torch.where(nonzero, J2, 1.0))
    p = torch.where(nonzero, p_raw, 0.0)
    safe_p = torch.where(nonzero, p_raw, 1.0)
    r = det3(B) / (2.0 * safe_p**3)
    margin = max(1e-12, 8.0 * torch.finfo(A.dtype).eps)
    lo = torch.full_like(r, -1.0 + margin)
    hi = torch.full_like(r, 1.0 - margin)
    r = torch.minimum(hi, torch.maximum(lo, r))
    theta = torch.acos(r) / 3.0

    two_pi_3 = 2.0 * math.pi / 3.0
    e1 = 2.0 * safe_p * torch.cos(theta)
    e2 = 2.0 * safe_p * torch.cos(theta - two_pi_3)
    e3 = 2.0 * safe_p * torch.cos(theta + two_pi_3)
    eigs = torch.stack([e1, e2, e3], dim=-1)
    return torch.where(p[..., None] > _TINY, eigs, torch.zeros_like(eigs))


def compute_eigenvalues(A: Tensor) -> Tensor:
    """Eigenvalues of symmetric ``A (..., 3, 3)`` -> ``(..., 3)``
    (descending)."""
    return compute_deviator_eigenvalues(A) + (_trace(A) / 3.0)[..., None]


def compute_eigen_decomposition(A: Tensor) -> tuple[Tensor, Tensor]:
    """Eigen-pairs of symmetric ``A (..., 3, 3)``: ``(eigenvalues (..., 3)
    descending, eigenvectors (..., 3, 3) in columns)``.

    Each of the first two eigenvectors is the largest column of its
    Cayley-Hamilton projector ``P_i = prod_{j != i} (A - l_j I) / (l_i -
    l_j)``, normalized; at a (near-)degenerate pair the coordinate axis
    ``e_i`` stands in. The third is their cross product, and the second
    is made orthogonal again, so the frame is right-handed."""
    eigs = compute_eigenvalues(A)
    eye = _eye(A)

    def projector_column(i, j, k):
        li = eigs[..., i, None, None]
        lj = eigs[..., j, None, None]
        lk = eigs[..., k, None, None]
        denom = (li - lj) * (li - lk)
        safe = torch.where(torch.abs(denom) > _TINY, denom, 1.0)
        P = ((A - lj * eye) @ (A - lk * eye)) / safe
        # the column of the projector with the largest norm
        idx = torch.argmax(torch.linalg.vector_norm(P, dim=-2), dim=-1)
        col = torch.gather(
            P, -1, idx[..., None, None].expand(*P.shape[:-1], 1))[..., 0]
        norm = torch.linalg.vector_norm(col, dim=-1, keepdim=True)
        unit = col / torch.where(norm > _TINY, norm, 1.0)
        # a degenerate pair: any unit vector of the eigenspace will do
        fallback = eye[i].expand_as(unit)
        bad = (torch.abs(denom[..., 0, 0]) <= _TINY)[..., None] \
            | (norm <= _TINY)
        return torch.where(bad, fallback, unit)

    v0 = projector_column(0, 1, 2)
    v1 = projector_column(1, 2, 0)
    v2 = torch.linalg.cross(v0, v1, dim=-1)
    n2 = torch.linalg.vector_norm(v2, dim=-1, keepdim=True)
    v2 = v2 / torch.where(n2 > _TINY, n2, 1.0)
    v1 = torch.linalg.cross(v2, v0, dim=-1)
    return eigs, torch.stack([v0, v1, v2], dim=-1)


def sorted_eigen_decomposition(A: Tensor) -> tuple[Tensor, Tensor]:
    """Eigen-pairs sorted ascending (the reference's order)."""
    eigs, V = compute_eigen_decomposition(A)
    order = torch.argsort(eigs, dim=-1, stable=True)
    V_sorted = torch.gather(
        V, -1, order[..., None, :].expand(*V.shape[:-2], 3, 3))
    return torch.gather(eigs, -1, order), V_sorted
