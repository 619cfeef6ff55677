"""Analytical yield functions: the traceable forms the anisotropic
effective stresses are built from.

Port of the traceable half of ``cmad_tpu/verification/functions.py``
(parity: reference ``cmad/verification/functions.py:7-138``); its numpy
oracles have no caller here. The forms are batched over the leading
dimensions of the stress and run under ``torch.func`` transforms; they
build every matrix out of place from the parameter tensors
(``torch.stack``), with no indexed write, so a CUDA graph can capture
them.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.typing import Tensor
from cmad_tpu_torch.util.eigen_decomposition import compute_eigenvalues


def hill_yield_torch(cauchy: Tensor, hill_params) -> Tensor:
    """Full-tensor Hill form, batched (``jax_hill_yield``): both mirror
    entries of each shear, so its gradient is symmetric."""
    F, G, H, L, M, N = hill_params
    s = cauchy
    return torch.sqrt(
        F * (s[..., 1, 1] - s[..., 2, 2]) ** 2
        + G * (s[..., 2, 2] - s[..., 0, 0]) ** 2
        + H * (s[..., 0, 0] - s[..., 1, 1]) ** 2
        + L * (s[..., 2, 1] ** 2 + s[..., 1, 2] ** 2)
        + M * (s[..., 2, 0] ** 2 + s[..., 0, 2] ** 2)
        + N * (s[..., 1, 0] ** 2 + s[..., 0, 1] ** 2))


# ----------------------------------------------------------------------
# Barlat Yld2004-18p
# ----------------------------------------------------------------------
# The transforms act on the 9-slot flattened stress in the order
# [00, 11, 22, 01, 12, 20, 10, 21, 02] (reference functions.py:105-135).
_FLAT_RC = ((0, 0), (1, 1), (2, 2), (0, 1), (1, 2), (2, 0),
            (1, 0), (2, 1), (0, 2))


def flatten_stress(stress: Tensor) -> Tensor:
    """(..., 3, 3) -> the 9 slots (..., 9) (``jax_flatten_stress``)."""
    return torch.stack([stress[..., r, c] for r, c in _FLAT_RC], dim=-1)


def unflatten_stress(flat: Tensor) -> Tensor:
    """The 9 slots (..., 9) -> (..., 3, 3) (``jax_unflatten_stress``)."""
    rows = [
        torch.stack([flat[..., 0], flat[..., 3], flat[..., 8]], dim=-1),
        torch.stack([flat[..., 6], flat[..., 1], flat[..., 4]], dim=-1),
        torch.stack([flat[..., 5], flat[..., 7], flat[..., 2]], dim=-1),
    ]
    return torch.stack(rows, dim=-2)


def _barlat_L(c12, c13, c21, c23, c31, c32, c44, c55, c66) -> Tensor:
    """One 9x9 Yld2004 linear transform from its 9 coefficients (0-d
    tensors): the 3x3 normal block, then the shear diagonal twice
    (``_barlat_L``)."""
    upper = [[c12 + c13, -2.0 * c12 + c13, c12 - 2.0 * c13],
             [-2.0 * c21 + c23, c21 + c23, c21 - 2.0 * c23],
             [-2.0 * c31 + c32, c31 - 2.0 * c32, c31 + c32]]
    z = torch.zeros_like(c44)
    shear = (c44, c55, c66)
    rows = []
    for i in range(9):
        row = [z] * 9
        if i < 3:
            row[:3] = [u / 3.0 for u in upper[i]]
        else:
            row[i] = shear[(i - 3) % 3]
        rows.append(torch.stack(row))
    return torch.stack(rows)


def unpack_barlat_params(barlat_params: Tensor) -> tuple[Tensor, Tensor]:
    """The two transforms of the 19 packed coefficients
    (``jax_unpack_barlat_params``)."""
    L_sp = _barlat_L(*[barlat_params[i] for i in range(9)])
    L_dp = _barlat_L(*[barlat_params[9 + i] for i in range(9)])
    return L_sp, L_dp


def compute_sbar_matrices(cauchy: Tensor, barlat_params: Tensor
                          ) -> tuple[Tensor, Tensor]:
    """The two transformed stresses (``jax_compute_sbar_matrices``)."""
    L_sp, L_dp = unpack_barlat_params(barlat_params)
    flat = flatten_stress(cauchy)
    return (unflatten_stress(flat @ L_sp.T),
            unflatten_stress(flat @ L_dp.T))


def barlat_yield_torch(cauchy: Tensor, barlat_params: Tensor) -> Tensor:
    """Yld2004-18p effective stress, batched over the leading dimensions
    of ``cauchy`` (``jax_barlat_yield``).

    At a zero difference of principal values ``abs``'s derivative is 0
    here and 1 in JAX; it multiplies the derivative of ``|0|**a``, which
    is 0 for a > 1, so the two agree."""
    a = barlat_params[-1]
    sbar_sp, sbar_dp = compute_sbar_matrices(cauchy, barlat_params)
    # the 9-slot form keeps both mirror entries; the closed-form
    # eigensolver expects exact symmetry
    sbar_sp = 0.5 * (sbar_sp + sbar_sp.transpose(-1, -2))
    sbar_dp = 0.5 * (sbar_dp + sbar_dp.transpose(-1, -2))
    ev_sp = compute_eigenvalues(sbar_sp)
    ev_dp = compute_eigenvalues(sbar_dp)
    diffs = ev_sp[..., :, None] - ev_dp[..., None, :]
    phi_a = 0.25 * torch.sum(torch.abs(diffs) ** a, dim=(-2, -1))
    return phi_a ** (1.0 / a)
