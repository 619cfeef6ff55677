"""Effective-stress (yield) functions on 3x3 Cauchy tensors.

Port of ``cmad_tpu/models/effective_stress.py`` (parity: reference
``cmad/models/effective_stress.py``): J2, Hill-1948, Barlat
Yld2004-18p, the diagonal Hosford form and the frame-invariant
(principal) Hosford form, batched over leading dimensions. The hybrid
(neural-network) and scaled forms of the JAX package are not ported;
naming one raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cmad_tpu_torch.typing import Tensor
from cmad_tpu_torch.util.eigen_decomposition import compute_eigenvalues
from cmad_tpu_torch.verification.functions import (
    barlat_yield_torch,
    hill_yield_torch,
)


def conventional_effective_stress_fun(name: str) -> Callable[..., Tensor]:
    table = {
        "J2": J2_effective_stress,
        "hill": hill_effective_stress,
        "barlat": barlat_effective_stress,
        "hosford": hosford_effective_stress,
        "hosford_principal": hosford_principal_effective_stress,
    }
    try:
        return table[name]
    except KeyError as e:
        raise NotImplementedError(
            f"unknown effective stress type: {name!r}") from e


def J2_effective_stress(
        cauchy: Tensor, params: dict[str, Any] | None = None) -> Tensor:
    """von Mises: sqrt(3/2) ||dev(sigma)||_F."""
    tr = torch.diagonal(cauchy, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=cauchy.dtype, device=cauchy.device)
    s = cauchy - tr[..., None, None] * eye
    return torch.sqrt(1.5 * torch.sum(s * s, dim=(-2, -1)))


def hill_effective_stress(cauchy: Tensor, params: dict[str, Any]) -> Tensor:
    """Hill-1948 quadratic anisotropic yield, on the full tensor (both
    mirror entries of each shear, so its gradient is symmetric):
    ``verification/functions.hill_yield_torch``."""
    c = params["effective stress"]["hill"]
    return hill_yield_torch(cauchy, [c[k] for k in "FGHLMN"])


_BARLAT_KEYS = ("sp_12", "sp_13", "sp_21", "sp_23", "sp_31", "sp_32",
                "sp_44", "sp_55", "sp_66",
                "dp_12", "dp_13", "dp_21", "dp_23", "dp_31", "dp_32",
                "dp_44", "dp_55", "dp_66", "a")


def flatten_barlat_params(params: dict[str, Any]) -> Tensor:
    """Pack the 18 Yld2004-18p linear-transform coefficients and the
    exponent (19,), out of place."""
    c = params["effective stress"]["barlat"]
    return torch.stack([torch.as_tensor(c[k]) for k in _BARLAT_KEYS])


def barlat_effective_stress(cauchy: Tensor, params: dict[str, Any]) -> Tensor:
    """Barlat Yld2004-18p (two linear transforms and the eigenvalue
    form, ``verification/functions.barlat_yield_torch``)."""
    packed = flatten_barlat_params(params).to(cauchy)
    return barlat_yield_torch(cauchy, packed)


def hosford_effective_stress(cauchy: Tensor, params: dict[str, Any]) -> Tensor:
    """Hosford on the diagonal stresses (the reference's form, its
    ``effective_stress.py:168``), rescaled by the largest diagonal stress
    difference so the a-th powers lie in [0, 1] with the largest ratio
    exactly 1: a von Mises rescale underflows every ``(d/vm)**a`` to 0 at
    a = 100 in float32 for a shear-dominated state, and the outer
    ``0 ** (1/a)`` then gives NaN gradients."""
    a = params["effective stress"]["hosford"]["a"]
    return _hosford_phi_of_three(
        cauchy[..., 0, 0], cauchy[..., 1, 1], cauchy[..., 2, 2], a)


def _hosford_phi_of_three(v0: Tensor, v1: Tensor, v2: Tensor,
                          a) -> Tensor:
    """Hosford combination of three (diagonal or principal) stresses,
    rescaled by the largest pairwise difference.

    At a zero difference ``abs``'s derivative is 0 here and 1 in JAX; it
    multiplies the derivative of ``(0/m)**a``, which is 0 for a > 1, so
    the two agree. ``maximum`` splits a tie's derivative in halves in
    both packages."""
    d01 = torch.abs(v0 - v1)
    d12 = torch.abs(v1 - v2)
    d20 = torch.abs(v2 - v0)
    m = torch.maximum(torch.maximum(d01, d12), d20)
    safe_m = torch.where(m > 0.0, m, torch.ones_like(m))
    base = 0.5 * ((d01 / safe_m) ** a + (d12 / safe_m) ** a
                  + (d20 / safe_m) ** a)
    # double where: keep the unselected branch's pow off base = 0
    safe_base = torch.where(m > 0.0, base, torch.ones_like(base))
    phi = safe_m * safe_base ** (1.0 / a)
    return torch.where(m > 0.0, phi, torch.zeros_like(phi))


def hosford_phi_of_principal(s: Tensor, a) -> Tensor:
    """Hosford effective stress of a ``(..., 3)`` vector of principal
    stresses (any order)."""
    return _hosford_phi_of_three(s[..., 0], s[..., 1], s[..., 2], a)


def hosford_principal_effective_stress(
        cauchy: Tensor, params: dict[str, Any]) -> Tensor:
    """Hosford 1972 on the principal stresses: the frame-invariant form,
    valid for any stress state (the reference's Hosford reads only the
    diagonal). The eigenvalues come from the guarded closed-form Cardano
    solution (``util/eigen_decomposition.py``), so the gradient (the
    yield normal) stays finite at repeated principal stresses; on a
    diagonal stress the value is the diagonal form's."""
    a = params["effective stress"]["hosford_principal"]["a"]
    sym = 0.5 * (cauchy + cauchy.transpose(-1, -2))
    return hosford_phi_of_principal(compute_eigenvalues(sym), a)
