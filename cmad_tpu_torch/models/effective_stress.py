"""Effective-stress (yield) functions on 3x3 Cauchy tensors.

Port of ``cmad_tpu/models/effective_stress.py`` (parity: reference
``cmad/models/effective_stress.py``): J2 and the diagonal Hosford form.
The other anisotropic forms (Hill, Barlat, principal Hosford) and the
hybrid and scaled forms come with their return maps in a later slice
(ROADMAP queue 1, item 21); naming one of them raises
``NotImplementedError``.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cmad_tpu_torch.typing import Tensor

_LATER = ("hill", "barlat", "hosford_principal")


def conventional_effective_stress_fun(name: str) -> Callable[..., Tensor]:
    if name == "J2":
        return J2_effective_stress
    if name == "hosford":
        return hosford_effective_stress
    if name in _LATER:
        raise NotImplementedError(
            f"effective stress {name!r} is not ported yet: it comes with "
            f"ROADMAP queue 1, item 21 (the anisotropic return maps)")
    raise NotImplementedError(f"unknown effective stress type: {name!r}")


def J2_effective_stress(
        cauchy: Tensor, params: dict[str, Any] | None = None) -> Tensor:
    """von Mises: sqrt(3/2) ||dev(sigma)||_F."""
    tr = torch.diagonal(cauchy, dim1=-2, dim2=-1).sum(-1) / 3.0
    eye = torch.eye(3, dtype=cauchy.dtype, device=cauchy.device)
    s = cauchy - tr[..., None, None] * eye
    return torch.sqrt(1.5 * torch.sum(s * s, dim=(-2, -1)))


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
