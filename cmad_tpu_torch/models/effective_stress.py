"""Effective-stress (yield) functions on 3x3 Cauchy tensors.

Port of ``cmad_tpu/models/effective_stress.py`` (parity: reference
``cmad/models/effective_stress.py``), J2 first. The anisotropic forms
(Hill, Barlat, Hosford, principal Hosford) and the hybrid and scaled
forms come with their return maps in a later slice (ROADMAP queue 1,
item 21); naming one of them raises ``NotImplementedError``.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cmad_tpu_torch.typing import Tensor

_LATER = ("hill", "barlat", "hosford", "hosford_principal")


def conventional_effective_stress_fun(name: str) -> Callable[..., Tensor]:
    if name == "J2":
        return J2_effective_stress
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
