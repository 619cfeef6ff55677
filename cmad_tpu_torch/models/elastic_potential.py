"""Hyperelastic potentials and stress from a potential by AD.

Port of ``cmad_tpu/models/elastic_potential.py`` (parity: reference
``cmad/models/elastic_potential.py:11,29``). The potential's derivative
in the invariants is ``torch.func.grad``, so the stress runs under the
other ``torch.func`` transforms. No model of either package calls it
yet; the elastic model's stresses are written out in closed form
(``models/elastic_stress.py``).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch
from torch.func import grad

from cmad_tpu_torch.models.kinematics import compute_invariants
from cmad_tpu_torch.typing import Tensor


def compute_cauchy_from_psi_b(
        F: Tensor, params: dict[str, Any],
        psi_b_fun: Callable[..., Tensor]) -> Tensor:
    """Cauchy stress from a potential of the invariants of b = F F^T."""
    b = F @ F.T
    invariants = compute_invariants(b)
    I1, _I2, I3 = invariants
    J = torch.sqrt(I3)

    dpsi = grad(psi_b_fun)(invariants, params)
    eye = torch.eye(3, dtype=F.dtype, device=F.device)
    return (2.0 / J) * (
        I3 * dpsi[2] * eye
        + (dpsi[0] + I1 * dpsi[1]) * b
        - dpsi[1] * (b @ b)
    )


def compressible_neohookean_potential(
        invariants: tuple[Tensor, Tensor, Tensor],
        params: dict[str, Any]) -> Tensor:
    """Simo-Hughes compressible neo-Hookean free energy psi(I1, I3)."""
    I1, _I2, I3 = invariants
    J = torch.sqrt(I3)
    Jm23 = J.pow(-2.0 / 3.0)

    kappa = params["elastic"]["kappa"]
    mu = params["elastic"]["mu"]
    return 0.5 * kappa * (0.5 * (J**2 - 1.0) - torch.log(J)) \
        + 0.5 * mu * (Jm23 * I1 - 3.0)
