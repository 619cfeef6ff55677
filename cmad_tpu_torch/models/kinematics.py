"""Kinematic helpers: deformation-gradient assembly per DefType.

Port of ``cmad_tpu/models/kinematics.py`` (parity: reference
``cmad/models/kinematics.py:10-65``), with the invariants of a 3x3
tensor that the hyperelastic potentials read. The constrained-stretch slots of
the flat state are passed in as tensors. F is built out of place
(``stack``/``pad``, no indexed writes), so ``gather_F`` runs under
``torch.func`` transforms.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as tnf

from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.ops.linalg import det3
from cmad_tpu_torch.typing import Tensor


def _eye(n: int, like: Tensor) -> Tensor:
    return torch.eye(n, dtype=like.dtype, device=like.device)


def _embed_2d(F2: Tensor, f33: Tensor | float) -> Tensor:
    """3x3 from a 2x2 block and the (3, 3) entry."""
    e33 = torch.zeros((3, 3), dtype=F2.dtype, device=F2.device)
    e33[2, 2] = 1.0
    return tnf.pad(F2, (0, 1, 0, 1)) + f33 * e33


def gather_F(
        grad_u: Tensor, def_type: int,
        local_stretches: Tensor | None = None,
        uniaxial_stress_idx: int = 0,
) -> Tensor:
    """Assemble the full 3x3 F from the (possibly lower-dim) grad u plus
    constrained-stretch state entries.

    ``local_stretches``: the xi slice holding the out-of-plane stretch
    (PLANE_STRESS: shape (1,)) or the two off-axis stretches
    (UNIAXIAL_STRESS: shape (2,)).
    """
    if def_type == DefType.FULL_3D:
        return _eye(3, grad_u) + grad_u

    if def_type == DefType.PLANE_STRESS:
        assert local_stretches is not None
        return _embed_2d(_eye(2, grad_u) + grad_u, local_stretches[0])

    if def_type == DefType.PLANE_STRAIN:
        return _embed_2d(_eye(2, grad_u) + grad_u, 1.0)

    if def_type == DefType.UNIAXIAL_STRESS:
        assert local_stretches is not None
        F_uni = 1.0 + grad_u[0, 0]
        s = local_stretches
        if uniaxial_stress_idx == 0:
            diag = torch.stack([F_uni, s[0], s[1]])
        elif uniaxial_stress_idx == 1:
            diag = torch.stack([s[0], F_uni, s[1]])
        elif uniaxial_stress_idx == 2:
            diag = torch.stack([s[0], s[1], F_uni])
        else:
            raise ValueError("uniaxial_stress_idx must be 0, 1, or 2")
        return torch.diag_embed(diag)

    raise NotImplementedError(f"gather_F: def_type {def_type}")


def compute_invariants(A: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    """The principal invariants ``(I1, I2, I3)`` of a 3x3 tensor; ``I3``
    is the closed-form determinant (``ops/linalg.det3``)."""
    I1 = torch.trace(A)
    I2 = 0.5 * (I1**2 - torch.trace(A @ A))
    I3 = det3(A)
    return I1, I2, I3


def off_axis_idx(uniaxial_stress_idx: int) -> np.ndarray:
    """The two coordinate indices orthogonal to the loading axis."""
    return np.array([i for i in range(3) if i != uniaxial_stress_idx])
