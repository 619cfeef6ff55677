"""Closed-form 3x3 determinant and inverse over leading batch dims.

Port of ``det3``/``inv3`` of ``cmad_tpu/ops/linalg.py``, with the same
order of operations, so both packages round alike. Elementwise only: on
the card, ``torch.linalg.det``/``inv`` of a batch of 3x3 matrices go
through a batched LU (several launches, under ``vmap``/``jacfwd`` too);
these are a few fused elementwise ops and run under ``torch.func``
transforms.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.typing import Tensor


def det3(A: Tensor) -> Tensor:
    """Closed-form determinant of (..., 3, 3) matrices."""
    return (A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2]
                            - A[..., 1, 2] * A[..., 2, 1])
            - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2]
                              - A[..., 1, 2] * A[..., 2, 0])
            + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1]
                              - A[..., 1, 1] * A[..., 2, 0]))


def inv3(A: Tensor) -> Tensor:
    """Closed-form (adjugate / det) inverse of (..., 3, 3) matrices."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    adj = torch.stack([
        torch.stack([c00, c01, c02], dim=-1),
        torch.stack([c10, c11, c12], dim=-1),
        torch.stack([c20, c21, c22], dim=-1),
    ], dim=-2)
    return adj / det3(A)[..., None, None]
