"""State-variable kinds and batched tensor<->vector packing.

Port of the part of ``cmad_tpu/models/var_types.py`` that the models
use (parity: reference ``cmad/models/var_types.py:21-60``). Both
converters accept arbitrary leading batch dimensions
(``(..., 6) <-> (..., 3, 3)``) and build their result out of place
(``stack``), so they run under ``torch.func`` transforms.

Symmetric-tensor component order (3D) is the reference's:
``[00, 01, 02, 11, 12, 22]``.
"""
from __future__ import annotations

from enum import IntEnum

import torch

from cmad_tpu_torch.typing import Tensor


class VarType(IntEnum):
    SCALAR = 0
    VECTOR = 1
    SYM_TENSOR = 2
    TENSOR = 3


# vec slot k holds tensor entry (row, col) = _SYM3_RC[k]
_SYM3_RC = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_SYM2_RC = ((0, 0), (0, 1), (1, 1))


def sym_tensor_from_vector(vec: Tensor, ndims: int = 3) -> Tensor:
    """(..., n(n+1)/2) -> (..., n, n), batch-dim aware."""
    v = vec
    if ndims == 3:
        rows = [
            torch.stack([v[..., 0], v[..., 1], v[..., 2]], dim=-1),
            torch.stack([v[..., 1], v[..., 3], v[..., 4]], dim=-1),
            torch.stack([v[..., 2], v[..., 4], v[..., 5]], dim=-1),
        ]
    elif ndims == 2:
        rows = [
            torch.stack([v[..., 0], v[..., 1]], dim=-1),
            torch.stack([v[..., 1], v[..., 2]], dim=-1),
        ]
    elif ndims == 1:
        rows = [v[..., 0:1]]
    else:
        raise ValueError("ndims must be 1, 2, or 3")
    return torch.stack(rows, dim=-2)


def vector_from_sym_tensor(tensor: Tensor, ndims: int = 3) -> Tensor:
    """(..., n, n) -> (..., n(n+1)/2), batch-dim aware."""
    rc = {3: _SYM3_RC, 2: _SYM2_RC, 1: ((0, 0),)}[ndims]
    return torch.stack([tensor[..., r, c] for r, c in rc], dim=-1)
