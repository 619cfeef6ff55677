"""Flat local-state layout.

Port of ``cmad_tpu/models/state.py``: the local state at a material point
is ONE flat vector ``xi`` of length ``num_dofs``, and a
:class:`StateLayout` names its slices. A batch of points is a leading
dimension, ``(n_points, num_dofs)``.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cmad_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE, checked_device
from cmad_tpu_torch.models.var_types import VarType
from cmad_tpu_torch.typing import Tensor


@dataclass(frozen=True)
class StateBlock:
    """One named variable inside the flat state vector."""

    var_name: str
    resid_name: str
    var_type: VarType
    size: int
    init: tuple[float, ...]  # initial values, length == size

    @staticmethod
    def zeros(var_name: str, resid_name: str, var_type: VarType,
              size: int) -> "StateBlock":
        return StateBlock(var_name, resid_name, var_type, size,
                          (0.0,) * size)

    @staticmethod
    def ones(var_name: str, resid_name: str, var_type: VarType,
             size: int) -> "StateBlock":
        return StateBlock(var_name, resid_name, var_type, size,
                          (1.0,) * size)


class StateLayout:
    """Immutable map from variable names to slices of the flat state."""

    def __init__(self, blocks: tuple[StateBlock, ...] | list[StateBlock]):
        self.blocks = tuple(blocks)
        offsets = np.cumsum([0] + [b.size for b in self.blocks])
        self.offsets = offsets[:-1]
        self.num_dofs = int(offsets[-1])
        self._slices = {
            b.var_name: slice(int(o), int(o + b.size))
            for b, o in zip(self.blocks, self.offsets, strict=True)
        }

    def __len__(self) -> int:
        return len(self.blocks)

    def slc(self, var_name: str) -> slice:
        return self._slices[var_name]

    def get(self, xi: Tensor, var_name: str) -> Tensor:
        """Batched slice: works on (num_dofs,) or (..., num_dofs)."""
        return xi[..., self._slices[var_name]]

    def init_xi(self, dtype: torch.dtype | None = None,
                device: torch.device | str = DEFAULT_DEVICE) -> Tensor:
        """The initial state, on the card unless ``device`` says
        otherwise."""
        vals = [v for b in self.blocks for v in b.init]
        return torch.tensor(vals, dtype=dtype or DEFAULT_DTYPE,
                            device=checked_device(device))

    @property
    def var_names(self) -> list[str]:
        return [b.var_name for b in self.blocks]

    @property
    def resid_names(self) -> list[str]:
        return [b.resid_name for b in self.blocks]

    @property
    def var_types(self) -> list[VarType]:
        return [b.var_type for b in self.blocks]

    @property
    def sizes(self) -> list[int]:
        return [b.size for b in self.blocks]
