"""Shared type aliases for cmad_tpu_torch (counterpart of
``cmad_tpu/typing.py``)."""
from __future__ import annotations

from collections.abc import Callable
from typing import Any, NamedTuple

import numpy as np
import torch
from numpy.typing import NDArray

Tensor = torch.Tensor
Scalar = float | Tensor
PyTree = Any
Params = dict[str, Any]

# A transform leaf: None (identity), [lo, hi] (bounds), or [ref] (log).
Transform = list[float] | None
ActiveFlags = PyTree
Transforms = PyTree

# Model function signatures. ``xi`` is the flat local state vector; ``U`` is
# a GlobalFieldsAtPoint.
ResidualFn = Callable[..., Tensor]  # (xi, xi_prev, params, U, U_prev) -> C
CauchyFn = Callable[..., Tensor]    # (xi, xi_prev, params, U, U_prev) -> (3,3)
QoIFn = Callable[..., Tensor]  # (xi, xi_prev, params, U, U_prev, data, w)


class GradientResult(NamedTuple):
    J: float
    grad: NDArray[np.floating]


class HessianResult(NamedTuple):
    J: float
    grad: NDArray[np.floating]
    hessian: NDArray[np.floating]
