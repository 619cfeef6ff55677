"""Deck ``parameters:`` tree -> :class:`Parameters`.

Port of ``cmad_tpu/io/params_builder.py`` (parity: reference
``cmad/io/params_builder.py:27``). Leaves are either bare scalars/lists
(inactive, no transform) or ``{value, active?, transform?}`` dicts; the
builder splits the tree into the three parallel trees.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch

from cmad_tpu_torch.config import DEFAULT_DEVICE, DEFAULT_DTYPE
from cmad_tpu_torch.parameters.parameters import Parameters


def build_parameters(parameters_section: dict[str, Any], *,
                     dtype: torch.dtype = DEFAULT_DTYPE,
                     device: torch.device | str = DEFAULT_DEVICE
                     ) -> Parameters:
    values, flags, transforms = _split(parameters_section)
    return Parameters(values, flags, transforms, dtype=dtype, device=device)


def _split(node: Any):
    if isinstance(node, dict) and "value" in node:
        return (_coerce(node["value"]),
                bool(node.get("active", False)),
                _parse_transform(node.get("transform")))
    if isinstance(node, dict):
        vals, flags, trs = {}, {}, {}
        for k, v in node.items():
            vals[k], flags[k], trs[k] = _split(v)
        return vals, flags, trs
    return _coerce(node), False, None


def _coerce(value: Any) -> Any:
    if isinstance(value, list):
        return np.asarray(value, dtype=np.float64)
    if isinstance(value, bool):
        return value
    if isinstance(value, int):
        return float(value)
    return value


def _parse_transform(spec: Any):
    if spec is None:
        return None
    if isinstance(spec, dict) and "bounds" in spec:
        return [float(spec["bounds"][0]), float(spec["bounds"][1])]
    if isinstance(spec, dict) and "log" in spec:
        return [float(spec["log"])]
    raise ValueError(f"unknown transform spec: {spec!r}")
