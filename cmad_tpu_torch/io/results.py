"""Field specs, Exodus component naming and order, and the IP-to-element
average.

Port of ``cmad_tpu/io/results.py`` (parity: reference
``cmad/io/results.py``), on numpy: the Exodus writer and reader work on
host arrays. The internal sym-tensor order is [xx, xy, xz, yy, yz, zz];
the Exodus disk order is [xx, yy, zz, xy, xz, yz], and the helpers
permute at the boundary. The JAX package's ``volume_average_global_field``
(no caller on the ported path) is not ported.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmad_tpu_torch.models.var_types import VarType


@dataclass(frozen=True)
class FieldSpec:
    name: str
    var_type: VarType


@dataclass(frozen=True)
class ExodusResults:
    times: np.ndarray
    nodal: dict[str, np.ndarray]
    element: dict[str, dict[str, np.ndarray]]


_VECTOR_SUFFIXES = {1: ("_x",), 2: ("_x", "_y"), 3: ("_x", "_y", "_z")}
_SYM_EXODUS_SUFFIXES = {
    1: ("_xx",),
    2: ("_xx", "_yy", "_xy"),
    3: ("_xx", "_yy", "_zz", "_xy", "_xz", "_yz"),
}
_TENSOR_SUFFIXES = {
    1: ("_xx",),
    2: ("_xx", "_xy", "_yx", "_yy"),
    3: ("_xx", "_xy", "_xz", "_yx", "_yy", "_yz", "_zx", "_zy", "_zz"),
}

# internal [xx, xy, xz, yy, yz, zz] <-> exodus [xx, yy, zz, xy, xz, yz]
_SYM_INTERNAL_TO_EXODUS = {1: (0,), 3: (0, 2, 1), 6: (0, 3, 5, 1, 2, 4)}
_SYM_EXODUS_TO_INTERNAL = {1: (0,), 3: (0, 2, 1), 6: (0, 3, 4, 1, 5, 2)}


def component_names(name: str, var_type: VarType,
                    ndims: int = 3) -> tuple[str, ...]:
    """Decorated per-component variable names in disk order."""
    if var_type == VarType.SCALAR:
        return (name,)
    table = {VarType.VECTOR: _VECTOR_SUFFIXES,
             VarType.SYM_TENSOR: _SYM_EXODUS_SUFFIXES,
             VarType.TENSOR: _TENSOR_SUFFIXES}[var_type]
    return tuple(name + s for s in table[ndims])


def to_exodus_storage(values: np.ndarray, var_type: VarType) -> np.ndarray:
    """Permute the trailing component axis internal -> Exodus (sym
    tensors only; other kinds pass through)."""
    if var_type != VarType.SYM_TENSOR:
        return values
    return np.asarray(values)[
        ..., list(_SYM_INTERNAL_TO_EXODUS[values.shape[-1]])]


def from_exodus_storage(values: np.ndarray,
                        var_type: VarType) -> np.ndarray:
    if var_type != VarType.SYM_TENSOR:
        return values
    return np.asarray(values)[
        ..., list(_SYM_EXODUS_TO_INTERNAL[values.shape[-1]])]


def ip_average_to_element(values_per_ip, geometry_cache,
                          block_name: str) -> np.ndarray:
    """Integration-measure-weighted IP -> element mean:
    sum_p(det w v) / sum_p(det w). values (n_e, n_ip, *comp)."""
    geom = geometry_cache[block_name]
    weights = (geom["per_elem"]["iso_jac_det"]
               * geom["shared"]["quad_w"][None, :]).cpu().numpy()
    values = np.asarray(values_per_ip)
    if values.shape[:2] != weights.shape:
        raise ValueError(
            f"values leading shape {values.shape[:2]} != weights "
            f"{weights.shape} for block {block_name!r}")
    w = weights
    while w.ndim < values.ndim:
        w = w[..., None]
    return (values * w).sum(axis=1) / w.sum(axis=1)
