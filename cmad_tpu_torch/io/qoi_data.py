"""QoI data/weight loaders.

Port of ``cmad_tpu/io/qoi_data.py`` (parity: reference
``cmad/io/qoi_data.py:31-116``): the material-point data loader, the
FE displacement target, from ``.npy`` or a ``cmad primal`` Exodus
output, and the FE load series.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def load_qoi_data(qoi_section: dict[str, Any]):
    """(data, weight) for a material-point QoI section (.npy only)."""
    data = _load_npy("qoi.data_file", qoi_section["data_file"])
    if "weight" in qoi_section:
        weight = np.asarray(qoi_section["weight"], dtype=np.float64)
    else:
        weight = _load_npy("qoi.weight_file", qoi_section["weight_file"])
    return data, weight


def load_displacement_data(qoi_section: dict[str, Any]) -> np.ndarray:
    """(num_steps, num_nodes, ndims) nodal displacement target; .npy or a
    cmad-primal Exodus output."""
    path = Path(qoi_section["data_file"])
    if not path.exists():
        raise FileNotFoundError(f"qoi.data_file: file not found at {path}")
    ext = path.suffix.lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext in (".exo", ".ex2"):
        from cmad_tpu_torch.io.exodus import read_results
        from cmad_tpu_torch.io.results import FieldSpec
        from cmad_tpu_torch.models.var_types import VarType

        results = read_results(
            path, nodal_field_specs=[FieldSpec("u", VarType.VECTOR)])
        arr = results.nodal["u"]
    else:
        raise ValueError(
            f"qoi.data_file: unsupported extension {ext!r}; "
            f"supported: .npy, .exo, .ex2")
    return np.asarray(arr, dtype=np.float64)


def load_reaction_data(qoi_section: dict[str, Any]) -> np.ndarray:
    """(num_steps,) or (num_steps, num_components) load series; .npy,
    .csv or .txt."""
    path = Path(qoi_section["data_file"])
    if not path.exists():
        raise FileNotFoundError(f"qoi.data_file: file not found at {path}")
    ext = path.suffix.lower()
    if ext == ".npy":
        arr = np.load(path)
    elif ext in (".csv", ".txt"):
        arr = np.loadtxt(path)
    else:
        raise ValueError(
            f"qoi.data_file: unsupported extension {ext!r}; "
            f"supported: .npy, .csv, .txt")
    return np.asarray(arr, dtype=np.float64)


def _load_npy(field_name: str, relpath: str) -> np.ndarray:
    path = Path(relpath)
    if not path.exists():
        raise FileNotFoundError(f"{field_name}: file not found at {path}")
    if path.suffix.lower() != ".npy":
        raise ValueError(
            f"{field_name}: unsupported extension {path.suffix!r}; "
            f"supported: .npy")
    return np.load(path).astype(np.float64)
