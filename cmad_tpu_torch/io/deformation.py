"""Deformation-gradient history loader.

Port of ``cmad_tpu/io/deformation.py`` (parity: reference
``cmad/io/deformation.py:45-120``). Returns a ``(n, n, N)`` float64
array canonicalized from ``.npy`` ((n,n,N) preferred or (N,n,n)),
``.csv``/``.txt`` (one flattened row-major n-by-n matrix per row), or an
inline YAML list of matrices (step-first). The history stays in numpy:
the commands move each step's F to their device.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np


def load_history(deformation_section: dict[str, Any],
                 expected_ndims: int) -> np.ndarray:
    if "history_file" in deformation_section:
        arr = _load_from_file(Path(deformation_section["history_file"]))
    elif "inline" in deformation_section:
        raw = np.asarray(deformation_section["inline"], dtype=np.float64)
        if raw.ndim != 3 or raw.shape[1] != raw.shape[2]:
            raise ValueError(
                f"deformation.inline: expected (N, n, n) matrices; "
                f"got {raw.shape}")
        arr = np.ascontiguousarray(raw.transpose(1, 2, 0))
    else:
        raise ValueError(
            "deformation: must contain either 'history_file' or 'inline'")

    n = arr.shape[0]
    if n != expected_ndims:
        raise ValueError(
            f"deformation: shape (n, n, N) with n={n} does not match the "
            f"model's expected ndims={expected_ndims}")
    return arr


def _load_from_file(path: Path) -> np.ndarray:
    if not path.exists():
        raise FileNotFoundError(
            f"deformation.history_file: file not found at {path}")
    ext = path.suffix.lower()
    if ext == ".npy":
        arr = np.load(path).astype(np.float64)
    elif ext in (".csv", ".txt"):
        raw = np.loadtxt(path, delimiter="," if ext == ".csv" else None,
                         ndmin=2).astype(np.float64)
        cols = raw.shape[1]
        n = int(np.sqrt(cols))
        if n * n != cols:
            raise ValueError(
                f"deformation.history_file: expected n*n columns per row; "
                f"got {cols} in {path}")
        arr = raw.reshape(raw.shape[0], n, n)
    else:
        raise ValueError(
            f"deformation.history_file: unsupported extension {ext!r}; "
            f"supported: .npy, .csv, .txt")
    # canonicalize: (n, n, N) preferred (wins at the N == n ambiguity)
    if arr.ndim == 3 and arr.shape[0] == arr.shape[1]:
        return arr
    if arr.ndim == 3 and arr.shape[1] == arr.shape[2]:
        return np.ascontiguousarray(arr.transpose(1, 2, 0))
    raise ValueError(
        f"deformation: expected (n, n, N) or (N, n, n); got {arr.shape}")
