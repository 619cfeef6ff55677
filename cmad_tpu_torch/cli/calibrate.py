"""Helpers of ``cmad calibrate`` (scipy.optimize over the active
parameters): the initial guess, the optimizer's status and the labels of
the active parameters.

Port of the helpers of ``cmad_tpu/cli/calibrate.py`` (parity: reference
``cmad/cli/calibrate.py:57-194``). The command's branches are
``cli/mp_subcommands.run_calibrate_mp`` and
``cli/fe_subcommands.run_calibrate_fe``, which ``cli/main.py`` reaches
through ``cli/common.run_command``.
"""
from __future__ import annotations

from typing import Any

import numpy as np

from cmad_tpu_torch.parameters.parameters import (
    Parameters,
    _leaf_size,
    _leaves_with_path,
)


def resolve_initial_guess(spec: Any, init_from_deck: np.ndarray) -> np.ndarray:
    if spec == "from_deck":
        return init_from_deck
    return np.asarray(spec, dtype=np.float64)


def optimize_status(result) -> dict[str, Any]:
    status: dict[str, Any] = {
        "success": bool(result.success),
        "status": int(result.status),
        "message": str(result.message),
        "fun": float(result.fun),
    }
    for name in ("nfev", "njev", "nhev", "nit"):
        value = getattr(result, name, None)
        if value is not None:
            status[name] = int(value)
    return status


def active_param_paths(parameters: Parameters) -> list[str]:
    """Dotted-path labels for the active parameters (spaces -> _),
    expanded per scalar (an array-valued leaf contributes one
    ``path[i]`` entry per component) so that they line up with
    ``Parameters.active_idx``, which indexes the ravelled values."""
    paths = []
    for key_path, v in _leaves_with_path(parameters.values):
        base = ".".join(str(k).replace(" ", "_") for k in key_path)
        size = _leaf_size(v)
        if size == 1:
            paths.append(base)
        else:
            paths.extend(f"{base}[{i}]" for i in range(size))
    return [paths[i] for i in parameters.active_idx]
