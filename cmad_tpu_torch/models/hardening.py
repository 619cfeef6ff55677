"""Isotropic hardening laws.

Port of ``cmad_tpu/models/hardening.py`` (parity: reference
``cmad/models/hardening.py``). All functions are batched (alpha may carry
batch dims).
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cmad_tpu_torch.typing import Tensor


def voce_hardening(alpha: Tensor, voce_params: dict[str, Any]) -> Tensor:
    S, D = voce_params["S"], voce_params["D"]
    return S * (1.0 - torch.exp(-D * alpha))


def linear_hardening(alpha: Tensor, linear_params: dict[str, Any]) -> Tensor:
    return linear_params["K"] * alpha


def get_hardening_funs() -> dict[str, Callable[..., Tensor]]:
    return {"voce": voce_hardening, "linear": linear_hardening}


def combined_hardening_fun(
        alpha: Tensor, params: dict[str, Any],
        hardening_funs: dict[str, Callable[..., Tensor]]) -> Tensor:
    """Sum of all hardening laws whose parameter blocks are present."""
    total = 0.0
    for htype, hparams in params.items():
        total = total + hardening_funs[htype](alpha, hparams)
    return total
