"""Elastic/plastic residual branch selection.

Port of ``cmad_tpu/models/paths.py`` (parity: reference
``cmad/models/paths.py:8-27``). A ``torch.where``, both branches
evaluated, as the JAX package's ``jnp.where``: it is branch-free across a
point batch and has no Python branch on a tensor value, so it runs under
``torch.func.vmap`` and nested ``jacfwd``/``grad``.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.typing import Tensor


def cond_residual(f: Tensor, C_e: Tensor, C_p: Tensor, tol: float) -> Tensor:
    """Plastic residual when yielding (``f > tol`` or ``|f| < tol``),
    elastic otherwise. ``f`` may carry batch dims matching C_e/C_p's
    leading dims."""
    is_plastic = torch.logical_or(f > tol, torch.abs(f) < tol)
    if C_e.dim() > f.dim():
        is_plastic = is_plastic[..., None]
    return torch.where(is_plastic, C_p, C_e)
