"""Precision policy for cmad_tpu_torch.

Hopper has native float64, so float64 is the default working dtype on CPU
and CUDA alike and the reference tolerances hold unchanged. The float32
policy of ``cmad_tpu/config.py`` existed only because the TPU lacks f64;
here float32 is an opt-in ``dtype`` argument, and :func:`newton_tols`
keys its table on the dtype it is given.
"""
from __future__ import annotations

import torch

DEFAULT_DTYPE = torch.float64
DEFAULT_DEVICE = torch.device("cuda")


def checked_device(device: torch.device | str) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device without a card
    raises (pass ``device="cpu"`` to run on the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device} asked for (the default is "
            f"{DEFAULT_DEVICE}), but no CUDA device is available; pass "
            f"device='cpu' to run on the CPU")
    return device


def setup() -> None:
    """Full-precision float32 matmuls and convolutions: TF32 keeps about
    three decimal digits, which stalls an implicit Newton whose Jacobian
    no longer matches its residual."""
    torch.set_float32_matmul_precision("highest")
    torch.backends.cudnn.allow_tf32 = False


def newton_tols(kind: str = "mp_local",
                dtype: torch.dtype = DEFAULT_DTYPE) -> tuple[float, float]:
    """(abs_tol, rel_tol) per solver family.

    float64 values match the reference defaults:
      mp_local  1e-14 (models/nonlinear_solver.py:17-18)
      fe_local  1e-12 (global_residuals/global_residual.py:292-297)
      fe_global 1e-10 (fem/nonlinear_solver.py:30-36)
    """
    if dtype == torch.float64:
        table = {
            "mp_local": (1e-14, 1e-14),
            "fe_local": (1e-12, 1e-12),
            "fe_global": (1e-10, 1e-10),
        }
    elif dtype == torch.float32:
        table = {
            "mp_local": (1e-6, 1e-6),
            "fe_local": (1e-5, 1e-5),
            "fe_global": (1e-6, 1e-5),
        }
    else:
        raise ValueError(f"newton_tols: unsupported dtype {dtype}")
    return table[kind]


def clamp_newton_tols(abs_tol: float, rel_tol: float, kind: str,
                      dtype: torch.dtype) -> tuple[float, float]:
    """A deck's Newton tolerances in ``dtype``. Decks are written against
    the float64 tolerances, which float64 keeps; in float32 they are
    raised to that dtype's floor (:func:`newton_tols`), as the JAX
    package's f32 policy did."""
    if dtype == torch.float64:
        return abs_tol, rel_tol
    floor_abs, floor_rel = newton_tols(kind, dtype)
    return max(abs_tol, floor_abs), max(rel_tol, floor_rel)
