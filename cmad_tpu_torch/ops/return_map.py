"""Component-major J2+Voce return map and history drive.

Port of the SoA part of ``cmad_tpu/ops/return_map.py``
(``make_soa_radial_return`` and ``make_j2_history_drive``). The JAX
package chose its kernel from ``jax.default_backend()`` when the function
was built; here the choice is made at call time from the device of the
input tensors: a CUDA tensor goes through the CUDA kernels
(``ops/cuda_radial_return.py``) or the call raises, a CPU tensor goes
through the plain version (``ops/j2_radial_return.py``).
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.ops.cuda_radial_return import (
    _from_wide,
    _to_wide,
    on_cuda,
    soa_history_cuda,
    soa_step_scalars_cuda,
)
from cmad_tpu_torch.ops.j2_radial_return import (
    j2_voce_scalars,
    soa_step_scalars,
)
from cmad_tpu_torch.typing import Tensor


def _step_scalars(xi_soa: Tensor, de_soa: Tensor, scalars: Tensor) -> Tensor:
    if on_cuda(xi_soa):
        return soa_step_scalars_cuda(xi_soa, de_soa, scalars)
    return soa_step_scalars(xi_soa, de_soa, scalars)


def make_soa_radial_return(parameters):
    """The component-major (SoA) J2+Voce radial return:
    ``step(xi_soa: (8, N), de_soa: (8, N), params) -> (8, N)``
    (contract in ``ops/j2_radial_return.py``), on the device of its
    inputs: the ``j2_soa_step`` kernel for CUDA tensors, the plain step
    for CPU tensors. ``params`` is a values dict on that device."""
    del parameters  # layout is fixed by the J2+Voce model

    def step(xi_soa: Tensor, de_soa: Tensor, params) -> Tensor:
        scalars = j2_voce_scalars(params, xi_soa.dtype)
        return _step_scalars(xi_soa, de_soa, scalars)

    return step


def make_j2_history_drive(parameters, record_alpha: bool = False,
                          fused: bool | None = None,
                          layout: str = "soa8"):
    """Batched J2+Voce history driver, component-major throughout:
    ``drive(xi0_soa: (8, N), de_hist: (T, 8, N), params)`` applies the
    strain-increment history carrying the (8, N) state. Returns the final
    state, or ``(final, alpha_hist)`` with ``alpha_hist: (T, N)`` when
    ``record_alpha`` (the accumulated plastic strain per step).

    On CUDA tensors the fused drive (``fused`` None or True, and
    ``record_alpha=False``) is ONE ``j2_soa_history`` launch for the
    whole history, any T, with the state in registers; otherwise it is a
    Python loop of ``j2_soa_step`` launches. On CPU tensors it is the
    plain loop of steps — the plain version of both kernels.

    ``layout='wide'`` takes ``xi0 (64, N/8), de_hist (T, 64, N/8)`` —
    the (8, N) arrays viewed as row-major (64, N/8), component c on rows
    [8c, 8c+8) — and returns the final state in that layout. In row-major
    memory the two layouts are the same bytes, so the drive reshapes to
    (8, N) views, runs the same kernel and reshapes back: results are
    bit-identical to soa8. Requires the fused path, as in the JAX
    package."""
    if layout not in ("soa8", "wide"):
        raise ValueError(f"layout must be 'soa8' or 'wide'; got {layout!r}")
    use_fused = fused is not False and not record_alpha
    if layout == "wide" and not use_fused:
        raise ValueError(
            "layout='wide' requires the fused path "
            "(record_alpha=False, fused not disabled)")

    def drive(xi0_soa: Tensor, de_hist: Tensor, params):
        if layout == "wide":
            xi0_soa, de_hist = _from_wide(xi0_soa), _from_wide(de_hist)
        scalars = j2_voce_scalars(params, xi0_soa.dtype)
        if use_fused and on_cuda(xi0_soa):
            xi = soa_history_cuda(xi0_soa, de_hist, scalars)
            return _to_wide(xi) if layout == "wide" else xi

        xi = xi0_soa
        alphas = []
        for t in range(de_hist.shape[0]):
            xi = _step_scalars(xi, de_hist[t], scalars)
            if record_alpha:
                alphas.append(xi[6])
        if record_alpha:
            alpha_hist = (torch.stack(alphas) if alphas
                          else xi.new_empty((0, xi.shape[1])))
            return xi, alpha_hist
        return _to_wide(xi) if layout == "wide" else xi

    return drive
