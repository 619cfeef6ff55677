"""The roofline experiment on the card: is the f32 history kernel held by
its bytes or by its arithmetic?

Counterpart of ``benchmarks/local_kernels/roofline_experiment.py`` (its
kernel R, ``kernel`` in ``_make_hist_call`` at :40, is the f32
``j2_soa_history`` with the Newton's iteration count as a template
parameter, :func:`~cmad_tpu_torch.ops.cuda_radial_return.soa_history_iters_cuda`).
It runs the same two sweeps over a T-step history of N points, chained in
chunks of ``t_steps`` steps, the state going through device memory
between launches:

1. Newton iterations 1, 2, 4, 8 and 12 at ``t_steps`` 8: the bytes are
   the same in every row, only the arithmetic per update changes. A time
   that grows with the iterations says the arithmetic holds the kernel.
2. ``t_steps`` 1, 2, 4, 8 and 16 at 8 iterations: the bytes per update
   fall as the state is read and written once per chunk. A rate that
   keeps rising as the bytes fall says the bytes held it.

The data follow the experiment's recipe: ``numpy.random.default_rng(0)``,
the state N(0, 50) with alpha ``|x| * 1e-3`` and row 7 zero, the strain
N(0, 2e-3) with rows 6-7 zero, the material [mu, lam, Y, S, D] =
[76923.1, 115384.6, 250, 200, 20], float32. The strain chunks are staged
before the clock starts, and every row is timed with CUDA events (best of
``rounds`` rounds of ``reps`` chained drives after a warm-up). The bytes
per update come from this port's layout, not the TPU's: each chunk
launch reads 6 strain rows per step and 7 state rows, and writes 8, so
(24 + 60 / t_steps) B per update in float32.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from cmad_tpu_torch.ops.j2_radial_return import soa_step_scalars
from cmad_tpu_torch.typing import Tensor

N = 2_097_152
T = 16
ITERS = (1, 2, 4, 8, 12)           # the iteration sweep, at t_steps 8
T_STEPS = (1, 2, 4, 8, 16)         # the chunk sweep, at 8 iterations
SCALARS = (76923.1, 115384.6, 250.0, 200.0, 20.0)
HBM_BYTES_PER_S = 3.35e12          # H100 SXM, 700 W


def bytes_per_update(t_steps: int, itemsize: int = 4) -> float:
    """6 strain values per update, 7 state values read and 8 written per
    chunk of ``t_steps`` updates."""
    return itemsize * (6 + 15 / t_steps)


def roofline_data(n: int = N, t_hist: int = T, device="cuda",
                  seed: int = 0) -> tuple[Tensor, Tensor, Tensor]:
    """``(xi0 (8, n), de (t_hist, 8, n), scalars (5,))`` in float32 on
    ``device``, by the experiment's recipe."""
    rng = np.random.default_rng(seed)
    xi0 = rng.normal(0, 50.0, (8, n)).astype(np.float32)
    xi0[6] = np.abs(xi0[6]) * 1e-3
    xi0[7] = 0.0
    de = rng.normal(0, 2e-3, (t_hist, 8, n)).astype(np.float32)
    de[:, 6:] = 0.0
    return (torch.as_tensor(xi0, device=device),
            torch.as_tensor(de, device=device),
            torch.tensor(SCALARS, dtype=torch.float32, device=device))


def chunks_of(de: Tensor, t_steps: int) -> list[Tensor]:
    """The history cut into contiguous chunks of ``t_steps`` steps."""
    if de.shape[0] % t_steps:
        raise ValueError(f"T = {de.shape[0]} is not a multiple of "
                         f"t_steps = {t_steps}")
    return [de[c:c + t_steps].contiguous()
            for c in range(0, de.shape[0], t_steps)]


def plain_drive(xi0: Tensor, de: Tensor, scalars: Tensor,
                newton_iters: int,
                plastic_updates: list | None = None) -> Tensor:
    """The plain version: the plain step with ``newton_iters`` iterations
    over every step (the chunking changes no value); appends each step's
    count of plastic points to ``plastic_updates`` if given."""
    xi = xi0
    for t in range(de.shape[0]):
        new = soa_step_scalars(xi, de[t], scalars, newton_iters=newton_iters)
        if plastic_updates is not None:
            plastic_updates.append(int((new[6] > xi[6]).sum()))
        xi = new
    return xi


def kernel_drive(xi0: Tensor, chunks: list[Tensor], scalars: Tensor,
                 newton_iters: int) -> Tensor:
    """R: one launch per chunk, the state through device memory between
    them."""
    from cmad_tpu_torch.ops.cuda_radial_return import soa_history_iters_cuda

    xi = xi0
    for ch in chunks:
        xi = soa_history_iters_cuda(xi, ch, scalars, newton_iters)
    return xi


def time_drive(fn, xi0: Tensor, reps: int, rounds: int) -> float:
    """ms per drive: best of ``rounds`` rounds of ``reps`` drives, each
    starting from the last one's state, CUDA events around each round,
    after one warm-up drive."""
    fn(xi0)
    torch.cuda.synchronize()
    best = math.inf
    for _ in range(rounds):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        xi = xi0
        start.record()
        for _ in range(reps):
            xi = fn(xi)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def row_scaled_error(out: Tensor, ref: Tensor) -> tuple[float, float]:
    """(max abs error, max row-scaled error) over state rows 0-6, each
    row's scale its largest magnitude (at least 1)."""
    diff = (out[:7] - ref[:7]).abs().amax(dim=1)
    scale = ref[:7].abs().amax(dim=1).clamp(min=1.0)
    return float(diff.max()), float((diff / scale).max())


def sweep(xi0: Tensor, de: Tensor, scalars: Tensor, reps: int, rounds: int,
          bound: float) -> list[dict]:
    """Both sweeps on the card, one dict per row: ``newton_iters``,
    ``t_steps``, ``ms`` per drive, ``updates_per_s``,
    ``bytes_per_update``, ``gb_per_s``, ``byte_bound_share`` (the bytes'
    time at HBM_BYTES_PER_S over ``ms``), the row's ``max_abs_err`` and
    ``max_row_scaled_err`` against :func:`plain_drive` on the same inputs
    and its plastic updates. Raises if a row's row-scaled error exceeds
    ``bound``."""
    n, t_hist = int(xi0.shape[1]), int(de.shape[0])
    rows = []
    cases = [(it, 8) for it in ITERS] + [(8, ts) for ts in T_STEPS]
    plain_cache: dict[int, tuple[Tensor, int]] = {}
    for iters, t_steps in cases:
        chunks = chunks_of(de, t_steps)
        out = kernel_drive(xi0, chunks, scalars, iters)
        if iters not in plain_cache:
            plastic: list[int] = []
            ref = plain_drive(xi0, de, scalars, iters, plastic)
            plain_cache[iters] = (ref, sum(plastic))
        ref, plastic_updates = plain_cache[iters]
        abs_err, rel_err = row_scaled_error(out, ref)
        if not (bool(torch.isfinite(out).all()) and bool((out[7] == 0).all())):
            raise RuntimeError(f"roofline: iters {iters} t_steps {t_steps}: "
                               f"non-finite output or nonzero pad row")
        if not rel_err <= bound:
            raise RuntimeError(f"roofline: iters {iters} t_steps {t_steps}: "
                               f"{rel_err} > {bound} against the plain drive")
        ms = time_drive(lambda x, c=chunks, i=iters: kernel_drive(
            x, c, scalars, i), xi0, reps, rounds)
        ups = n * t_hist / (ms * 1e-3)
        bpu = bytes_per_update(t_steps)
        rows.append({
            "newton_iters": iters, "t_steps": t_steps, "ms": ms,
            "updates_per_s": ups, "bytes_per_update": bpu,
            "gb_per_s": ups * bpu / 1e9,
            "byte_bound_share": (n * t_hist * bpu / HBM_BYTES_PER_S * 1e3)
            / ms,
            "max_abs_err": abs_err, "max_row_scaled_err": rel_err,
            "plastic_updates": plastic_updates, "launches": len(chunks)})
    return rows
