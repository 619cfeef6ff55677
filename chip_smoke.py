#!/usr/bin/env python3
"""Drive cmad_tpu_torch's J2+Voce return-map path once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the four CUDA kernels of ``cmad_tpu_torch/csrc`` (nvcc, into
``build/cmad_tpu_torch/``), checks each against its plain PyTorch version
on the card, drives the port's public entry points at the headline sizes
and checks the answers against the plain path and against the yield
condition, and prints timings of the kernel and plain paths measured with
CUDA events beside each kernel's bound (its bytes, and its operations as
the built library's SASS counts them). The paths driven:

- the SoA history drive at 2,097,152 points x 64 steps and the FE
  dispatch chain at 4,194,304 points x 8 steps (``j2_soa_history``,
  ``j2_soa_step``);
- the material-point models' batched return map,
  ``make_batched_return_map(model, specialize=True)``, at 4,194,304
  points x 2 chained steps for the rate form (``j2_aos_step``) and the
  total form (``j2_total_step``);
- the generic implicit-function Newton, ``make_batched_return_map(model)``,
  at 1,048,576 points x 2 steps, and its gradient against autograd
  through the plain radial return.

It prints one line per phase (each with its wall seconds), the card's
name and power limit, a JSON line with one entry per kernel, then the
final JSON line ``{"ok": true, "device": {...}}``. Any failed check
raises, and the script exits non-zero; without a CUDA device it exits
non-zero at once.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

# the material of the repo's benchmark (bench.py): E, nu, Y, S, D
MATERIAL = {
    "rotation matrix": np.eye(3),
    "elastic": {"E": 200e3, "nu": 0.3},
    "plastic": {
        "effective stress": {"J2": 0.0},
        "flow stress": {"initial yield": {"Y": 200.0},
                        "hardening": {"voce": {"S": 200.0, "D": 20.0}}}}}

N_STEP = 1_000_003          # parity of j2_soa_step (not a multiple of 8)
N_HIST = 262_147            # parity of j2_soa_history
# the history's edges: one point, a part of a warp, one block of
# j2_soa_history (256 threads) +- 1, and the odd N above; T shorter than
# the one-step-ahead prefetch, and two long histories
N_HIST_EDGES = (1, 33, 255, 257, N_HIST)
T_HIST = (0, 1, 2, 13, 64)
AOS_TILE = 128              # points per block of j2_aos_step
N_DRIVE, T_DRIVE = 2_097_152, 64   # the history-drive headline
N_FE, FE_STEPS, FE_Q = 4_194_304, 8, 8
N_MP = 4_194_304            # the batched return map (bench.py:355)
N_GENERIC = N_MP // 4       # the generic Newton (bench.py:650-664)
N_GRAD = 65_536
ROUNDS, REPS = 3, 5         # timing: best of 3 rounds of 5 chained calls

# bounds: per state row, max|kernel - plain| <= bound * max(1, max|row|)
STEP_BOUND = {"float64": 1e-11, "float32": 1e-5}   # nvcc contracts FMAs
HIST_BOUND = {"float64": 1e-10, "float32": 1e-4}   # error grows over T
GRAD_RTOL = 1e-8
YIELD_TOL = 1e-9            # |phi - Y - H(alpha)| <= YIELD_TOL * Y
# generic Newton vs radial return: the Newton stops once ||r|| < abs_tol
# (1e-14 in f64), and its stress rows are scaled by 1 / (2 mu), so it
# resolves the stress to about 2 mu abs_tol = 1.5e-9 (the CPU tests'
# atol 1e-9 holds at 256 points; 65,536 points on the CPU reach 9.8e-10)
GENERIC_TOL_FACTOR = 2.0    # bound = GENERIC_TOL_FACTOR * 2 mu * abs_tol
# the generic Newton's implicit-function gradient vs autograd through
# the plain radial return's 8 unrolled scalar iterations: both converge
# to f64 rounding, measured 1e-13 on the CPU at 4096 points
MP_GRAD_RTOL = 1e-9

# the card's peaks (NVIDIA H100 SXM data sheet, dense, outside the
# tensor cores): bytes/s and operations/s. The operations of each kernel,
# per elastic update and added per plastic update, are read from the
# built library's SASS (cmad_tpu_torch/ops/_sass.py: DFMA and FFMA 2,
# DADD, DMUL, FADD and FMUL 1)
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS = {"fp64": 34e12, "fp32": 67e12}

# the gradient phase's active parameters: E, Y, S, D
GRAD_FLAGS = {
    "rotation matrix": False, "elastic": {"E": True, "nu": False},
    "plastic": {"effective stress": {"J2": False},
                "flow stress": {"initial yield": {"Y": True},
                                "hardening": {"voce": {"S": True,
                                                       "D": True}}}}}
GRAD_TRANSFORMS = {
    "rotation matrix": None, "elastic": {"E": None, "nu": None},
    "plastic": {"effective stress": {"J2": None},
                "flow stress": {"initial yield": {"Y": None},
                                "hardening": {"voce": {"S": None,
                                                       "D": None}}}}}

SOURCE = "cmad_tpu_torch/csrc/j2_radial_return.cu"
PALLAS = "cmad_tpu/ops/pallas_radial_return.py"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def row_error(out, ref) -> tuple[float, float]:
    """(max abs error, max row-scaled error) over state rows 0-6."""
    diff = (out[:7] - ref[:7]).abs().amax(dim=1)
    scale = ref[:7].abs().amax(dim=1).clamp(min=1.0)
    return float(diff.max()), float((diff / scale).max())


def check_rows(phase, label, out, ref, bound, quiet=False) -> float:
    import torch

    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{phase} {label}: bad output {tuple(out.shape)}")
    if bool((out[7] != 0).any()):
        raise RuntimeError(f"{phase} {label}: pad row is not zero")
    abs_err, rel_err = row_error(out, ref)
    if not quiet:
        say(phase, f"{label}: max_abs_err={abs_err:.3e} "
                   f"max_row_scaled_err={rel_err:.3e} bound={bound:g}")
    if not rel_err <= bound:
        raise RuntimeError(f"{phase} {label}: {rel_err} > {bound}")
    return abs_err


def check_cols(phase, label, out, ref, bound) -> float:
    """Per column of (N, ...) arrays: max|out - ref| <= bound *
    max(1, max|ref column|). Returns the max abs error."""
    import torch

    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{phase} {label}: bad output {tuple(out.shape)}")
    a, b = out.reshape(out.shape[0], -1), ref.reshape(ref.shape[0], -1)
    diff = (a - b).abs().amax(dim=0)
    scale = b.abs().amax(dim=0).clamp(min=1.0)
    abs_err, rel_err = float(diff.max()), float((diff / scale).max())
    say(phase, f"{label}: max_abs_err={abs_err:.3e} "
               f"max_col_scaled_err={rel_err:.3e} bound={bound:g}")
    if not rel_err <= bound:
        raise RuntimeError(f"{phase} {label}: {rel_err} > {bound}")
    return abs_err


def bound_ms(nbytes: float, counts: dict, updates: float,
             plastic_updates: float):
    """The least time the card could take: (ms, "bytes" or
    "operations", bytes ms, operations ms), with the operations of
    ``counts`` (one kernel's entry of ``_sass.library_counts``); the f64
    and f32 pipes run side by side."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max((counts["elastic"][k] * updates
                 + counts["plastic"][k] * plastic_updates)
                / PEAK_OPS[k] * 1e3 for k in PEAK_OPS)
    if t_bytes >= t_ops:
        return t_bytes, "bytes", t_bytes, t_ops
    return t_ops, "operations", t_bytes, t_ops


def mises_3x3(s):
    """von Mises stress of (..., 3, 3) tensors."""
    import torch

    tr = torch.diagonal(s, dim1=-2, dim2=-1).sum(-1) / 3.0
    d = s - tr[..., None, None] * torch.eye(3, dtype=s.dtype,
                                            device=s.device)
    return torch.sqrt(1.5 * (d * d).sum(dim=(-2, -1)))


def best_ms(fn, x0, sync) -> float:
    """Best of ROUNDS rounds of REPS chained calls (each call's output
    is the next one's input), ms per call, CUDA events around each round
    after one warm-up call."""
    import torch

    fn(x0)
    sync()
    best = math.inf
    for _ in range(ROUNDS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        st = x0
        start.record()
        for _ in range(REPS):
            st = fn(st)
        end.record()
        end.synchronize()
        best = min(best, start.elapsed_time(end) / REPS)
    return best


def main() -> int:
    import torch
    from torch.utils.checkpoint import checkpoint

    # ---------------- 1. device ----------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs "
                         "only on a GPU")
    sys.path.insert(0, str(Path(__file__).resolve().parent))
    from cmad_tpu_torch.config import newton_tols
    from cmad_tpu_torch.fem.xi_carrier import pack_xi, unpack_xi
    from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
    from cmad_tpu_torch.models.nonlinear_solver import (
        make_newton_solve_with_stats,
    )
    from cmad_tpu_torch.models.small_elastic_plastic import (
        SmallElasticPlastic,
    )
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        SmallRateElasticPlastic,
    )
    from cmad_tpu_torch.ops import _build, _sass
    from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
    from cmad_tpu_torch.ops.j2_radial_return import (
        j2_voce_scalars,
        make_j2_radial_return,
        make_j2_radial_return_total,
        pack_state_soa,
        soa_step_scalars,
        strain_increment_soa,
        unpack_state_soa,
    )
    from cmad_tpu_torch.ops.j2_soa_ad import make_soa_step_ad
    from cmad_tpu_torch.ops.return_map import (
        make_batched_return_map,
        make_j2_history_drive,
    )
    from cmad_tpu_torch.parameters.parameters import (
        Parameters,
        parameters_from_numpy,
    )

    clock = [time.perf_counter()]

    def lap(phase: str) -> None:
        now = time.perf_counter()
        say(phase, f"wall {now - clock[0]:.1f} s")
        clock[0] = now

    dev = torch.device("cuda", 0)
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    say("device", f"{kind}, {count} visible, torch {torch.__version__}, "
                  f"CUDA {torch.version.cuda}")
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(0)
    dtypes = (torch.float64, torch.float32)
    params = {dt: parameters_from_numpy(MATERIAL, dtype=dt, device=dev)
              for dt in dtypes}
    scalars = {dt: j2_voce_scalars(params[dt].values, dt) for dt in dtypes}

    def increment(n, dtype):
        """The benchmark's strain increment: symmetric, 1.5e-3 std."""
        eps = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                   dtype=dtype)
        eps = 0.5 * (eps + eps.transpose(1, 2))
        return strain_increment_soa(eps, torch.zeros_like(eps))

    def zero_state(n, dtype):
        return pack_state_soa(torch.zeros((n, 7), device=dev, dtype=dtype))

    def plain_drive(xi, de_hist, sc, plastic_updates=None):
        """The plain step looped over the history; appends each step's
        count of plastic points to ``plastic_updates`` if given."""
        for t in range(de_hist.shape[0]):
            new = soa_step_scalars(xi, de_hist[t], sc)
            if plastic_updates is not None:
                plastic_updates.append(int((new[6] > xi[6]).sum()))
            xi = new
        return xi

    def advanced(n, dtype):
        """A mixed state: three plain steps of a tenth of the increment
        from rest, so that alpha > 0 on part of the points; returns the
        state and the next increment."""
        de = 0.1 * increment(n, dtype)
        xi = plain_drive(zero_state(n, dtype), de.expand(3, 8, n),
                         scalars[dtype])
        return xi, de

    # ---------------- 2. build ----------------
    t0 = time.perf_counter()
    path, log = _build.build()
    _build.load_library()
    say("build", f"{time.perf_counter() - t0:.2f} s -> {path.name}"
                 f"{' (cached)' if not log else ''}")
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            say("build", line.strip())
    ops = _sass.library_counts(path)
    for kname, c in sorted(ops.items()):
        say("build", f"{kname} SASS operations per update: elastic "
                     f"{c['elastic']}, a plastic update adds {c['plastic']}; "
                     f"{c['mnemonics']}")
    lap("build")

    results = {}

    # ---------------- 3. parity-step ----------------
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        xi, de = advanced(N_STEP, dt)
        out = cuda_rr.soa_step_scalars_cuda(xi, de, scalars[dt])
        ref = soa_step_scalars(xi, de, scalars[dt])
        frac = float((out[6] > xi[6]).double().mean())
        say("parity-step", f"{name} N={N_STEP}: plastic fraction {frac:.4f}, "
                           f"alpha>0 before the step on "
                           f"{float((xi[6] > 0).double().mean()):.4f}")
        if not 0.0 < frac < 1.0:
            raise RuntimeError("parity-step: the step is not mixed")
        check_rows("parity-step", f"{name} N={N_STEP}", out, ref,
                   STEP_BOUND[name])
        n8 = N_STEP - N_STEP % 8
        xw, dw = xi[:, :n8].contiguous(), de[:, :n8].contiguous()
        wide = cuda_rr._to_wide(cuda_rr.soa_step_scalars_cuda(
            cuda_rr._from_wide(cuda_rr._to_wide(xw)),
            cuda_rr._from_wide(cuda_rr._to_wide(dw)), scalars[dt]))
        narrow = cuda_rr.soa_step_scalars_cuda(xw, dw, scalars[dt])
        if not torch.equal(cuda_rr._from_wide(wide), narrow) or \
                cuda_rr._to_wide(xw).data_ptr() != xw.data_ptr():
            raise RuntimeError("parity-step: the wide view differs")
        say("parity-step", f"{name} wide (64, {n8 // 8}) view: bit-identical")
        del xi, de, out, ref, xw, dw, wide, narrow
    # the step at the FE dispatch's shape
    xi, de = advanced(N_FE, torch.float64)
    results["step_err"] = check_rows(
        "parity-step", f"float64 N={N_FE}",
        cuda_rr.soa_step_scalars_cuda(xi, de, scalars[torch.float64]),
        soa_step_scalars(xi, de, scalars[torch.float64]),
        STEP_BOUND["float64"])
    del xi, de
    sync()
    lap("parity-step")

    # ---------------- 4. parity-history ----------------
    def history_input(n, t_steps, dtype):
        de_hist = torch.zeros((t_steps, 8, n), device=dev, dtype=dtype)
        de_hist[:, :6] = (1.5e-3 / 16) * torch.randn(
            (t_steps, 6, n), generator=gen, device=dev, dtype=dtype)
        return de_hist

    for dt in dtypes:
        name = str(dt).split(".")[-1]
        worst = 0.0
        for n in N_HIST_EDGES:
            for T in T_HIST:
                xi0 = zero_state(n, dt)
                de_hist = history_input(n, T, dt)
                out = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
                ref = plain_drive(xi0, de_hist, scalars[dt])
                if n == N_HIST and T >= 13:
                    say("parity-history", f"{name} N={n} T={T}: plastic "
                                          f"fraction "
                                          f"{float((out[6] > 0).double().mean()):.4f}")
                    check_rows("parity-history", f"{name} N={n} T={T}", out,
                               ref, HIST_BOUND[name])
                else:
                    abs_err = check_rows("parity-history", f"{name} N={n} "
                                         f"T={T}", out, ref,
                                         HIST_BOUND[name], quiet=True)
                    worst = max(worst, abs_err)
                del xi0, de_hist, out, ref
        say("parity-history", f"{name}: N in {N_HIST_EDGES} x T in {T_HIST}: "
                              f"all within {HIST_BOUND[name]:g}, max abs "
                              f"err {worst:.3e} at the short edges")
        # against T chained j2_soa_step launches, and the yield condition
        # on the points that yield in the last step
        T = T_HIST[-1]
        xi0 = zero_state(N_HIST, dt)
        de_hist = history_input(N_HIST, T, dt)
        out = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
        before = cuda_rr.soa_history_cuda(xi0, de_hist[:T - 1], scalars[dt])
        xs = xi0
        for t in range(T):
            xs = cuda_rr.soa_step_scalars_cuda(xs, de_hist[t], scalars[dt])
        diff = float((out - xs).abs().max())
        say("parity-history", f"{name} N={N_HIST} T={T}: j2_soa_history vs "
                              f"{T} chained j2_soa_step launches: max abs "
                              f"diff {diff:.3e} (bit-identical: "
                              f"{bool(torch.equal(out, xs))})")
        check_rows("parity-history", f"{name} j2_soa_history vs chained "
                   f"j2_soa_step", out, xs, HIST_BOUND[name])
        if dt == torch.float64:
            mu, lam, Y, S, D = (float(v) for v in scalars[dt].tolist())
            plastic = out[6] > before[6]
            p = (out[0] + out[3] + out[5]) / 3.0
            phi = torch.sqrt(1.5 * ((out[0] - p) ** 2 + (out[3] - p) ** 2
                                    + (out[5] - p) ** 2
                                    + 2.0 * (out[1] ** 2 + out[2] ** 2
                                             + out[4] ** 2)))
            resid = (phi - Y - S * (1.0 - torch.exp(-D * out[6])))[plastic]
            max_resid = float(resid.abs().max())
            say("parity-history", f"{name} N={N_HIST} T={T}: "
                                  f"{int(plastic.sum())} points yield in "
                                  f"the last step; max |phi - Y - "
                                  f"H(alpha)| {max_resid:.3e} (bound "
                                  f"{YIELD_TOL * Y:g})")
            if not max_resid <= YIELD_TOL * Y:
                raise RuntimeError("parity-history: yield condition missed")
        del xi0, de_hist, out, before, xs
    sync()
    lap("parity-history")

    # ---------------- 5. history-drive (main path) ----------------
    cuda_rr.reset_launch_counts()
    hist_plastic: list[int] = []
    drive = make_j2_history_drive(params[torch.float64])
    drive_wide = make_j2_history_drive(params[torch.float64], layout="wide")
    timings = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        pv, sc = params[dt].values, scalars[dt]
        de = increment(N_DRIVE, dt)
        # headline: every point yields; mixed: about 57% do; elastic:
        # none does, which times the bytes alone
        for regime, factor in (("headline", 1.0),
                               ("mixed", 0.045 * 8 / T_DRIVE),
                               ("elastic", 1e-3)):
            de_hist = (factor * de).expand(T_DRIVE, 8, N_DRIVE).contiguous()
            xi0 = zero_state(N_DRIVE, dt)
            out = drive(xi0, de_hist, pv)
            headline64 = name == "float64" and regime == "headline"
            ref = plain_drive(xi0, de_hist, sc,
                              hist_plastic if headline64 else None)
            frac = float((out[6] > 0).double().mean())
            if (regime == "elastic") != (frac == 0.0):
                raise RuntimeError(f"history-drive: {regime} regime has "
                                   f"plastic fraction {frac}")
            label = f"{name} {regime} N={N_DRIVE} T={T_DRIVE}"
            err = check_rows("history-drive", label, out, ref,
                             HIST_BOUND[name])
            if headline64:
                results["hist_err"] = err
            # the TPU's wide kernels K7/K8 are this launch on a view
            wide = drive_wide(cuda_rr._to_wide(xi0), cuda_rr._to_wide(de_hist),
                              pv)
            if not torch.equal(cuda_rr._from_wide(wide), out):
                raise RuntimeError("history-drive: layout='wide' differs")
            say("history-drive", f"{label}: layout='wide' bit-identical")
            del out, ref, wide
            # every drive from xi0, so that each timed call is the regime
            ms = best_ms(lambda _x: drive(xi0, de_hist, pv), xi0, sync)
            plain = best_ms(lambda _x: plain_drive(xi0, de_hist, sc), xi0,
                            sync)
            ups = N_DRIVE * T_DRIVE / (ms * 1e-3)
            plain_ups = N_DRIVE * T_DRIVE / (plain * 1e-3)
            timings[("drive", name, regime)] = (ms, plain)
            say("history-drive", f"{label}: plastic fraction {frac:.4f}; "
                                 f"kernel {ms:.3f} ms/drive = {ups:.4g} "
                                 f"updates/s; plain {plain:.3f} ms/drive = "
                                 f"{plain_ups:.4g} updates/s")
            del de_hist, xi0
            sync()
            torch.cuda.empty_cache()
        del de
    lap("history-drive")

    # ---------------- 6. fe-dispatch (main path) ----------------
    step_ad = make_soa_step_ad()
    E = N_FE // FE_Q
    dt = torch.float64
    xi_aos = torch.zeros((E, FE_Q, 7), device=dev, dtype=dt)
    de = increment(N_FE, dt)

    def fe_chain(x_aos, de_, sc_, step):
        xc = pack_xi(x_aos)
        for _ in range(FE_STEPS):
            xc = step(xc, de_, sc_)
        return unpack_xi(xc, E, FE_Q)

    def plain_ckpt(xc, de_, sc_):
        # recompute each plain step in the backward pass: the graph of
        # 8 unrolled steps at this size would hold ~30 GB
        return checkpoint(
            soa_step_scalars, xc, de_, sc_, use_reentrant=False)

    with torch.no_grad():
        out = fe_chain(xi_aos, de, scalars[dt], step_ad)
        ref = fe_chain(xi_aos, de, scalars[dt], soa_step_scalars)
    if out.shape != (E, FE_Q, 7):
        raise RuntimeError(f"fe-dispatch: shape {tuple(out.shape)}")
    frac = float((out[..., 6] > 0).double().mean())
    def pad(a):  # (E, Q, 7) -> (8, N) rows, for the row check
        return torch.cat([a.reshape(-1, 7).T, a.new_zeros((1, N_FE))])

    check_rows("fe-dispatch", f"forward float64 N={N_FE} x {FE_STEPS} steps "
                              f"(plastic fraction {frac:.4f})",
               pad(out), pad(ref), HIST_BOUND["float64"])
    del out, ref

    w = torch.randn((E, FE_Q, 7), generator=gen, device=dev, dtype=dt)
    grads = []
    for step in (step_ad, plain_ckpt):
        de_g = de.clone().requires_grad_(True)
        sc_g = scalars[dt].clone().requires_grad_(True)
        loss = (w * fe_chain(xi_aos, de_g, sc_g, step)).sum()
        grads.append(torch.autograd.grad(loss, (de_g, sc_g)))
        del loss, de_g, sc_g
    (k_de, k_sc), (p_de, p_sc) = grads
    de_err = float((k_de - p_de).abs().max() / p_de.abs().max())
    sc_err = float(((k_sc - p_sc).abs() / p_sc.abs()).max())
    say("fe-dispatch", f"grad of a weighted sum: de rel err {de_err:.3e}, "
                       f"scalars rel err {sc_err:.3e} (rtol {GRAD_RTOL:g}); "
                       f"d/d[mu, lam, Y, S, D] = "
                       f"{[float(f'{v:.6e}') for v in k_sc.tolist()]}")
    if not (de_err <= GRAD_RTOL and sc_err <= GRAD_RTOL):
        raise RuntimeError("fe-dispatch: gradients disagree")
    del grads, k_de, k_sc, p_de, p_sc, w

    with torch.no_grad():
        ms = best_ms(lambda x: fe_chain(x, de, scalars[dt], step_ad),
                     xi_aos, sync)
        plain = best_ms(lambda x: fe_chain(x, de, scalars[dt],
                                           soa_step_scalars), xi_aos, sync)
        updates = N_FE * FE_STEPS
        say("fe-dispatch", f"forward chain N={N_FE} x {FE_STEPS}: kernel "
                           f"{ms:.3f} ms = {updates / (ms * 1e-3):.4g} "
                           f"updates/s; plain {plain:.3f} ms = "
                           f"{updates / (plain * 1e-3):.4g} updates/s")
        xc0 = pack_xi(xi_aos)
        step_ms = best_ms(lambda x: step_ad(x, de, scalars[dt]), xc0, sync)
        step_plain = best_ms(lambda x: soa_step_scalars(x, de, scalars[dt]),
                             xc0, sync)
        step_plastic = int((soa_step_scalars(xc0, de, scalars[dt])[6] > 0)
                           .sum())
        say("fe-dispatch", f"one step N={N_FE}: kernel {step_ms:.4f} ms, "
                           f"plain {step_plain:.4f} ms")
        timings[("fe", "float64")] = (ms, plain)
        timings[("step", "float64")] = (step_ms, step_plain)
    launches = cuda_rr.launch_counts()
    del xi_aos, de, xc0
    sync()
    torch.cuda.empty_cache()
    lap("fe-dispatch")

    # ---------------- 7. consistency ----------------
    dt = torch.float64
    mu, lam, Y, S, D = (float(v) for v in scalars[dt].tolist())
    xi, de = advanced(N_STEP, dt)
    out = cuda_rr.soa_step_scalars_cuda(xi, de, scalars[dt])
    tr = de[0] + de[3] + de[5]
    trial = torch.stack([xi[r] + 2.0 * mu * de[r]
                         + (lam * tr if r in (0, 3, 5) else 0.0)
                         for r in range(6)])

    def mises(s):
        p = (s[0] + s[3] + s[5]) / 3.0
        return torch.sqrt(1.5 * ((s[0] - p) ** 2 + (s[3] - p) ** 2
                                 + (s[5] - p) ** 2
                                 + 2.0 * (s[1] ** 2 + s[2] ** 2
                                          + s[4] ** 2)))

    f_trial = mises(trial) - Y - S * (1.0 - torch.exp(-D * xi[6]))
    plastic = out[6] > xi[6]
    sure = f_trial.abs() > YIELD_TOL * Y
    if bool((plastic != (f_trial > 0))[sure].any()):
        raise RuntimeError("consistency: yield classification differs")
    resid = (mises(out[:6]) - Y - S * (1.0 - torch.exp(-D * out[6])))[plastic]
    max_resid = float(resid.abs().max())
    row_scale = trial.abs().amax(dim=1, keepdim=True).clamp(min=1.0)
    el_err = float(((out[:6] - trial).abs() / row_scale)[:, ~plastic]
                   .max()) if bool((~plastic).any()) else 0.0
    el_alpha = bool(torch.equal(out[6][~plastic], xi[6][~plastic]))
    say("consistency", f"N={N_STEP}: {int(plastic.sum())} plastic, "
                       f"{int((~plastic).sum())} elastic; max |phi - Y - "
                       f"H(alpha)| on plastic points {max_resid:.3e} "
                       f"(bound {YIELD_TOL * Y:g}); elastic points: trial "
                       f"stress to {el_err:.3e}, alpha unchanged: {el_alpha}")
    if not (max_resid <= YIELD_TOL * Y and el_err <= 1e-12 and el_alpha):
        raise RuntimeError("consistency: the return map misses the oracle")
    del xi, de, out, trial
    sync()
    lap("consistency")

    # ---------------- 8. parity-aos, parity-total ----------------
    def sym_grad(n, dtype):
        """The benchmark's displacement gradient (bench.py:404-411):
        symmetric, N(0, 1.5e-3)."""
        g = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                 dtype=dtype)
        return (0.5 * (g + g.transpose(1, 2))).contiguous()

    def aos_zero(n, dtype):
        return torch.zeros((n, 7), device=dev, dtype=dtype)

    aos_kernel = {
        "rate": lambda x, g, g0, sc: cuda_rr.aos_step_cuda(x, g, g0, sc),
        "total": lambda x, g, g0, sc: cuda_rr.total_step_cuda(x, g, sc)}
    aos_plain = {"rate": make_j2_radial_return,
                 "total": make_j2_radial_return_total}
    for form, phase in (("rate", "parity-aos"), ("total", "parity-total")):
        errs = []
        for dt in dtypes:
            name = str(dt).split(".")[-1]
            plain = aos_plain[form](params[dt])
            pv, sc = params[dt].values, scalars[dt]
            g = sym_grad(N_STEP, dt)
            z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
                aos_zero(N_STEP, dt)
            k1 = aos_kernel[form](x0, g, z, sc)
            p1 = plain(x0, g, z, pv)
            k2 = aos_kernel[form](k1[0], g2, g, sc)
            p2 = plain(p1[0], g2, g, pv)
            fracs = [float((k[0][:, 6] > x[:, 6]).double().mean())
                     for k, x in ((k1, x0), (k2, k1[0]))]
            say(phase, f"{name} N={N_STEP}: plastic fraction {fracs[0]:.4f} "
                       f"(step 1), {fracs[1]:.4f} (step 2: 1.7 g from g)")
            if not 0.0 < fracs[0] < 1.0:
                raise RuntimeError(f"{phase}: step 1 is not mixed")
            for label, a, b in (("step 1 xi", k1[0], p1[0]),
                                ("step 1 sigma", k1[1], p1[1]),
                                ("step 2 xi", k2[0], p2[0]),
                                ("step 2 sigma", k2[1], p2[1])):
                err = check_cols(phase, f"{name} {label}", a, b,
                                 STEP_BOUND[name])
                if name == "float64":
                    errs.append(err)
            if not all(torch.equal(k[1], k[1].transpose(1, 2))
                       for k in (k1, k2)):
                raise RuntimeError(f"{phase}: sigma is not symmetric")
            say(phase, f"{name}: sigma exactly symmetric")
            del g, z, g2, x0, k1, k2, p1, p2
        results[f"{form}_err"] = max(errs)
        if form == "rate":
            # the ragged last tile, and inputs that start one row into
            # their storage (56 B into xi, 72 B into grad_u)
            for dt in dtypes:
                name = str(dt).split(".")[-1]
                plain = aos_plain[form](params[dt])
                pv, sc = params[dt].values, scalars[dt]
                for n in (AOS_TILE - 1, AOS_TILE + 1):
                    for offset in (0, 1):
                        g = sym_grad(n + offset, dt)[offset:]
                        g0 = (0.3 * sym_grad(n + offset, dt))[offset:]
                        x0 = unpack_state_soa(
                            advanced(n + offset, dt)[0]).contiguous()[offset:]
                        if offset and x0.data_ptr() % 16 == 0:
                            raise RuntimeError(f"{phase}: the view is "
                                               f"16 B aligned")
                        k1 = cuda_rr.aos_step_cuda(x0, g, g0, sc)
                        p1 = plain(x0, g, g0, pv)
                        for label, a, b in (("xi", k1[0], p1[0]),
                                            ("sigma", k1[1], p1[1])):
                            check_cols(phase, f"{name} N={n} offset "
                                       f"{offset} row {label}", a, b,
                                       STEP_BOUND[name])
                        if not torch.equal(k1[1], k1[1].transpose(1, 2)):
                            raise RuntimeError(f"{phase}: sigma is not "
                                               f"symmetric")
        sync()
        lap(phase)

    # ---------------- 9. mp-batched (main path) ----------------
    # the material-point models through make_batched_return_map, built
    # the way a user builds them: Parameters on its default device (the
    # card)
    mp_models = {"rate": SmallRateElasticPlastic,
                 "total": SmallElasticPlastic}
    mp_kernel = {"rate": "j2_aos_step", "total": "j2_total_step"}
    mp_g = {dt: sym_grad(N_MP, dt) for dt in dtypes}
    mp_runs = {}
    cuda_rr.reset_launch_counts()
    for form, cls in mp_models.items():
        for dt in dtypes:
            model = cls(Parameters(MATERIAL, dtype=dt))
            step = make_batched_return_map(model, specialize=True)
            pv, g = model.parameters.values, mp_g[dt]
            z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
                aos_zero(N_MP, dt)
            before = cuda_rr.launch_counts()
            xi1, s1 = step(x0, g, z, pv)
            xi2, s2 = step(xi1, g2, g, pv)
            expect = {**before,
                      mp_kernel[form]: before[mp_kernel[form]] + 2}
            if cuda_rr.launch_counts() != expect:
                raise RuntimeError(f"mp-batched: {form} launched "
                                   f"{cuda_rr.launch_counts()}, expected "
                                   f"{expect}")
            mp_runs[(form, dt)] = (model, step, xi1, s1, xi2, s2)
    sync()
    mp_launches = cuda_rr.launch_counts()
    say("mp-batched", f"main path launches (4 calls per kernel: 2 chained "
                      f"steps x f64, f32): {mp_launches}")

    for (form, dt), (model, step, xi1, s1, xi2, s2) in mp_runs.items():
        name = str(dt).split(".")[-1]
        label = f"{form} {name} N={N_MP}"
        pv, g = model.parameters.values, mp_g[dt]
        z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
            aos_zero(N_MP, dt)
        plain = aos_plain[form](model.parameters)
        p1 = plain(x0, g, z, pv)
        p2 = plain(p1[0], g2, g, pv)
        for what, a, b in (("step 1 xi", xi1, p1[0]),
                           ("step 1 sigma", s1, p1[1]),
                           ("step 2 xi", xi2, p2[0]),
                           ("step 2 sigma", s2, p2[1])):
            check_cols("mp-batched", f"{label} {what}", a, b,
                       STEP_BOUND[name])
        del p1, p2
        plastic1 = int((xi1[:, 6] > 0).sum())
        if name == "float64":
            mu, lam, Y, S, D = (float(v) for v in
                                j2_voce_scalars(pv, dt).tolist())
            for k, (xp, x, sg) in enumerate(((x0, xi1, s1),
                                             (xi1, xi2, s2)), start=1):
                plastic = x[:, 6] > xp[:, 6]
                resid = (mises_3x3(sg) - Y
                         - S * (1.0 - torch.exp(-D * x[:, 6])))[plastic]
                worst = float(resid.abs().max())
                say("mp-batched", f"{label} step {k}: {int(plastic.sum())} "
                                  f"plastic points, max |phi - Y - "
                                  f"H(alpha)| {worst:.3e} (bound "
                                  f"{YIELD_TOL * Y:g})")
                if not worst <= YIELD_TOL * Y:
                    raise RuntimeError("mp-batched: yield condition missed")
        sc = j2_voce_scalars(pv, dt)
        ms = best_ms(lambda x: aos_kernel[form](x, g, z, sc)[0], x0, sync)
        entry = best_ms(lambda x: step(x, g, z, pv)[0], x0, sync)
        plain_t = best_ms(lambda x: plain(x, g, z, pv)[0], x0, sync)
        say("mp-batched", f"{label}: kernel {ms:.4f} ms "
                          f"({N_MP / (ms * 1e-3):.4g} updates/s), entry "
                          f"point {entry:.4f} ms, plain {plain_t:.4f} ms")
        timings[("mp", form, name)] = (ms, entry, plain_t, plastic1)
        del model, step, xi1, s1, xi2, s2, z, g2, x0
    del mp_runs
    sync()
    torch.cuda.empty_cache()
    lap("mp-batched")

    # ---------------- 10. mp-generic ----------------
    dt = torch.float64
    model = SmallRateElasticPlastic(Parameters(MATERIAL, dtype=dt))
    pv = model.parameters.values
    g = mp_g[dt][:N_GENERIC].contiguous()
    z, g2, x0 = torch.zeros_like(g), (1.7 * g).contiguous(), \
        aos_zero(N_GENERIC, dt)
    generic = make_batched_return_map(model)
    special = make_batched_return_map(model, specialize=True)

    def two_steps(step):
        xi1, s1 = step(x0, g, z, pv)
        xi2, s2 = step(xi1, g2, g, pv)
        return xi1, s1, xi2, s2

    sync()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        gen_out = two_steps(generic)
        sync()
        peak = torch.cuda.max_memory_allocated()
        gen_ms = math.inf
        for _ in range(2):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            two_steps(generic)
            end.record()
            end.synchronize()
            gen_ms = min(gen_ms, start.elapsed_time(end))
        spec_out = two_steps(special)
    worst = max(float((a - b).abs().max())
                for a, b in zip(gen_out, spec_out, strict=True))
    over = sum(int(((a - b).abs() > 1e-9).any(dim=-1).reshape(-1).sum())
               for a, b in zip(gen_out[::2], spec_out[::2], strict=True))
    mu = float(j2_voce_scalars(pv, dt)[0])
    generic_atol = GENERIC_TOL_FACTOR * 2.0 * mu * newton_tols("mp_local",
                                                                 dt)[0]
    stats = make_newton_solve_with_stats(model.residual_fun,
                                         in_dims=(0, None, 0, 0))

    def fields(gu):
        return GlobalFieldsAtPoint({"u": gu.new_zeros(gu.shape[:-1])},
                                   {"u": gu})

    it1 = stats(x0, x0, pv, fields(g), fields(z))[1]
    it2 = stats(gen_out[0], gen_out[0], pv, fields(g2), fields(g))[1]
    max_it = int(max(it1.max(), it2.max()))
    gen_ups = 2 * N_GENERIC / (gen_ms * 1e-3)
    say("mp-generic", f"float64 N={N_GENERIC} x 2 steps: "
                      f"{gen_ms:.1f} ms = {gen_ups:.4g} updates/s; "
                      f"most Newton iterations of a point {max_it} "
                      f"(step 1 mean {float(it1.double().mean()):.3f}, "
                      f"step 2 mean {float(it2.double().mean()):.3f}); "
                      f"peak memory {peak / 2**30:.2f} GiB; max |generic - "
                      f"radial return| {worst:.3e} (atol {generic_atol:.3g} "
                      f"= {GENERIC_TOL_FACTOR:g} x 2 mu x abs_tol; "
                      f"{over} point-steps past 1e-9)")
    if not worst <= generic_atol:
        raise RuntimeError("mp-generic: the Newton disagrees with the "
                           "radial return")
    del gen_out, spec_out, it1, it2, generic, special
    sync()
    torch.cuda.empty_cache()
    lap("mp-generic")

    # ---------------- 11. mp-gradient ----------------
    gp = Parameters(MATERIAL, GRAD_FLAGS, GRAD_TRANSFORMS, dtype=dt)
    model = SmallRateElasticPlastic(gp)
    a0 = torch.tensor(gp.flat_active_values(), dtype=dt, device=dev)
    g = mp_g[dt][:N_GRAD].contiguous()
    z, x0 = torch.zeros_like(g), aos_zero(N_GRAD, dt)
    w = torch.randn((N_GRAD, 3, 3), generator=gen, device=dev, dtype=dt)
    grads = []
    for step in (make_batched_return_map(model),
                 make_j2_radial_return(gp)):
        a = a0.clone().requires_grad_(True)
        _, sg = step(x0, g, z, gp.tree_with_flat_active(a))
        grads.append(torch.autograd.grad((w * sg).sum(), a)[0])
    got, ref = grads
    rel = float(((got - ref).abs() / ref.abs()).max())
    say("mp-gradient", f"float64 N={N_GRAD}: d/d[E, D, S, Y] of a weighted "
                       f"sum of sigma, implicit-function rule "
                       f"{[float(f'{v:.10e}') for v in got.tolist()]} vs "
                       f"autograd through the plain radial return: max rel "
                       f"err {rel:.3e} (rtol {MP_GRAD_RTOL:g})")
    if not (bool(torch.isfinite(got).all()) and rel <= MP_GRAD_RTOL):
        raise RuntimeError("mp-gradient: gradients disagree")
    del model, g, z, x0, w, grads, mp_g
    sync()
    lap("mp-gradient")

    # ---------------- 12. launches ----------------
    main_path = {"j2_soa_step": launches["j2_soa_step"],
                 "j2_soa_history": launches["j2_soa_history"],
                 "j2_aos_step": mp_launches["j2_aos_step"],
                 "j2_total_step": mp_launches["j2_total_step"]}
    say("launches", f"main paths (history-drive + fe-dispatch; mp-batched): "
                    f"{main_path}")
    if not all(v > 0 for v in main_path.values()):
        raise RuntimeError(f"launches: a kernel never ran: {main_path}")

    # bounds from this run's shapes and data (f64): bytes each input read
    # once and each output written once; operations from the SASS counts
    # and the plastic updates this run's data produced
    step_ms, step_plain = timings[("step", "float64")]
    drive_ms, drive_plain = timings[("drive", "float64", "headline")]
    bounds = {
        "j2_soa_step": bound_ms(168 * N_FE, ops["j2_soa_step<double>"],
                                N_FE, step_plastic),
        "j2_soa_history": bound_ms(
            (48 * T_DRIVE + 120) * N_DRIVE, ops["j2_soa_history<double>"],
            N_DRIVE * T_DRIVE, sum(hist_plastic)),
    }
    rows = [("j2_soa_step", 173, results["step_err"], step_ms, step_plain),
            ("j2_soa_history", 464, results["hist_err"], drive_ms,
             drive_plain)]
    for form, kname, line, nbytes in (("rate", "j2_aos_step", 40, 328),
                                      ("total", "j2_total_step", 624, 256)):
        ms, _entry, plain_t, plastic1 = timings[("mp", form, "float64")]
        bounds[kname] = bound_ms(nbytes * N_MP, ops[f"{kname}<double>"],
                                 N_MP, plastic1)
        rows.append((kname, line, results[f"{form}_err"], ms, plain_t))
    for kname, line, _err, ms, _plain in rows:
        b_ms, by, t_bytes, t_ops = bounds[kname]
        say("launches", f"{kname}: bound {b_ms:.4f} ms ({by}; bytes "
                        f"{t_bytes:.4f} ms, operations {t_ops:.4f} ms); "
                        f"kernel {ms:.4f} ms = {b_ms / ms:.1%} of the bound")

    print(card, flush=True)
    print(json.dumps({"kernels": [
        {"name": kname, "route": "cuda", "source": SOURCE,
         "replaces": f"{PALLAS}:{line}", "launches": main_path[kname],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_t,
         "bound_ms": bounds[kname][0], "bound_by": bounds[kname][1],
         "library_ms": None}
        for kname, line, err, ms, plain_t in rows]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
