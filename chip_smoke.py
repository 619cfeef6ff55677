#!/usr/bin/env python3
"""Drive cmad_tpu_torch's J2+Voce return-map path once on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds both CUDA kernels of ``cmad_tpu_torch/csrc`` (nvcc, into
``build/cmad_tpu_torch/``), checks each against its plain PyTorch version
on the card, drives the port's public entry points at the headline size
(the history drive at 2,097,152 points x 64 steps, and the FE dispatch
chain at 4,194,304 points x 8 steps), checks the answers against the
plain path and against the yield condition, and prints timings of the
kernel and plain paths measured with CUDA events. It prints one line per
phase, then a JSON line with one entry per kernel, then the final JSON
line ``{"ok": true, "device": {...}}``. Any failed check raises, and the
script exits non-zero; without a CUDA device it exits non-zero at once.
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
T_HIST = (13, 64)
N_DRIVE, T_DRIVE = 2_097_152, 64   # the history-drive headline
N_FE, FE_STEPS, FE_Q = 4_194_304, 8, 8
ROUNDS, REPS = 3, 5         # timing: best of 3 rounds of 5 chained calls

# bounds: per state row, max|kernel - plain| <= bound * max(1, max|row|)
STEP_BOUND = {"float64": 1e-11, "float32": 1e-5}   # nvcc contracts FMAs
HIST_BOUND = {"float64": 1e-10, "float32": 1e-4}   # error grows over T
GRAD_RTOL = 1e-8
YIELD_TOL = 1e-9            # |phi - Y - H(alpha)| <= YIELD_TOL * Y

SOURCE = "cmad_tpu_torch/csrc/j2_radial_return.cu"
PALLAS = "cmad_tpu/ops/pallas_radial_return.py"


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def row_error(out, ref) -> tuple[float, float]:
    """(max abs error, max row-scaled error) over state rows 0-6."""
    diff = (out[:7] - ref[:7]).abs().amax(dim=1)
    scale = ref[:7].abs().amax(dim=1).clamp(min=1.0)
    return float(diff.max()), float((diff / scale).max())


def check_rows(phase, label, out, ref, bound) -> float:
    import torch

    if out.shape != ref.shape or not bool(torch.isfinite(out).all()):
        raise RuntimeError(f"{phase} {label}: bad output {tuple(out.shape)}")
    if bool((out[7] != 0).any()):
        raise RuntimeError(f"{phase} {label}: pad row is not zero")
    abs_err, rel_err = row_error(out, ref)
    say(phase, f"{label}: max_abs_err={abs_err:.3e} "
               f"max_row_scaled_err={rel_err:.3e} bound={bound:g}")
    if not rel_err <= bound:
        raise RuntimeError(f"{phase} {label}: {rel_err} > {bound}")
    return abs_err


def best_ms(fn, x0, sync) -> float:
    """Best of ROUNDS rounds of REPS chained calls, ms per call, CUDA
    events around each round after one warm-up call."""
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
    from cmad_tpu_torch.fem.xi_carrier import pack_xi, unpack_xi
    from cmad_tpu_torch.ops import _build
    from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr
    from cmad_tpu_torch.ops.j2_radial_return import (
        j2_voce_scalars,
        pack_state_soa,
        soa_step_scalars,
        strain_increment_soa,
    )
    from cmad_tpu_torch.ops.j2_soa_ad import make_soa_step_ad
    from cmad_tpu_torch.ops.return_map import make_j2_history_drive
    from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

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

    def plain_drive(xi, de_hist, sc):
        for t in range(de_hist.shape[0]):
            xi = soa_step_scalars(xi, de_hist[t], sc)
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

    # ---------------- 4. parity-history ----------------
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        for T in T_HIST:
            xi0 = zero_state(N_HIST, dt)
            de_hist = torch.zeros((T, 8, N_HIST), device=dev, dtype=dt)
            de_hist[:, :6] = (1.5e-3 / 16) * torch.randn(
                (T, 6, N_HIST), generator=gen, device=dev, dtype=dt)
            out = cuda_rr.soa_history_cuda(xi0, de_hist, scalars[dt])
            ref = plain_drive(xi0, de_hist, scalars[dt])
            frac = float((out[6] > 0).double().mean())
            say("parity-history", f"{name} N={N_HIST} T={T}: plastic "
                                  f"fraction {frac:.4f}")
            check_rows("parity-history", f"{name} N={N_HIST} T={T}", out,
                       ref, HIST_BOUND[name])
            del xi0, de_hist, out, ref
    sync()

    # ---------------- 5. history-drive (main path) ----------------
    cuda_rr.reset_launch_counts()
    drive = make_j2_history_drive(params[torch.float64])
    drive_wide = make_j2_history_drive(params[torch.float64], layout="wide")
    timings = {}
    for dt in dtypes:
        name = str(dt).split(".")[-1]
        pv, sc = params[dt].values, scalars[dt]
        de = increment(N_DRIVE, dt)
        for regime, factor in (("headline", 1.0),
                               ("mixed", 0.045 * 8 / T_DRIVE)):
            de_hist = (factor * de).expand(T_DRIVE, 8, N_DRIVE).contiguous()
            xi0 = zero_state(N_DRIVE, dt)
            out = drive(xi0, de_hist, pv)
            ref = plain_drive(xi0, de_hist, sc)
            frac = float((out[6] > 0).double().mean())
            label = f"{name} {regime} N={N_DRIVE} T={T_DRIVE}"
            err = check_rows("history-drive", label, out, ref,
                             HIST_BOUND[name])
            if name == "float64" and regime == "headline":
                results["hist_err"] = err
            # the TPU's wide kernels K7/K8 are this launch on a view
            wide = drive_wide(cuda_rr._to_wide(xi0), cuda_rr._to_wide(de_hist),
                              pv)
            if not torch.equal(cuda_rr._from_wide(wide), out):
                raise RuntimeError("history-drive: layout='wide' differs")
            say("history-drive", f"{label}: layout='wide' bit-identical")
            del out, ref, wide
            ms = best_ms(lambda x: drive(x, de_hist, pv), xi0, sync)
            plain = best_ms(lambda x: plain_drive(x, de_hist, sc), xi0, sync)
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
        say("fe-dispatch", f"one step N={N_FE}: kernel {step_ms:.4f} ms, "
                           f"plain {step_plain:.4f} ms")
        timings[("fe", "float64")] = (ms, plain)
        timings[("step", "float64")] = (step_ms, step_plain)
    launches = cuda_rr.launch_counts()
    del xi_aos, de, xc0
    sync()
    torch.cuda.empty_cache()

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

    # ---------------- 8. launches ----------------
    say("launches", f"main path (history-drive + fe-dispatch): {launches}")
    if not all(v > 0 for v in launches.values()):
        raise RuntimeError(f"launches: a kernel never ran: {launches}")

    step_ms, step_plain = timings[("step", "float64")]
    drive_ms, drive_plain = timings[("drive", "float64", "headline")]
    print(json.dumps({"kernels": [
        {"name": "j2_soa_step", "route": "cuda", "source": SOURCE,
         "replaces": f"{PALLAS}:173", "launches": launches["j2_soa_step"],
         "max_abs_err": results["step_err"], "ms": step_ms,
         "plain_ms": step_plain},
        {"name": "j2_soa_history", "route": "cuda", "source": SOURCE,
         "replaces": f"{PALLAS}:464",
         "launches": launches["j2_soa_history"],
         "max_abs_err": results["hist_err"], "ms": drive_ms,
         "plain_ms": drive_plain},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": count}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
