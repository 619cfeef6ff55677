#!/usr/bin/env python3
"""Where a notch step's time goes on the card: one step of the FE J2
primal traced by ``torch.profiler``.

Runs the deck of ``chip_smoke.py`` (the notch with J2, the stepped
driver and the linear solver of the deck's at-scale records: CG with the
two-level preconditioner, rtol 1e-6, at most 2000 iterations, the
Eisenstat-Walker forcing term; f64) through its first
``--steps - 1`` steps untraced, then traces the last step and prints the
step's wall seconds, the device time summed by kernel family (the K1
kernel, the sparse product, gathers, scatter-adds, reductions, dense
products, element-wise work, copies), the number of kernels launched, and the
device's busy and idle shares of the step's wall time (the kernels run
on one stream, so their times do not overlap). The tracer adds host
time to every operation, so the step is also run untraced first, and
the traced device time is given as a share of that wall time too (valid
when both runs took the same Newton and CG path, which it reports: f64
scatter-adds on the card round differently from run to run). Run from
the root of a checkout on a machine with an NVIDIA GPU:

    python3 tools/torch_fe_profile.py --mesh notch_h0.015.exo
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from collections import defaultdict
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

# kernel families, matched in order against the lower-cased kernel name
FAMILIES = (
    ("j2_soa_step (K1)", ("j2_soa_step",)),
    ("sparse product (cuSPARSE)", ("csrmv", "spmv", "cusparse", "csr")),
    ("gathers (tensor[index])", ("gather",)),
    ("scatter-add (index_add_, index_put_)", ("index", "scatter")),
    ("reductions (dot, norm, sum)", ("reduce", "dot", "norm")),
    ("dense products (gemv, gemm)", ("gemv", "gemm", "gemvx", "dot_kernel")),
    ("dense Cholesky (potrf, potrs, trsm)", ("potrf", "potrs", "trsm",
                                            "cholesky")),
    ("copies and fills", ("copy", "memcpy", "memset", "fill", "cat")),
    ("element-wise", ("elementwise", "vectorized", "unrolled")),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k in low for k in keys):
            return fam
    return "other"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="notch_h0.015.exo")
    ap.add_argument("--steps", type=int, default=4,
                    help="trace the last of this many steps")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("torch_fe_profile: no CUDA device")
    sys.path.insert(0, str(REPO))
    from chip_smoke import FE_RECORDS, notch_deck
    from cmad_tpu_torch.cli.fe_common import (
        build_fe_problem_from_deck,
        nonlinear_settings,
    )
    from cmad_tpu_torch.fem.driver import fe_quasistatic_drive_stepped

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    deck = notch_deck(args.mesh, FE_RECORDS)
    deck["discretization"]["num steps"] = args.steps
    bundle = build_fe_problem_from_deck(deck)
    fe = bundle.fe_problem
    nls = nonlinear_settings(bundle)
    lss = bundle.resolved["linear solver"]
    ts = bundle.t_schedule.tolist()
    state, _ = fe_quasistatic_drive_stepped(fe, ts[:-1], nls, lss)
    k = len(ts) - 2

    def last_step(stats=None):
        return fe_quasistatic_drive_stepped(
            fe, ts[-2:], nls, lss, U_init=state.U_at(k),
            xi_init_by_block={"block_1": state.xi_at(k, "block_1")},
            stats=stats)

    # the same step untraced, first: it warms the caches and gives the
    # wall time without the tracer's host overhead
    torch.cuda.synchronize()
    plain_stats: list = []
    t0 = time.perf_counter()
    last_step(plain_stats)
    torch.cuda.synchronize()
    plain_wall = time.perf_counter() - t0
    stats: list = []
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        last_step(stats)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0

    by_family: dict[str, float] = defaultdict(float)
    by_name: dict[str, list] = defaultdict(lambda: [0.0, 0])
    launches = 0
    for ev in prof.events():
        if ev.device_type != torch.autograd.DeviceType.CUDA:
            continue
        us = ev.time_range.elapsed_us()   # a kernel's own duration
        by_family[family(ev.name)] += us
        by_name[ev.name][0] += us
        by_name[ev.name][1] += 1
        launches += 1
    device_s = sum(by_family.values()) * 1e-6
    print(card)
    print(f"{args.mesh}: step {len(ts) - 1} of {len(ts) - 1}, wall "
          f"{wall:.4f} s, {stats[0]['newton_iters']} Newton iterations, "
          f"{stats[0]['assemblies']} assemblies, CG iterations "
          f"{stats[0].get('cg_iters')}")
    same = (plain_stats[0]["newton_iters"] == stats[0]["newton_iters"]
            and plain_stats[0].get("cg_iters") == stats[0].get("cg_iters"))
    print(f"device kernels {launches}, device time {device_s:.4f} s = busy "
          f"{device_s / wall:.1%}, idle {1 - device_s / wall:.1%} of the "
          f"traced step's wall time")
    print(f"untraced, the same step: wall {plain_wall:.4f} s, "
          f"{plain_stats[0]['newton_iters']} Newton iterations, CG "
          f"iterations {plain_stats[0].get('cg_iters')}; the traced "
          f"device time is {device_s / plain_wall:.1%} of it (the same "
          f"Newton and CG path: {same})")
    for fam, us in sorted(by_family.items(), key=lambda kv: -kv[1]):
        print(f"  {fam}: {us * 1e-3:.2f} ms ({us * 1e-6 / wall:.1%} of wall)")
    print("top kernels by device time:")
    for name, (us, n) in sorted(by_name.items(),
                                key=lambda kv: -kv[1][0])[:15]:
        print(f"  {us * 1e-3:9.3f} ms  {n:6d} x  {name[:110]}")
    print(json.dumps({
        "card": card, "mesh": args.mesh, "wall_s": wall,
        "untraced_wall_s": plain_wall, "same_path": same,
        "device_s": device_s, "busy": device_s / wall, "launches": launches,
        "stats": stats[0], "untraced_stats": plain_stats[0],
        "families_ms": {f: us * 1e-3 for f, us in by_family.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
