"""Time, count and compare builds of cmad_tpu_torch's CUDA kernels on one GPU.

Each ``--src NAME=DIR`` names a ``csrc`` directory (this checkout's, or
one of another commit unpacked beside it); every ``*.cu`` in it is
compiled with the flags of ``cmad_tpu_torch/ops/_build.py`` into its own
library. For each library the probe prints

- the registers, spills and shared memory that ``ptxas -v`` reports for
  each kernel, and the blocks per SM those allow at its block size;
- the SASS arithmetic of each kernel (``cuobjdump -sass``), see
  :func:`sass_counts`;
- the time of each kernel at the main path's shapes: ``j2_soa_history``
  at 2,097,152 points x 64 steps in three regimes (headline: every point
  plastic; mixed: the increment x 0.045 x 8 / 64, about 57% plastic;
  elastic: the increment x 1e-3, no point yields) and the three step
  kernels at 4,194,304 points, f64 and f32;
- ``j2_soa_history`` in f64 on the two materials outside the range of its
  f32 Newton phase (``chip_smoke.range_scalars``), against the plain
  loop of steps and the yield condition (not timed);
- ``j2_soa_step`` at the FE notch's shapes (47,628 and 153,600 points,
  one launch per assembly; f64 and f32; from rest with the bench
  increment, 99% of the points plastic, and x 1e-3, none): device ms
  warm (the same inputs again, a CUDA graph of ``GRAPH_REPS`` launches)
  and cold (``chip_smoke.cold_ms``: copies of the inputs larger than
  twice the 50 MB L2, in turns), its launch floor (an empty kernel on
  the library's grid, the same graph), the host ms of the wrapper
  (``soa_step_scalars_cuda`` on the library) and of its C entry alone,
  the byte and operations bounds and the error against the plain step;
  its chain floor (one thread's dependent plastic updates, ``clock64``);
  and the host's cost of the runtime queries a launch no longer makes.

``--cases j2_soa_step`` times only ``j2_soa_step`` (the FE shapes, the
chain floors and 4,194,304 points). The libraries are timed in turns
inside one process (A B B A ...), on the
same inputs, best of ``--rounds`` rounds of ``--reps`` launches, with
CUDA events; each library's output is compared with the first's, and
the cases where it is not bit-identical are listed at the end. Run
from the root of a checkout:

    python3 tools/torch_kernel_probe.py --src change=cmad_tpu_torch/csrc
    python3 tools/torch_kernel_probe.py --src parent=build/parent/cmad_tpu_torch/csrc \\
        --src change=cmad_tpu_torch/csrc --out build/probe

``--roofline`` runs only the roofline experiment (``ops/roofline.py``,
the port of ``benchmarks/local_kernels/roofline_experiment.py``): the f32
history at 2,097,152 points x 16 steps with 1, 2, 4, 8 and 12 Newton
iterations at 8 steps per launch, and with 1, 2, 4, 8 and 16 steps per
launch at 8 iterations, each row against the plain drive, on this
checkout's library:

    python3 tools/torch_kernel_probe.py --roofline

``--segsum`` times the reproducible sums instead (``csrc/segment_sum.cu``)
on the six segment plans of the 47,628-tet notch, built on the host by the
port (the residual scatter, the COO dedup and rows, the CSR dedup, the
two-level restriction and coarse pairs) and on synthetic plans of uniform
segment length: each library's thread path (``segment_sum``) and, where
it has one, its block path (``segment_sum_block``), beside ``index_add_``
on the card, each output against ``index_add_`` on the CPU bit for bit;
then the two-level ``coarse_matrix`` as a whole and its per-pair sum alone,
as PyTorch's products plus each library's segment sum and as each
library's fused ``coarse_pair_sum``, against ``coarse_matrix`` on the CPU.
Device times come from a CUDA graph of 20 launches (``chip_smoke.graph_ms``),
the libraries in turns; the notch's plans, ``csr_matvec`` (beside
PyTorch's CSR product) and the fused coarse-pair sum are also timed cold
(``chip_smoke.cold_ms``), as the byte bound counts their bytes. Each
plan's row gives its byte bound and its chain floor: the longest segment
times the latency of one dependent f64 add, which a one-thread chain
kernel measures in the same call:

    python3 tools/torch_kernel_probe.py --segsum \
        --src parent=build/parent/cmad_tpu_torch/csrc --src change=cmad_tpu_torch/csrc

``--variant NAME=BASE:OLD->NEW|...`` adds a copy of library BASE's
sources with each OLD text (which must occur once) replaced by NEW, to
time a tuning constant beside the source it comes from. ``--sass FILE``
only parses a saved ``cuobjdump -sass`` listing (no GPU needed). Results
go to stdout and to ``<out>/probe.json``.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from chip_smoke import (  # noqa: E402
    N_HIST as N_RANGE,
    T_RANGE,
    range_scalars,
    row_error,
    yield_residual,
)
from cmad_tpu_torch.ops import _build, _sass  # noqa: E402
from cmad_tpu_torch.ops.j2_radial_return import soa_step_scalars  # noqa: E402

N_HIST, T_HIST = 2_097_152, 64
N_STEP = 4_194_304
REGIMES = {"headline": 1.0, "mixed": 0.045 * 8 / T_HIST, "elastic": 1e-3}
# E 200e3, nu 0.3, Y 200, S 200, D 20 (bench.py's material) as
# [mu, lam, Y, S, D]
SCALARS = (200e3 / 2.6, 200e3 * 0.3 / (1.3 * 0.4), 200.0, 200.0, 20.0)

# --------------------------------------------------------------------------
# SASS


def divide_spans(insns) -> list[dict]:
    """The f64 and f32 operations and the instructions between each two
    consecutive divides (MUFU.RCP64H / MUFU.RCP), slow paths left out: in
    a straight-line kernel the middle spans are one Newton iteration
    each."""
    sub = _sass._subroutines(insns)
    main = [(a, p, b) for a, p, b in insns if a not in sub]
    rcp = [i for i, (_a, _p, b) in enumerate(main)
           if _sass._op(b) in ("MUFU.RCP64H", "MUFU.RCP")]
    spans = []
    for i, j in zip(rcp, rcp[1:]):
        c = Counter(_sass._op(b) for _a, _p, b in main[i:j])
        fp64_insns = sum(v for k, v in c.items()
                         if k.split(".")[0] in _sass.FP64 + ("DSETP",))
        spans.append({**_sass._ops(c), "fp64_insns": fp64_insns,
                      "insns": j - i})
    return spans


def sass_counts(insns) -> dict:
    return {**_sass.kernel_counts(insns), "divide_spans": divide_spans(insns)}


# --------------------------------------------------------------------------
# build


# the block size of each kernel: the constant of the source it launches
# with (j2_soa_step's is kThreads in builds before kStepThreads)
_BLOCK_CONST = {"j2_soa_step": ("kStepThreads", "kThreads"),
                "j2_total_step": ("kTotalTile",),
                "j2_soa_history": ("kHistThreads",),
                "j2_aos_step": ("kAosTile",)}


def _block_sizes(csrc: Path) -> dict[str, int]:
    text = "".join(p.read_text() for p in sorted(Path(csrc).glob("*.cu")))
    sizes = {}
    for kernel, consts in _BLOCK_CONST.items():
        found = [int(m.group(1)) for c in consts
                 for m in [re.search(rf"constexpr int {c} = (\d+);", text)]
                 if m]
        sizes[kernel] = found[0] if found else 256
    return sizes


def _ptxas_resources(log: str, block_sizes: dict[str, int]) -> dict[str, dict]:
    """Registers, spills and static shared memory of each kernel from the
    ``ptxas -v`` log, and the blocks per SM they allow: 65,536 registers
    allocated per warp in units of 256, 228 KB of shared memory less 1 KB
    per block, at most 2,048 threads and 32 blocks."""
    res: dict[str, dict] = {}
    cur = None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties for)"
                      r" '?(\S+?)'?(?: for|$)", line)
        if m:
            cur = _sass.kernel_key(m.group(1))
            res.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            res[cur]["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            regs = int(m.group(1))
            smem_m = re.search(r"(\d+) bytes smem", line)
            smem = int(smem_m.group(1)) if smem_m else 0
            threads = block_sizes.get(cur.split("<")[0], 256)
            per_warp = math.ceil(regs * 32 / 256) * 256
            blocks = min(65536 // (per_warp * (threads // 32)),
                         233472 // (smem + 1024), 2048 // threads, 32)
            res[cur].update(registers=regs, static_smem=smem,
                            threads=threads, blocks_per_sm=blocks,
                            occupancy=blocks * threads / 2048)
    return res


def build(name: str, csrc: Path, out: Path) -> subprocess.Popen:
    lib_dir = out / "lib" / name
    lib_dir.mkdir(parents=True, exist_ok=True)
    sources = sorted(str(p) for p in Path(csrc).glob("*.cu"))
    return subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(lib_dir / "lib.so"), *sources], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    sigs = {"j2_soa_step": [ptr] * 4 + [i64, ptr],
            "j2_soa_history": [ptr] * 4 + [i64, i64, ptr],
            "j2_aos_step": [ptr] * 6 + [i64, ptr],
            "j2_total_step": [ptr] * 5 + [i64, ptr],
            "segment_sum": [ptr] * 5 + [i64, i64, ptr],
            "segment_sum_block": [ptr] * 6 + [i64, i64, ptr],
            "coarse_pair_sum": [ptr] * 8 + [i64, i64, ptr],
            "csr_matvec": [ptr] * 5 + [i64, ptr]}
    for base, args in sigs.items():
        for sfx in ("f32", "f64"):
            # a parent's library may lack the newer entries
            fn = getattr(lib, f"{base}_{sfx}", None)
            if fn is not None:
                fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# the reproducible sums (--segsum)

# one thread's chain of dependent f64 adds: the latency of one DADD, in
# ns (CUDA events) and in SM cycles (clock64), for the chain floor of a
# segment sum that adds each output's entries in order
CHAIN_SRC = r"""
#include <cuda_runtime.h>
__global__ void dadd_chain(double* x, double step, long long n,
                           long long* cycles) {
  double acc = x[0];
  const long long t0 = clock64();
#pragma unroll 16
  for (long long i = 0; i < n; ++i) acc = __dadd_rn(acc, step);
  const long long t1 = clock64();
  x[0] = acc;
  cycles[0] = t1 - t0;
}
extern "C" int dadd_chain_run(void* x, double step, long long n,
                              void* cycles, void* stream) {
  dadd_chain<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<double*>(x), step, n, static_cast<long long*>(cycles));
  return static_cast<int>(cudaGetLastError());
}
"""
CHAIN_ADDS = 1 << 22
# synthetic plans of uniform segment length (segments, length, width):
# the restriction's 166 segments at lengths around the block path's
# threshold, then 256-entry segments in growing numbers at widths 6 and 1
SYNTH_PLANS = tuple((166, length, 6) for length in (16, 32, 48, 64, 96,
                                                    128, 512)) + tuple(
    (n_seg, 256, w) for w in (6, 1)
    for n_seg in (528, 1056, 2112, 4224, 8448, 29_040))


def dadd_latency(out: Path) -> dict:
    """ns and SM cycles per dependent f64 add, best of 3 chains of
    CHAIN_ADDS adds."""
    import torch

    src = out / "dadd_chain.cu"
    src.write_text(CHAIN_SRC)
    so = out / "lib" / "dadd_chain.so"
    so.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.dadd_chain_run.argtypes = [ctypes.c_void_p, ctypes.c_double,
                                   ctypes.c_longlong, ctypes.c_void_p,
                                   ctypes.c_void_p]
    lib.dadd_chain_run.restype = ctypes.c_int
    dev = torch.device("cuda", 0)
    x = torch.ones(1, dtype=torch.float64, device=dev)
    cyc = torch.zeros(1, dtype=torch.int64, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    best_ns, best_cyc = math.inf, math.inf
    for _ in range(4):      # the first is a warm-up
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        rc = lib.dadd_chain_run(x.data_ptr(), 1e-300, CHAIN_ADDS,
                                cyc.data_ptr(), stream)
        end.record()
        end.synchronize()
        if rc != 0:
            raise RuntimeError(f"dadd_chain launch failed: CUDA error {rc}")
        best_ns = min(best_ns, start.elapsed_time(end) * 1e6 / CHAIN_ADDS)
        best_cyc = min(best_cyc, int(cyc.item()) / CHAIN_ADDS)
    return {"ns_per_add": best_ns, "cycles_per_add": best_cyc}


def _in_turns(args, calls: dict, time_one) -> dict:
    """ms per call of each ``calls[name]``, best of ``--rounds`` timings
    ``time_one(calls[name])``, the names in turns (A B .. B A)."""
    best = {nm: math.inf for nm in calls}
    names = list(calls)
    for r in range(args.rounds):
        for nm in (names if r % 2 == 0 else names[::-1]):
            best[nm] = min(best[nm], time_one(calls[nm]))
    return best


def segsum(args, libs: dict, report: dict, out: Path) -> None:
    """The --segsum mode: the module docstring says what it times."""
    import numpy as np
    import torch

    from chip_smoke import FE_MESH, FE_RECORDS, cold_ms, graph_ms, notch_deck
    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu_torch.fem.nonlinear_solver import get_two_level_pattern
    from cmad_tpu_torch.ops import segment_sum as ss

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(0)
    f64 = torch.float64

    def stream():
        # the current stream at each launch: graph_ms captures on its own
        return torch.cuda.current_stream(dev).cuda_stream

    chain = dadd_latency(out)
    print(json.dumps({"dadd_chain": chain}), flush=True)
    report["dadd_chain"] = chain

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def in_turns(calls: dict) -> dict:
        return _in_turns(args, calls, lambda fn: graph_ms(fn, sync))

    def cold_in_turns(calls: dict) -> dict:
        return _in_turns(args, calls,
                         lambda fa: cold_ms(fa[0], fa[1], sync))

    def plan_row(label, plan, width, scale_too=False, cold=False):
        w = int(np.prod(width, dtype=np.int64))
        vals = torch.randn((plan.n_entries, *width), generator=gen,
                           device=dev, dtype=f64)
        scale = (torch.randn(plan.n_entries, generator=gen, device=dev,
                             dtype=f64) if scale_too else None)
        if plan.target is None:
            idx, src = plan.sorted_target, vals[plan.perm]
        else:
            idx, src = plan.target, vals
        if scale is not None:
            src = src * scale.reshape(-1, *([1] * len(width)))
        ref = torch.zeros((plan.n_segments, *width), dtype=f64).index_add_(
            0, idx.cpu(), src.cpu())
        perm = None if plan.perm is None else plan.perm.data_ptr()
        sc = None if scale is None else scale.data_ptr()
        calls, outs = {}, {}
        for nm, lib in libs.items():
            o = torch.empty((plan.n_segments, *width), dtype=f64, device=dev)
            calls[f"{nm}/thread"] = (lambda lib=lib, o=o: check(
                lib.segment_sum_f64(vals.data_ptr(), perm,
                                    plan.offsets.data_ptr(), sc,
                                    o.data_ptr(), plan.n_segments, w,
                                    stream())))
            outs[f"{nm}/thread"] = o
            if getattr(lib, "segment_sum_block_f64", None) is not None \
                    and w <= ss.BLOCK_MAX_WIDTH:
                ob = torch.empty_like(o)
                calls[f"{nm}/block"] = (lambda lib=lib, ob=ob: check(
                    lib.segment_sum_block_f64(
                        vals.data_ptr(), perm, plan.offsets.data_ptr(), sc,
                        plan.schedule.data_ptr(), ob.data_ptr(),
                        plan.n_segments, w, stream())))
                outs[f"{nm}/block"] = ob
        calls["index_add_"] = (lambda: vals.new_zeros(
            (plan.n_segments, *width)).index_add_(0, idx, src))
        for fn in calls.values():
            fn()
        sync()
        equal = {nm: bool(torch.equal(o.cpu(), ref)) for nm, o in outs.items()}
        ms = in_turns(calls)
        summed = int(plan.sorted_target.shape[0])
        nbytes = 8 * (summed * (w + (plan.perm is not None)
                                + (scale is not None))
                      + plan.n_segments * (w + 1) + 1)
        row = {"case": label, "entries": plan.n_entries, "summed": summed,
               "width": w, "segments": plan.n_segments,
               "longest": plan.max_length,
               "path": ss.segment_path(plan, w), "ms": ms,
               "bit_identical_to_cpu_index_add": equal,
               "byte_bound_ms": nbytes / 3.35e12 * 1e3,
               "chain_floor_ms": plan.max_length * chain["ns_per_add"] * 1e-6}
        if cold:
            # the same calls with every input read from device memory:
            # copies of vals, the plan's index arrays and the scale
            def launch(lib, path, vals_, perm_, offsets_, scale_, sched_):
                o = torch.empty((plan.n_segments, *width), dtype=f64,
                                device=dev)
                ptr = [None if t is None else t.data_ptr()
                       for t in (perm_, scale_)]
                if path == "thread":
                    check(lib.segment_sum_f64(
                        vals_.data_ptr(), ptr[0], offsets_.data_ptr(),
                        ptr[1], o.data_ptr(), plan.n_segments, w, stream()))
                else:
                    check(lib.segment_sum_block_f64(
                        vals_.data_ptr(), ptr[0], offsets_.data_ptr(),
                        ptr[1], sched_.data_ptr(), o.data_ptr(),
                        plan.n_segments, w, stream()))
                return o

            inputs = (vals, plan.perm, plan.offsets, scale, plan.schedule)
            cold_calls = {
                nm: (lambda *a, lib=libs[nm.split("/")[0]],
                     path=nm.split("/")[1]: launch(lib, path, *a), inputs)
                for nm in calls if nm != "index_add_"}
            cold_calls["index_add_"] = (
                lambda i, v: v.new_zeros((plan.n_segments, *width))
                .index_add_(0, i, v), (idx, src))
            row["ms_cold"] = cold_in_turns(cold_calls)
            row["byte_bound_share_of_cold"] = {
                nm: row["byte_bound_ms"] / t
                for nm, t in row["ms_cold"].items() if nm != "index_add_"}
        print(json.dumps(row), flush=True)
        report.setdefault("segsum", []).append(row)
        return row

    fe = build_fe_problem_from_deck(notch_deck(FE_MESH, FE_RECORDS),
                                    device=dev).fe_problem
    ka = fe.kernel_arrays
    pattern = get_two_level_pattern(fe)
    two = pattern.on(dev, f64)
    plans = {"residual scatter": (ka.eq_plan_by_block["block_1"][0], ()),
             "COO dedup": (ka.coo_dedup_plan, ()),
             "COO rows": (ka.coo_row_plan, ()),
             "CSR dedup": (fe.embedded_sparsity.dedup_plan, ()),
             "two-level restriction": (two["agg_plan"], (6,)),
             "coarse pairs": (two["pair_plan"], (6, 6))}
    for label, (plan, width) in plans.items():
        plan_row(label, plan, width,
                 scale_too=label == "two-level restriction", cold=True)
        torch.cuda.empty_cache()
    for n_seg, length, w in SYNTH_PLANS:
        plan = ss.plan_from_offsets(np.arange(n_seg + 1) * length, dev)
        plan_row(f"uniform {n_seg} x {length} x {w}", plan,
                 (w,) if w > 1 else ())

    # CG's product on K's pattern (29,040 rows) with random values: each
    # library's csr_matvec beside PyTorch's CSR product (cuSPARSE), warm
    # and cold
    sp = fe.embedded_sparsity
    data = torch.randn(sp.num_unique, generator=gen, device=dev, dtype=f64)
    xv = torch.randn(sp.n, generator=gen, device=dev, dtype=f64)

    def matvec(lib, ip, ci, d, x_):
        y = torch.empty_like(x_)
        check(lib.csr_matvec_f64(ip.data_ptr(), ci.data_ptr(), d.data_ptr(),
                                 x_.data_ptr(), y.data_ptr(), sp.n,
                                 stream()))
        return y

    def cusparse(ip, ci, d, x_):
        return ss.csr_tensor(ip, ci, d, sp.n) @ x_

    mv_args = (sp.indptr, sp.col_indices, data, xv)
    mv = {nm: (lambda *a, lib=lib: matvec(lib, *a))
          for nm, lib in libs.items()}
    mv["cuSPARSE"] = cusparse
    mv_ref = cusparse(*mv_args)
    mv_err = {nm: float((fn(*mv_args) - mv_ref).abs().max())
              for nm, fn in mv.items()}
    mv_bytes = 8 * (2 * sp.num_unique + 3 * sp.n + 1)
    row = {"case": "csr_matvec", "rows": sp.n, "nonzeros": sp.num_unique,
           "ms": in_turns({nm: (lambda fn=fn: fn(*mv_args))
                           for nm, fn in mv.items()}),
           "ms_cold": cold_in_turns({nm: (fn, mv_args)
                                     for nm, fn in mv.items()}),
           "max_abs_diff_to_cusparse": mv_err,
           "byte_bound_ms": mv_bytes / 3.35e12 * 1e3}
    print(json.dumps(row), flush=True)
    report.setdefault("segsum", []).append(row)

    # coarse_matrix as a whole, and its per-pair sum alone, on K's pattern
    # with random values: PyTorch's products + each library's segment sum
    # (the composition every library before the fused kernel ran), and
    # each library's fused coarse_pair_sum
    nnz = sp.num_unique
    unique = torch.randn(nnz, generator=gen, device=dev, dtype=f64)
    order, P, plan = two["order"], two["P_vals"], two["pair_plan"]
    na, w = pattern.num_aggregates, pattern.width
    m = pattern.coarse_dim

    def products():
        r_o, c_o = sp.rows[order], sp.col_indices[order]
        return (unique[order][:, None, None] * P[r_o][:, :, None]
                * P[c_o][:, None, :])

    def place(S):
        A = unique.new_zeros((m, m))
        A.view(na, w, na, w)[two["pI"], :, two["pJ"], :] = S
        return A

    from cmad_tpu_torch.fem.two_level import coarse_matrix
    ref = coarse_matrix(pattern, unique.cpu(), sp.rows.cpu(),
                        sp.col_indices.cpu())
    whole, alone = {}, {}
    block = products()
    for nm, lib in libs.items():
        def composed(lib=lib, path="thread"):
            b = products()
            S = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)
            if path == "thread":
                check(lib.segment_sum_f64(b.data_ptr(), None,
                                          plan.offsets.data_ptr(), None,
                                          S.data_ptr(), plan.n_segments,
                                          w * w, stream()))
            else:
                check(lib.segment_sum_block_f64(
                    b.data_ptr(), None, plan.offsets.data_ptr(), None,
                    plan.schedule.data_ptr(), S.data_ptr(), plan.n_segments,
                    w * w, stream()))
            return place(S)

        whole[f"{nm}/products+thread"] = composed
        if getattr(lib, "segment_sum_block_f64", None) is not None:
            whole[f"{nm}/products+block"] = (
                lambda composed=composed: composed(path="block"))
        if getattr(lib, "coarse_pair_sum_f64", None) is not None:
            S_f = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)

            def fused_sum(lib=lib, S_f=S_f):
                check(lib.coarse_pair_sum_f64(
                    unique.data_ptr(), order.data_ptr(), sp.rows.data_ptr(),
                    sp.col_indices.data_ptr(), P.data_ptr(),
                    plan.offsets.data_ptr(), plan.schedule.data_ptr(),
                    S_f.data_ptr(), plan.n_segments, w, stream()))
                return S_f

            whole[f"{nm}/fused"] = (lambda fused_sum=fused_sum:
                                    place(fused_sum()))
            alone[f"{nm}/fused sum"] = fused_sum
        S_t = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)
        alone[f"{nm}/thread sum"] = (lambda lib=lib, S_t=S_t: check(
            lib.segment_sum_f64(block.data_ptr(), None,
                                plan.offsets.data_ptr(), None, S_t.data_ptr(),
                                plan.n_segments, w * w, stream())))
    alone["index_add_ sum"] = (lambda: block.new_zeros(
        (plan.n_segments, w, w)).index_add_(0, plan.sorted_target, block))
    equal = {nm: bool(torch.equal(fn().cpu(), ref))
             for nm, fn in whole.items()}
    sync()
    pair_bytes = 8 * (4 * nnz + P.numel() + 2 * plan.n_segments + 1
                      + w * w * plan.n_segments)
    # the fused sum with its inputs read from device memory
    def fused_cold(lib, *a):
        S_c = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)
        check(lib.coarse_pair_sum_f64(*(t.data_ptr() for t in a),
                                      S_c.data_ptr(), plan.n_segments, w,
                                      stream()))
        return S_c

    fused_inputs = (unique, order, sp.rows, sp.col_indices, P, plan.offsets,
                    plan.schedule)
    cold_alone = {f"{nm}/fused sum": (lambda *a, lib=lib: fused_cold(lib, *a),
                                      fused_inputs)
                  for nm, lib in libs.items()
                  if getattr(lib, "coarse_pair_sum_f64", None) is not None}
    row = {"case": "coarse_matrix", "entries": nnz,
           "pairs": plan.n_segments, "longest": plan.max_length,
           "whole_ms": in_turns(whole), "sum_alone_ms": in_turns(alone),
           "fused_sum_cold_ms": cold_in_turns(cold_alone),
           "bit_identical_to_cpu_coarse_matrix": equal,
           "fused_byte_bound_ms": pair_bytes / 3.35e12 * 1e3,
           "products_bytes": block.numel() * 8,
           "chain_floor_ms": plan.max_length * chain["ns_per_add"] * 1e-6}
    print(json.dumps(row), flush=True)
    report.setdefault("segsum", []).append(row)
    bad = [r["case"] for r in report["segsum"]
           if not all(r.get("bit_identical_to_cpu_index_add",
                            r.get("bit_identical_to_cpu_coarse_matrix",
                                  {})).values())]
    print(f"segsum: every output bit-identical to the CPU's: "
          f"{'yes' if not bad else 'no: ' + str(bad)}", flush=True)
    if bad:
        raise RuntimeError(f"segsum: outputs differ from the CPU: {bad}")


# --------------------------------------------------------------------------
# j2_soa_step at the FE notch's shapes

# K1's launch at the FE path's shapes: one launch per assembly of the
# 47,628- and 153,600-tet notch (chip_smoke's FE_MESH, FE_LARGE_MESH)
N_FE_SHAPES = (47_628, 153_600)
# plastic: from rest with bench.py's increment, as at 4,194,304 (99.2% of
# the points yield; the notch's last step: 47,357 of 47,628); elastic: the
# increment x 1e-3, no point yields
FE_REGIMES = {"plastic": 1.0, "elastic": 1e-3}
CHAIN_STEPS = 1024

# one thread's chain of dependent K1 updates of one point, every one
# plastic (the same increment each step keeps loading the point): the
# latency of one plastic update, with the library's own update (soa_rows,
# or radial_rows in builds before it) compiled from its source
K1_CHAIN_SRC = r"""
#include "@SOURCE@"

template <typename T>
__global__ void k1_chain(const T* __restrict__ xi, const T* __restrict__ de,
                         const T* __restrict__ scalars, T* __restrict__ out,
                         long long steps, long long* __restrict__ stats) {
  @SETUP@
  T x[7], e[6];
  for (int r = 0; r < 7; ++r) x[r] = xi[r];
  for (int r = 0; r < 6; ++r) e[r] = de[r];
  long long plastic = 0;
  const long long t0 = clock64();
  for (long long k = 0; k < steps; ++k) {
    const T a = x[6];
    @UPDATE@
    plastic += x[6] > a;
  }
  const long long t1 = clock64();
  for (int r = 0; r < 7; ++r) out[r] = x[r];
  stats[0] = t1 - t0;
  stats[1] = plastic;
}

extern "C" int k1_chain_run(const void* xi, const void* de,
                            const void* scalars, void* out, long long steps,
                            void* stats, int f64, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  auto st = static_cast<long long*>(stats);
  if (f64) {
    k1_chain<double><<<1, 1, 0, s>>>(
        static_cast<const double*>(xi), static_cast<const double*>(de),
        static_cast<const double*>(scalars), static_cast<double*>(out),
        steps, st);
  } else {
    k1_chain<float><<<1, 1, 0, s>>>(
        static_cast<const float*>(xi), static_cast<const float*>(de),
        static_cast<const float*>(scalars), static_cast<float*>(out), steps,
        st);
  }
  return static_cast<int>(cudaGetLastError());
}
"""
# the host's cost of the runtime queries a launch made before
# launch_grid.cuh kept them (the SM count and the occupancy), against
# cudaGetDevice alone, which it still makes
QUERY_SRC = r"""
#include <cuda_runtime.h>
#include <chrono>
__global__ void empty_kernel() {}
extern "C" double query_ns(int reps, int all) {
  int device = 0, sms = 0, per_sm = 0;
  const auto t0 = std::chrono::steady_clock::now();
  for (int i = 0; i < reps; ++i) {
    cudaGetDevice(&device);
    if (all) {
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, empty_kernel,
                                                    128, 0);
    }
  }
  const auto t1 = std::chrono::steady_clock::now();
  return std::chrono::duration<double, std::nano>(t1 - t0).count() / reps;
}
"""


def _build_probe_libs(srcs: dict, out: Path) -> dict:
    """Per library: its K1 chain kernel (from its own source); and the
    empty kernel of K1's launch floor (chip_smoke.FLOOR_SRC) and the
    runtime queries' timer. Compiled in parallel, loaded with ctypes."""
    from chip_smoke import FLOOR_SRC

    procs = {}
    lib_dir = out / "lib"
    lib_dir.mkdir(parents=True, exist_ok=True)
    jobs = {"floor": FLOOR_SRC, "queries": QUERY_SRC}
    for name, d in srcs.items():
        text = (Path(d) / "j2_radial_return.cu").read_text()
        new = "soa_rows" in text
        jobs[f"chain_{name}"] = (
            K1_CHAIN_SRC
            .replace("@SOURCE@", str((Path(d) / "j2_radial_return.cu")
                                     .resolve()))
            .replace("@SETUP@", "const SoaMaterial<T> sm = soa_material("
                                "scalars);" if new else
                     "const Material<T> m = load_material(scalars);")
            .replace("@UPDATE@", "soa_rows<T, kNewtonIters>(x, e, sm);"
                     if new else "radial_rows(x, e, m);"))
    for name, text in jobs.items():
        src = out / f"{name}.cu"
        src.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(lib_dir / f"{name}.so"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on the probe's {name}:\n{log}")
        libs[name] = ctypes.CDLL(str(lib_dir / f"{name}.so"))
    libs["floor"].empty_run.argtypes = [ctypes.c_int, ctypes.c_int,
                                        ctypes.c_void_p]
    libs["floor"].empty_run.restype = ctypes.c_int
    libs["queries"].query_ns.argtypes = [ctypes.c_int, ctypes.c_int]
    libs["queries"].query_ns.restype = ctypes.c_double
    for name in srcs:
        fn = libs[f"chain_{name}"].k1_chain_run
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_longlong,
                                               ctypes.c_void_p, ctypes.c_int,
                                               ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return libs


def k1_fe_shape(args, libs: dict, srcs: dict, report: dict,
                out: Path) -> None:
    """j2_soa_step at the FE shapes, each library in turns: device ms warm
    (the same inputs, a CUDA graph of GRAPH_REPS launches) and cold
    (chip_smoke.cold_ms), the launch floor (an empty kernel on the
    library's grid, the same graph), the chain floor (one thread's plastic
    update, clock64 and CUDA events), the wrapper's time from the host
    (``soa_step_scalars_cuda`` on the library), the byte and operations
    bounds, and the output against the plain step and the first
    library's."""
    import torch

    from chip_smoke import STEP_BOUND, cold_ms, graph_ms
    from cmad_tpu_torch.ops import cuda_radial_return as cuda_rr

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(1)
    probe = _build_probe_libs(srcs, out)

    def stream():
        return torch.cuda.current_stream(dev).cuda_stream

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    def host_ms(lib_fn, calls=1000) -> float:
        """Host ms per call of ``fn()`` with ``load_library`` giving
        ``lib`` (``lib_fn = (lib, fn)``): ``calls`` calls between two reads
        of the host's clock; the device, faster than the host at these
        shapes, keeps up."""
        lib, fn = lib_fn
        saved = _build.load_library
        _build.load_library = lambda: lib
        try:
            fn()
            sync()
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            ms = (time.perf_counter() - t0) / calls * 1e3
            sync()
        finally:
            _build.load_library = saved
        return ms

    def floor_call(nm, n, dt):
        """The empty kernel on the grid the library's K1 takes for n
        points: the full grid at its occupancy (ptxas), and no more
        blocks than the points need; since launch_grid.cuh balanced, so
        that every block takes as many rounds."""
        key = f"j2_soa_step<{'double' if dt == torch.float64 else 'float'}>"
        per_sm = report["libs"][nm]["resources"][key]["blocks_per_sm"]
        threads = _block_sizes(Path(srcs[nm]))["j2_soa_step"]
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        full, needed = sms * per_sm, -(-n // threads)
        if (Path(srcs[nm]) / "launch_grid.cuh").exists():
            rounds = -(-needed // full)
            grid = -(-needed // rounds)
        else:
            grid = min(needed, full)
        return lambda: check(probe["floor"].empty_run(grid, threads,
                                                      stream()))

    # what a launch no longer asks of the runtime
    torch.cuda.synchronize()
    queries = {"three_queries_ns": min(probe["queries"].query_ns(100_000, 1)
                                       for _ in range(4)),
               "cudaGetDevice_ns": min(probe["queries"].query_ns(100_000, 0)
                                       for _ in range(4))}
    print(json.dumps({"runtime_queries": queries}), flush=True)
    report["runtime_queries"] = queries

    # the chain floor: one plastic update's latency, per library and type
    for dt, sfx in ((torch.float64, "f64"), (torch.float32, "f32")):
        if not re.search(args.cases, f"j2_soa_step {sfx} chain"):
            continue
        sc = torch.tensor(SCALARS, device=dev, dtype=dt)
        x0 = torch.zeros(8, device=dev, dtype=dt)
        de = torch.zeros(8, device=dev, dtype=dt)
        de[:6] = 1.5e-3 * torch.randn(6, generator=gen, device=dev,
                                      dtype=dt)
        row = {"case": f"j2_soa_step {sfx} chain {CHAIN_STEPS} steps",
               "cycles_per_update": {}, "ns_per_update": {},
               "plastic_updates": {}}
        for nm in libs:
            fn = probe[f"chain_{nm}"].k1_chain_run
            o = torch.zeros(8, device=dev, dtype=dt)
            stats = torch.zeros(2, device=dev, dtype=torch.int64)
            best_ns, best_cyc = math.inf, math.inf
            for _ in range(4):      # the first is a warm-up
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                check(fn(x0.data_ptr(), de.data_ptr(), sc.data_ptr(),
                         o.data_ptr(), CHAIN_STEPS, stats.data_ptr(),
                         int(dt == torch.float64), stream()))
                end.record()
                end.synchronize()
                cyc, plastic = stats.tolist()
                best_ns = min(best_ns, start.elapsed_time(end) * 1e6
                              / CHAIN_STEPS)
                best_cyc = min(best_cyc, cyc / CHAIN_STEPS)
            row["cycles_per_update"][nm] = best_cyc
            row["ns_per_update"][nm] = best_ns
            row["plastic_updates"][nm] = plastic
        print(json.dumps(row), flush=True)
        report.setdefault("k1_chain", []).append(row)

    for n in N_FE_SHAPES:
        for dt, sfx in ((torch.float64, "f64"), (torch.float32, "f32")):
            sc = torch.tensor(SCALARS, device=dev, dtype=dt)
            eps = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                       dtype=dt)
            eps = 0.5 * (eps + eps.transpose(1, 2))
            de1 = torch.zeros((8, n), device=dev, dtype=dt)
            for r, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1),
                                        (1, 2), (2, 2))):
                de1[r] = eps[:, i, j]
            xi0 = torch.zeros((8, n), device=dev, dtype=dt)
            for regime, factor in FE_REGIMES.items():
                case = f"j2_soa_step {sfx} fe {n} {regime}"
                if not re.search(args.cases, case):
                    continue
                de = factor * de1
                ref = soa_step_scalars(xi0, de, sc)
                warm, cold, floors, outs = {}, {}, {}, {}
                for nm, lib in libs.items():
                    fn = getattr(lib, f"j2_soa_step_{sfx}")

                    def launch(x, d, s, fn=fn):
                        o = torch.empty_like(x)
                        check(fn(x.data_ptr(), d.data_ptr(), s.data_ptr(),
                                 o.data_ptr(), n, stream()))
                        return o

                    outs[nm] = launch(xi0, de, sc)
                    warm[nm] = (lambda launch=launch: launch(xi0, de, sc))
                    cold[nm] = (launch, (xi0, de, sc))
                    floors[nm] = floor_call(nm, n, dt)
                sync()
                ms_warm = _in_turns(args, warm, lambda f: graph_ms(f, sync))
                ms_cold = _in_turns(args, cold,
                                    lambda fa: cold_ms(fa[0], fa[1], sync))
                ms_floor = _in_turns(args, floors,
                                     lambda f: graph_ms(f, sync))
                # the wrapper as the FE path calls it, on each library,
                # and its C entry alone, the libraries in turns
                o_host = torch.empty_like(xi0)
                wrapper, entries = {}, {}
                for nm, lib in libs.items():
                    fn = getattr(lib, f"j2_soa_step_{sfx}")
                    ptrs = (xi0.data_ptr(), de.data_ptr(), sc.data_ptr(),
                            o_host.data_ptr(), n)
                    wrapper[nm] = (lib, lambda: cuda_rr.soa_step_scalars_cuda(
                        xi0, de, sc))
                    entries[nm] = (lib, lambda fn=fn, ptrs=ptrs: check(
                        fn(*ptrs, stream())))
                host = _in_turns(args, wrapper, host_ms)
                entry = _in_turns(args, entries, host_ms)
                first = next(iter(outs))
                plastic = int((outs[first][6] > 0).sum())
                nbytes = 21 * n * de.element_size()
                bounds = {}
                for nm in libs:
                    key = f"j2_soa_step<{'double' if dt == torch.float64 else 'float'}>"
                    c = report["libs"][nm]["sass"][key]
                    t_ops = max((c["elastic"][k] * n + c["plastic"][k] * plastic)
                                / peak for k, peak in (("fp64", 34e12),
                                                       ("fp32", 67e12))) * 1e3
                    t_bytes = nbytes / 3.35e12 * 1e3
                    bounds[nm] = {"bytes_ms": t_bytes, "ops_ms": t_ops,
                                  "share_of_cold": max(t_bytes, t_ops)
                                  / ms_cold[nm]}
                errs = {}
                for nm, o in outs.items():
                    diff = (o[:7] - ref[:7]).abs().amax(dim=1)
                    scale = ref[:7].abs().amax(dim=1).clamp(min=1.0)
                    errs[nm] = float((diff / scale).max())
                bound = STEP_BOUND[str(dt).split(".")[-1]]
                row = {"case": case, "n": n, "plastic_updates": plastic,
                       "ms_cold": ms_cold, "ms_warm": ms_warm,
                       "launch_floor_ms": ms_floor,
                       "cold_above_floor_ms": {
                           nm: ms_cold[nm] - ms_floor[nm] for nm in libs},
                       "wrapper_host_ms": host, "entry_host_ms": entry,
                       "bounds": bounds,
                       "max_row_scaled_err_to_plain": errs,
                       "step_bound": bound,
                       "max_abs_diff_to_first": {
                           nm: float((o - outs[first]).abs().max())
                           for nm, o in outs.items()},
                       "bit_identical_to_first": {
                           nm: bool(torch.equal(o, outs[first]))
                           for nm, o in outs.items()}}
                print(json.dumps(row), flush=True)
                report.setdefault("k1_fe", []).append(row)
                if not all(e <= bound for e in errs.values()):
                    raise RuntimeError(f"{case}: outside the step bound: "
                                       f"{errs}")
                del warm, cold, outs, ref, de
                torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# timing


def roofline(args) -> int:
    """The roofline sweeps on this checkout's library, rows to stdout and
    ``<out>/roofline.json``."""
    import torch

    from cmad_tpu_torch.ops import roofline as rl

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card, flush=True)
    xi0, de, sc = rl.roofline_data(device=torch.device("cuda", 0))
    rows = rl.sweep(xi0, de, sc, reps=args.reps, rounds=args.rounds,
                    bound=1e-4)
    for row in rows:
        print(json.dumps(row), flush=True)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    (out / "roofline.json").write_text(json.dumps(
        {"card": card, "n": rl.N, "t": rl.T, "rows": rows}, indent=1))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR of a csrc directory (repeatable)")
    ap.add_argument("--variant", action="append", default=[],
                    help="NAME=BASE:OLD->NEW|OLD->NEW: a copy of --src BASE "
                         "with each OLD text (found exactly once) replaced "
                         "by NEW, timed like a --src (repeatable)")
    ap.add_argument("--out", default="build/probe")
    ap.add_argument("--cases", default="",
                    help="time only the cases whose name matches this regex")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sass", help="parse this cuobjdump -sass listing "
                                   "and exit")
    ap.add_argument("--segsum", action="store_true",
                    help="time the reproducible sums on the notch's plans "
                         "(segment_sum, segment_sum_block, coarse_pair_sum) "
                         "instead of the J2 kernels")
    ap.add_argument("--roofline", action="store_true",
                    help="run the roofline sweeps (ops/roofline.py) on "
                         "this checkout's library and exit")
    args = ap.parse_args()

    if args.sass:
        funcs = _sass.parse(Path(args.sass).read_text())
        print(json.dumps({k: sass_counts(v) for k, v in funcs.items()},
                         indent=1))
        return 0

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
    if args.roofline:
        return roofline(args)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    srcs = dict(s.split("=", 1) for s in (args.src or
                                          ["change=cmad_tpu_torch/csrc"]))
    for spec in args.variant:
        name, rest = spec.split("=", 1)
        base, subs = rest.split(":", 1)
        vdir = out / "variants" / name
        shutil.copytree(srcs[base], vdir, dirs_exist_ok=True)
        for sub in subs.split("|"):
            old, new = sub.split("->", 1)
            hits = [f for f in vdir.glob("*.cu") if old in f.read_text()]
            if len(hits) != 1 or hits[0].read_text().count(old) != 1:
                raise SystemExit(f"{name}: {old!r} must occur exactly once "
                                 f"in {srcs[base]}")
            hits[0].write_text(hits[0].read_text().replace(old, new))
        srcs[name] = str(vdir)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    bindir = Path(_build._nvcc()).parent
    tools = {t: str(bindir / t) if (bindir / t).exists() else shutil.which(t)
             for t in ("ncu", "nsys", "cuobjdump")}
    report = {"card": card, "torch": torch.__version__,
              "cuda": torch.version.cuda, "tools": tools, "libs": {}}
    print(card, flush=True)
    print(json.dumps({"tools": tools}), flush=True)

    procs = {name: build(name, Path(d), out) for name, d in srcs.items()}
    libs = {}
    failed = []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            print(f"[{name}] nvcc failed ({proc.returncode}):\n{log}",
                  flush=True)
            failed.append(name)
            continue
        path = out / "lib" / name / "lib.so"
        (out / f"ptxas_{name}.txt").write_text(log)
        sass = _sass.library_sass(path)
        (out / f"sass_{name}.txt").write_text(sass)
        funcs = _sass.parse(sass)
        info = {"resources": _ptxas_resources(log, _block_sizes(srcs[name])),
                "sass": {k: sass_counts(v) for k, v in funcs.items()}}
        report["libs"][name] = info
        for k, v in info["resources"].items():
            s = info["sass"].get(k, {})
            print(f"[{name}] {k}: {v}; per update: elastic "
                  f"{s.get('elastic')}, plastic adds {s.get('plastic')}; "
                  f"{s.get('instructions')} instructions; "
                  f"{s.get('mnemonics')}", flush=True)
        libs[name] = load(path)

    if args.segsum:
        segsum(args, libs, report, out)
        (out / "probe.json").write_text(json.dumps(report, indent=1))
        print(card, flush=True)
        return 1 if failed else 0

    if re.search(args.cases, "j2_soa_step"):
        k1_fe_shape(args, libs, srcs, report, out)

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream(dev).cuda_stream

    def sym_grad(n, dt):
        g = 1.5e-3 * torch.randn((n, 3, 3), generator=gen, device=dev,
                                 dtype=dt)
        return (0.5 * (g + g.transpose(1, 2))).contiguous()

    def soa_increment(n, dt):
        eps = sym_grad(n, dt)
        de = torch.zeros((8, n), device=dev, dtype=dt)
        for r, (i, j) in enumerate(((0, 0), (0, 1), (0, 2), (1, 1), (1, 2),
                                    (2, 2))):
            de[r] = eps[:, i, j]
        return de

    def timed(case, calls, kernel, dt, nbytes, updates, plastic_fn):
        """calls: {lib name: (launch(), output tensors)}; ms per launch,
        best of the rounds, the libraries in turns, and the SM clock and
        power nvidia-smi sampled every 50 ms meanwhile; each library's
        bound (bytes ``nbytes``; operations from its SASS counts for
        ``updates`` updates of which ``plastic_fn()`` are plastic) and its
        share of it."""
        if not re.search(args.cases, case):
            return {"case": case}
        names = list(calls)
        for nm in names:
            calls[nm][0]()
        torch.cuda.synchronize()
        best = {nm: math.inf for nm in names}
        smi = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
             "--format=csv,noheader,nounits", "-lms", "50"],
            stdout=subprocess.PIPE, text=True)
        for r in range(args.rounds):
            for nm in (names if r % 2 == 0 else names[::-1]):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for _ in range(args.reps):
                    calls[nm][0]()
                end.record()
                end.synchronize()
                best[nm] = min(best[nm], start.elapsed_time(end) / args.reps)
        smi.terminate()
        samples = [tuple(float(v) for v in line.split(","))
                   for line in smi.communicate()[0].splitlines()
                   if line.count(",") == 1]
        ref = calls[names[0]][1]
        diff = {nm: max(float((a - b).abs().max()) for a, b in
                        zip(calls[nm][1], ref, strict=True))
                for nm in names}
        plastic = plastic_fn()
        bounds = {}
        for nm in names:
            sass = report["libs"][nm]["sass"]
            key = f"{kernel}<{'double' if dt == torch.float64 else 'float'}"
            # the history kernel carries its Newton's iteration count
            c = sass.get(f"{key}>") or sass[f"{key}, 8>"]
            t_ops = max((c["elastic"][k] * updates + c["plastic"][k] * plastic)
                        / peak for k, peak in (("fp64", 34e12),
                                               ("fp32", 67e12))) * 1e3
            t_bytes = nbytes / 3.35e12 * 1e3
            bounds[nm] = {"bytes_ms": t_bytes, "ops_ms": t_ops,
                          "bound_ms": max(t_bytes, t_ops),
                          "share": max(t_bytes, t_ops) / best[nm]}
        row = {"case": case, "ms": best, "max_abs_diff_to_first": diff,
               "bit_identical_to_first": {nm: d == 0.0
                                          for nm, d in diff.items()},
               "updates": updates, "plastic_updates": plastic,
               "bounds": bounds,
               "sm_mhz_min_max": [min((c for c, _ in samples), default=None),
                                  max((c for c, _ in samples), default=None)],
               "power_w_max": max((w for _, w in samples), default=None)}
        print(json.dumps(row), flush=True)
        report.setdefault("times", []).append(row)
        return row

    def check(rc):
        if rc != 0:
            raise RuntimeError(f"launch failed: CUDA error {rc}")

    for dt, sfx in ((torch.float64, "f64"), (torch.float32, "f32")):
        sc = torch.tensor(SCALARS, device=dev, dtype=dt)
        # j2_soa_history
        de = soa_increment(N_HIST, dt)
        xi0 = torch.zeros((8, N_HIST), device=dev, dtype=dt)
        for regime, factor in REGIMES.items():
            hist = (factor * de).expand(T_HIST, 8, N_HIST).contiguous()
            calls = {}
            for nm, lib in libs.items():
                o = torch.empty_like(xi0)
                fn = getattr(lib, f"j2_soa_history_{sfx}")
                calls[nm] = ((lambda fn=fn, o=o: check(fn(
                    xi0.data_ptr(), hist.data_ptr(), sc.data_ptr(),
                    o.data_ptr(), N_HIST, T_HIST, stream))), (o,))
            def hist_plastic(hist=hist, sc=sc, sfx=sfx):
                # plastic updates of the drive: T chained steps of the
                # first library
                step = getattr(libs[next(iter(libs))], f"j2_soa_step_{sfx}")
                x, count = xi0, 0
                for t in range(T_HIST):
                    y = torch.empty_like(x)
                    check(step(x.data_ptr(), hist[t].data_ptr(),
                               sc.data_ptr(), y.data_ptr(), N_HIST, stream))
                    count += int((y[6] > x[6]).sum())
                    x = y
                return count

            timed(f"j2_soa_history {sfx} {regime} {N_HIST}x{T_HIST}", calls,
                  "j2_soa_history", dt,
                  (T_HIST * 6 + 15) * N_HIST * de.element_size(),
                  N_HIST * T_HIST, hist_plastic)
            del hist, calls
            torch.cuda.empty_cache()
        del de, xi0
        # j2_soa_step from rest
        de = soa_increment(N_STEP, dt)
        xi0 = torch.zeros((8, N_STEP), device=dev, dtype=dt)
        calls = {}
        for nm, lib in libs.items():
            o = torch.empty_like(xi0)
            fn = getattr(lib, f"j2_soa_step_{sfx}")
            calls[nm] = ((lambda fn=fn, o=o: check(fn(
                xi0.data_ptr(), de.data_ptr(), sc.data_ptr(), o.data_ptr(),
                N_STEP, stream))), (o,))
        first_out = calls[next(iter(calls))][1][0]
        timed(f"j2_soa_step {sfx} {N_STEP}", calls, "j2_soa_step", dt,
              21 * N_STEP * de.element_size(), N_STEP,
              lambda: int((first_out[6] > 0).sum()))
        del de, xi0, calls
        # the AoS steps from rest
        g = sym_grad(N_STEP, dt)
        z = torch.zeros_like(g)
        x0 = torch.zeros((N_STEP, 7), device=dev, dtype=dt)
        for kern in ("j2_aos_step", "j2_total_step"):
            calls = {}
            for nm, lib in libs.items():
                xo, so = torch.empty_like(x0), torch.empty_like(g)
                fn = getattr(lib, f"{kern}_{sfx}")
                if kern == "j2_aos_step":
                    launch = (lambda fn=fn, xo=xo, so=so: check(fn(
                        x0.data_ptr(), g.data_ptr(), z.data_ptr(),
                        sc.data_ptr(), xo.data_ptr(), so.data_ptr(), N_STEP,
                        stream)))
                else:
                    launch = (lambda fn=fn, xo=xo, so=so: check(fn(
                        x0.data_ptr(), g.data_ptr(), sc.data_ptr(),
                        xo.data_ptr(), so.data_ptr(), N_STEP, stream)))
                calls[nm] = (launch, (xo, so))
            first_xi = calls[next(iter(calls))][1][0]
            timed(f"{kern} {sfx} {N_STEP}", calls, kern, dt,
                  (41 if kern == "j2_aos_step" else 32) * N_STEP
                  * g.element_size(), N_STEP,
                  lambda: int((first_xi[:, 6] > 0).sum()))
            del calls
        del g, z, x0
        torch.cuda.empty_cache()

    # the f64 history outside the range of its f32 Newton phase
    if re.search(args.cases, "j2_soa_history f64 range"):
        dt = torch.float64
        sc = torch.tensor(SCALARS, device=dev, dtype=dt)
        hist = torch.zeros((T_RANGE, 8, N_RANGE), device=dev, dtype=dt)
        hist[:, :6] = 1.5e-3 * torch.randn((T_RANGE, 6, N_RANGE),
                                           generator=gen, device=dev,
                                           dtype=dt)
        xi0 = torch.zeros((8, N_RANGE), device=dev, dtype=dt)
        for label, sc_r in range_scalars(sc).items():
            ref = xi0
            for t in range(T_RANGE):
                before, ref = ref, soa_step_scalars(ref, hist[t], sc_r)
            plastic = ref[6] > before[6]
            row = {"case": f"j2_soa_history f64 range {label} "
                           f"{N_RANGE}x{T_RANGE}",
                   "points_yielding_in_last_step": int(plastic.sum()),
                   "max_row_scaled_err_to_plain": {},
                   "max_yield_residual_over_Y": {}}
            for nm, lib in libs.items():
                o = torch.empty_like(xi0)
                check(lib.j2_soa_history_f64(
                    xi0.data_ptr(), hist.data_ptr(), sc_r.data_ptr(),
                    o.data_ptr(), N_RANGE, T_RANGE, stream))
                torch.cuda.synchronize()
                row["max_row_scaled_err_to_plain"][nm] = row_error(o, ref)[1]
                row["max_yield_residual_over_Y"][nm] = yield_residual(
                    o, plastic, sc_r)
            print(json.dumps(row), flush=True)
            report.setdefault("range", []).append(row)
        del hist, xi0

    differ = [row["case"] for row in report.get("times", [])
              if not all(row["bit_identical_to_first"].values())]
    print(f"outputs bit-identical to {next(iter(libs))}'s: "
          f"{'every timed case' if not differ else 'all but ' + str(differ)}",
          flush=True)
    (out / "probe.json").write_text(json.dumps(report, indent=1))
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
