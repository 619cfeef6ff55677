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
segment length: each library's two paths (the tile path
``segment_sum_tile``, or in a library before it the thread path
``segment_sum``, and the block path ``segment_sum_block``; the tile path on
the notch's plans of one column also at each ``--tile-entries`` size) beside ``index_add_`` on the
card with an int64 and an int32 index, each output against ``index_add_``
on the CPU bit for bit; CG's product on K's pattern, each library's
``csr_matvec`` (each through its own C signature: ``LibSums``) beside
PyTorch's CSR product (cuSPARSE) with int64 and int32 indices, against
``csr_matvec_plain`` on the CPU bit for bit; then the two-level
``coarse_matrix`` as a whole and its per-pair sum alone, as PyTorch's
products plus each library's segment sum and as each library's fused
``coarse_pair_sum``, against ``coarse_matrix`` on the CPU. Device times
come from a CUDA graph of 20 launches (``chip_smoke.graph_ms``), the
libraries in turns, best of ``--rounds`` with the spread over the rounds;
the notch's plans, ``csr_matvec`` and the fused coarse-pair sum are also
timed cold (``chip_smoke.cold_ms``), as the byte bound counts their
bytes. Each row gives its byte bound with 4-byte indices and offsets (the
bound) and with 8-byte ones (the count before the tile kernel), and its
chain floor: the longest segment times the latency of one dependent f64
add, which a one-thread chain kernel measures in the same call. Last
(unless ``--no-drive``), the 47,628-tet notch is driven and its gradient
taken once per library, each library's sums in the whole path, the
libraries in turns: the U history, J and dJ/dc and the Newton and CG
counts must be bit-identical across them:

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
                "j2_aos_step": ("kAosTile",),
                "segment_sum_tile": ("kTileThreads",)}


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
            "segment_sum_tile": [ptr] * 6 + [i64, i64, i64, ptr],
            "segment_sum_block": [ptr] * 6 + [i64, i64, ptr],
            "coarse_pair_sum": [ptr] * 8 + [i64, i64, ptr]}
    # csr_matvec's entry took int64 indices and a thread per row before the
    # tile kernel, the tile path's arguments since (LibSums)
    sigs["csr_matvec"] = ([ptr] * 6 + [i64, i64, ptr]
                          if hasattr(lib, "segment_sum_tile_f64")
                          else [ptr] * 5 + [i64, ptr])
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


def _in_turns(args, calls: dict, time_one, spread=None) -> dict:
    """ms per call of each ``calls[name]``, best of ``--rounds`` timings
    ``time_one(calls[name])``, the names in turns (A B .. B A); the spread
    over the rounds (most less least, ms) into ``spread`` if given."""
    times: dict = {nm: [] for nm in calls}
    names = list(calls)
    for r in range(args.rounds):
        for nm in (names if r % 2 == 0 else names[::-1]):
            times[nm].append(time_one(calls[nm]))
    if spread is not None:
        spread.update({nm: max(t) - min(t) for nm, t in times.items()})
    return {nm: min(t) for nm, t in times.items()}


def _check_rc(rc) -> None:
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")


def _ptr(t):
    return None if t is None else t.data_ptr()


class LibSums:
    """One library's f64 segment sums and CSR product, each through that
    library's own C signature. A library with the tile path
    (``segment_sum_tile_f64``) has it and the block path, both reading the
    plan's int32 arrays, and takes ``csr_matvec_f64(tiles, indptr, cols,
    data, x, y, n_tiles, tile_entries, stream)`` with int32 indices. One
    without (before the tile kernel) has the thread path
    (``segment_sum_f64``) and the block path, both reading int64 copies of
    the plan's offsets, perm and schedule (:meth:`plan_for`), and takes
    ``csr_matvec_f64(indptr, cols, data, x, y, n, stream)`` with int64
    indices, a thread per row."""

    def __init__(self, lib):
        self.lib = lib
        self.tile = getattr(lib, "segment_sum_tile_f64", None) is not None
        self.short = "tile" if self.tile else "thread"
        self.paths = [self.short, "block"]
        self._wide: dict = {}

    def plan_for(self, plan):
        """``plan`` with the index type this library reads: itself, or
        int64 copies of its offsets, perm and schedule, made at the first
        call for each plan (the timings' warm-up) and kept."""
        import dataclasses

        if self.tile:
            return plan
        if id(plan) not in self._wide:
            self._wide[id(plan)] = (plan, dataclasses.replace(
                plan, offsets=plan.offsets.long(),
                perm=None if plan.perm is None else plan.perm.long(),
                schedule=plan.schedule.long()))
        return self._wide[id(plan)][1]

    def segment_sum(self, path, vals, plan, scale=None):
        import numpy as np
        import torch

        w = int(np.prod(vals.shape[1:], dtype=np.int64))
        out = vals.new_empty((plan.n_segments, *vals.shape[1:]))
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        pl = self.plan_for(plan)
        if path == "block":
            rc = self.lib.segment_sum_block_f64(
                vals.data_ptr(), _ptr(pl.perm), pl.offsets.data_ptr(),
                _ptr(scale), pl.schedule.data_ptr(), out.data_ptr(),
                pl.n_segments, w, stream)
        elif path == "tile":
            rc = self.lib.segment_sum_tile_f64(
                vals.data_ptr(), _ptr(pl.perm), pl.offsets.data_ptr(),
                _ptr(scale), pl.tiles.data_ptr(), out.data_ptr(),
                int(pl.tiles.shape[0]) - 1, w, pl.tile_entries, stream)
        else:
            rc = self.lib.segment_sum_f64(
                vals.data_ptr(), _ptr(pl.perm), pl.offsets.data_ptr(),
                _ptr(scale), out.data_ptr(), pl.n_segments, w, stream)
        _check_rc(rc)
        return out

    def csr_matvec(self, plan, cols64, data, x):
        """``plan`` a :class:`~cmad_tpu_torch.ops.segment_sum.CsrPlan`;
        ``cols64`` its columns as int64, which a library before the tile
        kernel reads."""
        import torch

        y = torch.empty_like(x)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rows = self.plan_for(plan.rows)
        if self.tile:
            rc = self.lib.csr_matvec_f64(
                rows.tiles.data_ptr(), rows.offsets.data_ptr(),
                plan.cols.data_ptr(), data.data_ptr(), x.data_ptr(),
                y.data_ptr(), int(rows.tiles.shape[0]) - 1,
                rows.tile_entries, stream)
        else:
            rc = self.lib.csr_matvec_f64(
                rows.offsets.data_ptr(), cols64.data_ptr(),
                data.data_ptr(), x.data_ptr(), y.data_ptr(), plan.n, stream)
        _check_rc(rc)
        return y


def with_tiles(plan, tile_entries: int):
    """``plan`` cut into tiles of at most ``tile_entries`` entries."""
    import dataclasses

    from cmad_tpu_torch.ops import segment_sum as ss

    tiles = ss._index32(ss.tile_plan(plan.offsets.cpu().numpy(),
                                     tile_entries), plan.tiles.device)
    return dataclasses.replace(plan, tiles=tiles, tile_entries=tile_entries)


def segsum(args, libs: dict, report: dict, out: Path) -> None:
    """The --segsum mode: the module docstring says what it times."""
    import dataclasses

    import numpy as np
    import torch

    from chip_smoke import (
        FE_MESH,
        FE_RECORDS,
        HBM_BYTES_PER_S,
        cold_ms,
        csr_bytes,
        csr_tensor,
        graph_ms,
        notch_deck,
        segsum_bytes,
    )
    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu_torch.fem.nonlinear_solver import get_two_level_pattern
    from cmad_tpu_torch.ops import segment_sum as ss

    dev = torch.device("cuda", 0)
    sync = torch.cuda.synchronize
    gen = torch.Generator(device=dev).manual_seed(0)
    f64 = torch.float64
    sums = {nm: LibSums(lib) for nm, lib in libs.items()}
    tile_sizes = [int(e) for e in args.tile_entries.split(",") if e]

    chain = dadd_latency(out)
    print(json.dumps({"dadd_chain": chain}), flush=True)
    report["dadd_chain"] = chain

    def in_turns(calls: dict, spread=None) -> dict:
        return _in_turns(args, calls, lambda fn: graph_ms(fn, sync), spread)

    def cold_in_turns(calls: dict, spread=None) -> dict:
        """``calls[name]`` = (fn, args, bytes a call reads)."""
        return _in_turns(args, calls,
                         lambda fa: cold_ms(fa[0], fa[1], sync, fa[2]),
                         spread)

    def bound_ms(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    def plan_row(label, plan, width, scale_too=False, cold=False,
                 sweep=False):
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
        idx32 = idx.to(torch.int32)
        ref = torch.zeros((plan.n_segments, *width), dtype=f64).index_add_(
            0, idx.cpu(), src.cpu())
        # name -> (library's sums, path, plan)
        runs = {}
        for nm, sm in sums.items():
            for path in sm.paths:
                if path != "block" or w <= ss.BLOCK_MAX_WIDTH:
                    runs[f"{nm}/{path}"] = (sm, path, plan)
            if sweep and sm.tile:
                for e in tile_sizes:
                    if e != plan.tile_entries:
                        runs[f"{nm}/tile E={e}"] = (sm, "tile",
                                                    with_tiles(plan, e))
        calls = {nm: (lambda sm=sm, path=path, pl=pl: sm.segment_sum(
            path, vals, pl, scale)) for nm, (sm, path, pl) in runs.items()}
        equal = {nm: bool(torch.equal(fn().cpu(), ref))
                 for nm, fn in calls.items()}
        calls["index_add_"] = (lambda: vals.new_zeros(
            (plan.n_segments, *width)).index_add_(0, idx, src))
        calls["index_add_ int32"] = (lambda: vals.new_zeros(
            (plan.n_segments, *width)).index_add_(0, idx32, src))
        sync()
        spread: dict = {}
        ms = in_turns(calls, spread)
        summed = int(plan.sorted_target.shape[0])
        shape = (summed, w, plan.n_segments, plan.perm is not None,
                 scale is not None)
        row = {"case": label, "entries": plan.n_entries, "summed": summed,
               "width": w, "segments": plan.n_segments,
               "longest": plan.max_length,
               "tiles": int(plan.tiles.shape[0]) - 1,
               "path": ss.segment_path(plan, w), "ms": ms,
               "spread": spread,
               "bit_identical_to_cpu_index_add": equal,
               "byte_bound_ms": bound_ms(segsum_bytes(*shape)),
               "byte_bound_ms_int64": bound_ms(segsum_bytes(
                   *shape, index_bytes=8)),
               "chain_floor_ms": plan.max_length * chain["ns_per_add"] * 1e-6}
        if cold:
            # the same calls with every input read from device memory:
            # copies of vals, the plan and the scale, as many as push the
            # bytes the bound counts out of the L2
            read = segsum_bytes(*shape)
            cold_calls = {
                nm: (lambda v, pl, sc, sm=sm, path=path: sm.segment_sum(
                    path, v, pl, sc), (vals, pl, scale), read)
                for nm, (sm, path, pl) in runs.items()}
            cold_calls["index_add_"] = (
                lambda i, v: v.new_zeros((plan.n_segments, *width))
                .index_add_(0, i, v), (idx, src), read)
            cold_calls["index_add_ int32"] = (
                cold_calls["index_add_"][0], (idx32, src), read)
            row["spread_cold"] = {}
            row["ms_cold"] = cold_in_turns(cold_calls, row["spread_cold"])
            row["byte_bound_share_of_cold"] = {
                nm: row["byte_bound_ms"] / t
                for nm, t in row["ms_cold"].items()
                if not nm.startswith("index_add_")}
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
                 scale_too=label == "two-level restriction", cold=True,
                 sweep=not width)
        torch.cuda.empty_cache()
    for n_seg, length, w in SYNTH_PLANS:
        plan = ss.plan_from_offsets(np.arange(n_seg + 1) * length, dev)
        plan_row(f"uniform {n_seg} x {length} x {w}", plan,
                 (w,) if w > 1 else ())

    # CG's product on K's pattern (29,040 rows) with random values: each
    # library's csr_matvec beside PyTorch's CSR product (cuSPARSE) with
    # int64 and with int32 indices, warm and cold, each against
    # csr_matvec_plain on the CPU
    sp = fe.embedded_sparsity
    cplan = sp.csr
    cols64 = cplan.cols.long()
    data = torch.randn(sp.num_unique, generator=gen, device=dev, dtype=f64)
    xv = torch.randn(sp.n, generator=gen, device=dev, dtype=f64)
    plain = ss.csr_matvec_plain(ss.csr_plan(sp.indptr_np, sp.col_indices_np,
                                            "cpu"), data.cpu(), xv.cpu())

    def cusparse(ip, ci, d, x_):
        return csr_tensor(ip, ci, d, sp.n) @ x_

    read = csr_bytes(sp.num_unique, sp.n)
    mv = {}
    for nm, sm in sums.items():
        mv[f"{nm}/{sm.short}"] = (
            lambda pl, c64, d, x_, sm=sm: sm.csr_matvec(pl, c64, d, x_),
            (cplan, cols64, data, xv), read)
        if sm.tile:
            for e in tile_sizes:
                if e != cplan.rows.tile_entries:
                    pl_e = dataclasses.replace(
                        cplan, rows=with_tiles(cplan.rows, e))
                    mv[f"{nm}/tile E={e}"] = (mv[f"{nm}/{sm.short}"][0],
                                              (pl_e, cols64, data, xv), read)
    mv["cuSPARSE"] = (cusparse, (cplan.rows.offsets.long(), cols64, data,
                                 xv), read)
    mv["cuSPARSE int32"] = (cusparse, (cplan.rows.offsets, cplan.cols,
                                       data, xv), read)
    mv_out = {nm: fn(*a) for nm, (fn, a, _r) in mv.items()}
    mv_err = {nm: float((y.cpu() - plain).abs().max())
              for nm, y in mv_out.items()}
    mv_equal = {nm: bool(torch.equal(y.cpu(), plain))
                for nm, y in mv_out.items() if not nm.startswith("cuSPARSE")}
    spread: dict = {}
    spread_cold: dict = {}
    row = {"case": "csr_matvec", "rows": sp.n, "nonzeros": sp.num_unique,
           "tiles": int(cplan.rows.tiles.shape[0]) - 1,
           "ms": in_turns({nm: (lambda fn=fn, a=a: fn(*a))
                           for nm, (fn, a, _r) in mv.items()}, spread),
           "ms_cold": cold_in_turns(mv, spread_cold),
           "spread": spread, "spread_cold": spread_cold,
           "bit_identical_to_cpu_plain": mv_equal,
           "max_abs_diff_to_cpu_plain": mv_err,
           "byte_bound_ms": bound_ms(csr_bytes(sp.num_unique, sp.n)),
           "byte_bound_ms_int64": bound_ms(csr_bytes(sp.num_unique, sp.n,
                                                     index_bytes=8))}
    row["byte_bound_share_of_cold"] = {
        nm: row["byte_bound_ms"] / t for nm, t in row["ms_cold"].items()}
    print(json.dumps(row), flush=True)
    report.setdefault("segsum", []).append(row)
    if not all(mv_equal.values()):
        raise RuntimeError(f"segsum: csr_matvec differs from "
                           f"csr_matvec_plain on the CPU: {mv_equal}")

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
    for nm, sm in sums.items():
        for path in sm.paths:
            whole[f"{nm}/products+{path}"] = (
                lambda sm=sm, path=path: place(sm.segment_sum(
                    path, products(), plan)))
        if getattr(sm.lib, "coarse_pair_sum_f64", None) is not None:
            S_f = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)

            def fused_sum(lib=sm.lib, S_f=S_f, pl=sm.plan_for(plan)):
                _check_rc(lib.coarse_pair_sum_f64(
                    unique.data_ptr(), order.data_ptr(), sp.rows.data_ptr(),
                    sp.col_indices.data_ptr(), P.data_ptr(),
                    pl.offsets.data_ptr(), pl.schedule.data_ptr(),
                    S_f.data_ptr(), plan.n_segments, w,
                    torch.cuda.current_stream(dev).cuda_stream))
                return S_f

            whole[f"{nm}/fused"] = (lambda fused_sum=fused_sum:
                                    place(fused_sum()))
            alone[f"{nm}/fused sum"] = fused_sum
        alone[f"{nm}/{sm.short} sum"] = (
            lambda sm=sm: sm.segment_sum(sm.short, block, plan))
    alone["index_add_ sum"] = (lambda: block.new_zeros(
        (plan.n_segments, w, w)).index_add_(0, plan.sorted_target, block))
    equal = {nm: bool(torch.equal(fn().cpu(), ref))
             for nm, fn in whole.items()}
    sync()
    pair_bytes = (8 * (4 * nnz + P.numel() + w * w * plan.n_segments)
                  + 4 * (2 * plan.n_segments + 1))
    # the fused sum with its inputs read from device memory

    def fused_cold(lib, *a):
        S_c = torch.empty((plan.n_segments, w, w), dtype=f64, device=dev)
        _check_rc(lib.coarse_pair_sum_f64(
            *(t.data_ptr() for t in a), S_c.data_ptr(), plan.n_segments, w,
            torch.cuda.current_stream(dev).cuda_stream))
        return S_c

    cold_alone = {}
    for nm, sm in sums.items():
        if getattr(sm.lib, "coarse_pair_sum_f64", None) is not None:
            pl = sm.plan_for(plan)
            cold_alone[f"{nm}/fused sum"] = (
                lambda *a, lib=sm.lib: fused_cold(lib, *a),
                (unique, order, sp.rows, sp.col_indices, P, pl.offsets,
                 pl.schedule), None)
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
    del block, fe, ka, two
    torch.cuda.empty_cache()
    bad = [r["case"] for r in report["segsum"]
           if not all(r.get("bit_identical_to_cpu_index_add",
                            r.get("bit_identical_to_cpu_coarse_matrix",
                                  {})).values())]
    print(f"segsum: every output bit-identical to the CPU's: "
          f"{'yes' if not bad else 'no: ' + str(bad)}", flush=True)
    if bad:
        raise RuntimeError(f"segsum: outputs differ from the CPU: {bad}")
    if not args.no_drive:
        notch_drives(sums, report, out)


def notch_drives(sums: dict, report: dict, out: Path) -> None:
    """The 47,628-tet notch of ``chip_smoke.py`` (4 steps, the records'
    solver) driven, and its gradient taken (``chip_smoke``'s fe-grad: J
    and dJ/dc at Y = 2.6 against the first drive's U), with each library's
    segment sums and CSR products (their own entries; K1 and the rest of
    the path this checkout's), the libraries in turns (A B .. B A, twice)
    after one drive and one gradient of warm-up: per run the Newton and CG
    iterations, the wall time, and the U history or J and dJ/dc, which
    must be bit-identical across the libraries."""
    import numpy as np
    import torch

    from chip_smoke import (
        FE_MESH,
        FE_RECORDS,
        grad_deck,
        notch_deck,
        save_displacements,
    )
    from cmad_tpu_torch.cli.fe_common import (
        build_fe_problem_from_deck,
        build_fe_stepped_vg,
        fe_primal_drive,
    )
    from cmad_tpu_torch.ops import segment_sum as ss

    own = (ss.segment_sum_cuda, ss.csr_matvec_cuda)

    def through(sm):
        """The wrappers' entries, launching ``sm``'s library."""
        cols64: dict = {}

        def seg(vals, plan, scale=None, path=None):
            w = int(np.prod(vals.shape[1:], dtype=np.int64))
            path = ss.segment_path(plan, w) if path is None else path
            return sm.segment_sum(path if path in sm.paths else "thread",
                                  vals, plan, scale)

        def csr(plan, data, x):
            if id(plan) not in cols64:
                cols64[id(plan)] = plan.cols.long()
            return sm.csr_matvec(plan, cols64[id(plan)], data, x)

        return seg, csr

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    names = list(sums)
    order = [names[0]] + (names + names[::-1]) * 2   # a warm-up first
    bundle = build_fe_problem_from_deck(notch_deck(FE_MESH, FE_RECORDS))
    drives: dict = {nm: [] for nm in names}
    grads: dict = {nm: [] for nm in names}
    truth = None
    for phase in ("drive", "gradient"):
        if phase == "gradient":
            truth = save_displacements(truth, out / "u_truth_47628.npy")
            gbundle = build_fe_problem_from_deck(grad_deck(
                FE_MESH, FE_RECORDS, truth))
            p0, s0, ts, vg = build_fe_stepped_vg(gbundle)
        for k, nm in enumerate(order):
            ss.segment_sum_cuda, ss.csr_matvec_cuda = through(sums[nm])
            try:
                if phase == "drive":
                    stats: list = []
                    (state, _log), wall = timed(
                        lambda stats=stats: fe_primal_drive(bundle, stats))
                    truth = state if truth is None else truth
                    rec = {"U": np.stack(state.U_history), "wall_s": wall,
                           "newton_iters": [s["newton_iters"]
                                            for s in stats],
                           "cg_iters": [sum(s.get("cg_iters", []))
                                        for s in stats]}
                else:
                    gstats: dict = {}
                    (J, g), wall = timed(lambda gstats=gstats: vg(
                        p0, s0, ts, stats=gstats))
                    rec = {"J": J, "dJ_dc": float(g[0]), "wall_s": wall,
                           "newton_iters": [f["newton_iters"]
                                            for f in gstats["forward"]],
                           "cg_iters": [sum(f.get("cg_iters", []))
                                        for f in gstats["forward"]]
                           + [sum(r["cg_iters"])
                              for r in gstats["reverse"]]}
            finally:
                ss.segment_sum_cuda, ss.csr_matvec_cuda = own
            if k == 0:
                continue                         # the warm-up
            (drives if phase == "drive" else grads)[nm].append(rec)
            print(json.dumps({f"notch_{phase}": nm, **{
                key: v for key, v in rec.items() if key != "U"}}),
                flush=True)
    # one gradient more per library under torch.profiler: the device time
    # of an evaluation, summed by kernel family (tools/torch_fe_profile.py)
    from torch.profiler import ProfilerActivity, profile
    from torch_fe_profile import family

    traced = {}
    for nm in names:
        ss.segment_sum_cuda, ss.csr_matvec_cuda = through(sums[nm])
        try:
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                vg(p0, s0, ts)
                torch.cuda.synchronize()
        finally:
            ss.segment_sum_cuda, ss.csr_matvec_cuda = own
        fams: dict = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                fam = family(ev.name)
                fams[fam] = fams.get(fam, 0.0) + ev.time_range.elapsed_us()
        traced[nm] = {"device_ms": sum(fams.values()) * 1e-3,
                      "families_ms": {f: us * 1e-3 for f, us in
                                      sorted(fams.items(),
                                             key=lambda kv: -kv[1])}}
        print(json.dumps({"notch_gradient_traced": nm, **traced[nm]}),
              flush=True)
    report["notch_gradient_traced"] = traced
    del bundle, gbundle, vg
    torch.cuda.empty_cache()
    first = drives[names[0]][0]
    g_first = grads[names[0]][0]
    same = {nm: all(np.array_equal(d["U"], first["U"])
                    and d["newton_iters"] == first["newton_iters"]
                    and d["cg_iters"] == first["cg_iters"]
                    for d in drives[nm])
            and all(g["J"] == g_first["J"] and g["dJ_dc"] == g_first["dJ_dc"]
                    and g["cg_iters"] == g_first["cg_iters"]
                    for g in grads[nm])
            for nm in names}
    print(json.dumps({"notch_bit_identical": same}), flush=True)
    report["notch_drives"] = {nm: [{k: v for k, v in d.items() if k != "U"}
                                   for d in drives[nm]] for nm in names}
    report["notch_gradients"] = grads
    report["notch_bit_identical"] = same
    if not all(same.values()):
        raise RuntimeError(f"segsum: the notch runs differ: {same}")


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
    ap.add_argument("--tile-entries", default="1024,4096",
                    help="with --segsum: tile sizes timed beside the "
                         "plans' own on the notch's width-1 plans and CG's "
                         "product (comma-separated)")
    ap.add_argument("--no-drive", action="store_true",
                    help="with --segsum: skip the notch drives")
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
