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
  kernels at 4,194,304 points, f64 and f32.

The libraries are timed in turns inside one process (A B B A ...), on the
same inputs, best of ``--rounds`` rounds of ``--reps`` launches, with
CUDA events; each library's output is compared with the first's. Run
from the root of a checkout:

    python3 tools/torch_kernel_probe.py --src change=cmad_tpu_torch/csrc
    python3 tools/torch_kernel_probe.py --src parent=build/parent/cmad_tpu_torch/csrc \\
        --src change=cmad_tpu_torch/csrc --out build/probe

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
from collections import Counter
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
from cmad_tpu_torch.ops import _build, _sass  # noqa: E402

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


# the block size of each kernel: the constant of the source it launches with
_BLOCK_CONST = {"j2_soa_step": "kThreads",
                "j2_total_step": "kThreads",
                "j2_soa_history": "kHistThreads",
                "j2_aos_step": "kAosTile"}


def _block_sizes(csrc: Path) -> dict[str, int]:
    text = "".join(p.read_text() for p in sorted(Path(csrc).glob("*.cu")))
    sizes = {}
    for kernel, const in _BLOCK_CONST.items():
        m = re.search(rf"constexpr int {const} = (\d+);", text)
        sizes[kernel] = int(m.group(1)) if m else 256
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
        [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(lib_dir / "lib.so"),
         *sources], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    ptr, i64 = ctypes.c_void_p, ctypes.c_longlong
    sigs = {"j2_soa_step": [ptr] * 4 + [i64, ptr],
            "j2_soa_history": [ptr] * 4 + [i64, i64, ptr],
            "j2_aos_step": [ptr] * 6 + [i64, ptr],
            "j2_total_step": [ptr] * 5 + [i64, ptr]}
    for base, args in sigs.items():
        for sfx in ("f32", "f64"):
            fn = getattr(lib, f"{base}_{sfx}")
            fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


# --------------------------------------------------------------------------
# timing


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
    args = ap.parse_args()

    if args.sass:
        funcs = _sass.parse(Path(args.sass).read_text())
        print(json.dumps({k: sass_counts(v) for k, v in funcs.items()},
                         indent=1))
        return 0

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_kernel_probe: no CUDA device")
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
            c = report["libs"][nm]["sass"][
                f"{kernel}<{'double' if dt == torch.float64 else 'float'}>"]
            t_ops = max((c["elastic"][k] * updates + c["plastic"][k] * plastic)
                        / peak for k, peak in (("fp64", 34e12),
                                               ("fp32", 67e12))) * 1e3
            t_bytes = nbytes / 3.35e12 * 1e3
            bounds[nm] = {"bytes_ms": t_bytes, "ops_ms": t_ops,
                          "bound_ms": max(t_bytes, t_ops),
                          "share": max(t_bytes, t_ops) / best[nm]}
        row = {"case": case, "ms": best, "max_abs_diff_to_first": diff,
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

    (out / "probe.json").write_text(json.dumps(report, indent=1))
    print(card, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
