#!/usr/bin/env python3
"""The notch drive's Newton path under each build of ``j2_soa_step`` (K1).

Drives the 47,628-tet FE J2 notch of ``chip_smoke.py`` (4 steps, f64, the
records' solver: CG + two-level at rtol 1e-6, Eisenstat-Walker) on the
card once for each K1: this checkout's library (the package's wrapper),
each ``--src NAME=DIR`` build (its ``j2_soa_step_f64`` entry, compiled
from that ``csrc`` as ``tools/torch_kernel_probe.py`` compiles it), and
the plain step (``ops/j2_radial_return.soa_step_scalars``) on the card.
Every other part of the path is this checkout's. At each K1 call of each
drive, every K1 runs on the same inputs.

It prints, per drive and load step, the Newton iterations, the CG
iterations per solve, ||U|| and the step's residual pair; per step, over
that step's K1 calls, each K1's largest row-scaled difference from the
plain step, the number of points it classifies otherwise than the plain
step (a point is plastic where its alpha grows, xi'[6] > xi[6]), how many
of those at the step's first call, and the largest difference of alpha'
from the plain step's at those points; and, per step, how far each
drive's K1 inputs are from the first drive's at the same call. Run from the root of
a checkout:

    python3 tools/torch_notch_witness.py \\
        --src parent=build/parent/cmad_tpu_torch/csrc --out build/witness

It writes everything to ``OUT/witness.json`` as well.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", action="append", default=[],
                    help="NAME=DIR of a csrc directory whose j2_soa_step "
                         "drives the notch too (repeatable)")
    ap.add_argument("--out", default="build/witness")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "tools"))
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_notch_witness: no CUDA device")

    from chip_smoke import (
        FE_MESH,
        FE_RECORDS,
        fe_converged,
        notch_deck,
        row_error,
    )
    from cmad_tpu_torch.cli.fe_common import (
        build_fe_problem_from_deck,
        nonlinear_settings,
        run_primal_fe,
    )
    from cmad_tpu_torch.ops import j2_soa_ad
    from cmad_tpu_torch.ops.j2_radial_return import soa_step_scalars
    from torch_kernel_probe import build, load

    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)
    srcs = dict(s.split("=", 1) for s in args.src)
    procs = {name: build(name, Path(d), out_dir) for name, d in srcs.items()}
    k1 = {"this": j2_soa_ad.soa_step_scalars_cuda}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on {name}:\n{log}")
        lib = load(out_dir / "lib" / name / "lib.so")

        def launch(xi, de, sc, entry=lib.j2_soa_step_f64):
            out = torch.empty_like(xi)
            rc = entry(xi.data_ptr(), de.data_ptr(), sc.data_ptr(),
                       out.data_ptr(), xi.shape[1],
                       torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"j2_soa_step launch failed: {rc}")
            return out

        k1[name] = launch
    k1["plain"] = soa_step_scalars

    report: dict = {"drives": {}}
    first_inputs: dict = {}     # (step, call) -> (xi, de) of the first drive

    for drive in k1:
        bundle = build_fe_problem_from_deck(notch_deck(FE_MESH, FE_RECORDS))
        stats: list = []
        per_step: dict = {}

        def hooked(xi, de, sc, drive=drive, stats=stats, per_step=per_step):
            step = len(stats) + 1
            rec = per_step.setdefault(step, {
                "calls": 0, "max_row_err_vs_plain": {},
                "points_classified_otherwise_than_plain": {},
                "of_them_at_the_first_call": {},
                "max_alpha_diff_where_classified_otherwise": {},
                "max_abs_input_diff_vs_first_drive": 0.0,
                "calls_with_inputs_equal_to_first_drive": 0})
            call = rec["calls"]
            rec["calls"] += 1
            outs = {name: fn(xi, de, sc) for name, fn in k1.items()}
            plain = outs["plain"]
            plain_plastic = plain[6] > xi[6]
            for name, o in outs.items():
                err = row_error(o, plain)[1]
                rec["max_row_err_vs_plain"][name] = max(
                    rec["max_row_err_vs_plain"].get(name, 0.0), err)
                otherwise = (o[6] > xi[6]) != plain_plastic
                n = int(otherwise.sum())
                for key, add in (
                        ("points_classified_otherwise_than_plain", n),
                        ("of_them_at_the_first_call", n if call == 0 else 0)):
                    rec[key][name] = rec[key].get(name, 0) + add
                key = "max_alpha_diff_where_classified_otherwise"
                rec[key][name] = max(rec[key].get(name, 0.0), float(
                    (o[6] - plain[6])[otherwise].abs().max()) if n else 0.0)
            if drive == next(iter(k1)):
                first_inputs[(step, call)] = (xi.clone(), de.clone())
            elif (step, call) in first_inputs:
                x0, d0 = first_inputs[(step, call)]
                diff = max(float((xi - x0).abs().max()),
                           float((de - d0).abs().max()))
                rec["max_abs_input_diff_vs_first_drive"] = max(
                    rec["max_abs_input_diff_vs_first_drive"], diff)
                rec["calls_with_inputs_equal_to_first_drive"] += int(
                    torch.equal(xi, x0) and torch.equal(de, d0))
            return outs[drive]

        j2_soa_ad.soa_step_scalars_cuda = hooked
        try:
            state, log = run_primal_fe(bundle, stats)
            torch.cuda.synchronize()
        finally:
            j2_soa_ad.soa_step_scalars_cuda = k1["this"]
        norms = [float(np.linalg.norm(u)) for u in state.U_history[1:]]
        steps = []
        for k, (s, e) in enumerate(zip(stats, log, strict=True), start=1):
            steps.append({"step": k, "newton_iters": s["newton_iters"],
                          "assemblies": s["assemblies"],
                          "cg_iters": s.get("cg_iters", []),
                          "U_norm": norms[k - 1],
                          "initial_residual": e["initial_residual"],
                          "final_residual": e["final_residual"],
                          **per_step.get(k, {})})
        converged = fe_converged(log, nonlinear_settings(bundle))
        report["drives"][drive] = {"converged": converged, "steps": steps,
                                   "U": np.stack(state.U_history)}
        print(json.dumps({"drive": drive, "converged": converged,
                          "newton_iters": [s["newton_iters"] for s in steps],
                          "cg_iters": [sum(s["cg_iters"]) for s in steps],
                          "U_norm": norms}), flush=True)
        for s in steps:
            print(json.dumps({"drive": drive, **s}), flush=True)
        del bundle, state
        torch.cuda.empty_cache()

    U_first = report["drives"]["this"]["U"]
    for drive, d in report["drives"].items():
        U = d.pop("U")
        d["U_rel_diff_vs_this"] = [
            float(np.linalg.norm(a - b) / np.linalg.norm(b))
            for a, b in zip(U[1:], U_first[1:], strict=True)]
        print(json.dumps({"drive": drive, "U_rel_diff_vs_this":
                          d["U_rel_diff_vs_this"]}), flush=True)
    (out_dir / "witness.json").write_text(json.dumps(report, indent=1))
    return 0 if all(d["converged"] for d in report["drives"].values()) else 1


if __name__ == "__main__":
    sys.exit(main())
