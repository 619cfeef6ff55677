#!/usr/bin/env python3
"""Reference numbers of the FE J2 primal on the notch, from cmad_tpu on the
CPU in float64 with the sparse-direct solve.

The deck is ``examples/notch_hosford.yaml`` with the J2 effective stress
swapped in and the stepped driver (the configuration of the at-scale
records in ``benchmarks/notch_hosford/``); ``--max-iters`` sets its global
Newton cap. It prints one JSON object: after each step ||U|| and max
|alpha|, the step's residual pair, and the mesh's sizes. ``chip_smoke.py``
holds the port on the card against these numbers.

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50

At 47,628 tets the drive takes about five and a half minutes on eight CPU
cores.
"""
from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="notch_h0.015.exo",
                    help="a mesh file of examples/meshes")
    ap.add_argument("--max-iters", type=int, default=15,
                    help="the global Newton's iteration cap (the deck: 15)")
    args = ap.parse_args()

    sys.path.insert(0, str(REPO))
    import numpy as np
    import yaml

    import jax

    jax.config.update("jax_platform_name", "cpu")
    jax.config.update("jax_enable_x64", True)

    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu.cli.fe_subcommands import _nls_settings
    from cmad_tpu.fem.driver import fe_quasistatic_drive_stepped

    deck = yaml.safe_load((REPO / "examples/notch_hosford.yaml").read_text())
    deck.pop("output")
    deck["discretization"]["mesh file"] = str(REPO / "examples/meshes"
                                              / args.mesh)
    deck["residuals"]["local residual"]["materials"]["block_1"]["plastic"][
        "effective stress"] = {"J2": {}}
    gr = deck["residuals"]["global residual"]
    gr["driver"] = "stepped"
    gr["nonlinear max iters"] = args.max_iters
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "deck.yaml"
        path.write_text(yaml.safe_dump(deck, sort_keys=False))
        bundle = build_fe_problem_from_deck(path, "primal")
    fe = bundle.fe_problem
    t0 = time.perf_counter()
    state, log = fe_quasistatic_drive_stepped(
        fe, bundle.t_schedule.tolist(),
        nonlinear_solver_settings=_nls_settings(bundle),
        linear_solver_settings=bundle.resolved["linear solver"])
    drive_s = time.perf_counter() - t0
    steps = range(1, len(state.U_history))
    print(json.dumps({
        "mesh": args.mesh, "max_iters": args.max_iters,
        "n_elems": int(fe.mesh.connectivity.shape[0]),
        "n_nodes": int(fe.mesh.nodes.shape[0]),
        "n_dofs": int(fe.dof_map.num_total_dofs),
        "U_norms": [float(np.linalg.norm(state.U_at(k))) for k in steps],
        "alpha_max": [float(np.abs(state.xi_at(k, "block_1")[..., 6]).max())
                      for k in steps],
        "log": log, "drive_s": drive_s, "jax": jax.__version__},
        indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
