#!/usr/bin/env python3
"""Reference numbers of the FE primal on the notch, from cmad_tpu on the
CPU in float64 with the sparse-direct solve.

The deck is ``examples/notch_hosford.yaml`` with the stepped driver (the
configuration of the at-scale records in ``benchmarks/notch_hosford/``)
and the effective stress of ``--effective-stress``: ``J2`` (the default)
swaps J2 in, ``hosford`` keeps the deck's Hosford with a = 100;
``--max-iters`` sets its global Newton cap. It prints one JSON object:
after each step ||U|| and max |alpha|, the step's residual pair, and the
mesh's sizes. ``chip_smoke.py`` holds the port on the card against these
numbers.

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50

At 47,628 tets the J2 drive takes about five and a half minutes on
eight CPU cores; the Hosford drive took 21 minutes and its gradient
(``--gradient``) 17 more, with
``XLA_FLAGS=--xla_force_host_platform_device_count=8``.

``--gradient`` adds the gradient of the notch calibration
(``benchmarks/notch_hosford/calibrate_scale.py``): the drive above at the
deck's Y = 2.0 is the truth; then, with Y active at 2.6 under the log
transform about 2.0 and ``fe_displacement_match`` against the truth
(weight ``--weight``, the records' 1e6), J and its gradient from
``cli/fe_common.build_fe_stepped_vg`` (the stepped adjoint). The gradient
is with respect to the canonical parameter c (Y = 2.0 exp(c)); dJ/dY =
dJ/dc / Y.

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50 --gradient

``--hessian`` adds the Hessian of ``benchmarks/notch_hosford/
hessian_scale.py``: the same truth, then Y active at 2.3 with no transform
(so the Hessian is d2J/dY2), the same QoI, and ``cmad_tpu``'s stepped
Hessian (``cli/fe_common.build_fe_stepped_hessian_fn``: a tangent forward
and a tangent reverse sweep per column), with J and dJ/dY from the stepped
gradient beside it. At 47,628 tets the Hessian takes about eight minutes
on eight CPU cores; run it with
``XLA_FLAGS=--xla_force_host_platform_device_count=8`` in the environment
(the sparse-direct solve is a host callback).

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50 --hessian
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
    ap.add_argument("--gradient", action="store_true",
                    help="also J and dJ/dY at Y = 2.6 against the truth")
    ap.add_argument("--hessian", action="store_true",
                    help="also d2J/dY2, J and dJ/dY at Y = 2.3")
    ap.add_argument("--effective-stress", choices=("J2", "hosford"),
                    default="J2",
                    help="J2 swapped in (the default) or the deck's Hosford")
    ap.add_argument("--weight", type=float, default=1.0e6,
                    help="the QoI's weight (calibrate_scale.py: 1e6)")
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
    if args.effective_stress == "J2":
        deck["residuals"]["local residual"]["materials"]["block_1"][
            "plastic"]["effective stress"] = {"J2": {}}
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
    grad = {}
    if args.gradient:
        grad = gradient_reference(deck, state, args.weight)
    if args.hessian:
        grad = {**grad, "hessian": hessian_reference(deck, state,
                                                     args.weight)}
    print(json.dumps({
        **grad,
        "mesh": args.mesh, "max_iters": args.max_iters,
        "effective_stress": args.effective_stress,
        "n_elems": int(fe.mesh.connectivity.shape[0]),
        "n_nodes": int(fe.mesh.nodes.shape[0]),
        "n_dofs": int(fe.dof_map.num_total_dofs),
        "U_norms": [float(np.linalg.norm(state.U_at(k))) for k in steps],
        "alpha_max": [float(np.abs(state.xi_at(k, "block_1")[..., 6]).max())
                      for k in steps],
        "log": log, "drive_s": drive_s, "jax": jax.__version__},
        indent=1))
    return 0


def _sensitivity_bundle(deck: dict, truth, weight: float, Y: dict,
                        tmp: str):
    """cmad_tpu's bundle of ``deck`` with the initial yield ``Y`` and
    ``fe_displacement_match`` against the displacements of ``truth``."""
    import copy

    import numpy as np
    import yaml

    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck

    deck = copy.deepcopy(deck)
    deck["residuals"]["local residual"]["materials"]["block_1"]["plastic"][
        "flow stress"]["initial yield"] = {"Y": Y}
    data = np.stack(truth.U_history).reshape(len(truth.U_history), -1, 3)
    np.save(Path(tmp) / "u_data.npy", data)
    deck["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(Path(tmp) / "u_data.npy"),
                   "weight": weight}
    path = Path(tmp) / "deck.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    return build_fe_problem_from_deck(path, "hessian")


def hessian_reference(deck: dict, truth, weight: float) -> dict:
    """d2J/dY2, J and dJ/dY at Y = 2.3 (no transform) against the
    displacements of ``truth``, from cmad_tpu's stepped Hessian and
    stepped gradient."""
    import numpy as np

    from cmad_tpu.cli.fe_common import (
        build_fe_stepped_hessian_fn,
        build_fe_stepped_vg,
    )

    with tempfile.TemporaryDirectory() as tmp:
        bundle = _sensitivity_bundle(deck, truth, weight,
                                     {"value": 2.3, "active": True}, tmp)
        p0, state_init, ts, hess = build_fe_stepped_hessian_fn(bundle)
        t0 = time.perf_counter()
        H, max_asym = hess(p0, state_init, ts)
        hessian_s = time.perf_counter() - t0
        _p, _s, _ts, vg = build_fe_stepped_vg(bundle)
        J, g = vg(p0, state_init, ts)
    return {"Y": 2.3, "Y_truth": 2.0, "weight": weight,
            "H": np.asarray(H).tolist(), "max_asym": float(max_asym),
            "J": float(J), "dJ_dY": float(np.asarray(g)[0]),
            "hessian_s": hessian_s}


def gradient_reference(deck: dict, truth, weight: float) -> dict:
    """J and its gradient at Y = 2.6 against the displacements of
    ``truth`` (the drive at Y = 2.0), from cmad_tpu's stepped adjoint."""
    import numpy as np

    from cmad_tpu.cli.fe_common import build_fe_stepped_vg

    with tempfile.TemporaryDirectory() as tmp:
        bundle = _sensitivity_bundle(
            deck, truth, weight, {"value": 2.6, "active": True,
                                  "transform": {"log": 2.0}}, tmp)
        p0, state_init, ts, vg = build_fe_stepped_vg(bundle)
        t0 = time.perf_counter()
        J, g = vg(p0, state_init, ts)
    return {"Y": 2.6, "Y_truth": 2.0, "weight": weight, "J": float(J),
            "dJ_dc": float(g[0]), "dJ_dY": float(g[0]) / 2.6,
            "canonical_c": float(np.asarray(p0)[0]),
            "gradient_s": time.perf_counter() - t0}


if __name__ == "__main__":
    sys.exit(main())
