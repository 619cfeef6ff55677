#!/usr/bin/env python3
"""Reference numbers of the FE primal on the notch, from cmad_tpu on the
CPU in float64 with the sparse-direct solve.

The deck is ``examples/notch_hosford.yaml`` with the stepped driver (the
configuration of the at-scale records in ``benchmarks/notch_hosford/``)
and the effective stress of ``--effective-stress``: ``J2`` (the default)
swaps J2 in, ``hosford`` keeps the deck's Hosford with a = 100, and
``hosford_principal`` takes ``examples/notch_hosford_principal.yaml``
instead (the frame-invariant Hosford, a = 100; otherwise the same deck);
``--max-iters`` sets its global Newton cap, ``--steps N`` keeps the
deck's first N load steps and ``--step-size S`` sets their size (the
deck: 1.0, t = S, 2 S, ...). It prints one JSON object:
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

The principal-Hosford deck as written (480 tets, four steps, the deck's
cap of 15) with its gradient, and its first step at 47,628 tets:

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.080.exo --effective-stress hosford_principal \\
        --gradient
    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50 \\
        --effective-stress hosford_principal --steps 1

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

``--model elastic`` swaps the deck's material for the closed-form
elastic model with the deck's E = 1000 and nu = 0.25 (``type: elastic``,
``def_type: full_3d``) and the Cauchy stress of ``--elastic-stress``
(``isotropic_linear``, the default, or ``neohookean``); the JSON then has
no max |alpha|. Its ``--gradient`` is the elastic calibration's: the
drive is the truth, its reaction on ``ymax_sides`` (component 1, the
loaded one) after each step the data, and J and dJ/dc come from E and nu
active at E = 1300 (the log transform about 1000, c = log(E / 1000)) and
nu = 0.3 (no transform) with ``fe_load_match`` (weight 1), which sees both
(the displacement of one isotropic linear material under displacement
loading does not depend on E).

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50 --model elastic \\
        --elastic-stress neohookean --gradient

``--loads`` (with J2) loads the notch by a traction and a body force in
place of the displacement ``load_y`` (``chip_smoke.loaded_deck``: ``surface
flux bcs`` ``[equilibrium, ymax_sides, "0.0", "0.75 * t", "0.0"]`` and
``body forces`` ``[equilibrium, "0.0", "-0.5 * t", "0.0"]``), the three
symmetry clamps kept. Its ``--gradient`` is the notch calibration's on
that loaded drive.

    env JAX_PLATFORMS=cpu python tools/fe_notch_reference.py \\
        --mesh notch_h0.015.exo --max-iters 50 --loads
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
    ap.add_argument("--effective-stress",
                    choices=("J2", "hosford", "hosford_principal"),
                    default="J2",
                    help="J2 swapped in (the default), the deck's Hosford, "
                         "or the principal-Hosford deck")
    ap.add_argument("--steps", type=int, default=None,
                    help="keep the deck's first N load steps (default: "
                         "all four)")
    ap.add_argument("--step-size", type=float, default=None,
                    help="the load steps' size (default: the deck's 1.0)")
    ap.add_argument("--weight", type=float, default=1.0e6,
                    help="the QoI's weight (calibrate_scale.py: 1e6)")
    ap.add_argument("--model", choices=("plastic", "elastic"),
                    default="plastic",
                    help="the deck's elastic-plastic material (the "
                         "default) or the closed-form elastic model")
    ap.add_argument("--elastic-stress",
                    choices=("isotropic_linear", "neohookean"),
                    default="isotropic_linear",
                    help="the elastic model's Cauchy stress")
    ap.add_argument("--loads", action="store_true",
                    help="a traction on ymax_sides and a body force in "
                         "place of the displacement load")
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

    name = ("notch_hosford_principal.yaml"
            if args.effective_stress == "hosford_principal"
            else "notch_hosford.yaml")
    deck = yaml.safe_load((REPO / "examples" / name).read_text())
    deck.pop("output")
    deck["discretization"]["mesh file"] = str(REPO / "examples/meshes"
                                              / args.mesh)
    elastic = args.model == "elastic"
    if elastic:
        deck = elastic_deck(deck, args.elastic_stress)
    elif args.effective_stress == "J2":
        deck["residuals"]["local residual"]["materials"]["block_1"][
            "plastic"]["effective stress"] = {"J2": {}}
    if args.steps is not None:
        deck["discretization"]["num steps"] = args.steps
    if args.step_size is not None:
        deck["discretization"]["step size"] = args.step_size
    if args.loads:
        from chip_smoke import loaded_deck

        deck = loaded_deck(deck)
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
    if args.gradient and elastic:
        grad = elastic_gradient_reference(deck, bundle, state)
    elif args.gradient:
        grad = gradient_reference(deck, state, args.weight)
    if args.hessian:
        grad = {**grad, "hessian": hessian_reference(deck, state,
                                                     args.weight)}
    print(json.dumps({
        **grad,
        "mesh": args.mesh, "max_iters": args.max_iters,
        "steps": len(state.U_history) - 1,
        "t": [float(t) for t in bundle.t_schedule[1:]],
        **({"model": "elastic", "elastic_stress": args.elastic_stress}
           if elastic else {"effective_stress": args.effective_stress}),
        **({"loads": {k: deck[k] for k in ("surface flux bcs",
                                            "body forces")}}
           if args.loads else {}),
        "n_elems": int(fe.mesh.connectivity.shape[0]),
        "n_nodes": int(fe.mesh.nodes.shape[0]),
        "n_dofs": int(fe.dof_map.num_total_dofs),
        "U_norms": [float(np.linalg.norm(state.U_at(k))) for k in steps],
        **({} if elastic else {"alpha_max": [
            float(np.abs(state.xi_at(k, "block_1")[..., 6]).max())
            for k in steps]}),
        "log": log, "drive_s": drive_s, "jax": jax.__version__},
        indent=1))
    return 0


def elastic_deck(deck: dict, elastic_stress: str) -> dict:
    """The notch deck with the closed-form elastic model (the deck's E
    and nu) in place of its elastic-plastic material."""
    local = deck["residuals"]["local residual"]
    local["type"] = "elastic"
    local["elastic_stress"] = elastic_stress
    local["materials"] = {"block_1": {"elastic": dict(
        local["materials"]["block_1"]["elastic"])}}
    return deck


def elastic_gradient_reference(deck: dict, bundle, truth) -> dict:
    """J and its gradient at E = 1300 (log transform about 1000) and nu =
    0.3 against the reactions of ``truth`` (the drive at E = 1000, nu =
    0.25) on ``ymax_sides``, component 1, from cmad_tpu's stepped
    adjoint."""
    import copy

    import numpy as np
    import yaml

    from cmad_tpu.cli.fe_common import (
        build_fe_problem_from_deck,
        build_fe_stepped_vg,
    )
    from cmad_tpu.qois.fe_load_match import FELoadMatch

    fe = bundle.fe_problem
    with tempfile.TemporaryDirectory() as tmp:
        series = Path(tmp) / "reaction.csv"
        FELoadMatch(fe, bundle.t_schedule.tolist(), "ymax_sides", [1],
                    output_file=str(series)).write_primal_outputs(fe, truth)
        data = np.loadtxt(series, delimiter=",").reshape(-1, 1)
        np.save(Path(tmp) / "reaction.npy", data)
        deck = copy.deepcopy(deck)
        deck["residuals"]["local residual"]["materials"]["block_1"] = {
            "elastic": {"E": {"value": 1300.0, "active": True,
                              "transform": {"log": 1000.0}},
                        "nu": {"value": 0.3, "active": True}}}
        deck["qoi"] = {"name": "fe_load_match", "sideset": "ymax_sides",
                       "components": [1],
                       "data_file": str(Path(tmp) / "reaction.npy"),
                       "weight": 1.0}
        path = Path(tmp) / "deck.yaml"
        path.write_text(yaml.safe_dump(deck, sort_keys=False))
        sens = build_fe_problem_from_deck(path, "gradient")
        p0, state_init, ts, vg = build_fe_stepped_vg(sens)
        t0 = time.perf_counter()
        J, g = vg(p0, state_init, ts)
    return {"E": 1300.0, "nu": 0.3, "E_truth": 1000.0, "nu_truth": 0.25,
            "reactions": data[:, 0].tolist(), "J": float(J),
            "dJ_dc": np.asarray(g).tolist(),
            "canonical_c": np.asarray(p0).tolist(),
            "gradient_s": time.perf_counter() - t0}


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
