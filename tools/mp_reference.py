#!/usr/bin/env python3
"""Reference numbers of the material-point stack, from cmad_tpu on the
CPU in float64.

The decks are ``chip_smoke.mp_deck``'s: "a", the round-trip deck
(``small_rate_elastic_plastic``, plane stress, 20 steps to 1.5%,
``calibration``) and "b" (``small_elastic_plastic``, uniaxial stress, 100
steps to 1.2%, ``uniaxial_calibration``), Y (log), S and D (bounds)
active. Each runs through ``cmad_tpu``'s commands (``cmad_tpu.cli.main``
on YAML copies of the decks): ``primal`` at the truth (Y = 200), whose
output is the QoI's data (``chip_smoke.mp_truth_data``), then at
``chip_smoke.MP_EVAL_Y`` ``objective``, ``gradient`` with each
strategy, ``hessian`` (direct_adjoint and jvp for "a", direct_adjoint for
"b") and, for "a", ``calibrate`` (adjoint, L-BFGS-B) back to the truth.
It prints one JSON object: per deck the primal's ||cauchy||_F after each
step, its last state, its Newton iterations per step, J, each strategy's
J and gradient, the Hessians and the calibration's status and fitted
values; and the messages of the sensitivity rules. ``chip_smoke.py``'s
``MP_REF`` is this object.

    env JAX_PLATFORMS=cpu python tools/mp_reference.py

It takes about five minutes on this repository's development CPU, most
of it compiling.
"""
from __future__ import annotations

import json
import sys
import tempfile
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    sys.path.insert(0, str(REPO))
    import numpy as np
    import yaml

    import jax

    jax.config.update("jax_platform_name", "cpu")
    jax.config.update("jax_enable_x64", True)

    import chip_smoke as cs
    from cmad_tpu.cli.common import build_mp_problem
    from cmad_tpu.cli.main import main as cmad
    from cmad_tpu.cli.sensitivity import build_sensitivity_driver

    ref: dict = {"rules": {}}
    with tempfile.TemporaryDirectory() as tmp:
        where = Path(tmp)

        def run(command, deck, name):
            out = where / name
            path = where / f"{name}.yaml"
            path.write_text(yaml.safe_dump(
                {**deck, "output": {"path": str(out)}}, sort_keys=False))
            assert cmad([command, str(path)]) == 0
            return path, out

        for case in ("a", "b"):
            r = ref[case] = {}
            path, out = run("primal", cs.mp_deck(where, case),
                            f"truth_{case}")
            cauchy = np.load(out / "cauchy.npy")
            xi = np.load(out / "xi.npy")
            stretches = build_mp_problem(path, "primal").model.layout.slc(
                "off-axis stretches") if case == "b" else None
            np.save(where / f"data_{case}.npy",
                    cs.mp_truth_data(case, cauchy, xi, stretches))
            r["norms"] = np.linalg.norm(cauchy, axis=(0, 1)).tolist()
            r["xi_last"] = xi[-1].tolist()
            r["iters"] = [e["iters"] for e in json.loads(
                (out / "solver.json").read_text())]

            deck = cs.mp_deck(where, case, cs.MP_EVAL_Y[case], qoi=True)
            _p, out = run("objective", deck, f"objective_{case}")
            r["J"] = json.loads((out / "J.json").read_text())["J"]
            r["grad"] = {}
            for st in cs.MP_STRATEGIES:
                _p, out = run("gradient", {**deck, "sensitivity": {
                    "type": st}}, f"gradient_{case}_{st}")
                r["grad"][st] = [
                    json.loads((out / "J.json").read_text())["J"],
                    np.load(out / "grad.npy").tolist()]
            r["hess"] = {}
            for st in (("direct_adjoint", "jvp") if case == "a"
                       else ("direct_adjoint",)):
                _p, out = run("hessian", {**deck, "sensitivity": {
                    "type": st}}, f"hessian_{case}_{st}")
                r["hess"][st] = np.load(out / "hess.npy").tolist()
            if case == "a":
                _p, out = run("calibrate", {
                    **deck, "sensitivity": {"type": "adjoint"},
                    "optimizer": {"algorithm": "L-BFGS-B"}}, "calibrate_a")
                status = json.loads((out / "opt_status.json").read_text())
                fs = yaml.safe_load((out / "opt_params.yaml").read_text())[
                    "plastic"]["flow stress"]
                voce = fs["hardening"]["voce"]
                r["calibrate"] = {**status, "Y_S_D": [
                    fs["initial yield"]["Y"]["value"], voce["S"]["value"],
                    voce["D"]["value"]]}

    for sub, st in (("hessian", "adjoint"), ("hessian", "direct"),
                    ("calibrate", "direct_adjoint")):
        try:
            build_sensitivity_driver({"type": st}, None, None, {}, sub)
        except ValueError as e:
            ref["rules"][f"{sub}:{st}"] = str(e)
    print(json.dumps(ref))
    return 0


if __name__ == "__main__":
    sys.exit(main())
