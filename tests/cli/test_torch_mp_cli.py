"""The port's material-point deck commands on the CPU, against
cmad_tpu's commands.

The round-trip deck of ``tests/cli/test_mp_roundtrips.py``
(``small_rate_elastic_plastic``, plane stress, Y (log), S and D (bounds)
active) on a 6-step ramp to 1.5%, written as YAML and run through
``cmad_tpu.cli.main.main`` and through the port's ``main`` with
``device="cpu"`` (PyYAML and the schema on both sides); the data are the
port's primal at the deck's values, the sensitivities at Y = 220:

- ``primal``: ``cauchy``, ``xi`` and its per-variable files to 1e-12 of
  each file's largest value, ``solver.json`` with the same Newton
  iterations, ``deck.resolved.yaml`` the same deck;
- ``calibrate`` (adjoint) at ``maxiter: 2`` (not a recovery): the same
  ``opt_status`` fields, the history's J and gradient norms to 1e-10 and
  1e-9, the fitted values to 1e-9;
- ``objective``, ``gradient`` (adjoint) and ``hessian`` (direct_adjoint
  and jvp): J to 1e-10 and the gradient's norm to 1e-9 of cmad_tpu's
  ``calibrate`` at its first evaluation (the deck's point); the gradient
  file equals the port's library call bit for bit (which
  ``tests/objectives/test_torch_mp_objectives.py`` holds to cmad_tpu's
  gradient and Hessians to 1e-9); the two Hessians agree to 1e-9;
  ``gradient`` with direct_adjoint warns on stderr;
- the sensitivity rules raise with cmad_tpu's messages; an FE QoI in an
  MP deck raises cmad_tpu's error; without ``--device cpu`` a command
  asks for the card and raises here.
"""
from __future__ import annotations

import copy
import json

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu.cli.main import main as jax_main
from cmad_tpu.cli.sensitivity import (
    build_sensitivity_driver as jax_sensitivity,
)
from cmad_tpu_torch.cli import mp_subcommands as ms
from cmad_tpu_torch.cli.common import build_mp_problem
from cmad_tpu_torch.cli.main import main
from cmad_tpu_torch.cli.sensitivity import build_sensitivity_driver

from tests.support.torch_mp import params_section, ramp_F

torch.set_num_threads(1)

J_RTOL, GRAD_RTOL, TRAJ_RTOL = 1e-10, 1e-9, 1e-12


def _deck(tmp, **sections) -> dict:
    params = params_section()
    del params["rotation matrix"]
    deck = {
        "problem": {"type": "material_point", "name": "roundtrip"},
        "model": {"name": "small_rate_elastic_plastic",
                  "def_type": "plane_stress"},
        "parameters": params,
        "deformation": {"history_file": str(tmp / "F.npy")},
        "solver": {"newton": {}},
    }
    deck.update(sections)
    return deck


def _qoi(tmp) -> dict:
    return {"name": "calibration", "data_file": str(tmp / "data.npy"),
            "weight": [[1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 0.0]]}


def _at_Y(deck, Y):
    deck = copy.deepcopy(deck)
    deck["parameters"]["plastic"]["flow stress"]["initial yield"]["Y"][
        "value"] = Y
    return deck


def _write(tmp, name, deck):
    path = tmp / f"{name}.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    return path


def _run(runner, tmp, name, deck):
    out = tmp / name
    assert runner(_write(tmp, name, {**deck, "output": {"path": str(out)}}))
    return out


def _rel(a, b) -> float:
    return float(np.abs(a - b).max() / max(1e-300, np.abs(b).max()))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each command's output directory, through both packages."""
    tmp = tmp_path_factory.mktemp("mp_cli")
    np.save(tmp / "F.npy", ramp_F(2))
    truth = tmp / "truth"
    assert ms.run_primal_mp(_deck(tmp), truth, device="cpu") == 0
    np.save(tmp / "data.npy", np.load(truth / "cauchy.npy"))

    def jax(path):
        return jax_main([path.name.split("-")[0], str(path)]) == 0

    def port(path):
        return main([path.name.split("-")[0], str(path)],
                    device="cpu") == 0

    q = _qoi(tmp)
    off = _at_Y(_deck(tmp, qoi=q), 220.0)
    adjoint = {**off, "sensitivity": {"type": "adjoint"}}
    cal = {**adjoint, "optimizer": {"algorithm": "L-BFGS-B",
                                    "options": {"maxiter": 2}}}
    out = {"jax": {}, "port": {}}
    for side, runner in (("jax", jax), ("port", port)):
        out[side]["primal"] = _run(runner, tmp, f"primal-{side}",
                                   _deck(tmp))
        out[side]["calibrate"] = _run(runner, tmp, f"calibrate-{side}", cal)
    out["port"]["objective"] = _run(port, tmp, "objective-port", off)
    out["port"]["gradient"] = _run(port, tmp, "gradient-port", adjoint)
    for st in ("direct_adjoint", "jvp"):
        sens = {**off, "sensitivity": {"type": st}}
        out["port"][f"hessian_{st}"] = _run(port, tmp, f"hessian-{st}", sens)
    return tmp, out


def _J(path) -> float:
    return json.loads((path / "J.json").read_text())["J"]


def _trajectory_matches(port, ref):
    names = sorted(p.name for p in ref.glob("*.npy"))
    assert names == sorted(p.name for p in port.glob("*.npy"))
    assert "xi_block_02.npy" in names
    for name in names:
        a, b = np.load(port / name), np.load(ref / name)
        assert a.shape == b.shape
        assert _rel(a, b) <= TRAJ_RTOL, name
    log, log_ref = (json.loads((d / "solver.json").read_text())
                    for d in (port, ref))
    assert [e["iters"] for e in log] == [e["iters"] for e in log_ref]
    assert all(e["final_residual"] < 1e-12 for e in log)


def test_primal_matches_cmad_tpu(runs):
    _tmp, out = runs
    port, ref = out["port"]["primal"], out["jax"]["primal"]
    _trajectory_matches(port, ref)
    assert np.all(np.load(port / "cauchy.npy")[:, :, 0] == 0.0)
    decks = [yaml.safe_load((d / "deck.resolved.yaml").read_text())
             for d in (port, ref)]
    assert decks[0].pop("output")["path"] == str(port)
    assert decks[1].pop("output")["path"] == str(ref)
    assert decks[0] == decks[1]


def _first_evaluation(out) -> dict:
    """cmad_tpu's calibrate at its first evaluation: the deck's point."""
    return json.loads((out["jax"]["calibrate"] / "opt_history.json")
                      .read_text())["history"][0]


def test_objective_matches_cmad_tpu(runs):
    _tmp, out = runs
    port = out["port"]["objective"]
    cauchy, cauchy_truth = (np.load(d / "cauchy.npy") for d in (
        port, out["jax"]["primal"]))
    assert _rel(cauchy, cauchy_truth) > 1e-3  # Y = 220: not the truth
    J_ref = _first_evaluation(out)["J"]
    assert J_ref > 0.0
    assert abs(_J(port) - J_ref) <= J_RTOL * J_ref


@pytest.mark.parametrize("run", ["gradient", "hessian_direct_adjoint",
                                 "hessian_jvp"])
def test_sensitivity_commands_match_cmad_tpu(runs, run):
    _tmp, out = runs
    port, ref = out["port"][run], _first_evaluation(out)
    grad = np.load(port / "grad.npy")
    assert abs(_J(port) - ref["J"]) <= J_RTOL * ref["J"]
    assert abs(np.linalg.norm(grad) - ref["grad_norm"]) \
        <= GRAD_RTOL * ref["grad_norm"]
    if run.startswith("hessian"):
        H = np.load(port / "hess.npy")
        assert H.shape == (3, 3)
        H_other = np.load(out["port"]["hessian_jvp"] / "hess.npy")
        assert _rel(H, H_other) <= 1e-9
        return
    deck = yaml.safe_load((port / "deck.resolved.yaml").read_text())
    driver, x = ms.sensitivity_driver(
        build_mp_problem(deck, "gradient", device="cpu"), "gradient")
    result = driver.evaluate_grad(x)
    assert np.array_equal(grad, result.grad)
    assert _J(port) == result.J


def test_calibrate_at_capped_maxiter_matches_cmad_tpu(runs):
    _tmp, out = runs
    port, ref = out["port"]["calibrate"], out["jax"]["calibrate"]
    status, status_ref = (json.loads((d / "opt_status.json").read_text())
                          for d in (port, ref))
    assert set(status) == set(status_ref)
    for key in ("success", "status", "message", "nfev", "njev", "nit"):
        assert status[key] == status_ref[key], key
    assert abs(status["fun"] - status_ref["fun"]) <= J_RTOL * status_ref[
        "fun"]
    hist, hist_ref = (json.loads((d / "opt_history.json").read_text())
                      for d in (port, ref))
    assert hist["active_param_paths"] == hist_ref["active_param_paths"]
    for key, rtol in (("J", J_RTOL), ("grad_norm", GRAD_RTOL)):
        assert np.allclose([h[key] for h in hist["history"]],
                           [h[key] for h in hist_ref["history"]],
                           rtol=rtol, atol=0.0)
    fit, fit_ref = (yaml.safe_load((d / "opt_params.yaml").read_text())
                    for d in (port, ref))
    vals = [fit[k]["flow stress"] for k in ("plastic",)]
    vals_ref = [fit_ref[k]["flow stress"] for k in ("plastic",)]
    for a, b in zip(vals, vals_ref, strict=True):
        for path in (("initial yield", "Y"), ("hardening", "voce", "S"),
                     ("hardening", "voce", "D")):
            x, y = a, b
            for k in path:
                x, y = x[k], y[k]
            assert abs(x["value"] - y["value"]) <= 1e-9 * abs(y["value"])


def test_direct_adjoint_gradient_warns_on_stderr(runs, capsys):
    tmp, _out = runs
    deck = {**_at_Y(_deck(tmp, qoi=_qoi(tmp)), 220.0),
            "sensitivity": {"type": "direct_adjoint"}}
    assert ms.run_gradient_mp(deck, tmp / "warn", device="cpu") == 0
    assert "computes a Hessian as a side effect" in capsys.readouterr().err


@pytest.mark.parametrize("subcommand,stype", [("hessian", "adjoint"),
                                              ("hessian", "direct"),
                                              ("calibrate", "direct_adjoint"),
                                              ("gradient", "bogus")])
def test_sensitivity_rules_raise_as_cmad_tpu(subcommand, stype):
    errors = []
    for build in (jax_sensitivity, build_sensitivity_driver):
        with pytest.raises(ValueError) as e:
            build({"type": stype}, None, None, {}, subcommand)
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "sensitivity.type" in errors[1]


def test_fe_qoi_in_an_mp_deck_raises_as_cmad_tpu(runs):
    tmp, _out = runs
    deck = {**_deck(tmp, qoi={**_qoi(tmp), "name": "fe_displacement_match"}),
            "sensitivity": {"type": "adjoint"}}
    path = _write(tmp, "fe_qoi", deck)
    errors = []
    for run in (lambda: jax_main(["gradient", str(path)]),
                lambda: main(["gradient", str(path)], device="cpu"),
                lambda: ms.run_gradient_mp(deck, device="cpu")):
        with pytest.raises(ValueError) as e:
            run()
        errors.append(str(e.value))
    assert errors[0] == errors[1]
    assert "fe_displacement_match" in errors[2]


def test_mp_commands_run_on_the_card_by_default(runs):
    """No fallback: without a device the command asks for the card, and
    raises where there is none."""
    tmp, _out = runs
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ms.run_primal_mp(_deck(tmp), tmp / "card")
