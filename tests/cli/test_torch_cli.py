"""The port's FE deck commands (``python -m cmad_tpu_torch``) on the
CPU, against cmad_tpu's commands and against the port's own library
calls.

- ``examples/elastic_plastic_uniaxial.yaml`` (the 512-hex cube, scan
  driver, sparse-direct solve) runs unedited through ``primal``; its
  Exodus output, ``solver.json`` and ``deck.resolved.yaml`` are held to
  cmad_tpu's to 1e-9 (of the largest value of each field), and ``python
  -m cmad_tpu_torch`` writes the same files bit for bit. The same deck
  with a ``qoi`` (against that Exodus output, at Y = 210) runs
  ``objective`` and ``gradient`` through ``main`` and both drivers, the
  stepped gradient held to cmad_tpu's to 1e-9.
- The 8-hex cube decks of ``tests/fem/test_torch_fe_gradient.py`` run
  every command, given as dicts with an output directory, through both
  drivers; each file holds the library call's number bit for bit (the
  library is held to cmad_tpu in ``tests/fem/test_torch_fe_hessian.py``
  and ``test_torch_fe_gradient.py``), and the two drivers agree to 1e-9.
- Load cases, the restart, and the drivers and problems that are not
  ported (they raise naming their ROADMAP items).
- The Y recovery and the two-depth Y/S/D recovery, held to cmad_tpu's
  fits, are marked ``slow``.
"""
from __future__ import annotations

import copy
import json
import os
import runpy
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.cli import fe_subcommands as fs
from cmad_tpu_torch.cli.fe_common import (
    build_fe_J_of_params_flat,
    build_fe_problem_from_deck,
    build_fe_stepped_vg,
)
from cmad_tpu_torch.cli.main import main
from cmad_tpu_torch.io.exodus import read_results

from tests.fem.test_torch_fe_gradient import (
    _plastic_deck,
    _sensitivity_deck,
)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
EXAMPLE = REPO / "examples" / "elastic_plastic_uniaxial.yaml"
F64 = torch.float64


def _stage(where: Path) -> Path:
    (where / "meshes").mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "examples" / "meshes" / "cube_hex_8.exo",
                where / "meshes")
    shutil.copy(EXAMPLE, where / "d.yaml")
    return where


def _in(where: Path, fn, *args, **kwargs):
    cwd = os.getcwd()
    os.chdir(where)
    try:
        return fn(*args, **kwargs)
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def example(tmp_path_factory):
    """The example deck's primal through both packages, and the port's
    run through ``python -m cmad_tpu_torch``."""
    from cmad_tpu.cli.main import main as jax_main

    port = _stage(tmp_path_factory.mktemp("port"))
    ref = _stage(tmp_path_factory.mktemp("jax"))
    mod = _stage(tmp_path_factory.mktemp("module"))
    assert _in(port, main, ["primal", "d.yaml"], device="cpu") == 0
    assert _in(ref, jax_main, ["primal", "d.yaml"]) == 0
    argv = sys.argv
    sys.argv = ["cmad_tpu_torch", "primal", "d.yaml", "--device", "cpu"]
    try:
        with pytest.raises(SystemExit) as done:
            _in(mod, runpy.run_module, "cmad_tpu_torch", run_name="__main__")
    finally:
        sys.argv = argv
    assert done.value.code == 0
    return port, ref, mod


def _exo(d: Path):
    return read_results(d / "results" / "elastic_plastic_uniaxial.exo")


def test_example_deck_primal_matches_cmad_tpu(example):
    port, ref, _mod = example
    got, want = _exo(port), _exo(ref)
    np.testing.assert_array_equal(got.times, want.times)
    assert sorted(got.nodal) == sorted(want.nodal) == ["u_x", "u_y", "u_z"]
    assert sorted(got.element) == sorted(want.element)
    for k, v in got.nodal.items():
        np.testing.assert_allclose(v, want.nodal[k], rtol=0,
                                   atol=1e-9 * np.abs(want.nodal[k]).max())
    # an element field's scale is its largest component (a tensor's
    # off-axis components are rounding noise in a uniaxial state)
    scale: dict[str, float] = {}
    for k, by_block in want.element.items():
        root = _root(k)
        for w in by_block.values():
            scale[root] = max(scale.get(root, 0.0), np.abs(w).max())
    for k, by_block in got.element.items():
        for b, v in by_block.items():
            np.testing.assert_allclose(v, want.element[k][b], rtol=0,
                                       atol=1e-9 * scale[_root(k)])
    solver = json.loads((port / "results" / "solver.json").read_text())
    solver_ref = json.loads((ref / "results" / "solver.json").read_text())
    assert len(solver) == len(solver_ref) == 5
    # a step's initial residual is taken with the tangent at its start;
    # once the cube has yielded, its points sit on the yield surface and
    # each package picks that tangent's branch (elastic or plastic) by its
    # own rounding (ROADMAP queue 3's hazard), so only the first two
    # starts, elastic, are compared; every step converges in both
    for i, (a, b) in enumerate(zip(solver, solver_ref, strict=True)):
        if i < 2:
            assert abs(a["initial_residual"] - b["initial_residual"]) \
                <= 1e-9 * b["initial_residual"]
        assert a["final_residual"] <= 1e-9 * a["initial_residual"]
        assert b["final_residual"] <= 1e-9 * b["initial_residual"]
    assert yaml.safe_load((port / "results" / "deck.resolved.yaml")
                          .read_text()) == yaml.safe_load(
        (ref / "results" / "deck.resolved.yaml").read_text())


def _root(name: str) -> str:
    head, _, tail = name.rpartition("_")
    return head if head and tail in ("x", "y", "z", "xx", "yy", "zz", "xy",
                                     "xz", "yz") else name


def test_python_m_writes_the_same_files(example):
    port, _ref, mod = example
    for name in ("solver.json", "deck.resolved.yaml"):
        assert (port / "results" / name).read_bytes() == \
            (mod / "results" / name).read_bytes()
    a, b = _exo(port), _exo(mod)
    for k in a.nodal:
        np.testing.assert_array_equal(a.nodal[k], b.nodal[k])


def _qoi_deck(example, driver: str) -> dict:
    port = example[0]
    deck = yaml.safe_load(EXAMPLE.read_text())
    deck["discretization"]["mesh file"] = str(
        port / "meshes" / "cube_hex_8.exo")
    deck["residuals"]["global residual"]["driver"] = driver
    deck["residuals"]["local residual"]["materials"]["all"]["plastic"][
        "flow stress"]["initial yield"]["Y"]["value"] = 210.0
    deck["qoi"] = {"name": "fe_displacement_match", "weight": 1.0e6,
                   "data_file": str(port / "results"
                                    / "elastic_plastic_uniaxial.exo")}
    return deck


def test_example_deck_objective_and_gradient(example, tmp_path):
    """Both drivers, against each other to 1e-9; the stepped gradient
    against cmad_tpu's (the cube test holds each file to its library
    call)."""
    from cmad_tpu.cli.main import main as jax_main

    grads, Js = {}, {}
    for driver in ("stepped", "scan"):
        deck = _qoi_deck(example, driver)
        out = tmp_path / driver
        deck["output"] = {"path": str(out)}
        path = tmp_path / f"{driver}.yaml"
        path.write_text(yaml.safe_dump(deck, sort_keys=False))
        for cmd in ("objective", "gradient"):
            assert main([cmd, str(path)], device="cpu") == 0
        Js[driver] = json.loads((out / "J.json").read_text())["J"]
        grads[driver] = np.load(out / "grad.npy")
    assert grads["scan"].shape == (5,) and Js["scan"] > 0.0
    assert abs(Js["scan"] - Js["stepped"]) <= 1e-9 * Js["scan"]
    np.testing.assert_allclose(grads["scan"], grads["stepped"], rtol=1e-9,
                               atol=1e-9 * np.abs(grads["scan"]).max())
    deck = _qoi_deck(example, "stepped")
    deck["output"] = {"path": str(tmp_path / "jax")}
    (tmp_path / "jax.yaml").write_text(yaml.safe_dump(deck,
                                                      sort_keys=False))
    assert jax_main(["gradient", str(tmp_path / "jax.yaml")]) == 0
    ref = np.load(tmp_path / "jax" / "grad.npy")
    np.testing.assert_allclose(grads["stepped"], ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """The cube decks: a truth through the port's ``primal`` (Exodus
    out), then the sensitivity deck against it."""
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    tmp = tmp_path_factory.mktemp("cube")
    mesh = tmp / "cube.exo"
    ExodusWriter(mesh, StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    truth = _plastic_deck(mesh)
    truth["output"] = {"path": str(tmp / "truth"), "write restart": True,
                       "global residual": ["u"]}
    assert fs.run_primal_fe(truth, device="cpu") == 0
    data = tmp / "truth" / "cube_fe.exo"
    return tmp, truth, _sensitivity_deck(mesh, data)


def _with(deck, driver, **extra):
    deck = copy.deepcopy(deck)
    deck["residuals"]["global residual"]["driver"] = driver
    deck.update(extra)
    return deck


def test_cube_commands_equal_the_library_calls(cube):
    tmp, _truth, sens = cube
    H = {}
    for driver in ("stepped", "scan"):
        deck = _with(sens, driver)
        out = tmp / f"cmd_{driver}"
        assert fs.run_hessian_fe(deck, out, device="cpu") == 0
        assert fs.run_gradient_fe(deck, out, device="cpu") == 0
        bundle = build_fe_problem_from_deck(copy.deepcopy(deck),
                                            device="cpu")
        H[driver] = np.load(out / "hess.npy")
        np.testing.assert_array_equal(H[driver], fs.fe_hessian(bundle)[0])
        p0, vg = fs.fe_value_and_grad(bundle)
        np.testing.assert_array_equal(np.load(out / "grad.npy"), vg(p0)[1])
        resolved = yaml.safe_load((out / "deck.resolved.yaml").read_text())
        assert resolved["output"]["path"] == str(out)
        assert resolved["residuals"]["global residual"]["driver"] == driver
    assert H["scan"].shape == (2, 2)
    assert np.abs(H["scan"] - H["stepped"]).max() \
        <= 1e-9 * np.abs(H["scan"]).max()


def test_cube_primal_writes_and_resumes_a_restart(cube, tmp_path):
    """The truth run wrote ``restart.npz`` at t = 1; a 6-step deck that
    resumes from it solves steps 4-6 and ends where the 6-step run from
    rest ends."""
    tmp, truth, _sens = cube
    ckpt = tmp / "truth" / "restart.npz"
    assert ckpt.exists()
    J_exo = read_results(tmp / "truth" / "cube_fe.exo")
    assert len(J_exo.times) == 4
    longer = copy.deepcopy(truth)
    longer["discretization"]["num steps"] = 6
    longer["output"] = {"path": str(tmp_path / "full"),
                        "write restart": True}
    resumed = copy.deepcopy(longer)
    resumed["output"] = {"path": str(tmp_path / "resumed"),
                         "write restart": True}
    resumed["restart"] = {"file": str(ckpt)}
    assert fs.run_primal_fe(longer, device="cpu") == 0
    assert fs.run_primal_fe(resumed, device="cpu") == 0
    full = np.load(tmp_path / "full" / "restart.npz")
    res = np.load(tmp_path / "resumed" / "restart.npz")
    assert float(full["t"]) == float(res["t"]) == 2.0
    np.testing.assert_allclose(res["U"], full["U"], rtol=0,
                               atol=1e-12 * np.abs(full["U"]).max())
    steps = read_results(tmp_path / "resumed" / "cube_fe.exo").times
    np.testing.assert_allclose(steps, [1.0, 4 / 3, 5 / 3, 2.0])


def test_cube_objective_and_calibrate_run(cube, tmp_path):
    tmp, _truth, sens = cube
    for driver in ("stepped", "scan"):
        deck = _with(sens, driver, optimizer={"algorithm": "L-BFGS-B",
                                              "options": {"maxiter": 1}})
        out = tmp_path / driver
        assert fs.run_objective_fe(_with(sens, driver), out,
                                   device="cpu") == 0
        assert fs.run_calibrate_fe(deck, out, device="cpu") == 0
        J0 = json.loads((out / "J.json").read_text())["J"]
        hist = json.loads((out / "opt_history.json").read_text())
        assert hist["history"][0]["J"] == pytest.approx(J0, rel=1e-12)
        assert hist["history"][-1]["J"] < J0
        assert hist["active_param_paths"] == [
            "all.plastic.flow_stress.hardening.voce.S",
            "all.plastic.flow_stress.initial_yield.Y"]
        status = json.loads((out / "opt_status.json").read_text())
        active = json.loads((out / "active_params.json").read_text())
        assert status["nit"] == 1 and len(active) == 2
        opt = yaml.safe_load((out / "opt_params.yaml").read_text())
        assert opt["all"]["plastic"]["flow stress"]["initial yield"]["Y"][
            "value"] == active["all.plastic.flow_stress.initial_yield.Y"]


def _two_cases(cube, tmp_path):
    tmp, truth, sens = cube
    deep = copy.deepcopy(truth)
    deep["discretization"]["step size"] = 2.0 / 3.0
    deep["output"] = {"path": str(tmp_path / "deep")}
    assert fs.run_primal_fe(deep, device="cpu") == 0
    deck = copy.deepcopy(sens)
    deck["load cases"] = [
        {"name": "shallow"},
        {"name": "deep", "step size": 2.0 / 3.0, "weight": 0.5,
         "qoi": {"data_file": str(tmp_path / "deep" / "cube_fe.exo")}}]
    return deck


def test_load_cases_sum_and_drivers_agree(cube, tmp_path):
    deck = _two_cases(cube, tmp_path)
    stepped = build_fe_problem_from_deck(_with(deck, "stepped"),
                                         device="cpu")
    p0, s0, ts, vg = build_fe_stepped_vg(stepped)
    J, g = vg(p0, s0, ts)
    parts = []
    for case in deck["load cases"]:
        one = copy.deepcopy(deck)
        del one["load cases"]
        if "step size" in case:
            one["discretization"]["step size"] = case["step size"]
            one["qoi"].update(case["qoi"])
        b = build_fe_problem_from_deck(one, device="cpu")
        q, s, t, f = build_fe_stepped_vg(b)
        parts.append((case.get("weight", 1.0), f(q, s, t)))
    assert J == pytest.approx(sum(w * Jc for w, (Jc, _g) in parts),
                              rel=1e-14)
    np.testing.assert_allclose(g, sum(w * gc for w, (_J, gc) in parts),
                               rtol=1e-13)
    with pytest.raises(ValueError, match="base schedule"):
        vg(p0, s0, ts[:-1])
    scan = build_fe_problem_from_deck(_with(deck, "scan"), device="cpu")
    q0, r0, J_of = build_fe_J_of_params_flat(scan)
    p = q0.clone().requires_grad_(True)
    J_scan = J_of(p, r0)
    (g_scan,) = torch.autograd.grad(J_scan, p)
    assert float(J_scan) == pytest.approx(J, rel=1e-9)
    np.testing.assert_allclose(g_scan.numpy(), g, rtol=1e-9)


def test_unported_drivers_and_problems_raise(cube, tmp_path):
    _tmp, truth, sens = cube
    with pytest.raises(NotImplementedError, match="item 18"):
        fs.run_primal_fe(_with(truth, "host"), tmp_path, device="cpu")
    with pytest.raises(NotImplementedError, match="item 18"):
        fs.run_objective_fe(_with(sens, "host"), tmp_path, device="cpu")
    for run in (fs.run_gradient_fe, fs.run_hessian_fe):
        with pytest.raises(ValueError, match="primal-only"):
            run(_with(sens, "host"), tmp_path, device="cpu")
    # a material-point deck reaches the MP commands (they raised naming
    # item 23 until the port had them), whose schema wants a model
    mp = tmp_path / "mp.yaml"
    mp.write_text(yaml.safe_dump({"problem": {"type": "material_point"}}))
    with pytest.raises(ValueError, match="model: missing 'name' field"):
        main(["primal", str(mp)], device="cpu")


def _recovery(cube, tmp_path, deck, jax_name):
    """The port's and cmad_tpu's ``calibrate`` of ``deck`` (stepped),
    their fits and evaluation counts."""
    from cmad_tpu.cli.main import main as jax_main

    deck = _with(deck, "stepped", optimizer={"algorithm": "L-BFGS-B"})
    assert fs.run_calibrate_fe(deck, tmp_path / "port", device="cpu") == 0
    deck["output"] = {"path": str(tmp_path / "jax")}
    (tmp_path / jax_name).write_text(yaml.safe_dump(deck, sort_keys=False))
    assert jax_main(["calibrate", str(tmp_path / jax_name)]) == 0
    return [json.loads((tmp_path / d / "active_params.json").read_text())
            for d in ("port", "jax")]


@pytest.mark.slow
def test_y_recovery_matches_cmad_tpu(cube, tmp_path):
    _tmp, _truth, sens = cube
    deck = copy.deepcopy(sens)
    fs_ = deck["residuals"]["local residual"]["materials"]["all"][
        "plastic"]["flow stress"]
    fs_["hardening"]["voce"]["S"]["active"] = False
    port, ref = _recovery(cube, tmp_path, deck, "y.yaml")
    key = "all.plastic.flow_stress.initial_yield.Y"
    assert port[key] == pytest.approx(200.0, rel=1e-4)
    assert port[key] == pytest.approx(ref[key], rel=1e-6)


@pytest.mark.slow
def test_two_depth_ysd_recovery_matches_cmad_tpu(cube, tmp_path):
    deck = _two_cases(cube, tmp_path)
    fs_ = deck["residuals"]["local residual"]["materials"]["all"][
        "plastic"]["flow stress"]
    fs_["hardening"]["voce"]["D"]["active"] = True
    port, ref = _recovery(cube, tmp_path, deck, "ysd.yaml")
    assert sorted(port) == sorted(ref)
    for k in port:
        assert port[k] == pytest.approx(ref[k], rel=1e-4)
    assert port["all.plastic.flow_stress.initial_yield.Y"] == \
        pytest.approx(200.0, rel=1e-2)


def test_chip_smoke_runs_notch_hosford_yaml_as_written():
    """``chip_smoke.py`` runs ``examples/notch_hosford.yaml`` through the
    primal command as a dict, since the GPU host has no PyYAML: the dict
    is the file, key for key."""
    chip = runpy.run_path(str(REPO / "chip_smoke.py"))
    deck = yaml.safe_load((REPO / "examples" / "notch_hosford.yaml")
                          .read_text())
    assert chip["NOTCH_HOSFORD_DECK"] == deck


def test_chip_smoke_runs_notch_hosford_principal_yaml_as_written():
    """The principal-Hosford deck, which ``chip_smoke.py`` runs as a dict
    in its fe-principal phase, is the file key for key."""
    chip = runpy.run_path(str(REPO / "chip_smoke.py"))
    deck = yaml.safe_load((REPO / "examples" / "notch_hosford_principal.yaml")
                          .read_text())
    assert chip["NOTCH_PRINCIPAL_DECK"] == deck


# ``tests/cli/test_mp_roundtrips.py``'s anisotropic yield sections
_MP_YIELDS = {
    "hill": {"hill": {k: {"value": v} for k, v in (
        ("F", 0.45), ("G", 0.55), ("H", 0.5),
        ("L", 1.4), ("M", 1.6), ("N", 1.5))}},
    "hosford_principal": {"hosford_principal": {"a": {"value": 8.0}}},
}


@pytest.mark.parametrize("yield_name", sorted(_MP_YIELDS))
def test_mp_primal_with_an_anisotropic_yield_matches_cmad_tpu(
        yield_name, tmp_path):
    """``tests/cli/test_mp_roundtrips.py``'s FULL_3D material-point ramp
    through yield with Hill or principal Hosford: ``python -m
    cmad_tpu_torch primal`` against cmad_tpu's ``primal``, every output
    array to 1e-12 of its scale and the same Newton iterations."""
    from cmad_tpu.cli.main import main as jax_main

    from tests.support.torch_mp import params_section

    num_steps = 8
    eps = np.r_[0.0, np.linspace(0.0008, 0.012, num_steps)]
    F = np.repeat(np.eye(3)[:, :, None], num_steps + 1, axis=2)
    F[0, 0, :] += eps
    F[1, 1, :] -= 0.45 * eps
    F[2, 2, :] -= 0.45 * eps
    np.save(tmp_path / "F.npy", F)
    params = params_section()
    del params["rotation matrix"]
    params["plastic"]["effective stress"] = _MP_YIELDS[yield_name]
    outs = {}
    for side in ("jax", "port"):
        deck = {
            "problem": {"type": "material_point",
                        "name": f"primal_{yield_name}"},
            "model": {"name": "small_rate_elastic_plastic",
                      "def_type": "full_3d"},
            "parameters": params,
            "deformation": {"history_file": str(tmp_path / "F.npy")},
            "solver": {"newton": {}},
            "output": {"path": str(tmp_path / side)},
        }
        (tmp_path / f"{side}.yaml").write_text(yaml.safe_dump(deck))
        outs[side] = tmp_path / side
    assert _in(tmp_path, jax_main, ["primal", "jax.yaml"]) == 0
    argv = sys.argv
    sys.argv = ["cmad_tpu_torch", "primal", "port.yaml", "--device", "cpu"]
    try:
        with pytest.raises(SystemExit) as done:
            _in(tmp_path, runpy.run_module, "cmad_tpu_torch",
                run_name="__main__")
    finally:
        sys.argv = argv
    assert done.value.code == 0
    port, ref = outs["port"], outs["jax"]
    names = sorted(p.name for p in ref.glob("*.npy"))
    assert names == sorted(p.name for p in port.glob("*.npy"))
    assert {"cauchy.npy", "xi.npy"} <= set(names)
    for name in names:
        a, b = np.load(port / name), np.load(ref / name)
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-12 * max(np.abs(b).max(), 1e-300))
    assert np.load(port / "xi.npy")[-1, 6] > 0.0      # the ramp yielded
    log, log_ref = (json.loads((d / "solver.json").read_text())
                    for d in (port, ref))
    assert [e["iters"] for e in log] == [e["iters"] for e in log_ref]
