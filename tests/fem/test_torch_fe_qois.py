"""cmad_tpu_torch's FE QoIs ``fe_displacement_l2``, ``fe_load_match`` and
``fe_weighted_sum`` against cmad_tpu's, on the CPU in float64.

The problem is ``tests/fem/test_torch_fe_gradient.py``'s 8-hex cube with
J2+Voce (the J2 block, its state in the carrier layout), 2 steps, Y =
230 active; the load series to match is the reaction of the drive at Y =
200, scaled by 1.1. One port drive gives the trajectory; on it, each
QoI's step contribution at the second step and its partial derivatives
in U and in Y (the reaction's direct dependence on the parameters
through the assembly) are compared with cmad_tpu's closures evaluated on
the same arrays, 1e-10 relative (the same f64 arithmetic summed in other
orders). The total gradient of each QoI through the stepped adjoint is
held to a central difference of the port's own J at h = 1e-2 in Y ~ 230
(1e-6 relative; truncation about 1e-9, the Newton's 1e-12 noise over 2h
about 1e-9): the adjoint itself is held to cmad_tpu's by
``test_torch_fe_gradient.py``, and cmad_tpu's stepped gradient of each
QoI would compile for about a minute on one core.
"""
from __future__ import annotations

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.cli.fe_common import (
    build_fe_problem_from_deck,
    build_fe_stepped_vg,
    fe_primal_drive,
)
from cmad_tpu_torch.cli.fe_subcommands import run_primal_fe
from cmad_tpu_torch.fem.assembly import params_by_block_from_models
from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block

torch.set_num_threads(1)

F64 = torch.float64
RTOL = 1e-10
FD_H, FD_RTOL = 1e-2, 1e-6
Y_TRUTH, Y = 200.0, 230.0


def _deck(mesh_file, Y_value, qoi=None):
    deck = {
        "problem": {"type": "fe", "name": "cube_qois"},
        "discretization": {"mesh file": str(mesh_file),
                           "num steps": 2, "step size": 0.5},
        "residuals": {
            "global residual": {"type": "small_disp_equilibrium",
                                "def_type": "full_3d", "driver": "stepped"},
            "local residual": {
                "type": "small_elastic_plastic",
                "materials": {"all": {
                    "elastic": {"E": {"value": 200e3},
                                "nu": {"value": 0.3}},
                    "plastic": {
                        "effective stress": {"J2": {}},
                        "flow stress": {
                            "initial yield": {"Y": {"value": Y_value,
                                                    "active": True}},
                            "hardening": {"voce": {
                                "S": {"value": 200.0},
                                "D": {"value": 20.0}}}}}}}}},
        "dirichlet bcs": {"expression": {
            "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"],
            "ramp_x": ["equilibrium", 0, "xmax_sides", "0.004 * t"]}},
    }
    if qoi is not None:
        deck["qoi"] = qoi
    return deck


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    tmp = tmp_path_factory.mktemp("fe_qois")
    mesh = tmp / "cube.exo"
    ExodusWriter(mesh, StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    # the load series: the x reaction on xmax_sides of the drive at Y =
    # 200, written by the primal command in fe_load_match's write mode
    series = tmp / "reaction.csv"
    truth = _deck(mesh, Y_TRUTH, {"name": "fe_load_match",
                                  "sideset": "xmax_sides", "components": [0],
                                  "output_file": str(series)})
    truth["output"] = {"path": str(tmp / "out"), "write exodus": False}
    run_primal_fe(truth, device="cpu")
    data = tmp / "reaction.npy"
    np.save(data, 1.1 * np.loadtxt(series, delimiter=",").reshape(-1, 1))
    qois = {
        "fe_displacement_l2": {"name": "fe_displacement_l2"},
        "fe_load_match": {"name": "fe_load_match", "sideset": "xmax_sides",
                          "components": [0], "data_file": str(data),
                          "weight": 1e-4},
        "fe_weighted_sum": {"name": "fe_weighted_sum", "terms": [
            {"name": "fe_displacement_l2", "term_weight": 2.0},
            {"name": "fe_load_match", "sideset": "xmax_sides",
             "components": [0], "data_file": str(data), "weight": 1e-4,
             "term_weight": 0.5}]},
    }
    decks = {name: _deck(mesh, Y, q) for name, q in qois.items()}
    port = {name: build_fe_problem_from_deck(copy.deepcopy(d), dtype=F64,
                                             device="cpu")
            for name, d in decks.items()}
    state, _ = fe_primal_drive(port["fe_displacement_l2"])
    return {"tmp": tmp, "series": series, "truth": truth, "decks": decks,
            "port": port, "state": state}


def _jax_bundle(case, name):
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf

    path = case["tmp"] / f"{name}.yaml"
    path.write_text(yaml.safe_dump(case["decks"][name], sort_keys=False))
    return jax_bf(path, "objective")


def _jax_params(fe, Y_value):
    """cmad_tpu's per-block parameter trees with Y set to ``Y_value``."""
    from cmad_tpu.fem.assembly import params_by_block_from_models as jax_p

    v = jax_p(fe)["all"]
    fs = v["plastic"]["flow stress"]
    return {"all": {**v, "plastic": {**v["plastic"], "flow stress": {
        **fs, "initial yield": {"Y": Y_value}}}}}


def _port_params(fe, Y_value):
    v = params_by_block_from_models(fe)["all"]
    fs = v["plastic"]["flow stress"]
    return {"all": {**v, "plastic": {**v["plastic"], "flow stress": {
        **fs, "initial yield": {"Y": Y_value}}}}}


def _close(got, ref, what):
    got, ref = float(got), float(ref)
    assert abs(got - ref) <= RTOL * max(abs(ref), 1e-300), (what, got, ref)


@pytest.mark.parametrize("name", ["fe_displacement_l2", "fe_load_match",
                                  "fe_weighted_sum"])
def test_step_contributions_and_partials_match_cmad_tpu(case, name):
    """The second step's j_n, dj_n/dU_n and dj_n/dY (plastic, from a
    plastic state) against cmad_tpu's closure on the same state."""
    jb = _jax_bundle(case, name)
    fe_j, qoi_j = jb.fe_problem, jb.qoi
    bt = case["port"][name]
    fe_t, qoi_t = bt.fe_problem, bt.qoi
    state, ts = case["state"], bt.t_schedule.tolist()
    U, U_prev = state.U_at(2), state.U_at(1)
    xi_prev = state.xi_at(1, "all")
    args = (ts[2], ts[1])

    def j_jax(U_, Y_):
        c = qoi_j.step_contribution(_jax_params(fe_j, Y_),
                                    fe_j.kernel_arrays)
        return c(U_, jnp.asarray(U_prev), None,
                 {"all": jnp.asarray(xi_prev)}, *args)

    jv, (jU, jY) = jax.value_and_grad(j_jax, argnums=(0, 1))(
        jnp.asarray(U), jnp.asarray(Y))

    U_t = torch.tensor(U, requires_grad=True)
    Y_t = torch.tensor(Y, dtype=F64, requires_grad=True)
    xi_t = pack_xi_by_block(fe_t, {"all": torch.tensor(xi_prev)},
                            layout="aos")
    c = qoi_t.step_contribution(_port_params(fe_t, Y_t),
                                fe_t.kernel_arrays)
    tv = c(U_t, torch.tensor(U_prev), None, xi_t, *args)
    if name == "fe_displacement_l2":
        tU = torch.autograd.grad(tv, U_t)[0]
        tY = 0.0                       # no direct dependence
    else:
        tU, tY = torch.autograd.grad(tv, (U_t, Y_t))
    _close(tv, jv, "j")
    _close(tY, jY, "dj/dY")
    ref = np.asarray(jU)
    assert np.abs(tU.numpy() - ref).max() <= RTOL * np.abs(ref).max()
    assert float(jv) > 0.0


def test_weighted_sum_is_its_terms(case):
    bt = case["port"]
    state, ts = case["state"], bt["fe_weighted_sum"].t_schedule.tolist()
    fe = bt["fe_weighted_sum"].fe_problem
    params = params_by_block_from_models(fe)

    def at(k):
        return (torch.tensor(state.U_at(k)),
                pack_xi_by_block(fe, {"all": torch.tensor(
                    state.xi_at(k, "all"))}, layout="aos"))

    (U0, x0), (U1, x1) = at(0), at(1)
    parts = [float(bt[n].qoi.step_contribution(params, fe.kernel_arrays)(
        U1, U0, x1, x0, ts[1], ts[0]))
        for n in ("fe_weighted_sum", "fe_displacement_l2",
                  "fe_load_match")]
    assert parts[0] == pytest.approx(2.0 * parts[1] + 0.5 * parts[2],
                                     rel=1e-14)


@pytest.mark.parametrize("name", ["fe_displacement_l2", "fe_load_match",
                                  "fe_weighted_sum"])
def test_stepped_gradient_matches_central_difference(case, name):
    p0, s0, ts, vg = build_fe_stepped_vg(case["port"][name])
    assert float(p0[0]) == Y
    J, g = vg(p0, s0, ts)
    Jp, _ = vg(p0 + FD_H, s0, ts)
    Jm, _ = vg(p0 - FD_H, s0, ts)
    fd = (Jp - Jm) / (2.0 * FD_H)
    assert J > 0.0 and abs(g[0] - fd) <= FD_RTOL * abs(fd), (g[0], fd)


def test_load_match_write_mode_matches_cmad_tpu(case):
    """The primal command wrote the reaction after every step (the
    truth at Y = 200): each row equals cmad_tpu's reaction on the same
    trajectory."""
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf

    truth = copy.deepcopy(case["truth"])
    truth.pop("output")
    path = case["tmp"] / "truth.yaml"
    path.write_text(yaml.safe_dump(truth, sort_keys=False))
    jb = jax_bf(path, "primal")
    assert jb.qoi.produces_primal_output()
    fe_j = jb.fe_problem
    state, _ = fe_primal_drive(build_fe_problem_from_deck(
        copy.deepcopy(truth), dtype=F64, device="cpu"))
    written = np.loadtxt(case["series"], delimiter=",").reshape(-1)
    assert written.shape == (3,)
    params = _jax_params(fe_j, jnp.asarray(Y_TRUTH))
    for k in range(3):
        kp = max(k - 1, 0)
        ref = jb.qoi._reaction_at(
            params, fe_j.kernel_arrays, jnp.asarray(state.U_at(k)),
            jnp.asarray(state.U_at(kp)), float(state.t_history[k]),
            {"all": jnp.asarray(state.xi_at(kp, "all"))})
        _close(written[k], float(ref[0]), f"reaction step {k}")
