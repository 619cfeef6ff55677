"""The FE J2 stepped gradient of cmad_tpu_torch against cmad_tpu's, on the
CPU in float64.

The decks are the JAX package's own stepped-adjoint decks
(``tests/fem/test_stepped_adjoint.py``): the 8-hex cube with J2+Voce
(small_elastic_plastic), 3 steps of a ramp, a truth at Y = 200, then Y =
230 and S active, ``fe_displacement_match`` against the truth at weight
1e8, the sparse-direct solve. One module fixture builds the JAX truth,
cmad_tpu's ``build_fe_stepped_vg`` value and gradient, and the port's
bundle. Tolerances:

- the port vs cmad_tpu, J and dJ/dp: 1e-9 relative. Both are f64 with the
  same Newton (the deck's default tolerances, 1e-12) and the same
  sparse-direct solves; they differ by the order of their sums (measured
  about 3e-12);
- ``reuse_primal=False`` vs True: cmad_tpu's own bounds, 1e-10 in J and
  1e-6 in the gradient;
- ``checkpoint_offload``: bit for bit (the same arithmetic);
- ``gradcheck`` of :class:`FeSolutionAt`'s rule in the parameters, with
  the solution re-solved at each perturbed point (a Newton at 1e-14):
  central differences at eps 1e-3 of Y ~ 200 against the rule, atol 1e-9
  on displacements of about 1e-3.
"""
from __future__ import annotations

import copy
import logging

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.cli.fe_common import (
    build_fe_problem_from_deck,
    build_fe_stepped_vg,
    fe_params_overlay,
    nonlinear_settings,
)
from cmad_tpu_torch.fem.nonlinear_solver import (
    fe_newton_solve,
    fe_solution_at,
)
from cmad_tpu_torch.fem.stepped_adjoint import (
    build_fe_stepped_value_and_grad,
)
from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block
from cmad_tpu_torch.qois.fe_displacement_match import FEDisplacementMatch

torch.set_num_threads(1)

F64 = torch.float64
RTOL_PORT = 1e-9


def _plastic_deck(mesh_file, Y=200.0):
    """``tests/fem/test_stepped_adjoint.py``'s deck, stepped."""
    return {
        "problem": {"type": "fe", "name": "cube_fe"},
        "discretization": {"mesh file": str(mesh_file),
                           "num steps": 3, "step size": 1.0 / 3.0},
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
                            "initial yield": {"Y": {"value": Y}},
                            "hardening": {"voce": {
                                "S": {"value": 200.0},
                                "D": {"value": 20.0}}}}}}}}},
        "dirichlet bcs": {"expression": {
            "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"],
            "ramp_x": ["equilibrium", 0, "xmax_sides", "0.004 * t"]}},
    }


def _sensitivity_deck(mesh_file, data_file):
    deck = _plastic_deck(mesh_file, Y=230.0)
    fs = deck["residuals"]["local residual"]["materials"]["all"]["plastic"][
        "flow stress"]
    fs["initial yield"]["Y"]["active"] = True
    fs["hardening"]["voce"]["S"]["active"] = True
    deck["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(data_file), "weight": 1.0e8}
    return deck


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf
    from cmad_tpu.cli.fe_common import build_fe_stepped_vg as jax_vg
    from cmad_tpu.cli.fe_subcommands import _nls_settings
    from cmad_tpu.fem.driver import fe_quasistatic_drive_stepped
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    tmp = tmp_path_factory.mktemp("fe_grad")
    mesh = tmp / "cube.exo"
    ExodusWriter(mesh, StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    truth_deck = tmp / "truth.yaml"
    truth_deck.write_text(yaml.safe_dump(_plastic_deck(mesh),
                                         sort_keys=False))
    bt = jax_bf(truth_deck, "primal")
    state, _ = fe_quasistatic_drive_stepped(
        bt.fe_problem, bt.t_schedule.tolist(),
        nonlinear_solver_settings=_nls_settings(bt),
        linear_solver_settings=bt.resolved["linear solver"])
    data = tmp / "u_data.npy"
    np.save(data, np.stack(state.U_history).reshape(
        len(state.U_history), -1, 3))
    deck = _sensitivity_deck(mesh, data)
    path = tmp / "sens.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    jb = jax_bf(path, "gradient")
    p0, s0, ts, vg = jax_vg(jb)
    J, g = vg(p0, s0, ts)
    port = build_fe_problem_from_deck(copy.deepcopy(deck), dtype=F64,
                                      device="cpu")
    q0, r0, qts, pvg = build_fe_stepped_vg(port)
    pJ, pg = pvg(q0, r0, qts)
    return {"deck": deck, "jax": (jb, np.asarray(p0), float(J),
                                  np.asarray(g)),
            "port": port, "port_vg": (q0, r0, qts), "port_J": pJ,
            "port_g": pg}


def test_value_and_grad_match_cmad_tpu(case):
    _jb, p0, J, g = case["jax"]
    q0 = case["port_vg"][0]
    np.testing.assert_array_equal(q0.numpy(), p0)      # [Y, S] canonical
    assert g.shape == case["port_g"].shape == (2,)
    assert abs(case["port_J"] - J) <= RTOL_PORT * abs(J)
    np.testing.assert_allclose(case["port_g"], g, rtol=RTOL_PORT, atol=0)


def test_gradient_is_finite_and_nonzero(case):
    assert np.isfinite(case["port_J"]) and case["port_J"] > 0.0
    assert np.isfinite(case["port_g"]).all()
    assert np.all(case["port_g"] != 0.0)


def _port_vg(case, **options):
    """The port's stepped value-and-gradient of the case's deck, built as
    ``build_fe_stepped_vg`` builds it, with ``options``."""
    bundle = case["port"]
    return build_fe_stepped_value_and_grad(
        bundle.fe_problem, fe_params_overlay(bundle.fe_problem)[1],
        bundle.qoi, nonlinear_solver_settings=nonlinear_settings(bundle),
        linear_solver_settings=bundle.resolved["linear solver"], **options)


def test_reuse_primal_false_matches_true(case):
    q0, r0, ts = case["port_vg"]
    vg = _port_vg(case, reuse_primal=False)
    J, g = vg(q0, r0, ts)
    assert abs(J - case["port_J"]) <= 1e-10 * abs(case["port_J"])
    np.testing.assert_allclose(g, case["port_g"], rtol=1e-6)


def test_checkpoint_offload_is_bit_identical(case):
    q0, r0, ts = case["port_vg"]
    vg = _port_vg(case, checkpoint_offload=True)
    J, g = vg(q0, r0, ts)
    assert J == case["port_J"]
    np.testing.assert_array_equal(g, case["port_g"])


def test_qoi_data_loaders(tmp_path):
    from cmad_tpu.io.qoi_data import load_displacement_data as jax_load
    from cmad_tpu.io.qoi_data import load_qoi_data as jax_load_mp
    from cmad_tpu_torch.io.qoi_data import (
        load_displacement_data,
        load_qoi_data,
    )

    rng = np.random.default_rng(2)
    np.save(tmp_path / "u.npy", rng.normal(size=(3, 4, 3)))
    np.save(tmp_path / "w.npy", rng.random(5))
    sec = {"data_file": str(tmp_path / "u.npy")}
    np.testing.assert_array_equal(load_displacement_data(sec),
                                  jax_load(sec))
    for extra in ({"weight": 2.0}, {"weight_file": str(tmp_path / "w.npy")}):
        got, ref = load_qoi_data({**sec, **extra}), jax_load_mp({**sec,
                                                                 **extra})
        for a, b in zip(got, ref, strict=True):
            np.testing.assert_array_equal(a, b)
    from cmad_tpu.fem.mesh import StructuredHexMesh

    from cmad_tpu_torch.io.exodus import ExodusWriter

    mesh = StructuredHexMesh((1.0, 1.0, 1.0), (1, 1, 1))
    w = ExodusWriter(tmp_path / "u.exo", mesh,
                     nodal_var_names=["u_x", "u_y", "u_z"])
    for t in (0.0, 1.0):
        w.write_step(t, {c: rng.normal(size=8) for c in ("u_x", "u_y",
                                                          "u_z")})
    w.close()
    exo = {"data_file": str(tmp_path / "u.exo")}
    np.testing.assert_array_equal(load_displacement_data(exo),
                                  jax_load(exo))
    with pytest.raises(FileNotFoundError):
        load_displacement_data({"data_file": str(tmp_path / "none.npy")})


def test_stepped_vg_stats_split_the_sweeps(case):
    q0, r0, ts = case["port_vg"]
    _, _, _, vg = build_fe_stepped_vg(case["port"])
    stats: dict = {}
    J, g = vg(q0, r0, ts, stats=stats)
    assert J == case["port_J"] and np.array_equal(g, case["port_g"])
    assert len(stats["forward"]) == len(stats["reverse"]) == len(ts) - 1
    for f in stats["forward"]:
        assert f["newton_iters"] >= 1 and f["assemblies"] > f["newton_iters"]
    for r in stats["reverse"]:
        assert r["wall_s"] >= r["assembly_s"] + r["solve_s"] > 0.0


def test_qoi_step_contribution_matches_cmad_tpu(case):
    """The QoI module alone: one step's contribution at a perturbed state,
    both packages, from the deck's data."""
    import jax.numpy as jnp

    jb = case["jax"][0]
    port = case["port"]
    rng = np.random.default_rng(11)
    U = rng.normal(0.0, 1e-3, port.fe_problem.dof_map.num_total_dofs)
    Up = 0.5 * U
    jc = jb.qoi.step_contribution({}, jb.fe_problem.kernel_arrays)
    pc = port.qoi.step_contribution({}, port.fe_problem.kernel_arrays)
    t, tp = float(jb.t_schedule[2]), float(jb.t_schedule[1])
    ref = float(jc(jnp.asarray(U), jnp.asarray(Up), {}, {}, t, tp))
    got = float(pc(torch.as_tensor(U), torch.as_tensor(Up), {}, {}, t, tp))
    assert isinstance(port.qoi, FEDisplacementMatch)
    assert abs(got - ref) <= 1e-13 * abs(ref)


def test_deck_dispatch_knobs(case, caplog):
    deck = copy.deepcopy(case["deck"])
    deck["residuals"]["global residual"]["steps per dispatch"] = 2
    bundle = build_fe_problem_from_deck(deck, dtype=F64, device="cpu")
    q0, r0, ts, vg = build_fe_stepped_vg(bundle)
    with caplog.at_level(logging.INFO,
                         logger="cmad_tpu_torch.fem.stepped_adjoint"):
        J, g = vg(q0, r0, ts)
        vg2 = build_fe_stepped_vg(bundle)[3]
    assert "steps_per_dispatch=2 ignored" in caplog.text
    assert J == case["port_J"] and np.array_equal(g, case["port_g"])
    del vg2
    deck["residuals"]["global residual"]["max iters per dispatch"] = 2
    with pytest.raises(ValueError, match="PRIMAL"):
        build_fe_stepped_vg(build_fe_problem_from_deck(
            deck, dtype=F64, device="cpu"))


def test_fe_solution_at_gradcheck_in_the_parameters(case):
    """``FeSolutionAt``'s backward is the derivative of the solution map:
    with U* re-solved (no grad) at each point, its outputs (U*, xi*) of
    the first step are a smooth function of the canonical [Y, S], which
    ``gradcheck`` differentiates by central differences."""
    fe = case["port"].fe_problem
    q0, (U0, xi0), ts = case["port_vg"]
    _p, overlay = fe_params_overlay(fe)
    xi0 = pack_xi_by_block(fe, xi0, layout="aos")
    nls = {"max iters": 30, "abs tol": 1e-14, "rel tol": 1e-14}
    t1 = float(ts[1])

    def step(p):
        params = overlay(p)
        with torch.no_grad():
            U_star, _ = fe_newton_solve(fe, overlay(p.detach()), U0, xi0, t1,
                                        nls)
        U, xi = fe_solution_at(fe, params, U0, xi0, t1, U_star, nls)
        return U, xi["all"][:7]

    p = q0.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(step, (p,), eps=1e-3, atol=1e-9,
                                    rtol=1e-4)
