"""cmad_tpu_torch's generic per-point FE block against cmad_tpu's, on the
CPU in float64.

The generic block (``fem/generic_block.py``) takes what the J2 and
point-batch blocks decline: CLOSED_FORM blocks (the elastic model) and
COUPLED blocks with per-point convergence printing. Tolerances:

- CLOSED_FORM R and K on ``examples/meshes/cube_hex_8.exo`` (512 hexes)
  against ``cmad_tpu.fem.assembly.assemble_global`` at a random U,
  isotropic linear and neo-Hookean: 1e-12 relative to the largest entry
  (the same f64 algebra; the sums over points and into the pattern run
  in other orders);
- COUPLED R, K and xi of J2 with ``print convergence: true`` on one hex
  against cmad_tpu's (which prints every point's every iteration through
  a host callback: 340 s on the 512-hex cube, 10 s on one hex), at
  1e-12; against the port's own J2 block (radial return, no printing)
  within the local Newton's tolerance, 1e-9 relative;
- ``gradcheck`` and ``gradgradcheck`` of both blocks in their
  parameters (torch's defaults, on one hex);
- the two-block cube of ``tests/fem/test_multi_block.py`` (soft and stiff
  elastic halves, nu = 0) through every FE command, its series-composite
  solution checked with no JAX drive: sigma_xx uniform and exact, the
  slope of u_x in each half inversely proportional to its E, to 1e-10;
  calibrate recovers the soft E to 1e-6;
- an elastic block beside a J2 block: drive, Exodus, restart, objective,
  gradient and Hessian (stepped and scan drivers alike, to 1e-12) of
  the library calls the commands make; the Hessian against a central
  difference of the gradient, 1e-6;
- ``fe_load_match``'s gradient on the 8-hex cube (neo-Hookean, E and nu
  active) against cmad_tpu's stepped gradient, 1e-8, and its Hessian
  against the port's central difference, 1e-6.
"""
from __future__ import annotations

import contextlib
import copy
import dataclasses
import io

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.cli import fe_subcommands as fs
from cmad_tpu_torch.cli.fe_common import (
    build_fe_problem_from_deck,
    fe_primal_drive,
)
from cmad_tpu_torch.fem.assembly import (
    assemble_global,
    params_by_block_from_models,
)
from cmad_tpu_torch.fem.fe_problem import FEState, build_fe_problem
from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block, unpack_xi_by_block
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.io.registry import resolve_qoi

from tests.support.torch_fe import MESHES

torch.set_num_threads(1)

F64 = torch.float64
E_SOFT, E_STIFF = 500.0, 2000.0
RAMP = 0.01
J2_MATERIAL = {
    "elastic": {"E": {"value": 200e3}, "nu": {"value": 0.3}},
    "plastic": {"effective stress": {"J2": {}},
                "flow stress": {"initial yield": {"Y": {"value": 200.0}},
                                "hardening": {"voce": {
                                    "S": {"value": 200.0},
                                    "D": {"value": 20.0}}}}}}


def _elastic(E, nu=0.25, active=()):
    out = {"elastic": {"E": {"value": E}, "nu": {"value": nu}}}
    for name in active:
        out["elastic"][name]["active"] = True
    if "E" in active:
        out["elastic"]["E"]["transform"] = {"log": E}
    return out


def _deck(mesh, materials, model="elastic", num_steps=2, ramp=RAMP,
          **local):
    return {
        "problem": {"type": "fe", "name": "generic"},
        "discretization": {"mesh file": str(mesh), "num steps": num_steps,
                           "step size": 1.0 / num_steps},
        "residuals": {
            "global residual": {"type": "small_disp_equilibrium",
                                "def_type": "full_3d", "driver": "stepped",
                                "nonlinear absolute tol": 1e-12,
                                "nonlinear relative tol": 1e-12},
            "local residual": {"type": model, "materials": materials,
                               **local}},
        "dirichlet bcs": {"expression": {
            "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"],
            "ramp_x": ["equilibrium", 0, "xmax_sides", f"{ramp} * t"]}},
        "linear solver": {"type": "direct"},
    }


def _port(deck):
    return build_fe_problem_from_deck(copy.deepcopy(deck), dtype=F64,
                                      device="cpu")


def _jax(deck, tmp, subcommand="primal"):
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf

    path = tmp / "deck.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    return jax_bf(path, subcommand)


@pytest.fixture(scope="module")
def meshes(tmp_path_factory):
    from cmad_tpu.fem.mesh import Mesh, StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    tmp = tmp_path_factory.mktemp("fe_generic")
    ExodusWriter(tmp / "one.exo",
                 StructuredHexMesh((1.0, 1.0, 1.0), (1, 1, 1))).close()
    ExodusWriter(tmp / "cube.exo",
                 StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    base = StructuredHexMesh((1.0, 1.0, 1.0), (4, 1, 1))
    x = base.nodes[base.connectivity].mean(axis=1)[:, 0]
    ExodusWriter(tmp / "two.exo", Mesh(
        nodes=base.nodes, connectivity=base.connectivity,
        element_family=base.element_family,
        element_blocks={"soft": np.where(x < 0.5)[0].astype(np.intp),
                        "stiff": np.where(x >= 0.5)[0].astype(np.intp)},
        node_sets=base.node_sets, side_sets=base.side_sets)).close()
    return tmp


def _inputs(fe, scale, seed=0):
    """A random U and U_prev about the ramp's uniform stretch."""
    rng = np.random.default_rng(seed)
    n = fe.dof_map.num_total_dofs
    x = np.repeat(fe.mesh.nodes[:, 0], 3) * (np.arange(n) % 3 == 0)
    return (scale * (x + 0.1 * rng.normal(size=n)),
            0.5 * scale * (x + 0.1 * rng.normal(size=n)))


def _jax_assemble(jb, U, Up):
    """cmad_tpu's (R, K data, xi_solved_by_block) from the initial
    state."""
    import jax.numpy as jnp

    from cmad_tpu.fem.assembly import assemble_global as jax_assemble
    from cmad_tpu.fem.assembly import params_by_block_from_models as jax_p
    from cmad_tpu.fem.fe_problem import FEState as JaxState

    fe = jb.fe_problem
    xi = {b: jnp.asarray(v[0]) for b, v in
          JaxState.from_problem(fe).xi_history_by_block.items()}
    K, R, xi_out = jax_assemble(fe, fe.kernel_arrays, jax_p(fe),
                                jnp.asarray(U), jnp.asarray(Up), 1.0, xi)
    return (np.asarray(R), np.asarray(K.data),
            {b: np.asarray(v) for b, v in xi_out.items()})


def _port_assemble(pb, U, Up):
    fe = pb.fe_problem
    xi = pack_xi_by_block(fe, {b: torch.as_tensor(v[0]) for b, v in
                               FEState.from_problem(fe)
                               .xi_history_by_block.items()})
    K, R, xi_out = assemble_global(fe, fe.kernel_arrays,
                                   params_by_block_from_models(fe),
                                   torch.as_tensor(U), torch.as_tensor(Up),
                                   1.0, xi)
    return (R.numpy(), K.data.numpy(),
            {b: v.numpy() for b, v in
             unpack_xi_by_block(fe, xi_out).items()})


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


@pytest.mark.parametrize("form", ["isotropic_linear", "neohookean"])
def test_closed_form_block_matches_cmad_tpu(meshes, form):
    deck = _deck(MESHES / "cube_hex_8.exo", {"all": _elastic(1000.0)},
                 elastic_stress=form)
    pb = _port(deck)
    assert pb.fe_problem.modes_by_block == {
        "all": GlobalResidualMode.CLOSED_FORM}
    U, Up = _inputs(pb.fe_problem, 0.05)
    Rj, Kj, xij = _jax_assemble(_jax(deck, meshes), U, Up)
    Rp, Kp, xip = _port_assemble(pb, U, Up)
    assert _rel(Rp, Rj) <= 1e-12 and _rel(Kp, Kj) <= 1e-12
    assert xij == {} and xip == {}


def _print_deck(mesh, print_convergence=True, local_tol=1e-12):
    return _deck(mesh, {"all": J2_MATERIAL}, "small_elastic_plastic",
                 ramp=0.004, **{"print convergence": print_convergence,
                                "nonlinear max iters": 50,
                                "nonlinear absolute tol": local_tol,
                                "nonlinear relative tol": local_tol})


def test_coupled_block_with_printing_matches_cmad_tpu_and_the_j2_block(
        meshes):
    deck = _print_deck(meshes / "one.exo")
    pb = _port(deck)
    ev = pb.fe_problem.evaluators_by_block["all"]
    assert "local_solve" in ev and "xi_carrier" not in ev
    U, Up = _inputs(pb.fe_problem, 1.0)
    Rj, Kj, xij = _jax_assemble(_jax(deck, meshes), U, Up)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        Rp, Kp, xip = _port_assemble(pb, U, Up)
    assert sum("abs ||C|| =" in ln for ln in out.getvalue().splitlines()) \
        >= 2, "the local Newton printed no iterations"
    assert xip["all"].shape == (1, 8, 7)
    assert np.abs(xip["all"][..., 6]).min() > 0.0      # every point yields
    assert _rel(Rp, Rj) <= 1e-12 and _rel(Kp, Kj) <= 1e-12
    assert _rel(xip["all"], xij["all"]) <= 1e-12
    # the same block through the port's J2 block (no printing)
    j2 = _port(_print_deck(meshes / "one.exo", False))
    assert "xi_carrier" in j2.fe_problem.evaluators_by_block["all"]
    R2, K2, xi2 = _port_assemble(j2, U, Up)
    assert _rel(Rp, R2) <= 1e-9 and _rel(Kp, K2) <= 1e-9
    assert _rel(xip["all"], xi2["all"]) <= 1e-9


def _block_fn(pb, leaf_paths, scale):
    """``f(a) -> (R_e, K_e)`` of the problem's one block, with the
    parameter leaves at ``leaf_paths`` set to their values times ``1 +
    a[i]``: the parameters enter the evaluator as an explicit input."""
    fe = pb.fe_problem
    ev = fe.evaluators_by_block["all"]
    params = params_by_block_from_models(fe)["all"]
    U, Up = (torch.as_tensor(u) for u in _inputs(fe, scale))
    from cmad_tpu_torch.fem.assembly import gather_element_U

    U_e = gather_element_U(U, fe.kernel_arrays, "all")[0]
    Up_e = gather_element_U(Up, fe.kernel_arrays, "all")[0]
    xi = torch.as_tensor(FEState.from_problem(fe).xi_at(0, "all"))
    geom = fe.kernel_arrays.geometry_cache["all"]

    def with_leaves(a):
        def put(tree, path, value):
            if len(path) == 1:
                return {**tree, path[0]: value}
            return {**tree, path[0]: put(tree[path[0]], path[1:], value)}

        out = params
        for i, path in enumerate(leaf_paths):
            node = params
            for k in path:
                node = node[k]
            out = put(out, path, node * (1.0 + a[i]))
        return out

    def f(a):
        R, K, _xi = ev["block_R_and_K_and_xi"](with_leaves(a), U_e, Up_e,
                                               geom, None, 1.0, xi)
        return R, K

    return f


@pytest.mark.parametrize("mode", ["closed_form", "coupled"])
def test_generic_blocks_gradcheck_in_the_parameters(meshes, mode):
    if mode == "closed_form":
        pb = _port(_deck(meshes / "one.exo", {"all": _elastic(1000.0)},
                         elastic_stress="neohookean"))
        f = _block_fn(pb, [("elastic", "E"), ("elastic", "nu")], 0.05)
    else:
        # the local Newton to its round-off floor (about 2e-14 here), so
        # that the central differences see the state move with the
        # parameters and not with where each probe's Newton stopped
        pb = _port(_print_deck(meshes / "one.exo", local_tol=1e-13))
        f = _block_fn(pb, [("elastic", "E"), ("plastic", "flow stress",
                                                "initial yield", "Y")], 1.0)
    # a step of 1e-3 in the relative parameters: the second derivatives
    # of K are central differences of first derivatives of size |K| ~
    # 5e4, whose round-off (~1e-14 of it, more through the local solve) a
    # step of 1e-6 turns into ~1e-4, above the second derivatives
    # themselves (a central difference at 1e-2 agrees with them to 1e-3)
    a = torch.zeros(2, dtype=F64, requires_grad=True)
    with contextlib.redirect_stdout(io.StringIO()):
        assert torch.autograd.gradcheck(f, (a,), eps=1e-3, fast_mode=True)
        assert torch.autograd.gradgradcheck(f, (a,), eps=1e-3,
                                            fast_mode=True)


def _two_block_deck(meshes, E_soft=E_SOFT, active=()):
    return _deck(meshes / "two.exo", {"soft": _elastic(E_soft, 0.0, active),
                                      "stiff": _elastic(E_STIFF, 0.0)},
                 num_steps=2)


def test_two_block_series_composite_through_every_command(meshes, tmp_path):
    """The series composite (nu = 0): sigma_xx = RAMP / (0.5 / E_soft + 0.5
    / E_stiff) in both halves and E_soft e_soft = E_stiff e_stiff, from
    the primal command's Exodus output; a restart resumed; objective,
    gradient and Hessian against the library calls; calibrate from E_soft
    = 650 back to the truth's 500 through fe_load_match."""
    from cmad_tpu_torch.io.exodus import read_results
    from cmad_tpu_torch.io.results import FieldSpec
    from cmad_tpu_torch.models.var_types import VarType

    truth = _two_block_deck(meshes)
    truth["output"] = {"path": str(tmp_path / "primal"),
                       "write restart": True}
    truth["qoi"] = {"name": "fe_load_match", "sideset": "xmax_sides",
                    "components": [0],
                    "output_file": str(tmp_path / "reaction.csv")}
    assert fs.run_primal_fe(truth, device="cpu") == 0
    res = read_results(tmp_path / "primal" / "generic.exo",
                       element_field_specs=[FieldSpec("cauchy",
                                                      VarType.SYM_TENSOR)])
    sigma = RAMP / (0.5 / E_SOFT + 0.5 / E_STIFF)
    for block in ("soft", "stiff"):
        sig = res.element["cauchy"][block][-1]
        np.testing.assert_allclose(sig[:, 0], sigma, rtol=1e-10)
        np.testing.assert_allclose(sig[:, 1:], 0.0, atol=1e-10 * sigma)
    bundle = _port(_two_block_deck(meshes))
    state, _ = fe_primal_drive(bundle)
    u = state.U_at(2).reshape(-1, 3)[:, 0]
    x = bundle.fe_problem.mesh.nodes[:, 0]
    e_soft = np.polyfit(x[x <= 0.5], u[x <= 0.5], 1)[0]
    e_stiff = np.polyfit(x[x >= 0.5], u[x >= 0.5], 1)[0]
    assert abs(E_SOFT * e_soft / (E_STIFF * e_stiff) - 1.0) <= 1e-10
    assert abs(E_SOFT * e_soft - sigma) <= 1e-10 * sigma

    resumed = copy.deepcopy(truth)
    resumed.pop("qoi")
    resumed["discretization"]["num steps"] = 3
    resumed["discretization"]["step size"] = 0.5
    resumed["restart"] = {"file": str(tmp_path / "primal" / "restart.npz")}
    resumed["output"] = {"path": str(tmp_path / "resumed")}
    assert fs.run_primal_fe(resumed, device="cpu") == 0

    np.save(tmp_path / "reaction.npy",
            np.loadtxt(tmp_path / "reaction.csv", delimiter=",")
            .reshape(-1, 1))
    deck = _two_block_deck(meshes, 650.0, active=("E",))
    deck["qoi"] = {"name": "fe_load_match", "sideset": "xmax_sides",
                   "components": [0],
                   "data_file": str(tmp_path / "reaction.npy")}
    bundle = _port(deck)
    J = fs.fe_objective(bundle)
    p0, vg = fs.fe_value_and_grad(bundle)
    J_vg, g = vg(p0)
    H, _asym = fs.fe_hessian(bundle)
    h = 1e-5
    fd = (vg(p0 + h)[1] - vg(p0 - h)[1]) / (2 * h)
    assert J > 0.0 and J_vg == J and g[0] > 0.0   # E_soft too high
    assert abs(H[0, 0] - fd[0]) <= 1e-6 * abs(fd[0])
    for cmd, name, want in (("objective", "J.json", None),
                            ("gradient", "grad.npy", g),
                            ("hessian", "hess.npy", H)):
        out = tmp_path / cmd
        assert getattr(fs, f"run_{cmd}_fe")(deck, out, device="cpu") == 0
        if want is not None:
            np.testing.assert_array_equal(np.load(out / name).reshape(
                want.shape), want)
    cal = copy.deepcopy(deck)
    cal["optimizer"] = {"algorithm": "L-BFGS-B",
                        "options": {"maxiter": 30, "gtol": 1e-12}}
    assert fs.run_calibrate_fe(cal, tmp_path / "cal", device="cpu") == 0
    import json

    got = json.loads((tmp_path / "cal" / "active_params.json").read_text())
    assert abs(got["soft.elastic.E"] / E_SOFT - 1.0) <= 1e-6


def _mixed_bundle(deck):
    """The deck's bundle with block ``stiff`` J2 (COUPLED, the J2 block)
    beside the elastic ``soft`` (CLOSED_FORM, the generic block): a deck
    names one model, so the problem is rebuilt from both decks'
    models."""
    elastic = _port(deck)
    j2_deck = copy.deepcopy(deck)
    j2_deck["residuals"]["local residual"] = {
        "type": "small_elastic_plastic",
        "materials": {"soft": J2_MATERIAL, "stiff": J2_MATERIAL}}
    e, j = elastic.fe_problem, _port(j2_deck).fe_problem
    fe = build_fe_problem(
        e.mesh, e.dof_map, e.gr,
        {"soft": e.models_by_block["soft"],
         "stiff": j.models_by_block["stiff"]},
        {"soft": GlobalResidualMode.CLOSED_FORM,
         "stiff": GlobalResidualMode.COUPLED}, dtype=F64, device="cpu")
    qoi = elastic.resolved.get("qoi")
    return dataclasses.replace(
        elastic, fe_problem=fe,
        qoi=None if qoi is None else resolve_qoi(qoi["name"]).from_deck(
            qoi, fe, elastic.t_schedule.tolist()))


def test_elastic_beside_j2_runs_the_library_calls_of_every_command(
        meshes, tmp_path):
    """A stateless CLOSED_FORM block beside a COUPLED one: the drive
    echoes its initial state; Exodus writes its Cauchy stress and the J2
    block's state; a restart round-trips; the objective, gradient and
    Hessian agree between the stepped and scan drivers, and the Hessian
    with a central difference of the gradient."""
    from cmad_tpu_torch.io.fe_writers import (
        resolve_fe_output_plan,
        write_fe_exodus,
    )
    from cmad_tpu_torch.io.restart import (
        check_restart_compatible,
        read_restart,
        write_restart,
    )

    deck = _deck(meshes / "two.exo",
                 {"soft": _elastic(1.0e5, 0.3, active=("E",)),
                  "stiff": _elastic(1.0e5, 0.3)}, num_steps=2, ramp=0.004)
    deck["qoi"] = {"name": "fe_load_match", "sideset": "xmax_sides",
                   "components": [0],
                   "output_file": str(tmp_path / "reaction.csv")}
    bundle = _mixed_bundle(deck)
    fe = bundle.fe_problem
    assert fe.state_blocks() == ["stiff"]
    assert "xi_carrier" in fe.evaluators_by_block["stiff"]
    state, log = fe_primal_drive(bundle)
    assert max(e["final_residual"] for e in log) <= 1e-8
    assert np.all(state.xi_at(2, "soft") == 0.0)         # echoed
    assert np.abs(state.xi_at(2, "stiff")[..., 6]).max() > 0.0  # yields
    plan = resolve_fe_output_plan({}, fe)
    assert [f.name for f in plan.element_by_block["soft"]] == ["cauchy"]
    assert {"alpha", "cauchy"} <= {f.name for f in
                                   plan.element_by_block["stiff"]}
    write_fe_exodus(tmp_path, "", fe, state, plan, "mixed.exo")
    write_restart(tmp_path / "restart.npz", state.U_at(2),
                  {b: state.xi_at(2, b) for b in fe.models_by_block}, 1.0)
    U0, xi0, t0 = read_restart(tmp_path / "restart.npz")
    check_restart_compatible(fe, U0, xi0)
    assert t0 == 1.0 and np.array_equal(xi0["stiff"],
                                        state.xi_at(2, "stiff"))
    bundle.qoi.write_primal_outputs(fe, state)
    np.save(tmp_path / "reaction.npy", 1.05 * np.loadtxt(
        tmp_path / "reaction.csv", delimiter=",").reshape(-1, 1))

    deck["qoi"] = {"name": "fe_load_match", "sideset": "xmax_sides",
                   "components": [0],
                   "data_file": str(tmp_path / "reaction.npy")}
    got = {}
    for driver in ("stepped", "scan"):
        deck["residuals"]["global residual"]["driver"] = driver
        bundle = _mixed_bundle(deck)
        p0, vg = fs.fe_value_and_grad(bundle)
        got[driver] = (fs.fe_objective(bundle), *vg(p0),
                       fs.fe_hessian(bundle)[0])
    (J, J_vg, g, H), (J2, _J2vg, g2, H2) = got["stepped"], got["scan"]
    assert J > 0.0 and abs(J_vg - J) <= 1e-12 * J
    assert abs(J2 - J) <= 1e-12 * J
    np.testing.assert_allclose(g2, g, rtol=1e-12)
    np.testing.assert_allclose(H2, H, rtol=1e-12)
    h = 1e-5
    fd = (vg(p0 + h)[1] - vg(p0 - h)[1]) / (2 * h)
    np.testing.assert_allclose(H[:, 0], fd, rtol=1e-6)


def test_elastic_load_match_gradient_matches_cmad_tpu(meshes, tmp_path):
    """``fe_load_match`` sees E and nu (a displacement match would not:
    under displacement loading the displacement of one isotropic linear
    material does not depend on E): the stepped gradient on the 8-hex
    cube, neo-Hookean, against cmad_tpu's; the Hessian against a central
    difference of the port's gradient."""
    from cmad_tpu.cli.fe_common import build_fe_stepped_vg as jax_vg

    np.save(tmp_path / "reaction.npy", np.array([[0.0], [5.0], [10.0]]))
    materials = {"all": _elastic(1300.0, 0.3, active=("E", "nu"))}
    materials["all"]["elastic"]["E"]["transform"] = {"log": 1000.0}
    deck = _deck(meshes / "cube.exo", materials,
                 elastic_stress="neohookean")
    deck["qoi"] = {"name": "fe_load_match", "sideset": "xmax_sides",
                   "components": [0],
                   "data_file": str(tmp_path / "reaction.npy")}
    p0, s0, ts, vg = jax_vg(_jax(deck, tmp_path, "gradient"))
    J_ref, g_ref = vg(p0, s0, ts)
    bundle = _port(deck)
    q0, pvg = fs.fe_value_and_grad(bundle)
    np.testing.assert_array_equal(q0.numpy(), np.asarray(p0))
    J, g = pvg(q0)
    assert abs(J - float(J_ref)) <= 1e-8 * abs(float(J_ref))
    np.testing.assert_allclose(g, np.asarray(g_ref), rtol=1e-8)
    H, asym = fs.fe_hessian(bundle)
    h = 1e-5
    for i in range(2):
        e = np.zeros(2)
        e[i] = h
        fd = (pvg(q0.numpy() + e)[1] - pvg(q0.numpy() - e)[1]) / (2 * h)
        np.testing.assert_allclose(H[:, i], fd, rtol=1e-6,
                                   atol=1e-6 * np.abs(H).max())
    assert asym <= 1e-10 * np.abs(H).max()
