"""The FE path of cmad_tpu_torch with the anisotropic yields: the
point-batch COUPLED block (``fem/coupled_block.py``) with the reduced
principal-Hosford and Hill Newtons (``ops/principal_return.py``,
``ops/hill_return.py``), against cmad_tpu's, on the CPU in float64.

The problem is ``tests/fem/test_torch_fe_hosford.py``'s unit cube of one
hex (8 integration points): 2 steps of a ramp that varies across the
face, the deck's local Newton of ``examples/notch_hosford_principal.yaml``
(500 iterations, tolerance 1e-12, line search of 100 evaluations), the
global Newton at 1e-12 and the sparse-direct solve. The yields: principal
Hosford at a = 8 in the total form (the notch deck's form) and Hill with
``tests/fem/test_coupled_block_fastpath.py``'s coefficients in the rate
form. cmad_tpu's ``make_pointbatch_block_kernels`` is compiled once per
yield and evaluated at the port's step-2 state. Tolerances:

- the block's R, K and xi at that plastic state: 1e-9 of each output's
  scale (both local Newtons stop at 1e-12 from the same guess; K is
  ``jacfwd`` through the solve in JAX and the implicit-function rule in
  strain space here, the same derivative);
- principal Hosford's stepped gradient in Y (one step against the
  2-step drive's last state, Y = 230, ``fe_displacement_match``) against
  the central difference of the port's own J at h = 0.05: 1e-6 relative;
  and one Hessian-vector product (the stepped Hessian of the one active
  Y) against the central difference of the port's gradient at the same
  h: 1e-5 relative;
- each yield's stepped gradient in Y over both steps (Y = 230 against the
  drive's states after steps 1 and 2), whose second step differentiates
  the reduced solve in the previous state the first step left: against
  the central difference of the port's own J at h = 0.05, 1e-6 relative.
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
    build_fe_stepped_hessian_fn,
    build_fe_stepped_vg,
    fe_primal_drive,
)
from cmad_tpu_torch.fem.assembly import (
    gather_element_U,
    params_by_block_from_models,
)
from cmad_tpu_torch.fem.coupled_block import pointbatch_applicable
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode

torch.set_num_threads(1)

F64 = torch.float64
Y_TRUTH, Y = 200.0, 230.0
H_FD = 0.05
LOCAL = {"max_iters": 500, "abs_tol": 1e-12, "rel_tol": 1e-12,
         "line_search_settings": {"max evals": 100}}
BLOCK_RTOL = 1e-9
GRAD_RTOL, HVP_RTOL = 1e-6, 1e-5
NEWTON_TOL = 1e-12
YIELDS = {
    "principal": ("small_elastic_plastic",
                  {"hosford_principal": {"a": {"value": 8.0}}}),
    "hill": ("small_rate_elastic_plastic",
             {"hill": {k: {"value": v} for k, v in (
                 ("F", 0.45), ("G", 0.55), ("H", 0.5),
                 ("L", 1.4), ("M", 1.7), ("N", 1.55))}}),
}


def _deck(mesh_file, name, Y_value=Y_TRUTH, active=False, num_steps=2):
    model, effective_stress = YIELDS[name]
    return {
        "problem": {"type": "fe", "name": f"cube_{name}"},
        "discretization": {"mesh file": str(mesh_file),
                           "num steps": num_steps,
                           "step size": 1.0 / num_steps},
        "residuals": {
            "global residual": {
                "type": "small_disp_equilibrium", "def_type": "full_3d",
                "driver": "stepped", "nonlinear max iters": 30,
                "nonlinear absolute tol": NEWTON_TOL,
                "nonlinear relative tol": NEWTON_TOL},
            "local residual": {
                "type": model,
                "nonlinear max iters": LOCAL["max_iters"],
                "nonlinear absolute tol": LOCAL["abs_tol"],
                "nonlinear relative tol": LOCAL["rel_tol"],
                "line search": {"max evals": 100},
                "materials": {"all": {
                    "elastic": {"E": {"value": 200e3},
                                "nu": {"value": 0.3}},
                    "plastic": {
                        "effective stress": copy.deepcopy(effective_stress),
                        "flow stress": {
                            "initial yield": {"Y": {
                                "value": Y_value, "active": active}},
                            "hardening": {"voce": {
                                "S": {"value": 200.0},
                                "D": {"value": 20.0}}}}}}}}},
        "dirichlet bcs": {"expression": {
            "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"],
            "ramp_x": ["equilibrium", 0, "xmax_sides",
                       "0.004 * t * (1 + y)"]}},
    }


@pytest.fixture(scope="module")
def mesh(tmp_path_factory):
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    path = tmp_path_factory.mktemp("fe_aniso") / "cube.exo"
    ExodusWriter(path, StructuredHexMesh((1.0, 1.0, 1.0), (1, 1, 1))).close()
    return path


_CASES: dict = {}


@pytest.fixture(scope="module", params=sorted(YIELDS))
def case(request, mesh):
    """The port's 2-step drive (the truth) and the sensitivity decks at
    Y = 230, Y active: one step to the truth's last time, and the truth's
    two steps; built once per yield."""
    name = request.param
    if name in _CASES:
        return _CASES[name]
    truth = build_fe_problem_from_deck(_deck(mesh, name), dtype=F64,
                                       device="cpu")
    state, _ = fe_primal_drive(truth)
    data = mesh.parent / f"u_data_{name}.npy"
    np.save(data, np.stack([state.U_at(0), state.U_at(2)]).reshape(
        2, -1, 3))
    sens = _deck(mesh, name, Y, active=True, num_steps=1)
    sens["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(data), "weight": 1.0e8}
    data2 = mesh.parent / f"u_data2_{name}.npy"
    np.save(data2, np.stack([state.U_at(k) for k in range(3)]).reshape(
        3, -1, 3))
    sens2 = _deck(mesh, name, Y, active=True)
    sens2["qoi"] = {**sens["qoi"], "data_file": str(data2)}
    _CASES[name] = {"name": name, "truth": truth, "state": state,
                    "sens": sens, "sens2": sens2}
    return _CASES[name]


def _close(got, ref, rtol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (what, err)


def test_pointbatch_block_matches_cmad_tpu(case, mesh):
    """R, K and xi of one block evaluation at a plastic state (step 2
    from step 1 of the port's drive), against cmad_tpu's block on the
    same arrays."""
    from cmad_tpu.cli.fe_common import (
        build_fe_problem_from_deck as jax_build,
    )
    from cmad_tpu.fem.coupled_block import make_pointbatch_block_kernels

    fe = case["truth"].fe_problem
    model = fe.models_by_block["all"]
    assert pointbatch_applicable(fe.gr, model, GlobalResidualMode.COUPLED,
                                 False)
    ev = fe.evaluators_by_block["all"]
    solve = ev["local_solve"]
    assert solve.residual.__module__.endswith(
        {"principal": "principal_return", "hill": "hill_return"}[
            case["name"]])

    path = mesh.parent / f"{case['name']}.yaml"
    path.write_text(yaml.safe_dump(_deck(mesh, case["name"]),
                                   sort_keys=False))
    jfe = jax_build(path, "primal").fe_problem
    jmodel = jfe.models_by_block["all"]
    kernel = jax.jit(make_pointbatch_block_kernels(jmodel, LOCAL)[
        "block_R_and_K_and_xi"], static_argnums=(4,))
    gather = np.asarray(jfe.kernel_arrays.u_gather_eq_by_block["all"][0])

    state, t = case["state"], case["truth"].t_schedule.tolist()[2]
    U, U_prev = state.U_at(2), state.U_at(1)
    xi_prev = state.xi_at(1, "all")
    assert (xi_prev[..., 6] > 0).all()
    ref = kernel(jmodel.parameters.values, jnp.asarray(U[gather]),
                 jnp.asarray(U_prev[gather]),
                 jfe.kernel_arrays.geometry_cache["all"], None, t,
                 jnp.asarray(xi_prev))

    as_t = torch.tensor
    U_e = gather_element_U(as_t(U), fe.kernel_arrays, "all")[0]
    Up_e = gather_element_U(as_t(U_prev), fe.kernel_arrays, "all")[0]
    params = params_by_block_from_models(fe)["all"]
    geom = fe.kernel_arrays.geometry_cache["all"]
    with torch.no_grad():
        got = ev["block_R_and_K_and_xi"](params, U_e, Up_e, geom, None, t,
                                         as_t(xi_prev))
        R_only = ev["block_R"](params, U_e, Up_e, geom, None, t,
                               as_t(xi_prev))
    for g, r, what in zip(got, ref, ("R", "K", "xi"), strict=True):
        _close(g, np.asarray(r), BLOCK_RTOL, what)
    assert torch.equal(R_only, got[0])


@pytest.mark.parametrize("case", ["principal"], indirect=True)
def test_gradient_and_hvp_match_central_differences(case):
    """Principal Hosford: dJ/dY against the central difference of the
    port's own J, and one Hessian-vector product (the stepped Hessian of
    the one active Y) against the central difference of the port's
    gradient."""
    port = build_fe_problem_from_deck(copy.deepcopy(case["sens"]),
                                      dtype=F64, device="cpu")
    p0, s0, ts, vg = build_fe_stepped_vg(port)
    assert float(p0[0]) == Y                      # no transform: Y itself
    _J, g = vg(p0, s0, ts)
    (Jm, gm), (Jp, gp) = (vg(p0 + s * H_FD, s0, ts) for s in (-1.0, 1.0))
    fd = (Jp - Jm) / (2.0 * H_FD)
    assert abs(g[0] - fd) <= GRAD_RTOL * abs(fd), (g[0], fd)

    port = build_fe_problem_from_deck(copy.deepcopy(case["sens"]),
                                      dtype=F64, device="cpu")
    p0, s0, ts, hess = build_fe_stepped_hessian_fn(port)
    H, _max_asym = hess(p0, s0, ts)
    fd = (gp[0] - gm[0]) / (2.0 * H_FD)
    assert abs(H[0, 0] - fd) <= HVP_RTOL * abs(fd), (H[0, 0], fd)


def test_two_step_gradient_matches_central_difference(case):
    """dJ/dY over two steps against the central difference of the port's
    own J: the second step's local solve starts from the plastic state
    the first left, so the reverse sweep carries d xi_2 / d xi_1 through
    the reduced solve's previous state."""
    port = build_fe_problem_from_deck(copy.deepcopy(case["sens2"]),
                                      dtype=F64, device="cpu")
    p0, s0, ts, vg = build_fe_stepped_vg(port)
    assert len(ts) == 3
    _J, g = vg(p0, s0, ts)
    Jm, Jp = (vg(p0 + s * H_FD, s0, ts)[0] for s in (-1.0, 1.0))
    fd = (Jp - Jm) / (2.0 * H_FD)
    assert g[0] != 0.0
    assert abs(g[0] - fd) <= GRAD_RTOL * abs(fd), (g[0], fd)
