"""The FE Hosford path of cmad_tpu_torch (the point-batch COUPLED block
with the reduced Hosford Newton, ``fem/coupled_block.py``) against
cmad_tpu's, on the CPU in float64.

The problem is a unit cube of one hex (8 integration points) with the
total-form Hosford model of ``examples/notch_hosford.yaml`` (a = 100,
the deck's local Newton: 500 iterations, tolerance 1e-12, line search of
100 evaluations), 2 steps of a ramp that varies across the face, so
every point has its own plastic state, the global Newton at 1e-12 and
the sparse-direct solve; the sensitivities take one step of the same
ramp against the 2-step drive's last state at Y = 200. cmad_tpu's
``make_pointbatch_block_kernels`` is compiled once (its whole FE drive
and stepped gradient took about 45 and 90 s to compile on one core, on a
cube of eight hexes); the test
drives it with its own dense Newton (the same stopping rule) to get
cmad_tpu's trajectory, its J under ``fe_displacement_match`` and that
J's central differences. Tolerances:

- the block's R, K and xi at a plastic state: 1e-9 of each output's
  scale. Both local Newtons stop at 1e-12 from the same guess; K's
  tangent is ``jacfwd`` through the solve in JAX and the
  implicit-function rule in strain space here, the same derivative
  (measured 2.2e-15 in K);
- the 2-step drive, U and xi per step: 1e-9 of their scales (measured
  1.6e-12 and 1.8e-12: the two Newtons stop at 1e-12 on their own
  paths);
- J: 1e-9 relative (measured 3.4e-11); dJ/dY of the stepped adjoint
  against the central difference of cmad_tpu's J at h = 0.05 (Y = 230):
  1e-6 relative (on eight hexes, at h = 1 the truncation error was
  3.6e-5, so about 1e-7 at this h; J's Newton noise over 2h is about
  1e-10 of the gradient; measured 2.8e-10);
- the stepped Hessian against the second central difference of cmad_tpu's
  J at the same h: 1e-4 relative (J's Newton noise over h^2 is about
  1e-6 of H; measured 1.4e-6), so no JAX Hessian is compiled;
- the Cauchy stress the Exodus writer evaluates on the drive's states:
  1e-12 of its scale (measured 2e-16).
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
A = 100.0
Y_TRUTH, Y = 200.0, 230.0
H_FD = 0.05
LOCAL = {"max_iters": 500, "abs_tol": 1e-12, "rel_tol": 1e-12,
         "line_search_settings": {"max evals": 100}}
BLOCK_RTOL = DRIVE_RTOL = J_RTOL = 1e-9
GRAD_RTOL, HESS_RTOL = 1e-6, 1e-4
NEWTON_TOL = 1e-12


def _deck(mesh_file, Y_value=Y_TRUTH, active=False, num_steps=2):
    return {
        "problem": {"type": "fe", "name": "cube_hosford"},
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
                "type": "small_elastic_plastic",
                "nonlinear max iters": LOCAL["max_iters"],
                "nonlinear absolute tol": LOCAL["abs_tol"],
                "nonlinear relative tol": LOCAL["rel_tol"],
                "line search": {"max evals": 100},
                "materials": {"all": {
                    "elastic": {"E": {"value": 200e3},
                                "nu": {"value": 0.3}},
                    "plastic": {
                        "effective stress": {"hosford": {"a": {
                            "value": A}}},
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


class JaxDrive:
    """cmad_tpu's point-batch block, compiled once, under a dense
    Newton with the port's stopping rule: the trajectory of cmad_tpu's
    FE path at any Y without compiling its drive."""

    def __init__(self, bundle):
        from cmad_tpu.fem.coupled_block import make_pointbatch_block_kernels
        from cmad_tpu.fem.dof import build_dbc_arrays

        fe = bundle.fe_problem
        self.fe = fe
        model = fe.models_by_block["all"]
        self.values = model.parameters.values
        self.kernel = jax.jit(
            make_pointbatch_block_kernels(model, LOCAL)[
                "block_R_and_K_and_xi"], static_argnums=(4,))
        self.geom = fe.kernel_arrays.geometry_cache["all"]
        self.gather = np.asarray(
            fe.kernel_arrays.u_gather_eq_by_block["all"][0])
        dm = fe.dof_map
        self.n = dm.num_total_dofs
        self.presc = np.asarray(dm.prescribed_indices)
        self.free = np.setdiff1d(np.arange(self.n), self.presc)
        self.dbc = build_dbc_arrays(dm)
        det = self.geom["per_elem"]["iso_jac_det"]
        self.EQ = tuple(det.shape)

    def with_Y(self, Y_value):
        v = self.values
        return {**v, "plastic": {**v["plastic"], "flow stress": {
            **v["plastic"]["flow stress"],
            "initial yield": {"Y": jnp.asarray(Y_value)}}}}

    def block(self, values, U, U_prev, t, xi_prev):
        R_e, K_e, xi = self.kernel(values, jnp.asarray(U[self.gather]),
                                   jnp.asarray(U_prev[self.gather]),
                                   self.geom, None, t, jnp.asarray(xi_prev))
        return np.asarray(R_e), np.asarray(K_e), np.asarray(xi)

    def drive(self, Y_value, ts):
        values = self.with_Y(Y_value)
        E = self.gather.shape[0]
        idx = self.gather.reshape(E, -1)
        U = np.zeros(self.n)
        xi = np.zeros((*self.EQ, 7))
        hist = [(U, xi)]
        for k in range(1, len(ts)):
            U_prev, xi_prev = U, xi
            U = U_prev.copy()
            U[self.presc] = np.asarray(self.fe.dof_map.
                                       evaluate_prescribed_values(
                                           self.dbc, ts[k]))
            for it in range(30):
                R_e, K_e, xi = self.block(values, U, U_prev, ts[k],
                                          xi_prev)
                R = np.zeros(self.n)
                np.add.at(R, idx.ravel(), R_e.reshape(-1))
                norm = float(np.linalg.norm(R[self.free]))
                norm0 = norm if it == 0 else norm0
                if norm < NEWTON_TOL or norm < NEWTON_TOL * norm0:
                    break
                K = np.zeros((self.n, self.n))
                nd = idx.shape[1]
                np.add.at(K, (idx[:, :, None], idx[:, None, :]),
                          K_e.reshape(E, nd, nd))
                f = self.free
                U[f] -= np.linalg.solve(K[np.ix_(f, f)], R[f])
            hist.append((U, xi))
        return hist


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    tmp = tmp_path_factory.mktemp("fe_hosford")
    mesh = tmp / "cube.exo"
    ExodusWriter(mesh, StructuredHexMesh((1.0, 1.0, 1.0), (1, 1, 1))).close()
    truth = build_fe_problem_from_deck(_deck(mesh), dtype=F64, device="cpu")
    log = truth.fe_problem.evaluators_by_block["all"]["local_solve"].newton
    log.log = []
    state, _ = fe_primal_drive(truth)
    # the sensitivity deck takes one step to the truth's last time, so
    # its target is the truth at t = 0 and t = 1
    data = tmp / "u_data.npy"
    np.save(data, np.stack([state.U_at(0), state.U_at(2)]).reshape(
        2, -1, 3))

    sens = _deck(mesh, Y, active=True, num_steps=1)
    sens["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(data), "weight": 1.0e8}
    path = tmp / "sens.yaml"
    path.write_text(yaml.safe_dump(sens, sort_keys=False))
    jb = jax_bf(path, "gradient")
    return {"truth": truth, "state": state, "local_log": log.log,
            "ts": truth.t_schedule.tolist(), "sens": sens,
            "sens_ts": jb.t_schedule.tolist(), "jax": JaxDrive(jb),
            "jax_qoi": jb.qoi}


def _jax_J(case, hist):
    ts = case["sens_ts"]
    closure = case["jax_qoi"].step_contribution({}, case["jax"].fe.
                                                kernel_arrays)
    return sum(float(closure(jnp.asarray(hist[k][0]),
                             jnp.asarray(hist[k - 1][0]), None, None,
                             ts[k], ts[k - 1]))
               for k in range(1, len(ts)))


def _close(got, ref, rtol, what):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (what, err)


def test_the_deck_binds_the_pointbatch_block(case):
    fe = case["truth"].fe_problem
    ev = fe.evaluators_by_block["all"]
    assert pointbatch_applicable(fe.gr, fe.models_by_block["all"],
                                 GlobalResidualMode.COUPLED, False)
    assert not ev.get("xi_carrier")
    assert {"block_R_and_K_and_xi", "block_R", "local_solve"} <= set(ev)
    # every assembly ran the reduced Newton: (iterations of the slowest
    # point, their sum, points), and the plastic ones iterated
    log = case["local_log"]
    assert log and all(n == 8 for _k, _s, n in log)
    assert max(k for k, _s, _n in log) > 2


def test_pointbatch_block_matches_cmad_tpu(case):
    """R, K and xi of one block evaluation at a plastic state (step 2
    from step 1 of the truth)."""
    fe = case["truth"].fe_problem
    state, jd, t = case["state"], case["jax"], case["ts"][2]
    U, U_prev = state.U_at(2), state.U_at(1)
    xi_prev = state.xi_at(1, "all")
    assert (xi_prev[..., 6] > 0).all()
    ref = jd.block(jd.with_Y(Y_TRUTH), U, U_prev, t, xi_prev)

    ev = fe.evaluators_by_block["all"]
    as_t = torch.tensor
    U_e = gather_element_U(as_t(U), fe.kernel_arrays, "all")[0]
    Up_e = gather_element_U(as_t(U_prev), fe.kernel_arrays, "all")[0]
    params = params_by_block_from_models(fe)["all"]
    with torch.no_grad():
        got = ev["block_R_and_K_and_xi"](
            params, U_e, Up_e, fe.kernel_arrays.geometry_cache["all"], None,
            t, as_t(xi_prev))
        R_only = ev["block_R"](
            params, U_e, Up_e, fe.kernel_arrays.geometry_cache["all"], None,
            t, as_t(xi_prev))
    for g, r, what in zip(got, ref, ("R", "K", "xi"), strict=True):
        _close(g, r, BLOCK_RTOL, what)
    assert torch.equal(R_only, got[0])


def test_stepped_drive_matches_cmad_tpu(case):
    state = case["state"]
    hist = case["jax"].drive(Y_TRUTH, case["ts"])
    assert (hist[-1][1][..., 6] > 0).all()
    for k in (1, 2):
        _close(state.U_at(k), hist[k][0], DRIVE_RTOL, f"U step {k}")
        _close(state.xi_at(k, "all"), hist[k][1], DRIVE_RTOL,
               f"xi step {k}")


@pytest.fixture(scope="module")
def jax_J(case):
    """cmad_tpu's J at Y - h, Y, Y + h."""
    return [_jax_J(case, case["jax"].drive(Y + s * H_FD, case["sens_ts"]))
            for s in (-1.0, 0.0, 1.0)]


def test_stepped_gradient_matches_cmad_tpu(case, jax_J):
    port = build_fe_problem_from_deck(copy.deepcopy(case["sens"]),
                                      dtype=F64, device="cpu")
    p0, s0, ts, vg = build_fe_stepped_vg(port)
    assert float(p0[0]) == Y                      # no transform: Y itself
    J, g = vg(p0, s0, ts)
    Jm, J0, Jp = jax_J
    assert abs(J - J0) <= J_RTOL * abs(J0)
    fd = (Jp - Jm) / (2.0 * H_FD)
    assert abs(g[0] - fd) <= GRAD_RTOL * abs(fd), (g[0], fd)


def test_stepped_hessian_matches_second_difference(case, jax_J):
    port = build_fe_problem_from_deck(copy.deepcopy(case["sens"]),
                                      dtype=F64, device="cpu")
    p0, s0, ts, hess = build_fe_stepped_hessian_fn(port)
    H, _max_asym = hess(p0, s0, ts)
    Jm, J0, Jp = jax_J
    fd = (Jp - 2.0 * J0 + Jm) / H_FD**2
    assert abs(H[0, 0] - fd) <= HESS_RTOL * abs(fd), (H[0, 0], fd)


def test_cauchy_output_matches_cmad_tpu(case):
    """The Exodus writer's Cauchy stress (``fem/postprocess``, through
    ``model.cauchy_fun``) on the drive's states, against cmad_tpu's on
    the same arrays: 1e-12 of its scale (the same elastic map)."""
    from cmad_tpu.fem.postprocess import (
        evaluate_cauchy_at_ips as jax_cauchy,
    )
    from cmad_tpu_torch.fem.postprocess import evaluate_cauchy_at_ips

    fe, state = case["truth"].fe_problem, case["state"]
    for k in (1, 2):
        _close(evaluate_cauchy_at_ips(fe, state, k, "all"),
               jax_cauchy(case["jax"].fe, state, k, "all"), 1e-12,
               f"cauchy step {k}")
