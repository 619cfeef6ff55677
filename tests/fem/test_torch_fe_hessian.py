"""Second derivatives of the FE J2 drive in cmad_tpu_torch against
cmad_tpu's, on the CPU in float64.

The decks are ``tests/fem/test_torch_fe_gradient.py``'s (the JAX
package's stepped-adjoint decks): the 8-hex cube, J2+Voce, 3 steps, a
truth at Y = 200, then Y = 230 and S active, ``fe_displacement_match``
at weight 1e8, the sparse-direct solve, the global Newton at its default
1e-12. One module fixture drives the truth (the port's primal, the data
of both packages) and builds cmad_tpu's stepped Hessian and the port's
bundles. Tolerances:

- the port's stepped and scan Hessians vs cmad_tpu's stepped Hessian:
  1e-8 of max|H| (measured about 6e-14: the same f64 arithmetic in
  another order; the JAX package holds its own scan and stepped Hessians
  together to 5e-4);
- ``J_dot`` (the tangent sweep's directional derivative) vs ``grad . v``:
  1e-10 relative; H symmetric to 1e-12 of max|H| before symmetrizing;
- the gradient that rides along the HVP vs ``build_fe_stepped_vg``'s:
  1e-12 relative (the reverse sweep re-solves each step where the
  gradient's goes through the stored solution), and J bit for bit;
- ``gradcheck``/``gradgradcheck`` of :class:`FeNewtonSolve` and of the
  differentiable linear solve: central differences at eps 1e-3 of Y ~
  230 (Newton at 1e-14) against the rules, on two weighted sums of the
  outputs.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.cli.fe_common import (
    build_fe_problem_from_deck,
    build_fe_stepped_hessian_fn,
    build_fe_stepped_vg,
    fe_params_overlay,
    nonlinear_settings,
)
from cmad_tpu_torch.cli.fe_subcommands import fe_hessian
from cmad_tpu_torch.fem.nonlinear_solver import (
    fe_newton_solve,
    fe_newton_solve_ad,
    linear_solver,
)
from cmad_tpu_torch.fem.sparse_solve import _csr_operator, linear_solve
from cmad_tpu_torch.fem.stepped_adjoint import build_fe_stepped_hvp
from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block
from cmad_tpu_torch.ops import segment_sum as segsum

from tests.fem.test_torch_fe_gradient import (
    _plastic_deck,
    _sensitivity_deck,
)

torch.set_num_threads(1)

F64 = torch.float64
RTOL_H = 1e-8


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    """The truth is the port's primal (data for both packages); the JAX
    stepped Hessian is the reference (about 50 s of one core, nearly all
    of it the compile of its tangent programs)."""
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf
    from cmad_tpu.cli.fe_common import build_fe_stepped_hessian_fn as jax_h
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    from cmad_tpu_torch.cli.fe_common import fe_primal_drive

    tmp = tmp_path_factory.mktemp("fe_hess")
    mesh = tmp / "cube.exo"
    ExodusWriter(mesh, StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    state, _ = fe_primal_drive(build_fe_problem_from_deck(
        _plastic_deck(mesh), dtype=F64, device="cpu"))
    data = tmp / "u_data.npy"
    np.save(data, np.stack(state.U_history).reshape(
        len(state.U_history), -1, 3))
    deck = _sensitivity_deck(mesh, data)
    path = tmp / "sens.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    jb = jax_bf(path, "hessian")
    p0, s0, ts, hess = jax_h(jb)
    H, _asym = hess(p0, s0, ts)
    port = build_fe_problem_from_deck(copy.deepcopy(deck), dtype=F64,
                                      device="cpu")
    return {"deck": deck, "jax_H": np.asarray(H), "port": port}


def _scan_bundle(case):
    deck = copy.deepcopy(case["deck"])
    deck["residuals"]["global residual"]["driver"] = "scan"
    return build_fe_problem_from_deck(deck, dtype=F64, device="cpu")


def test_stepped_hessian_matches_cmad_tpu(case):
    q0, r0, ts, hess = build_fe_stepped_hessian_fn(case["port"])
    stats: dict = {}
    J, g, H, max_asym = hess.with_gradient(q0, r0, ts, stats)
    ref = case["jax_H"]
    assert H.shape == ref.shape == (2, 2) and np.abs(ref).max() > 0.0
    assert np.abs(H - ref).max() <= RTOL_H * np.abs(ref).max()
    assert max_asym <= 1e-12 * np.abs(ref).max()
    np.testing.assert_array_equal(H, H.T)
    # the gradient riding along the HVP is the stepped gradient's (which
    # tests/fem/test_torch_fe_gradient.py holds to cmad_tpu's)
    _q, _r, _ts, vg = build_fe_stepped_vg(case["port"])
    J_vg, g_vg = vg(q0, r0, ts)
    assert J == J_vg
    np.testing.assert_allclose(g, g_vg, rtol=1e-12, atol=0)
    n_steps = len(ts) - 1
    assert [len(stats[k]) for k in ("forward", "tangent", "reverse")] \
        == [n_steps] * 3
    assert all(r["newton_iters"] >= 1 for r in stats["reverse"])


def test_scan_hessian_matches_cmad_tpu(case):
    H, max_asym = fe_hessian(_scan_bundle(case))
    ref = case["jax_H"]
    assert np.abs(H - ref).max() <= RTOL_H * np.abs(ref).max()
    assert max_asym <= 1e-12 * np.abs(ref).max()


def test_hvp_jdot_is_grad_dot_v(case):
    bundle = case["port"]
    fe = bundle.fe_problem
    q0, r0, ts, _vg = build_fe_stepped_vg(bundle)
    hvp = build_fe_stepped_hvp(
        fe, fe_params_overlay(fe)[1], bundle.qoi,
        nonlinear_solver_settings=nonlinear_settings(bundle),
        linear_solver_settings=bundle.resolved["linear solver"])
    V = np.array([[0.3, 1.0], [-0.7, 0.0]])     # two directions at once
    (J, g, HV), J_dot = hvp._with_jdot(q0, r0, ts, V)
    assert HV.shape == (2, 2) and J_dot.shape == (2,)
    np.testing.assert_allclose(J_dot, g @ V, rtol=1e-10, atol=0)
    ref = case["jax_H"]
    assert np.abs(HV - ref @ V).max() <= RTOL_H * np.abs(ref).max()
    _J, _g, hv = hvp(q0, r0, ts, V[:, 0])       # one direction
    assert hv.shape == (2,)
    np.testing.assert_allclose(hv, HV[:, 0], rtol=1e-12, atol=0)


def _first_step(case):
    fe = case["port"].fe_problem
    q0, (U0, xi0), ts, _vg = build_fe_stepped_vg(case["port"])
    _p, overlay = fe_params_overlay(fe)
    xi0 = pack_xi_by_block(fe, xi0, layout="aos")
    nls = {"max iters": 30, "abs tol": 1e-14, "rel tol": 1e-14}
    rng = np.random.default_rng(5)
    w_U = torch.as_tensor(rng.normal(size=U0.shape[0]))
    w_xi = torch.as_tensor(rng.normal(size=(7, xi0["all"].shape[1])))
    return fe, q0, U0, xi0, overlay, nls, float(ts[2]), w_U, w_xi


def test_fe_newton_solve_gradgradcheck_in_the_parameters(case):
    """``FeNewtonSolve``'s backward is differentiable: two weighted sums
    of the step's (U*, xi*) (from rest to t = 2/3, plastic) are smooth in
    the canonical [Y, S]; gradcheck and gradgradcheck differentiate them
    by central differences, the Newton re-solved at each point."""
    fe, q0, U0, xi0, overlay, nls, t, w_U, w_xi = _first_step(case)

    def step(p):
        U, xi = fe_newton_solve_ad(fe, overlay(p), U0, xi0, t, nls)
        return (w_U * U).sum(), (w_xi * xi["all"][:7]).sum()

    p = q0.clone().requires_grad_(True)
    assert torch.autograd.gradcheck(step, (p,), eps=1e-3, atol=1e-9,
                                    rtol=1e-4)
    assert torch.autograd.gradgradcheck(step, (p,), eps=1e-3, atol=1e-9,
                                        rtol=1e-3)


def test_linear_solve_gradgradcheck(case):
    """The differentiable solve ``x = K^-1 b`` on the FE pattern (the
    cube's tangent at a plastic state, the direct arm): gradcheck and
    gradgradcheck along a line in its data and its right-hand side."""
    fe, q0, U0, xi0, overlay, nls, t, w_U, _w = _first_step(case)
    from cmad_tpu_torch.fem.assembly import assemble_global
    from cmad_tpu_torch.fem.sparse_solve import _embedded_bc_enforce

    U1, _ = fe_newton_solve(fe, overlay(q0), U0, xi0, t, nls)
    K, _R, _xi = assemble_global(fe, fe.kernel_arrays, overlay(q0), U1,
                                 U0, t, xi_prev_by_block=xi0)
    K_data, _ = _embedded_bc_enforce(K, fe.kernel_arrays.prescribed_indices)
    sp = fe.embedded_sparsity
    unique0 = _csr_operator(K_data, sp)[0]
    rng = np.random.default_rng(8)
    dK = torch.as_tensor(rng.normal(size=unique0.shape)) * unique0.abs()
    dK = 0.5 * (dK + dK[sp.transpose])          # keep K symmetric
    b0 = torch.as_tensor(rng.normal(size=U0.shape[0]))
    db = torch.as_tensor(rng.normal(size=U0.shape[0]))
    solve = linear_solver(fe, fe.kernel_arrays, {"type": "direct"})

    def f(s, r):
        x = linear_solve(unique0 + 0.05 * s * dK, b0 + r * db, sp, solve)
        return (w_U * x).sum()

    args = (torch.zeros((), dtype=F64, requires_grad=True),
            torch.zeros((), dtype=F64, requires_grad=True))
    assert torch.autograd.gradcheck(f, args, eps=1e-4, atol=1e-8,
                                    rtol=1e-5)
    assert torch.autograd.gradgradcheck(f, args, eps=1e-4, atol=1e-8,
                                        rtol=1e-4)


def test_segment_sums_double_backward_through_invisible_kernels(
        monkeypatch):
    """On the card the sums are ctypes kernels that autograd cannot see;
    here ``_segment_sum_raw`` runs under ``torch.no_grad()`` to act the
    same. The double backward of the sum and of the gather must still be
    complete: each backward calls the other's differentiable entry."""
    raw = segsum._segment_sum_raw

    def invisible(vals, plan, scale):
        with torch.no_grad():
            return raw(vals, plan, scale)

    monkeypatch.setattr(segsum, "_segment_sum_raw", invisible)
    rng = np.random.default_rng(3)
    target = rng.integers(0, 5, size=17)
    plan = segsum.plan_from_target(target, 5, "cpu")
    vals = torch.tensor(rng.normal(size=(17, 2)), requires_grad=True)
    x = torch.tensor(rng.normal(size=(5, 2)), requires_grad=True)

    def summed(v):
        out = segsum.segment_sum(v, plan)
        return out * out

    def gathered(y):
        out = segsum.segment_gather(y, plan)
        return out * out

    assert torch.autograd.gradcheck(summed, (vals,))
    assert torch.autograd.gradgradcheck(summed, (vals,))
    assert torch.autograd.gradcheck(gathered, (x,))
    assert torch.autograd.gradgradcheck(gathered, (x,))
