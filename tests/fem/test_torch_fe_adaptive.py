"""cmad_tpu_torch's stepped FE drive against cmad_tpu's with the linear
solver of the notch's at-scale records
(``benchmarks/notch_hosford/calibrate_scale.py:103-106``): CG with the
two-level preconditioner, rtol 1e-6, at most 2000 iterations, and the
Eisenstat-Walker forcing term (``adaptive rtol``). The 480-tet notch with
J2 (the deck's total form), two steps, on the CPU in float64.

The forcing term loosens the inner solves while the Newton is far from
its answer; it does not change the answer, which is fixed by the Newton's
own tolerance. Both drives stop at a global tolerance of 1e-12, so the
trajectories agree as far as the sparse-direct drives do
(``test_torch_fe_drive.py``): 1e-10 of the largest entry.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from cmad_tpu.cli.fe_subcommands import _nls_settings
from cmad_tpu.fem.driver import (
    fe_quasistatic_drive_stepped as jax_drive_stepped,
)
from cmad_tpu_torch.cli.fe_common import fe_primal_drive
from cmad_tpu_torch.fem import nonlinear_solver

from tests.support.torch_fe import jax_bundle, notch_deck, port_bundle

torch.set_num_threads(1)

TOL = 1e-12
RTOL = 1e-10
RECORDS = {"type": "cg", "rtol": 1.0e-6, "max iters": 2000,
           "adaptive rtol": True, "preconditioner": {"type": "two_level"}}


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    deck = notch_deck(num_steps=2, global_tol=TOL, max_iters=30,
                      linear_solver=RECORDS)
    bj = jax_bundle(deck, tmp_path_factory.mktemp("adaptive"))
    ref = jax_drive_stepped(
        bj.fe_problem, bj.t_schedule.tolist(),
        nonlinear_solver_settings=_nls_settings(bj),
        linear_solver_settings=bj.resolved["linear solver"])
    # the inner tolerance of every linear solve the port's Newton asks for
    forced: list = []
    solve = nonlinear_solver.solve_linear

    def recording(*args, rtol_override=None, **kw):
        forced.append(rtol_override)
        return solve(*args, rtol_override=rtol_override, **kw)

    stats: list = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(nonlinear_solver, "solve_linear", recording)
        got = fe_primal_drive(port_bundle(deck), stats)
    return ref, got, stats, forced


def test_adaptive_cg_drive_matches_cmad_tpu(drives):
    (state_j, log_j), (state, log), _stats, _forced = drives
    assert state.t_history == state_j.t_history == [0.0, 1.0, 2.0]
    for k in range(3):
        U, U_j = state.U_at(k), state_j.U_at(k)
        assert np.abs(U - U_j).max() <= RTOL * max(np.abs(U_j).max(), 1.0)
        xi, xi_j = state.xi_at(k, "block_1"), state_j.xi_at(k, "block_1")
        assert xi.shape == xi_j.shape == (480, 1, 7)
        for c in range(7):
            scale = max(np.abs(xi_j[..., c]).max(), 1e-300)
            assert np.abs(xi[..., c] - xi_j[..., c]).max() <= RTOL * scale
    assert state.xi_at(2, "block_1")[..., 6].max() > 0.05   # it yields
    for e, e_j in zip(log, log_j, strict=True):
        assert e["final_residual"] <= TOL * e["initial_residual"]
        assert e_j["final_residual"] <= TOL * e_j["initial_residual"]


def test_adaptive_rtol_follows_the_forcing_term(drives):
    _ref, _got, stats, forced = drives
    n_solves = [len(s["cg_iters"]) for s in stats]
    assert n_solves == [s["newton_iters"] for s in stats]
    assert len(forced) == sum(n_solves)
    start = 0
    for n in n_solves:
        step = forced[start:start + n]
        start += n
        # the first solve of a step: 0.9 (||r|| / (10 ||r||))^2 = 0.009
        assert step[0] == pytest.approx(0.009, rel=1e-12)
        assert all(RECORDS["rtol"] <= f <= 1e-2 for f in step)
        # the endgame tightens to the floor
        assert step[-1] == RECORDS["rtol"]
    assert all(0 < k < RECORDS["max iters"]
               for s in stats for k in s["cg_iters"])
