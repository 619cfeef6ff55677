"""cmad_tpu_torch's stepped FE drive against cmad_tpu's: the 480-tet notch
with J2 (the deck's total form), two steps, the sparse-direct solve, on
the CPU in float64; and the port's drive contracts (the iteration-cap
warning, the counts it reports, the arms that are not ported).

Both drives run with the global Newton tolerances at 1e-12, so that each
step converges far below the 1e-10 the trajectories are compared at: with
the deck's 1e-8, two converged Newton paths may differ by ~1e-7 in U.

The paths can differ. A point that yielded in the previous step sits on
its yield surface to rounding at the start of the next, so its first
tangent takes the elastic or the plastic branch by the last bit of the
trial stress, in each package by its own order of operations. That moves
the step's first embedded residual (through the tangent's coupling to the
prescribed dofs) and the Newton path, not the converged answer.
"""
from __future__ import annotations

import logging
import warnings

import numpy as np
import pytest
import torch

from cmad_tpu.cli.fe_subcommands import _nls_settings
from cmad_tpu.fem.driver import (
    fe_quasistatic_drive_stepped as jax_drive_stepped,
)
from cmad_tpu_torch.cli.fe_common import nonlinear_settings, fe_primal_drive
from cmad_tpu_torch.fem.driver import fe_quasistatic_drive_stepped
from cmad_tpu_torch.fem.nonlinear_solver import solve_linear

from tests.support.torch_fe import jax_bundle, notch_deck, port_bundle

torch.set_num_threads(1)

TOL = 1e-12
RTOL = 1e-10
CG_TWO_LEVEL = {"type": "cg", "rtol": 1e-10,
                "preconditioner": {"type": "two_level"}}


@pytest.fixture(scope="module")
def drives(tmp_path_factory):
    deck = notch_deck(num_steps=2, global_tol=TOL, max_iters=30)
    bj = jax_bundle(deck, tmp_path_factory.mktemp("drive"))
    ref = jax_drive_stepped(
        bj.fe_problem, bj.t_schedule.tolist(),
        nonlinear_solver_settings=_nls_settings(bj),
        linear_solver_settings=bj.resolved["linear solver"])
    bt = port_bundle(deck)
    stats: list = []
    got = fe_primal_drive(bt, stats)
    return bt, ref, got, stats


def test_stepped_drive_matches_cmad_tpu(drives):
    _bt, (state_j, log_j), (state, log), _stats = drives
    assert len(state.U_history) == len(state_j.U_history) == 3
    assert state.t_history == state_j.t_history == [0.0, 1.0, 2.0]
    for k in range(3):
        U, U_j = state.U_at(k), state_j.U_at(k)
        assert U.shape == U_j.shape == (495,)
        assert np.abs(U - U_j).max() <= RTOL * max(np.abs(U_j).max(), 1.0)
        xi, xi_j = state.xi_at(k, "block_1"), state_j.xi_at(k, "block_1")
        assert xi.shape == xi_j.shape == (480, 1, 7)
        for c in range(7):
            scale = max(np.abs(xi_j[..., c]).max(), 1e-300)
            assert np.abs(xi[..., c] - xi_j[..., c]).max() <= RTOL * scale
    assert state.xi_at(2, "block_1")[..., 6].max() > 0.05   # it yields
    for k, (e, e_j) in enumerate(zip(log, log_j, strict=True), start=1):
        assert set(e) == set(e_j) == {"final_residual", "initial_residual"}
        scale = e_j["initial_residual"]
        assert e["final_residual"] <= TOL * scale
        assert abs(e["final_residual"] - e_j["final_residual"]) \
            <= RTOL * scale
        # step 1 starts from rest: one branch; later steps start on the
        # yield surface (module docstring)
        rtol = RTOL if k == 1 else 1e-2
        assert abs(e["initial_residual"] - scale) <= rtol * scale


def test_drive_reports_its_counts(drives):
    bt, _ref, (state, log), stats = drives
    assert len(stats) == 2
    for s in stats:
        # one assembly per Newton start, one per line-search probe (at
        # least one per iteration), two for the step's residual pair
        assert s["newton_iters"] >= 2
        assert s["assemblies"] >= s["newton_iters"] + 3
        assert "cg_iters" not in s          # the direct solve
    # the recorded pair is the drive's own residual at the state it kept
    again = fe_quasistatic_drive_stepped(
        bt.fe_problem, [1.0, 2.0], nonlinear_settings(bt),
        bt.resolved["linear solver"], U_init=state.U_at(1),
        xi_init_by_block={"block_1": state.xi_at(1, "block_1")})
    np.testing.assert_allclose(again[1][0]["initial_residual"],
                               log[1]["initial_residual"], rtol=1e-13)
    np.testing.assert_allclose(again[0].U_at(1), state.U_at(2), rtol=0,
                               atol=1e-13)


def test_two_level_cg_drive_matches_direct(drives):
    bt, _ref, (state, _log), _stats = drives
    deck = notch_deck(num_steps=2, global_tol=TOL, max_iters=30,
                      linear_solver=CG_TWO_LEVEL)
    stats: list = []
    cg_state, cg_log = fe_primal_drive(port_bundle(deck), stats)
    scale = np.abs(state.U_at(2)).max()
    assert np.abs(cg_state.U_at(2) - state.U_at(2)).max() <= 1e-9 * scale
    for s, e in zip(stats, cg_log, strict=True):
        assert e["final_residual"] <= TOL * e["initial_residual"]
        assert len(s["cg_iters"]) == s["newton_iters"]
        assert all(0 < n < 300 for n in s["cg_iters"])


def test_iteration_cap_warns():
    bt = port_bundle(notch_deck(num_steps=1, max_iters=1))
    with pytest.warns(RuntimeWarning, match="iteration-cap"):
        _state, log = fe_primal_drive(bt)
    assert log[0]["final_residual"] > 1e-6


def test_arms_not_ported_raise(caplog):
    deck = notch_deck(num_steps=1)
    deck["residuals"]["global residual"]["driver"] = "host"
    with pytest.raises(NotImplementedError, match="item 18"):
        fe_primal_drive(port_bundle(deck))
    bt = port_bundle(notch_deck(num_steps=1))
    fe = bt.fe_problem
    K = torch.ones(fe.embedded_sparsity.perm.shape[0], dtype=torch.float64)
    b = torch.ones(fe.dof_map.num_total_dofs, dtype=torch.float64)
    for settings, item in (({"type": "gmres", "rtol": 1e-8}, "item 22"),
                           ({"type": "cg", "rtol": 1e-8,
                             "preconditioner": {"type": "chebyshev"}},
                            "item 13"),
                           ({"type": "cg", "solve dtype": "mixed"},
                            "item 13")):
        with pytest.raises(NotImplementedError, match=item):
            solve_linear(K, fe, fe.kernel_arrays, b, settings)
    # the tunnel-only dispatch knobs are accepted, logged and do nothing
    with warnings.catch_warnings(), caplog.at_level(
            logging.INFO, logger="cmad_tpu_torch.fem.driver"):
        warnings.simplefilter("error")
        a = fe_quasistatic_drive_stepped(fe, [0.0, 0.5],
                                         nonlinear_settings(bt),
                                         max_iters_per_dispatch=1,
                                         steps_per_dispatch=2)
    logged = caplog.text
    assert "max_iters_per_dispatch=1 ignored" in logged
    assert "steps_per_dispatch=2 ignored" in logged
    b_ = fe_quasistatic_drive_stepped(fe, [0.0, 0.5], nonlinear_settings(bt))
    np.testing.assert_array_equal(a[0].U_at(1), b_[0].U_at(1))
