"""cmad_tpu_torch's FE assembly and linear solvers against cmad_tpu's on
the 480-tet notch with J2, on the CPU in float64: the global residual,
tangent and per-IP state of the J2 block in both forms and both state
layouts, the embedded-BC pair, CG's product (in the card's row order, bit
for bit), the two-level preconditioner's apply, and the CG arms against
the sparse-direct solve.

Assembly agrees to 1e-12 of each output's scale: the two packages sum the
element contributions in different orders. The strains are random and
the state comes from a first return, so no point sits on its yield
surface to rounding (where either branch is right, and the two packages
may take different ones).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cmad_tpu.fem.assembly import (
    assemble_global as jax_assemble,
    assemble_global_residual as jax_assemble_residual,
    params_by_block_from_models as jax_params,
)
from cmad_tpu.fem.nonlinear_solver import (
    get_two_level_pattern as jax_two_level_pattern,
)
from cmad_tpu.fem.sparse_solve import (
    _bcsr_operator,
    _embedded_bc_enforce as jax_enforce,
    _embedded_residual as jax_embedded_residual,
    coo_rows_from_indptr,
    jax_cg_two_level as jax_cg_two_level_ref,
)
from cmad_tpu.fem.two_level import (
    make_two_level_preconditioner as jax_make_two_level,
)
from cmad_tpu_torch.fem.assembly import (
    assemble_global,
    assemble_global_residual,
    params_by_block_from_models,
)
from cmad_tpu_torch.fem.nonlinear_solver import (
    get_two_level_pattern,
    solve_linear,
)
from cmad_tpu_torch.fem.sparse_solve import (
    _csr_operator,
    _embedded_bc_enforce,
    _embedded_residual,
    jax_cg_two_level,
    scipy_lu,
)
from cmad_tpu_torch.fem.two_level import make_two_level_preconditioner
from cmad_tpu_torch.fem.xi_carrier import pack_xi, unpack_xi

from tests.support.torch_fe import jax_bundle, notch_deck, port_bundle

torch.set_num_threads(1)

RTOL = 1e-12
T = 2.0


def _close(got, ref, rtol=RTOL, what=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    ref = np.asarray(ref)
    assert got.shape == ref.shape, what
    err = float(np.abs(got - ref).max())
    assert err <= rtol * float(np.abs(ref).max()), (what, err)


@pytest.fixture(scope="module", params=["total", "rate"])
def case(request, tmp_path_factory):
    """Both packages' problems of one J2 form, a random pair (U_prev, U)
    and a plastic state xi_prev from a first return at U_prev."""
    deck = notch_deck(form=request.param)
    bj = jax_bundle(deck, tmp_path_factory.mktemp(request.param))
    bt = port_bundle(deck)
    fj, ft = bj.fe_problem, bt.fe_problem
    n = ft.dof_map.num_total_dofs
    rng = np.random.default_rng(7)
    U_prev = 1e-4 * rng.standard_normal(n)
    U = U_prev + 1e-4 * rng.standard_normal(n)
    xi0 = np.zeros((480, 1, 7))
    params = jax_params(fj)

    @jax.jit
    def jax_step(U, U_prev, xi_prev):
        return jax_assemble(fj, fj.kernel_arrays, params, U, U_prev, T,
                            {"block_1": xi_prev})

    _, _, xi1 = jax_step(jnp.asarray(U_prev), jnp.zeros(n),
                         jnp.asarray(xi0))
    xi_prev = np.asarray(xi1["block_1"])
    ref = jax_step(jnp.asarray(U), jnp.asarray(U_prev),
                   jnp.asarray(xi_prev))
    return {"form": request.param, "fj": fj, "ft": ft, "U": U,
            "U_prev": U_prev, "xi_prev": xi_prev, "ref": ref,
            "params": params}


def _port_assemble(c, xi_prev):
    ft = c["ft"]
    return assemble_global(ft, ft.kernel_arrays,
                           params_by_block_from_models(ft),
                           torch.as_tensor(c["U"]),
                           torch.as_tensor(c["U_prev"]), T,
                           {"block_1": xi_prev})


def test_assemble_global_matches(case):
    K_j, R_j, xi_j = case["ref"]
    plastic = np.asarray(xi_j["block_1"])[..., 6] > case["xi_prev"][..., 6]
    assert 0 < plastic.sum() < plastic.size   # a mixed state
    K, R, xi = _port_assemble(case, torch.as_tensor(case["xi_prev"]))
    _close(R, R_j, what="R")
    _close(K.data, K_j.data, what="K")
    np.testing.assert_array_equal(K.rows.numpy(),
                                  np.asarray(K_j.indices[:, 0]))
    np.testing.assert_array_equal(K.cols.numpy(),
                                  np.asarray(K_j.indices[:, 1]))
    xi_ref = np.asarray(xi_j["block_1"])
    assert tuple(xi["block_1"].shape) == xi_ref.shape == (480, 1, 7)
    for c in range(7):
        _close(xi["block_1"][..., c], xi_ref[..., c], what=f"xi[{c}]")
    # the tangent is symmetric, and the residual-only assembly agrees
    dense = torch.zeros((K.n, K.n), dtype=K.data.dtype)
    dense[K.rows, K.cols] = K.data
    _close(dense.T, dense.numpy(), rtol=1e-13, what="K symmetry")
    ft = case["ft"]
    R_only = assemble_global_residual(
        ft, ft.kernel_arrays, params_by_block_from_models(ft),
        torch.as_tensor(case["U"]), torch.as_tensor(case["U_prev"]), T,
        {"block_1": torch.as_tensor(case["xi_prev"])})
    assert torch.equal(R_only, R)
    fj = case["fj"]
    _close(R_only, jax_assemble_residual(
        fj, fj.kernel_arrays, case["params"], jnp.asarray(case["U"]),
        jnp.asarray(case["U_prev"]), T,
        {"block_1": jnp.asarray(case["xi_prev"])}), what="R only")


def test_carrier_layout_matches_aos(case):
    """The drives keep the state component-major (8, E*Q); the block
    returns the layout it was given, with the same values."""
    xi_aos = torch.as_tensor(case["xi_prev"])
    K_a, R_a, xi_a = _port_assemble(case, xi_aos)
    K_c, R_c, xi_c = _port_assemble(case, pack_xi(xi_aos, 7))
    assert tuple(xi_c["block_1"].shape) == (8, 480)
    assert torch.equal(R_c, R_a) and torch.equal(K_c.data, K_a.data)
    assert torch.equal(unpack_xi(xi_c["block_1"], 480, 1), xi_a["block_1"])
    assert bool((xi_c["block_1"][7] == 0).all())


def _enforced(case):
    """Both packages' embedded-BC (r, K_data) at the case's U."""
    K_j, R_j, _ = case["ref"]
    fj, ft = case["fj"], case["ft"]
    pv = ft.dof_map.evaluate_prescribed_values(ft.kernel_arrays.dbc_arrays,
                                               T)
    pj = fj.kernel_arrays.prescribed_indices
    Kd_j, Kii_j = jax_enforce(K_j, pj)
    r_j = jax_embedded_residual(R_j, K_j, jnp.asarray(case["U"]), pj,
                                jnp.asarray(pv), Kii_j)
    K, R, _ = _port_assemble(case, torch.as_tensor(case["xi_prev"]))
    pt = ft.kernel_arrays.prescribed_indices
    Kd, Kii = _embedded_bc_enforce(K, pt)
    r = _embedded_residual(R, K, torch.as_tensor(case["U"]), pt,
                           torch.as_tensor(pv), Kii)
    return (r_j, Kd_j), (r, Kd)


def test_embedded_bc_pair_matches(case):
    (r_j, Kd_j), (r, Kd) = _enforced(case)
    _close(Kd, Kd_j, what="K_data")
    _close(r, r_j, what="r")
    sp = case["ft"].embedded_sparsity
    unique, matvec = _csr_operator(Kd, sp)
    _close(unique, _bcsr_operator(Kd_j, case["fj"].kernel_arrays
                                  .embedded_sparsity)[0], what="unique")
    x = np.random.default_rng(2).standard_normal(sp.n)
    dense = np.zeros((sp.n, sp.n))
    dense[sp.rows.numpy(), sp.col_indices.numpy()] = unique.numpy()
    _close(matvec(torch.as_tensor(x)), dense @ x, rtol=1e-14, what="matvec")


def test_two_level_apply_matches(case):
    (_, Kd_j), (_, Kd) = _enforced(case)
    fj, ft = case["fj"], case["ft"]
    sj, st = fj.kernel_arrays.embedded_sparsity, ft.embedded_sparsity
    pat_j, pat = jax_two_level_pattern(fj), get_two_level_pattern(ft)
    np.testing.assert_array_equal(pat.agg_of_dof, pat_j.agg_of_dof)
    np.testing.assert_array_equal(pat.coarse_order, pat_j.coarse_order)
    np.testing.assert_allclose(pat.P_vals, pat_j.P_vals, rtol=0, atol=1e-15)
    unique_j = _bcsr_operator(Kd_j, sj)[0]
    M_j = jax_make_two_level(pat_j, unique_j, coo_rows_from_indptr(sj),
                             sj.col_indices, unique_j[sj.diag_idx])
    unique = _csr_operator(Kd, st)[0]
    M = make_two_level_preconditioner(pat, unique, st.rows, st.col_indices,
                                      unique[st.diag_idx])
    rng = np.random.default_rng(11)
    for _ in range(2):
        v = rng.standard_normal(st.n)
        _close(M(torch.as_tensor(v)), M_j(jnp.asarray(v)), what="M v")


@pytest.mark.parametrize("precon", ["two_level", "jacobi"])
def test_cg_matches_direct(case, precon):
    """CG at rtol 1e-10 reaches that true relative residual, and its
    answer agrees with the sparse-direct solve's to the conditioning of
    K; two-level CG also agrees with cmad_tpu's at the same rtol."""
    (r_j, Kd_j), (r, Kd) = _enforced(case)
    ft = case["ft"]
    sp = ft.embedded_sparsity
    rtol = 1e-10
    x_lu = scipy_lu(Kd, sp, -r)
    stats: dict = {}
    x = solve_linear(Kd, ft, ft.kernel_arrays, -r,
                     {"type": "cg", "rtol": rtol, "max iters": None,
                      "preconditioner": {"type": precon}}, stats=stats)
    _, matvec = _csr_operator(Kd, sp)
    rel = float(torch.linalg.norm(-r - matvec(x)) / torch.linalg.norm(r))
    assert rel <= rtol
    assert len(stats["cg_iters"]) == 1 and 0 < stats["cg_iters"][0] < 4950
    assert float(torch.linalg.norm(matvec(x_lu) + r)
                 / torch.linalg.norm(r)) <= 1e-13
    _close(x, x_lu.numpy(), rtol=1e-6, what="x vs direct")
    if precon == "two_level":
        fj = case["fj"]
        x_j = jax_cg_two_level_ref(
            Kd_j, fj.kernel_arrays.embedded_sparsity, -r_j,
            jax_two_level_pattern(fj), rtol=rtol)
        _close(x, x_j, rtol=1e-8, what="x vs cmad_tpu")
        # fewer iterations than jacobi needs on the same system
        assert stats["cg_iters"][0] < 200


def test_two_level_cg_budget_is_split_over_cycles(case):
    """With ``max iters`` m, each of the up to 4 residual-replacement
    cycles gets m // 4 iterations: a budget too small to converge spends
    exactly 4 * (m // 4)."""
    (_, _), (r, Kd) = _enforced(case)
    ft = case["ft"]
    stats: dict = {}
    jax_cg_two_level(Kd, ft.embedded_sparsity, -r, get_two_level_pattern(ft),
                     rtol=1e-14, max_iters=10, stats=stats)
    assert stats["cg_iters"] == [8]


def test_cg_product_is_the_row_order_sum(case):
    """CG's product on the embedded K, as the CPU runs it
    (``csr_matvec_plain`` over the pattern's ``CsrPlan``), equals a numpy
    loop over each row in ascending column position bit for bit, the order
    of the card's tile kernel; its row tiles cover every row once; and it
    agrees with cmad_tpu's product (the node-block contraction of 3 x 3
    blocks, another summation order) to 1e-14 of max |y|."""
    (_, Kd_j), (_, Kd) = _enforced(case)
    sp = case["ft"].embedded_sparsity
    tiles = sp.csr.rows.tiles.numpy().astype(np.int64)
    assert tiles[0].tolist() == [0, 0] and tiles[-1, 0] == sp.n
    assert np.all(np.diff(tiles[:, 0]) > 0)
    assert np.array_equal(tiles[:, 1], sp.indptr_np[tiles[:, 0]])
    assert np.array_equal(sp.csr.cols.numpy(), sp.col_indices_np)
    unique, matvec = _csr_operator(Kd, sp)
    x = np.random.default_rng(13).standard_normal(sp.n)
    y = matvec(torch.as_tensor(x)).numpy()
    u = unique.numpy()
    loop = np.zeros(sp.n)
    for r in range(sp.n):
        acc = np.float64(0.0)
        for j in range(sp.indptr_np[r], sp.indptr_np[r + 1]):
            acc = acc + u[j] * x[sp.col_indices_np[j]]
        loop[r] = acc
    assert np.array_equal(y, loop)
    sj = case["fj"].kernel_arrays.embedded_sparsity
    y_j = np.asarray(_bcsr_operator(Kd_j, sj)[1](jnp.asarray(x)))
    _close(y, y_j, rtol=1e-14, what="K x vs cmad_tpu")
