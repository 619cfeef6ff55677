"""The reproducible sums of cmad_tpu_torch (``ops/segment_sum.py``): the
segment sum over a fixed plan, the coarse-pair contraction and the CSR
product, on the CPU.

The CUDA kernels ``segment_sum_tile`` and ``segment_sum_block`` add each
segment's entries in ascending position of its plan, from 0. Here that
order, written in plain PyTorch (``segment_sum_in_plan_order``), is held
bit for bit to ``index_add_`` on the CPU (the plain version, and the JAX
package's scatter-add order on the CPU) on every plan of the FE path: the
residual scatter, the COO dedup and rows of assembly, the embedded-BC CSR
dedup, and the two-level restriction and coarse pairs, on the 8-hex cube
and the 480-tet notch. The plans' longest-first schedules and the rule that
picks a kernel from the plan are pinned, and the coarse-pair contraction's
plain version is held to the kernel's order (each entry's products, then
the adds in plan order) bit for bit and to ``cmad_tpu``'s
``coarse_matrix``. The tile path's plans (tiles of consecutive segments)
cover every segment once, in order, and a numpy emulation of the tile
kernel (tile by tile, chunk by chunk: the staged products, then each
output's ascending chain) equals ``index_add_`` bit for bit, for plans and
for the CSR product; ``csr_matvec_plain`` equals an ascending loop bit for
bit and ``cmad_tpu``'s BCSR operator on the cube's embedded K. On the card
``chip_smoke.py`` holds the kernels to ``index_add_``,
``csr_matvec_plain`` and ``coarse_matrix`` on the CPU bit for bit.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from cmad_tpu.fem import two_level as jax_two_level
from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
from cmad_tpu_torch.fem.nonlinear_solver import get_two_level_pattern
from cmad_tpu_torch.fem.two_level import coarse_matrix
from cmad_tpu_torch.ops import segment_sum as ss
from tests.support.torch_fe import notch_deck

torch.set_num_threads(1)

F64 = torch.float64
PLANS = ("residual scatter", "coo dedup", "coo rows", "csr dedup",
         "restriction", "coarse pairs")
# the kernel each plan of the 480-tet notch takes: the scatter and the
# dedups have at most 24 entries per segment; the COO rows 45 (15,525 in
# all, 345 times that), the restriction 99 and the coarse pairs 1,627
NOTCH_PATHS = {"residual scatter": "tile", "coo dedup": "tile",
               "coo rows": "block", "csr dedup": "tile",
               "restriction": "block", "coarse pairs": "block"}
# port vs cmad_tpu's coarse_matrix on the same pattern and values (CPU,
# f64): the same products, summed in the same order, gave 0 on both meshes
# (measured); the bound allows the last bit of a different summation order
# in XLA's segment sum, relative to max |A_c|
COARSE_JAX_RTOL = 1e-14


def _cube_deck(tmp_path):
    from cmad_tpu.fem.mesh import StructuredHexMesh
    from cmad_tpu.io.exodus import ExodusWriter

    path = tmp_path / "cube.exo"
    ExodusWriter(path, StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2))).close()
    deck = notch_deck(num_steps=1)
    deck["discretization"]["mesh file"] = str(path)
    deck["discretization"].pop("build coordinate sidesets", None)
    deck["residuals"]["local residual"]["materials"] = {
        "all": deck["residuals"]["local residual"]["materials"]["block_1"]}
    deck["dirichlet bcs"] = {"expression": {
        "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
        "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
        "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"],
        "ramp_x": ["equilibrium", 0, "xmax_sides", "0.004 * t"]}}
    return deck


@pytest.fixture(scope="module")
def problems(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("segsum")
    out = {}
    for name, deck in (("cube", _cube_deck(tmp)), ("notch", notch_deck())):
        fe = build_fe_problem_from_deck(copy.deepcopy(deck), dtype=F64,
                                        device="cpu").fe_problem
        ka = fe.kernel_arrays
        t = get_two_level_pattern(fe).on(torch.device("cpu"), F64)
        block = next(iter(fe.evaluators_by_block))
        out[name] = {"residual scatter": (ka.eq_plan_by_block[block][0], ()),
                     "coo dedup": (ka.coo_dedup_plan, ()),
                     "coo rows": (ka.coo_row_plan, ()),
                     "csr dedup": (fe.embedded_sparsity.dedup_plan, ()),
                     "restriction": (t["agg_plan"], (6,)),
                     "coarse pairs": (t["pair_plan"], (6, 6)),
                     "fe": fe}
    return out


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("mesh", ("cube", "notch"))
def test_plan_order_equals_index_add_bit_for_bit(problems, mesh, plan_name):
    plan, width = problems[mesh][plan_name]
    rng = np.random.default_rng(7)
    vals = torch.as_tensor(rng.normal(size=(plan.n_entries, *width)))
    scale = (torch.as_tensor(rng.normal(size=plan.n_entries))
             if plan_name == "restriction" else None)
    plain = ss.segment_sum(vals, plan, scale)
    ordered = ss.segment_sum_in_plan_order(vals, plan, scale)
    assert plain.shape == (plan.n_segments, *width)
    assert torch.equal(ordered, plain)
    # and the plain version is index_add_ over each entry's target
    if plan.target is not None:
        src = vals if scale is None else vals * scale.reshape(
            -1, *([1] * len(width)))
        ref = torch.zeros_like(plain).index_add_(0, plan.target, src)
        assert torch.equal(plain, ref)
    assert ss.launch_counts() == {"segment_sum_tile": 0,
                                  "segment_sum_block": 0,
                                  "coarse_pair_sum": 0, "csr_matvec": 0}
    assert ss.plan_launches == {}


@pytest.mark.parametrize("plan_name", PLANS)
@pytest.mark.parametrize("mesh", ("cube", "notch"))
def test_plan_schedule_is_longest_first_and_stable(problems, mesh,
                                                   plan_name):
    plan, _ = problems[mesh][plan_name]
    lengths = (plan.offsets[1:] - plan.offsets[:-1]).numpy()
    sched = plan.schedule.numpy()
    assert plan.max_length == int(lengths.max())
    assert sched.dtype == np.int32 and sched.shape == (plan.n_segments,)
    assert np.array_equal(np.sort(sched), np.arange(plan.n_segments))
    ordered = lengths[sched]
    assert np.all(np.diff(ordered) <= 0)
    # equal lengths keep ascending segment id
    ties = np.diff(ordered) == 0
    assert np.all(np.diff(sched)[ties] > 0)


def test_plan_fields_on_synthetic_plans():
    plan = ss.plan_from_offsets([0, 2, 2, 7, 9, 14], "cpu")
    assert plan.max_length == 5
    assert plan.schedule.tolist() == [2, 4, 0, 3, 1]
    empty = ss.plan_from_sorted(None, [], 3, 0, "cpu")
    assert empty.max_length == 0 and empty.schedule.tolist() == [0, 1, 2]


def test_segment_path_rule(problems):
    long_ = ss.LONG_SEGMENT
    short = ss.plan_from_offsets([0, long_ - 1, 2 * long_ - 2], "cpu")
    long_plan = ss.plan_from_offsets([0, 1, long_ + 1], "cpu")
    # short segments take the tile path at every width
    assert ss.segment_path(short, 6) == "tile"
    assert ss.segment_path(short, 1) == "tile"
    assert ss.segment_path(long_plan, 6) == "block"
    assert ss.segment_path(long_plan, 1) == "block"
    assert ss.segment_path(long_plan, ss.BLOCK_MAX_WIDTH) == "block"
    assert ss.segment_path(long_plan, ss.BLOCK_MAX_WIDTH + 1) == "tile"
    # many long segments: the spread past BLOCK_MAX_SPREAD longest ones
    n_seg = ss.BLOCK_MAX_SPREAD
    full = ss.plan_from_offsets(np.arange(n_seg + 1) * long_, "cpu")
    over = ss.plan_from_offsets(np.arange(n_seg + 2) * long_, "cpu")
    assert ss.segment_path(full, 6) == "block"
    assert ss.segment_path(over, 6) == "tile"
    assert ss.segment_path(over, 1) == "tile"
    for name, path in NOTCH_PATHS.items():
        plan, width = problems["notch"][name]
        w = int(np.prod(width, dtype=np.int64))
        assert ss.segment_path(plan, w) == path, name


def _pair_sums_in_kernel_order(unique, order, rows, cols, P, plan):
    """What ``coarse_pair_sum``'s kernel does, in plain PyTorch: position
    k of every pair at once, k = 0, 1, ..., each entry's products formed
    as (unique[e] * P[rows[e], a]) * P[cols[e], b] and added to its pair's
    sums from 0."""
    lengths = plan.offsets[1:] - plan.offsets[:-1]
    starts = plan.offsets[:-1]
    w = P.shape[1]
    out = unique.new_zeros((plan.n_segments, w, w))
    for k in range(plan.max_length):
        live = lengths > k
        e = order[starts[live] + k]
        ua = unique[e][:, None] * P[rows[e]]
        out[live] = out[live] + ua[:, :, None] * P[cols[e]][:, None, :]
    return out


def _pair_inputs(problems, mesh):
    fe = problems[mesh]["fe"]
    sp = fe.embedded_sparsity
    pattern = get_two_level_pattern(fe)
    t = pattern.on(torch.device("cpu"), F64)
    rng = np.random.default_rng(17)
    unique = torch.as_tensor(rng.normal(size=sp.num_unique))
    return fe, sp, pattern, t, unique


@pytest.mark.parametrize("mesh", ("cube", "notch"))
def test_coarse_pair_sum_plain_equals_kernel_order_bit_for_bit(problems,
                                                               mesh):
    _fe, sp, pattern, t, unique = _pair_inputs(problems, mesh)
    plan = t["pair_plan"]
    S = ss.coarse_pair_sum(unique, t["order"], sp.rows, sp.col_indices,
                           t["P_vals"], plan)
    # the composition coarse_matrix ran before the fused kernel: the
    # products materialized in pair order, then index_add_
    order, P = t["order"], t["P_vals"]
    r_o, c_o = sp.rows[order], sp.col_indices[order]
    block = (unique[order][:, None, None] * P[r_o][:, :, None]
             * P[c_o][:, None, :])
    composed = torch.zeros_like(S).index_add_(0, plan.sorted_target, block)
    assert S.shape == (plan.n_segments, 6, 6)
    assert torch.equal(S, composed)
    assert torch.equal(S, _pair_sums_in_kernel_order(
        unique, order, sp.rows, sp.col_indices, P, plan))
    # and coarse_matrix places those sums
    A_c = coarse_matrix(pattern, unique, sp.rows, sp.col_indices)
    na = pattern.num_aggregates
    placed = torch.zeros_like(A_c)
    placed.view(na, 6, na, 6)[t["pI"], :, t["pJ"], :] = composed
    assert torch.equal(A_c, placed)
    assert ss.launch_counts()["coarse_pair_sum"] == 0


@pytest.mark.parametrize("mesh", ("cube", "notch"))
def test_coarse_matrix_matches_jax(problems, mesh):
    import jax.numpy as jnp

    fe, sp, pattern, _t, unique = _pair_inputs(problems, mesh)
    pat_j = jax_two_level.attach_coarse_scatter(
        jax_two_level.build_two_level_pattern(
            np.asarray(fe.mesh.nodes, dtype=np.float64),
            np.asarray(fe.dof_map.prescribed_indices),
            fe.dof_map.num_total_dofs),
        sp.indptr_np, sp.col_indices_np)
    np.testing.assert_array_equal(pat_j.coarse_order, pattern.coarse_order)
    A_j = np.asarray(jax_two_level.coarse_matrix(
        pat_j, jnp.asarray(unique.numpy()), jnp.asarray(sp.rows.numpy()),
        jnp.asarray(sp.col_indices.numpy())))
    A_c = coarse_matrix(pattern, unique, sp.rows, sp.col_indices).numpy()
    assert A_c.shape == A_j.shape
    err = np.abs(A_c - A_j).max() / np.abs(A_j).max()
    assert err <= COARSE_JAX_RTOL, err


def test_plan_builders():
    plan = ss.plan_from_target([2, 0, 2, 1, 0], 4, "cpu")
    assert plan.perm.tolist() == [1, 4, 3, 0, 2]
    assert plan.offsets.tolist() == [0, 2, 3, 5, 5]       # segment 3 empty
    assert plan.sorted_target.tolist() == [0, 0, 1, 2, 2]
    vals = torch.arange(5, dtype=F64) + 1.0
    assert ss.segment_sum(vals, plan).tolist() == [7.0, 4.0, 4.0, 0.0]
    assert ss.plan_from_target([0, 0, 1], 2, "cpu").perm is None
    rows = ss.plan_from_offsets([0, 2, 2, 3], "cpu")
    assert rows.target.tolist() == [0, 0, 2] and rows.n_entries == 3
    # entries 1 and 3 belong to no segment
    part = ss.plan_from_sorted([2, 0, 4], [0, 0, 1], 2, 5, "cpu")
    assert part.target is None
    assert ss.segment_sum(vals, part).tolist() == [4.0, 5.0]
    with pytest.raises(ValueError, match="nondecreasing"):
        ss.plan_from_sorted(None, [1, 0], 2, 2, "cpu")
    with pytest.raises(ValueError, match="entries"):
        ss.segment_sum(vals[:4], plan)


def test_segment_sum_and_gather_gradcheck():
    rng = np.random.default_rng(3)
    plan = ss.plan_from_target(rng.integers(0, 5, size=17), 6, "cpu")
    part = ss.plan_from_sorted([3, 0, 7, 5], [0, 1, 1, 2], 3, 9, "cpu")
    for p, n in ((plan, 17), (part, 9)):
        v = torch.as_tensor(rng.normal(size=(n, 2)), dtype=F64
                            ).requires_grad_(True)
        assert torch.autograd.gradcheck(lambda x, p=p: ss.segment_sum(x, p),
                                        (v,))
    x = torch.as_tensor(rng.normal(size=(6, 3)), dtype=F64
                        ).requires_grad_(True)
    assert torch.autograd.gradcheck(
        lambda y: ss.segment_gather(y, plan), (x,))
    assert torch.equal(ss.segment_gather(x, plan), x[plan.target])


def test_csr_matvec_plain_matches_dense():
    rng = np.random.default_rng(5)
    dense = rng.normal(size=(7, 7)) * (rng.random((7, 7)) < 0.4)
    dense[np.arange(7), np.arange(7)] = 1.0
    rows, cols = np.nonzero(dense)
    indptr = np.searchsorted(rows, np.arange(8))
    as_t = lambda a: torch.as_tensor(a, dtype=torch.int64)  # noqa: E731
    data = torch.as_tensor(dense[rows, cols])
    x = torch.as_tensor(rng.normal(size=7))
    matvec = ss.make_csr_matvec(ss.csr_plan(as_t(indptr), as_t(cols), "cpu"),
                                data)
    np.testing.assert_allclose(matvec(x).numpy(), dense @ x.numpy(),
                               rtol=1e-14, atol=1e-14)


def test_cuda_wrappers_take_cuda_tensors_only():
    plan = ss.plan_from_target([0, 1, 1], 2, "cpu")
    vals = torch.ones(3, dtype=F64)
    for path in (None, "tile", "block"):
        with pytest.raises(ValueError, match="CUDA tensors"):
            ss.segment_sum_cuda(vals, plan, None, path=path)
    with pytest.raises(ValueError, match="no 'thread' path"):
        ss.segment_sum_cuda(vals, plan, None, path="thread")
    csr = ss.csr_plan([0, 1, 3], [0, 0, 1], "cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.csr_matvec_cuda(csr, vals, vals[:2])
    with pytest.raises(ValueError, match="no kernel"):
        ss.segment_sum(vals.to("meta"), plan)
    rows = torch.tensor([0, 1, 1])
    P = torch.ones((2, 6), dtype=F64)
    order = torch.arange(3)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.coarse_pair_sum_cuda(vals, order, rows, rows, P, plan)
    with pytest.raises(ValueError, match="no kernel"):
        ss.coarse_pair_sum(vals.to("meta"), order, rows, rows, P, plan)
    assert all(v == 0 for v in ss.launch_counts().values())


def test_sass_keys_name_the_block_kernels():
    from cmad_tpu_torch.ops._sass import kernel_key

    ns = "_ZN47_GLOBAL__N__fa68b9e6_14_segment_sum_cu_c650e772"
    assert kernel_key(ns + "24segment_sum_block_kernelIdLb1ELb1EEEvPKT_") \
        == "segment_sum_block<double, 1, 1>"
    assert kernel_key(ns + "22coarse_pair_sum_kernelIdLi6EEEvPKT_") == \
        "coarse_pair_sum<double, 6>"
    assert kernel_key(ns + "24segment_sum_block_kernelIfLb0ELb0EEEvPKT_") \
        == "segment_sum_block<float, 0, 0>"
    assert kernel_key(ns + "23segment_sum_tile_kernelIfLi1ELb0EEEvPKT_") \
        == "segment_sum_tile<float, 1, 0>"


# ---------------------------------------------------------------------------
# the tile path: tile plans, the kernel's order, the CSR product

def _random_offsets(rng, n_seg, longest):
    """Segment lengths in [0, longest], with a few empty segments."""
    lengths = rng.integers(0, longest + 1, size=n_seg)
    return np.concatenate([[0], np.cumsum(lengths)])


def _check_tiles(offsets, tiles, tile_entries):
    offsets = np.asarray(offsets)
    n = offsets.shape[0] - 1
    starts, firsts = tiles[:, 0], tiles[:, 1]
    assert starts[0] == 0 and starts[-1] == n
    assert np.all(np.diff(starts) > 0)          # each segment once, in order
    assert np.array_equal(firsts, offsets[starts])
    entries = np.diff(firsts)
    segs = np.diff(starts)
    within = (entries <= tile_entries) & (segs <= tile_entries)
    # a tile past the limits is one segment longer than tile_entries
    lone = (segs == 1) & (entries > tile_entries)
    assert np.all(within | lone)
    # greedy: no tile could have taken its next segment
    nxt = offsets[np.minimum(starts[1:-1] + 1, n)] - firsts[:-2]
    assert np.all((nxt > tile_entries) | (segs[:-1] == tile_entries))


@pytest.mark.parametrize("tile_entries", (1, 7, 64, ss.TILE_ENTRIES))
def test_tile_plan_covers_every_segment_once_in_order(tile_entries):
    rng = np.random.default_rng(tile_entries)
    for n_seg, longest in ((1, 0), (1, 5), (40, 3), (300, 12), (97, 150)):
        offsets = _random_offsets(rng, n_seg, longest)
        _check_tiles(offsets, ss.tile_plan(offsets, tile_entries),
                     tile_entries)
    empty = ss.tile_plan([0], tile_entries)
    assert empty.tolist() == [[0, 0]]


@pytest.mark.parametrize("plan_name", PLANS)
def test_cube_plans_carry_their_tiles(problems, plan_name):
    plan, _ = problems["cube"][plan_name]
    offsets = plan.offsets.numpy()
    _check_tiles(offsets.astype(np.int64),
                 plan.tiles.numpy().astype(np.int64), plan.tile_entries)
    # the arrays the kernels read are int32
    for idx in (plan.offsets, plan.perm, plan.schedule, plan.tiles):
        assert idx is None or idx.dtype == torch.int32
    # small tiles on the cube's pattern, lone long segments included
    for tile_entries in (1, 5, 33):
        _check_tiles(offsets, ss.tile_plan(offsets, tile_entries),
                     tile_entries)


def _tile_kernel_order(value_at, offsets, tiles, n_segments, width,
                       tile_entries):
    """What ``segment_sum_tile_kernel`` does, in numpy scalars (each
    product and sum rounded once, as ``__dmul_rn`` and ``__dadd_rn``): per
    tile, per chunk of at most max(tile_entries, width) // width entries,
    the chunk's values staged, then each output adds its staged values in
    ascending position to what the chunk before left (0 at its first)."""
    out = np.full((n_segments, width), np.nan)
    chunk = max(tile_entries, width) // width
    for (s0, lo), (s1, hi) in zip(tiles[:-1], tiles[1:]):
        n_chunks = max(1, -(-(hi - lo) // chunk))
        for k in range(n_chunks):
            c0, c1 = lo + k * chunk, min(hi, lo + (k + 1) * chunk)
            staged = [[value_at(i, c) for c in range(width)]
                      for i in range(c0, c1)]
            for s in range(s0, s1):
                a, b = offsets[s], offsets[s + 1]
                for c in range(width):
                    if a == b:
                        if k == 0:
                            out[s, c] = 0.0
                        continue
                    if b <= c0 or a >= c1:
                        continue
                    acc = np.float64(0.0) if a >= c0 else out[s, c]
                    for i in range(max(a, c0), min(b, c1)):
                        acc = acc + staged[i - c0][c]
                    out[s, c] = acc
    return out


@pytest.mark.parametrize("tile_entries", (4, 9, ss.TILE_ENTRIES))
@pytest.mark.parametrize("form", ("ordered", "permuted", "scaled",
                                  "wide"))
def test_tile_kernel_order_equals_index_add_bit_for_bit(form, tile_entries):
    rng = np.random.default_rng(len(form) * 100 + tile_entries)
    width = 3 if form == "wide" else 1
    target = np.sort(rng.integers(0, 37, size=400))
    target[rng.random(400) < 0.05] = 11          # one long segment
    if form != "ordered":
        target = rng.permutation(target)
    plan = ss.plan_from_target(target, 40, "cpu")
    vals = rng.normal(size=(400, width)) * 10.0 ** rng.integers(
        -8, 8, size=(400, 1))
    scale = rng.normal(size=400) if form == "scaled" else None
    perm = None if plan.perm is None else plan.perm.numpy()

    def value_at(i, c):
        e = i if perm is None else perm[i]
        v = vals[e, c]
        return v * scale[e] if scale is not None else v

    offsets = plan.offsets.numpy()
    tiles = ss.tile_plan(offsets, tile_entries)
    got = _tile_kernel_order(value_at, offsets, tiles, 40, width,
                             tile_entries)
    ref = ss.segment_sum(torch.as_tensor(vals), plan,
                         None if scale is None else torch.as_tensor(scale))
    assert np.array_equal(got, ref.numpy()), np.abs(got - ref.numpy()).max()


def _random_csr(rng, n, density):
    dense = rng.normal(size=(n, n)) * (rng.random((n, n)) < density)
    dense[np.arange(n), np.arange(n)] = rng.normal(size=n)
    rows, cols = np.nonzero(dense)
    indptr = np.searchsorted(rows, np.arange(n + 1))
    return dense, indptr, cols, dense[rows, cols]


@pytest.mark.parametrize("tile_entries", (3, 16, ss.TILE_ENTRIES))
def test_csr_tile_order_equals_csr_matvec_plain_bit_for_bit(tile_entries):
    rng = np.random.default_rng(tile_entries)
    _dense, indptr, cols, data = _random_csr(rng, 60, 0.2)
    x = rng.normal(size=60)
    tiles = ss.tile_plan(indptr, tile_entries)
    got = _tile_kernel_order(lambda i, c: data[i] * x[cols[i]], indptr,
                             tiles, 60, 1, tile_entries)[:, 0]
    plain = ss.csr_matvec_plain(ss.csr_plan(indptr, cols, "cpu"),
                                torch.as_tensor(data), torch.as_tensor(x))
    assert np.array_equal(got, plain.numpy())


def test_csr_matvec_plain_equals_an_ascending_loop_bit_for_bit():
    rng = np.random.default_rng(23)
    _dense, indptr, cols, data = _random_csr(rng, 50, 0.3)
    x = rng.normal(size=50)
    loop = np.zeros(50)
    for r in range(50):
        acc = np.float64(0.0)
        for j in range(indptr[r], indptr[r + 1]):
            acc = acc + data[j] * x[cols[j]]
        loop[r] = acc
    plan = ss.csr_plan(indptr, cols, "cpu")
    y = ss.csr_matvec_plain(plan, torch.as_tensor(data), torch.as_tensor(x))
    assert np.array_equal(y.numpy(), loop)
    # make_csr_matvec's CPU arm is the plain version
    matvec = ss.make_csr_matvec(plan, torch.as_tensor(data))
    assert np.array_equal(matvec(torch.as_tensor(x)).numpy(), loop)
    assert plan.cols.dtype == torch.int32 and plan.n == 50
    assert ss.launch_counts()["csr_matvec"] == 0


# csr_matvec_plain vs cmad_tpu's BCSR operator on the cube's embedded K:
# the same products, summed per row in ascending column order here and in
# XLA's order there (the node-block contraction of 3 x 3 blocks), so the
# last bits of a row's sum may differ; relative to max |y|
CSR_JAX_RTOL = 1e-14


def test_csr_matvec_plain_matches_jax_bcsr_on_the_cube(problems):
    import jax.numpy as jnp

    from cmad_tpu.fem.sparse_solve import (
        EmbeddedSparsity as JaxSparsity,
        _bcsr_operator,
        _node_block_ell,
    )

    fe = problems["cube"]["fe"]
    sp = fe.embedded_sparsity
    nb = _node_block_ell(sp.indptr_np, sp.col_indices_np)
    assert nb is not None                       # the node-block matvec
    sj = JaxSparsity(
        perm=jnp.asarray(sp.perm.numpy()),
        segment_ids=jnp.asarray(sp.segment_ids.numpy()),
        indptr=jnp.asarray(sp.indptr_np), col_indices=jnp.asarray(
            sp.col_indices_np), diag_idx=jnp.asarray(sp.diag_idx.numpy()),
        nb_col=jnp.asarray(nb[0]), nb_src=jnp.asarray(nb[1]))
    rng = np.random.default_rng(29)
    K_data = rng.normal(size=sp.dedup_plan.n_entries)
    x = rng.normal(size=sp.n)
    unique_j, matvec_j = _bcsr_operator(jnp.asarray(K_data), sj)
    unique = ss.segment_sum(torch.as_tensor(K_data), sp.dedup_plan)
    np.testing.assert_array_equal(unique.numpy(), np.asarray(unique_j))
    y = ss.csr_matvec_plain(sp.csr, unique, torch.as_tensor(x)).numpy()
    y_j = np.asarray(matvec_j(jnp.asarray(x)))
    err = np.abs(y - y_j).max() / np.abs(y_j).max()
    assert err <= CSR_JAX_RTOL, err


def test_cuda_wrappers_raise_on_the_wrong_index_type():
    import dataclasses

    plan = ss.plan_from_target([1, 0, 1], 2, "cpu")
    vals = torch.ones(3, dtype=F64)
    # each path checks the plan arrays it reads: offsets, perm, and the
    # tiles (tile path) or the schedule (block path)
    for path, fields in (("tile", ("offsets", "perm", "tiles")),
                         ("block", ("offsets", "perm", "schedule"))):
        for field in fields:
            wide = dataclasses.replace(
                plan, **{field: getattr(plan, field).to(torch.int64)})
            with pytest.raises(ValueError, match=f"{field} must be "
                                                 "contiguous int32"):
                ss.segment_sum_cuda(vals, wide, path=path)
    csr = ss.csr_plan([0, 1, 3], [0, 0, 1], "cpu")
    for wide in (dataclasses.replace(csr, cols=csr.cols.long()),
                 dataclasses.replace(csr, rows=dataclasses.replace(
                     csr.rows, offsets=csr.rows.offsets.long()))):
        with pytest.raises(ValueError, match="must be contiguous int32"):
            ss.csr_matvec_cuda(wide, vals, vals[:2])
    # coarse_pair_sum reads the fine triplet's indices as int64 and the
    # pair plan's as int32
    rows = torch.tensor([0, 1, 1])
    P = torch.ones((2, 6), dtype=F64)
    with pytest.raises(ValueError, match="order must be contiguous int64"):
        ss.coarse_pair_sum_cuda(vals, rows.int(), rows, rows, P, plan)
    with pytest.raises(ValueError, match="offsets must be contiguous int32"):
        ss.coarse_pair_sum_cuda(vals, rows, rows, rows, P,
                                dataclasses.replace(
                                    plan, offsets=plan.offsets.long()))
    assert all(v == 0 for v in ss.launch_counts().values())
