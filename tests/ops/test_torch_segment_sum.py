"""The reproducible sums of cmad_tpu_torch (``ops/segment_sum.py``): the
segment sum over a fixed plan and the CSR product, on the CPU.

The CUDA kernel ``segment_sum`` adds each segment's entries in ascending
position of its plan, from 0, in one thread. Here that order, written in
plain PyTorch (``segment_sum_in_plan_order``), is held bit for bit to
``index_add_`` on the CPU (the plain version, and the JAX package's
scatter-add order on the CPU) on every plan of the FE path: the residual
scatter, the COO dedup and rows of assembly, the embedded-BC CSR dedup,
and the two-level restriction and coarse pairs, on the 8-hex cube and the
480-tet notch. On the card ``chip_smoke.py`` holds the kernel to
``index_add_`` on the CPU bit for bit.
"""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
from cmad_tpu_torch.fem.nonlinear_solver import get_two_level_pattern
from cmad_tpu_torch.ops import segment_sum as ss
from tests.support.torch_fe import notch_deck

torch.set_num_threads(1)

F64 = torch.float64
PLANS = ("residual scatter", "coo dedup", "coo rows", "csr dedup",
         "restriction", "coarse pairs")


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
                     "coarse pairs": (t["pair_plan"], (6, 6))}
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
    assert ss.launch_counts() == {"segment_sum": 0, "csr_matvec": 0}


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
    matvec = ss.make_csr_matvec(as_t(indptr), as_t(cols), data, 7)
    np.testing.assert_allclose(matvec(x).numpy(), dense @ x.numpy(),
                               rtol=1e-14, atol=1e-14)


def test_cuda_wrappers_take_cuda_tensors_only():
    plan = ss.plan_from_target([0, 1, 1], 2, "cpu")
    vals = torch.ones(3, dtype=F64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss._segment_sum_cuda(vals, plan, None)
    idx = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ss.csr_matvec_cuda(idx, idx, vals, vals)
    with pytest.raises(ValueError, match="no kernel"):
        ss.segment_sum(vals.to("meta"), plan)
