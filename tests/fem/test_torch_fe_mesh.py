"""cmad_tpu_torch's FE data preparation against cmad_tpu's: the Exodus
read, coordinate side sets, the DOF map and its Dirichlet arrays, the
prescribed values, deck expressions and defaults, the geometry cache and
the assembled COO pattern with its dedup scatter; and the port's own
contracts: the FE entry point defaults to the card, the xi carrier's
explicit layouts. (That no deck parser comes with the package is part
of the import-hygiene test, ``tests/ops/test_torch_parameters.py``.)

Integers and host arrays must be identical; the geometry cache agrees to
1e-14 of each array's scale (both packages use the closed-form 3x3
determinant and inverse).
"""
from __future__ import annotations

import inspect

import numpy as np
import pytest
import torch

from cmad_tpu.fem.dof import GlobalFieldLayout as JaxLayout
from cmad_tpu.fem.elements import P1_TET as JAX_P1, Q1_HEX as JAX_Q1
from cmad_tpu.fem.mesh import coordinate_side_sets as jax_side_sets
from cmad_tpu.fem.precompute import precompute_block_geometry as jax_geometry
from cmad_tpu.fem.quadrature import (
    default_assembly_quadrature as jax_quadrature,
)
from cmad_tpu.io.deck import apply_deck_defaults as jax_defaults
from cmad_tpu.io.expressions import parse_scalar_expression as jax_parse
from cmad_tpu.io.mesh_io import read_mesh_file as jax_read
from cmad_tpu_torch import config
from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
from cmad_tpu_torch.fem.dof import GlobalFieldLayout
from cmad_tpu_torch.fem.elements import P1_TET, Q1_HEX
from cmad_tpu_torch.fem.mesh import coordinate_side_sets
from cmad_tpu_torch.fem.precompute import precompute_block_geometry
from cmad_tpu_torch.fem.quadrature import default_assembly_quadrature
from cmad_tpu_torch.fem.xi_carrier import (
    pack_xi,
    pack_xi_by_block,
    unpack_xi_by_block,
)
from cmad_tpu_torch.io.deck import apply_deck_defaults, load_deck
from cmad_tpu_torch.io.expressions import parse_scalar_expression
from cmad_tpu_torch.io.mesh_io import read_mesh_file

from tests.support.torch_fe import (
    MESHES,
    NOTCH_480,
    REPO,
    jax_bundle,
    notch_deck,
    port_bundle,
)

torch.set_num_threads(1)

F64 = torch.float64


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    deck = notch_deck()
    return jax_bundle(deck, tmp_path_factory.mktemp("deck")), \
        port_bundle(deck)


def _same_sets(a: dict, b: dict) -> None:
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]))


@pytest.mark.parametrize("name", [NOTCH_480, "cube_hex_8.exo"])
def test_exodus_read_matches(name):
    ref, got = jax_read(MESHES / name), read_mesh_file(MESHES / name)
    assert got.element_family.name == ref.element_family.name
    for attr in ("nodes", "connectivity", "edges", "element_edges",
                 "faces", "element_faces"):
        a, b = getattr(ref, attr), getattr(got, attr)
        assert b.dtype == a.dtype, attr
        np.testing.assert_array_equal(b, a, err_msg=attr)
    for attr in ("element_blocks", "node_sets", "side_sets"):
        _same_sets(getattr(ref, attr), getattr(got, attr))
    for attr in ("element_block_ids", "node_set_ids", "side_set_ids"):
        assert getattr(got, attr) == getattr(ref, attr)


def test_coordinate_side_sets_match():
    ref = jax_side_sets(jax_read(MESHES / NOTCH_480))
    got = coordinate_side_sets(read_mesh_file(MESHES / NOTCH_480))
    assert sorted(got) == ["xmax_sides", "xmin_sides", "ymax_sides",
                           "ymin_sides", "zmax_sides", "zmin_sides"]
    _same_sets(ref, got)


def test_dof_map_and_dirichlet_arrays_match(bundles):
    bj, bt = bundles
    dj, dt = bj.fe_problem.dof_map, bt.fe_problem.dof_map
    assert dt.num_total_dofs == dj.num_total_dofs == 495
    for attr in ("num_dofs_per_basis_fn", "block_offsets",
                 "prescribed_indices"):
        np.testing.assert_array_equal(getattr(dt, attr), getattr(dj, attr))
    assert dt.overprescribed == dj.overprescribed
    assert len(dt.resolved_bcs) == len(dj.resolved_bcs) == 4
    for rt, rj in zip(dt.resolved_bcs, dj.resolved_bcs, strict=True):
        np.testing.assert_array_equal(rt.eq_indices, rj.eq_indices)
        np.testing.assert_array_equal(rt.set_coords, rj.set_coords)
    aj, at = bj.fe_problem.kernel_arrays.dbc_arrays, \
        bt.fe_problem.kernel_arrays.dbc_arrays
    for (pj, cj), (pt, ct) in zip(aj, at, strict=True):
        np.testing.assert_array_equal(np.asarray(pt), np.asarray(pj))
        np.testing.assert_array_equal(np.asarray(ct), np.asarray(cj))
    np.testing.assert_array_equal(
        bt.fe_problem.kernel_arrays.prescribed_indices.numpy(),
        np.asarray(bj.fe_problem.kernel_arrays.prescribed_indices))
    np.testing.assert_array_equal(bt.t_schedule, bj.t_schedule)
    for t in (0.0, 1.0, 2.5, 4.0):
        np.testing.assert_array_equal(
            dt.evaluate_prescribed_values(at, t),
            np.asarray(dj.evaluate_prescribed_values(aj, t)))


def test_near_null_space_matches(bundles):
    """The rigid-body modes of the two-level coarse space; the mixed
    form is not ported and says so."""
    bj, bt = bundles
    nns = bt.fe_problem.near_null_space
    assert nns.shape == (495, 6)
    np.testing.assert_array_equal(nns, np.asarray(
        bj.fe_problem.near_null_space))
    from cmad_tpu_torch.global_residuals.small_disp_equilibrium import (
        SmallDispEquilibrium,
    )
    with pytest.raises(NotImplementedError, match="item 22"):
        SmallDispEquilibrium.from_deck(
            {"def_type": "full_3d", "mixed": True}, ndims=3)


def test_expressions_match():
    rng = np.random.default_rng(3)
    x, y, z = rng.uniform(-1.0, 1.0, (3, 17))
    names = ("x", "y", "z", "t")
    for expr in ("0.01 * t", "sin(pi*x)*cos(pi*y) + z**2 * t", "2.5", 1):
        ref = np.asarray(jax_parse(expr, names)(x=x, y=y, z=z, t=1.75))
        got = np.asarray(parse_scalar_expression(expr, names)(
            x=x, y=y, z=z, t=1.75))
        np.testing.assert_allclose(got, ref, rtol=1e-15, atol=0)


def test_deck_defaults_match(tmp_path):
    deck = notch_deck(linear_solver={"type": "cg", "rtol": 1e-10,
                                     "preconditioner": {"type": "pyamg"}})
    with pytest.warns(UserWarning, match="pyamg"):
        ref = jax_defaults(deck)
    with pytest.warns(UserWarning, match="pyamg"):
        got = apply_deck_defaults(deck)
    assert got == ref
    # the YAML path reads the same dict
    path = tmp_path / "deck.yaml"
    path.write_text((REPO / "examples/notch_hosford.yaml").read_text())
    import yaml

    assert load_deck(path) == yaml.safe_load(path.read_text())


@pytest.mark.parametrize("name, fe_j, fe_t", [
    (NOTCH_480, JAX_P1, P1_TET), ("cube_hex_8.exo", JAX_Q1, Q1_HEX)])
def test_geometry_cache_matches(name, fe_j, fe_t):
    mj, mt = jax_read(MESHES / name), read_mesh_file(MESHES / name)
    gj = jax_geometry(mj, jax_quadrature(), [JaxLayout("u", fe_j)])
    gt = precompute_block_geometry(mt, default_assembly_quadrature(),
                                   [GlobalFieldLayout("u", fe_t)], F64,
                                   torch.device("cpu"))
    assert sorted(gt) == sorted(gj)
    for b in gj:
        pairs = [(gj[b]["shared"]["quad_w"], gt[b]["shared"]["quad_w"]),
                 (gj[b]["shared"]["N"][0], gt[b]["shared"]["N"][0]),
                 (gj[b]["per_elem"]["grad_N_phys"][0],
                  gt[b]["per_elem"]["grad_N_phys"][0])]
        pairs += [(gj[b]["per_elem"][k], gt[b]["per_elem"][k])
                  for k in ("iso_jac_det", "coords_ip", "h")]
        for ref, got in pairs:
            ref = np.asarray(ref)
            assert got.dtype == F64 and tuple(got.shape) == ref.shape
            np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                                       atol=1e-14 * np.abs(ref).max())


def test_coo_pattern_and_embedded_sparsity_match(bundles):
    bj, bt = bundles
    kj, kt = bj.fe_problem.kernel_arrays, bt.fe_problem.kernel_arrays
    for attr in ("coo_rows", "coo_cols", "coo_dedup_scatter"):
        np.testing.assert_array_equal(getattr(kt, attr).numpy(),
                                      np.asarray(getattr(kj, attr)))
    for eqj, eqt in ((kj.u_gather_eq_by_block, kt.u_gather_eq_by_block),
                     (kj.r_scatter_eq_by_block, kt.r_scatter_eq_by_block)):
        for a, b in zip(eqj["block_1"], eqt["block_1"], strict=True):
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    sj, st = kj.embedded_sparsity, kt.embedded_sparsity
    for attr in ("perm", "segment_ids", "indptr", "col_indices",
                 "diag_idx"):
        np.testing.assert_array_equal(getattr(st, attr).numpy(),
                                      np.asarray(getattr(sj, attr)))
    # each dedup segment collects every emitted duplicate of its (row,
    # col): the pattern rebuilt from the scatter is the emitted stream
    rows = kt.coo_rows.numpy()[kt.coo_dedup_scatter.numpy()]
    conn = bt.fe_problem.mesh.connectivity
    eq = (3 * conn[:, :, None] + np.arange(3)).reshape(conn.shape[0], 12)
    np.testing.assert_array_equal(
        rows, np.broadcast_to(eq[:, :, None], (conn.shape[0], 12, 12))
        .ravel())


def test_fe_entry_point_defaults_to_the_card():
    default = inspect.signature(build_fe_problem_from_deck) \
        .parameters["device"].default
    assert default == config.DEFAULT_DEVICE == torch.device("cuda")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_fe_problem_from_deck(notch_deck())


def test_pack_xi_checks_the_trailing_dimension():
    rng = np.random.default_rng(0)
    xi = torch.as_tensor(rng.normal(size=(5, 1, 7)))
    assert tuple(pack_xi(xi, 7).shape) == (8, 5)
    with pytest.raises(ValueError, match=r"\(E, Q, 6\)"):
        pack_xi(xi, 6)
    with pytest.raises(ValueError, match="AoS state"):
        pack_xi(xi[0])


def test_pack_xi_by_block_takes_the_layout_explicitly(bundles):
    fe = bundles[1].fe_problem
    rng = np.random.default_rng(1)
    xi = torch.as_tensor(rng.normal(size=(480, 1, 7)))
    carrier = pack_xi_by_block(fe, {"block_1": xi}, layout="aos")
    assert tuple(carrier["block_1"].shape) == (8, 480)
    assert torch.equal(unpack_xi_by_block(fe, carrier)["block_1"], xi)
    assert pack_xi_by_block(fe, carrier, layout="carrier") == carrier
    # a stacked carrier history (T, 8, E*Q) is 3-D like the AoS state:
    # it is refused, not relaid out
    history = torch.stack([carrier["block_1"]] * 3)
    with pytest.raises(ValueError, match=r"\(480, 1, 7\)"):
        pack_xi_by_block(fe, {"block_1": history}, layout="aos")
    with pytest.raises(ValueError, match=r"\(8, 480\)"):
        pack_xi_by_block(fe, {"block_1": history}, layout="carrier")
    with pytest.raises(ValueError, match="layout"):
        pack_xi_by_block(fe, {"block_1": xi}, layout="soa")

