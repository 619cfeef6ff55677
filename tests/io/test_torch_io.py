"""The port's deck I/O against cmad_tpu's, on the CPU: the Exodus writer
and results reader (each package reads the other's file, bit for bit),
the results helpers, the YAML emitter, the schema fragments and the
schema's errors, the restart files, the QoI target from an Exodus file
and the profiler hook.
"""
from __future__ import annotations

import copy
import filecmp
from pathlib import Path

import numpy as np
import pytest
import torch
import yaml

from cmad_tpu_torch.io import exodus, restart, results
from cmad_tpu_torch.io.writers import dump_yaml
from cmad_tpu_torch.models.var_types import VarType

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[2]
EXAMPLES = sorted((REPO / "examples").glob("*.yaml")) + sorted(
    (REPO / "examples" / "results").glob("*.yaml"))


def _cube():
    from cmad_tpu_torch.io.mesh_io import read_mesh_file

    return read_mesh_file(REPO / "examples" / "meshes" / "cube_hex_8.exo")


def _write(writer_cls, path, mesh, rng):
    """Three steps of a vector nodal field and a sym-tensor element field
    (on the one block) through ``writer_cls``; returns what was written."""
    nodal = component_names_of("u", VarType.VECTOR)
    elem = component_names_of("cauchy", VarType.SYM_TENSOR)
    block = next(iter(mesh.element_blocks))
    n_e = len(mesh.element_blocks[block])
    w = writer_cls(path, mesh, nodal_var_names=nodal,
                   element_var_names={block: elem})
    steps = []
    for t in (0.0, 0.5, 1.0):
        nv = {c: rng.normal(size=mesh.nodes.shape[0]) for c in nodal}
        ev = {c: {block: rng.normal(size=n_e)} for c in elem}
        w.write_step(t, nv, ev)
        steps.append((t, nv, ev))
    w.close()
    return block, steps


def component_names_of(name, var_type):
    return list(results.component_names(name, var_type))


def _specs(pkg_results, pkg_var_type):
    return ([pkg_results.FieldSpec("u", pkg_var_type.VECTOR)],
            [pkg_results.FieldSpec("cauchy", pkg_var_type.SYM_TENSOR)])


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_exodus_results_cross_read_bit_for_bit(tmp_path, writer):
    from cmad_tpu.io import exodus as jax_exodus
    from cmad_tpu.io import results as jax_results
    from cmad_tpu.models.var_types import VarType as JaxVarType

    rng = np.random.default_rng(4)
    mesh = _cube()
    cls = exodus.ExodusWriter if writer == "port" else jax_exodus.ExodusWriter
    path = tmp_path / f"{writer}.exo"
    block, steps = _write(cls, path, mesh, rng)
    got = exodus.read_results(path, *_specs(results, VarType))
    ref = jax_exodus.read_results(path, *_specs(jax_results, JaxVarType))
    np.testing.assert_array_equal(got.times, ref.times)
    np.testing.assert_array_equal(got.times, [t for t, _n, _e in steps])
    np.testing.assert_array_equal(got.nodal["u"], ref.nodal["u"])
    np.testing.assert_array_equal(got.element["cauchy"][block],
                                  ref.element["cauchy"][block])
    np.testing.assert_array_equal(
        got.nodal["u"][1][:, 2], steps[1][1]["u_z"])
    raw = exodus.read_results(path)
    raw_ref = jax_exodus.read_results(path)
    assert sorted(raw.nodal) == sorted(raw_ref.nodal)
    for name in raw.element:
        np.testing.assert_array_equal(raw.element[name][block],
                                      raw_ref.element[name][block])
    # the mesh reads back the same through both packages
    m = exodus.read_mesh(path)
    np.testing.assert_array_equal(m.nodes, mesh.nodes)
    np.testing.assert_array_equal(m.connectivity, mesh.connectivity)


def test_port_and_jax_writers_write_the_same_file(tmp_path):
    from cmad_tpu.io import exodus as jax_exodus

    mesh = _cube()
    _write(exodus.ExodusWriter, tmp_path / "a.exo", mesh,
           np.random.default_rng(1))
    _write(jax_exodus.ExodusWriter, tmp_path / "b.exo", mesh,
           np.random.default_rng(1))
    ra = exodus.read_results(tmp_path / "a.exo")
    rb = exodus.read_results(tmp_path / "b.exo")
    np.testing.assert_array_equal(ra.times, rb.times)
    assert sorted(ra.nodal) == sorted(rb.nodal)
    for k in ra.nodal:
        np.testing.assert_array_equal(ra.nodal[k], rb.nodal[k])
    for k in ra.element:
        for b in ra.element[k]:
            np.testing.assert_array_equal(ra.element[k][b],
                                          rb.element[k][b])


def test_writer_rejects_what_its_schema_lacks(tmp_path):
    mesh = _cube()
    w = exodus.ExodusWriter(tmp_path / "x.exo", mesh,
                            nodal_var_names=["u_x"])
    with pytest.raises(ValueError, match="not in the writer schema"):
        w.write_step(0.0, {"p": np.zeros(mesh.nodes.shape[0])})
    with pytest.raises(ValueError, match="shape"):
        w.write_step(0.0, {"u_x": np.zeros(3)})
    w.close()
    with pytest.raises(exodus.ExodusFormatError, match="aliases"):
        exodus.read_results(tmp_path / "x.exo",
                            field_name_aliases={"v": "u"})


def test_results_helpers_match_cmad_tpu():
    from cmad_tpu.io import results as jax_results
    from cmad_tpu.models.var_types import VarType as JaxVarType

    rng = np.random.default_rng(6)
    for vt in ("SCALAR", "VECTOR", "SYM_TENSOR", "TENSOR"):
        assert results.component_names("f", VarType[vt]) == \
            jax_results.component_names("f", JaxVarType[vt])
    v = rng.normal(size=(4, 6))
    out = results.to_exodus_storage(v, VarType.SYM_TENSOR)
    np.testing.assert_array_equal(
        out, np.asarray(jax_results.to_exodus_storage(
            v, JaxVarType.SYM_TENSOR)))
    np.testing.assert_array_equal(
        results.from_exodus_storage(out, VarType.SYM_TENSOR), v)


@pytest.mark.parametrize("path", EXAMPLES, ids=lambda p: p.name)
def test_yaml_emitter_round_trips_every_example_deck(path):
    from cmad_tpu_torch.io.deck import apply_deck_defaults

    deck = yaml.safe_load(path.read_text())
    assert yaml.safe_load(dump_yaml(deck)) == deck
    resolved = apply_deck_defaults(copy.deepcopy(deck))
    assert yaml.safe_load(dump_yaml(resolved)) == resolved


def test_yaml_emitter_scalars():
    data = {"tiny": 1e-8, "big": [1.5e300, -2e-308, 5e-324, float("inf")],
            "none": None, "flag": True, "word": "yes", "Y": "n",
            "expr": "0.003 * t", "empty": [], "nested": {}, "quote": 'a"b',
            "matrix": [[1.0, 0.0], [0.0, 1.0]], "colon": "a: b",
            "list of dicts": [{"x": 1, "y": [{"z": "q"}]}], "n": 7,
            "lead": "  x", "blank": "", "ctl": "tab\tnl\n"}
    assert yaml.safe_load(dump_yaml(data)) == data
    assert yaml.safe_load(dump_yaml([1, "two"])) == [1, "two"]
    with pytest.raises(TypeError, match="cannot write"):
        dump_yaml({"x": object()})


def test_schema_fragments_are_the_jax_packages_file_for_file():
    ours = REPO / "cmad_tpu_torch" / "io" / "schemas"
    theirs = REPO / "cmad_tpu" / "io" / "schemas"
    files = sorted(p.relative_to(theirs) for p in theirs.rglob("*.yaml"))
    assert files == sorted(p.relative_to(ours) for p in ours.rglob("*.yaml"))
    assert files
    for f in files:
        assert filecmp.cmp(ours / f, theirs / f, shallow=False), f


def _fe_deck():
    return yaml.safe_load(
        (REPO / "examples" / "elastic_plastic_uniaxial.yaml").read_text())


@pytest.mark.parametrize("edit, subcommand", [
    (lambda d: d, "primal"),
    (lambda d: d.update(bogus={}), "primal"),
    (lambda d: d.pop("residuals"), "primal"),
    (lambda d: d, "gradient"),
    (lambda d: d["discretization"].update({"num steps": "five"}),
     "primal"),
    (lambda d: d.update(qoi={"name": "nope"}), "objective"),
    (lambda d: d["residuals"]["global residual"].update(
        {"steps per dispatch": 2}), "primal"),
    (lambda d: d["problem"].update(type="solid"), "primal"),
], ids=["valid", "extra-section", "missing-section", "missing-qoi",
        "bad-type", "unknown-qoi", "cap-without-stepped", "bad-problem"])
def test_schema_errors_match_cmad_tpu(edit, subcommand):
    from cmad_tpu.io.schema import validate_deck as jax_validate

    from cmad_tpu_torch.io.deck import apply_deck_defaults
    from cmad_tpu_torch.io.schema import validate_deck

    deck = _fe_deck()
    edit(deck)
    resolved = apply_deck_defaults(copy.deepcopy(deck))

    def outcome(fn):
        try:
            fn(copy.deepcopy(resolved), subcommand)
        except ValueError as e:
            return str(e)
        return None

    got, ref = outcome(validate_deck), outcome(jax_validate)
    assert got == ref
    assert (got is None) == (subcommand == "primal"
                             and edit.__code__.co_code
                             == (lambda d: d).__code__.co_code)


def test_restart_round_trip_and_checks(tmp_path):
    from cmad_tpu.io import restart as jax_restart

    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck

    rng = np.random.default_rng(9)
    deck = _fe_deck()
    deck["discretization"]["mesh file"] = str(
        REPO / "examples" / "meshes" / "cube_hex_8.exo")
    fe = build_fe_problem_from_deck(deck, device="cpu").fe_problem
    U = rng.normal(size=fe.dof_map.num_total_dofs)
    xi = {"all": rng.normal(size=(len(fe.mesh.element_blocks["all"]),
                                  fe.num_ips(), 7))}
    restart.write_restart(tmp_path / "r" / "restart.npz", U, xi, 0.6)
    got = restart.read_restart(tmp_path / "r" / "restart.npz")
    ref = jax_restart.read_restart(tmp_path / "r" / "restart.npz")
    for a, b in ((got[0], ref[0]), (got[1]["all"], ref[1]["all"])):
        np.testing.assert_array_equal(a, b)
    assert got[2] == ref[2] == 0.6
    restart.check_restart_compatible(fe, U, xi)
    with pytest.raises(ValueError, match="dofs"):
        restart.check_restart_compatible(fe, U[:-1], xi)
    with pytest.raises(ValueError, match="blocks"):
        restart.check_restart_compatible(fe, U, {"other": xi["all"]})
    with pytest.raises(FileNotFoundError):
        restart.read_restart(tmp_path / "none.npz")


def test_displacement_target_from_exodus_matches_cmad_tpu(tmp_path):
    from cmad_tpu.io.qoi_data import load_displacement_data as jax_load

    from cmad_tpu_torch.io.qoi_data import load_displacement_data

    _write(exodus.ExodusWriter, tmp_path / "u.exo", _cube(),
           np.random.default_rng(2))
    sec = {"data_file": str(tmp_path / "u.exo")}
    got = load_displacement_data(sec)
    assert got.shape == (3, _cube().nodes.shape[0], 3)
    np.testing.assert_array_equal(got, jax_load(sec))


def test_maybe_trace_writes_a_chrome_trace(tmp_path):
    from cmad_tpu_torch.util.profiling import maybe_trace

    with maybe_trace(None) as none:
        assert none is None
    with maybe_trace({"output": {"profile trace": str(tmp_path / "tr")}}
                     ) as path:
        torch.ones(3).sum()
    assert path == tmp_path / "tr"
    assert (tmp_path / "tr" / "trace.json").stat().st_size > 0


def _notch_deck():
    from tests.support.torch_fe import notch_deck

    return notch_deck()


@pytest.mark.parametrize("where,name,item", [
    ("model", "elastic", 19),
    ("qoi", "calibration", 23),
    ("qoi", "uniaxial_calibration", 23),
])
def test_advertised_but_unported_names_raise_with_their_item(where, name,
                                                             item):
    """A deck naming a model or QoI that the schema copy advertises but the
    port has no module for raises NotImplementedError naming its ROADMAP
    item, where it raised a KeyError about a missing module."""
    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu_torch.io.registry import (
        registered_model_names,
        registered_qoi_names,
    )

    deck = _notch_deck()
    if where == "model":
        assert name in registered_model_names()
        deck["residuals"]["local residual"]["type"] = name
    else:
        assert name in registered_qoi_names()
        deck["qoi"] = {"name": name}
    with pytest.raises(NotImplementedError, match=rf"item {item}\b"):
        build_fe_problem_from_deck(deck, dtype=torch.float64, device="cpu")


def test_every_advertised_name_resolves_or_names_its_item():
    from cmad_tpu_torch.io.registry import (
        registered_model_names,
        registered_qoi_names,
        resolve_model,
        resolve_qoi,
    )

    for names, resolve in ((registered_model_names(), resolve_model),
                           (registered_qoi_names(), resolve_qoi)):
        for name in names:
            try:
                resolve(name)
            except NotImplementedError as e:
                assert "ROADMAP queue 1, item" in str(e), name
    for name in ("fe_displacement_l2", "fe_load_match", "fe_weighted_sum"):
        assert resolve_qoi(name).problem_type == "fe"
    with pytest.raises(KeyError):
        resolve_model("no_such_model")
