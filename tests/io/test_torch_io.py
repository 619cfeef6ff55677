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
    ("qoi", "calibration", 23),
    ("qoi", "uniaxial_calibration", 23),
])
def test_advertised_but_unported_names_raise_with_their_item(where, name,
                                                             item):
    """The names that raised NotImplementedError naming their ROADMAP item
    (``item``) until the port had their modules now resolve: the
    material-point QoIs. An FE deck naming one raises cmad_tpu's
    problem-type error."""
    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu_torch.io.registry import registered_qoi_names, resolve_qoi

    assert where == "qoi" and item == 23
    assert name in registered_qoi_names()
    assert resolve_qoi(name).problem_type == "material_point"
    deck = _notch_deck()
    deck["qoi"] = {"name": name}
    with pytest.raises(ValueError, match="problem_type='material_point'"):
        build_fe_problem_from_deck(deck, dtype=torch.float64, device="cpu")


def test_a_fragment_without_a_module_raises_not_implemented(tmp_path,
                                                            monkeypatch):
    """A schema fragment whose module the port lacks raises
    NotImplementedError, naming the ROADMAP item when ``_NOT_PORTED``
    lists one and without one when it does not (it lists none now)."""
    from cmad_tpu_torch.io import registry

    (tmp_path / "qois").mkdir()
    (tmp_path / "qois" / "made_up_qoi.yaml").write_text("type: object\n")
    monkeypatch.setattr(registry, "_SCHEMA_DIR", tmp_path)
    assert registry._NOT_PORTED == {}
    with pytest.raises(NotImplementedError, match=r"not ported yet$"):
        registry.resolve_qoi("made_up_qoi")
    monkeypatch.setitem(registry._NOT_PORTED, ("qois", "made_up_qoi"), 99)
    with pytest.raises(NotImplementedError, match=r"item 99$"):
        registry.resolve_qoi("made_up_qoi")
    with pytest.raises(KeyError):
        registry.resolve_qoi("no_such_qoi")


def _history_cases(tmp_path):
    """(name, deformation section, expected ndims) for each layout the
    loader reads, on the same (2, 2, 5) history."""
    rng = np.random.default_rng(3)
    F = np.eye(2)[:, :, None] + rng.normal(0.0, 1e-2, (2, 2, 5))
    steps = F.transpose(2, 0, 1)
    np.save(tmp_path / "nnN.npy", F)
    np.save(tmp_path / "Nnn.npy", steps)
    np.save(tmp_path / "tie.npy", F[:, :, :2])  # N == n: (n, n, N) wins
    np.savetxt(tmp_path / "F.csv", steps.reshape(5, 4), delimiter=",")
    np.savetxt(tmp_path / "F.txt", steps.reshape(5, 4))
    return [("npy_nnN", {"history_file": str(tmp_path / "nnN.npy")}),
            ("npy_Nnn", {"history_file": str(tmp_path / "Nnn.npy")}),
            ("npy_tie", {"history_file": str(tmp_path / "tie.npy")}),
            ("csv", {"history_file": str(tmp_path / "F.csv")}),
            ("txt", {"history_file": str(tmp_path / "F.txt")}),
            ("inline", {"inline": steps.tolist()})]


def _history_errors(tmp_path):
    """(name, deformation section, expected ndims), each an error."""
    np.save(tmp_path / "bad.npy", np.zeros((2, 3, 4)))
    np.savetxt(tmp_path / "cols.csv", np.zeros((4, 3)), delimiter=",")
    (tmp_path / "F.dat").write_text("1 0 0 1\n")
    np.save(tmp_path / "ok.npy", np.repeat(np.eye(2)[:, :, None], 3, 2))
    return [("missing", {"history_file": str(tmp_path / "none.npy")}, 2),
            ("extension", {"history_file": str(tmp_path / "F.dat")}, 2),
            ("columns", {"history_file": str(tmp_path / "cols.csv")}, 2),
            ("npy_shape", {"history_file": str(tmp_path / "bad.npy")}, 2),
            ("inline_shape", {"inline": [[[1.0, 0.0]], [[1.0, 0.0]]]}, 2),
            ("neither", {}, 2),
            ("ndims", {"history_file": str(tmp_path / "ok.npy")}, 3)]


def test_load_history_reads_every_format_as_cmad_tpu(tmp_path):
    from cmad_tpu.io.deformation import load_history as jax_load

    from cmad_tpu_torch.io.deformation import load_history

    cases = _history_cases(tmp_path)
    for name, section in cases:
        F, F_ref = load_history(section, 2), jax_load(section, 2)
        assert F.dtype == np.float64 and F_ref.dtype == np.float64, name
        assert np.array_equal(F, F_ref), name
        expected = (2, 2, 2) if name == "npy_tie" else (2, 2, 5)
        assert F.shape == expected, name
    full = load_history(cases[0][1], 2)
    for _name, section in cases[1:]:
        if "tie" not in _name:
            assert np.array_equal(load_history(section, 2), full), _name


@pytest.mark.parametrize("case", ["missing", "extension", "columns",
                                  "npy_shape", "inline_shape", "neither",
                                  "ndims"])
def test_load_history_errors_match_cmad_tpu(tmp_path, case):
    from cmad_tpu.io.deformation import load_history as jax_load

    from cmad_tpu_torch.io.deformation import load_history

    section, ndims = {n: (s, d) for n, s, d in _history_errors(tmp_path)}[
        case]
    errors = []
    for load in (jax_load, load_history):
        with pytest.raises((ValueError, FileNotFoundError)) as e:
            load(section, ndims)
        errors.append((type(e.value), str(e.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("fmt", ["npy", "text"])
def test_mp_writers_write_cmad_tpus_files(tmp_path, fmt):
    """``write_cauchy`` and ``write_xi`` (with its per-variable files) on
    the same trajectory: the same file names; npy files byte-equal, CSV
    files equal as numbers."""
    from cmad_tpu.io import writers as jax_writers
    from cmad_tpu.models.state import StateBlock as JaxBlock
    from cmad_tpu.models.state import StateLayout as JaxLayout

    from cmad_tpu_torch.io import writers
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        _build_layout,
    )
    from cmad_tpu_torch.models.deformation_types import DefType

    rng = np.random.default_rng(4)
    cauchy = rng.normal(size=(3, 3, 6))
    layout = _build_layout(DefType.UNIAXIAL_STRESS)
    xi = rng.normal(size=(6, layout.num_dofs))
    jax_layout = JaxLayout([JaxBlock(b.var_name, b.resid_name, b.var_type,
                                     b.size, b.init) for b in layout.blocks])
    dirs = {}
    for side, (w, lay) in {"jax": (jax_writers, jax_layout),
                           "port": (writers, layout)}.items():
        out = dirs[side] = tmp_path / side
        out.mkdir()
        w.write_cauchy(out, "p_", cauchy, fmt)
        w.write_xi(out, "p_", xi, lay, fmt)
    names = sorted(p.name for p in dirs["jax"].iterdir())
    assert names == sorted(p.name for p in dirs["port"].iterdir())
    assert len(names) == 2 + len(layout.var_names)
    for name in names:
        a, b = dirs["port"] / name, dirs["jax"] / name
        if fmt == "npy":
            assert filecmp.cmp(a, b, shallow=False), name
        else:
            assert a.read_text().splitlines()[0] == \
                b.read_text().splitlines()[0]
            assert np.allclose(np.loadtxt(a, delimiter=","),
                               np.loadtxt(b, delimiter=","), rtol=0, atol=0)
    with pytest.raises(ValueError, match="output.format"):
        writers.write_cauchy(tmp_path, "", cauchy, "hdf5")


def test_mp_U_from_F_matches_cmad_tpu():
    from cmad_tpu.models.global_fields import mp_U_from_F as jax_U

    from cmad_tpu_torch.models.global_fields import mp_U_from_F

    F = np.random.default_rng(5).normal(size=(4, 2, 2))
    U, U_ref = mp_U_from_F(torch.as_tensor(F)), jax_U(F)
    assert U.grad_fields["u"].dtype == torch.float64
    for a, b in ((U.fields["u"], U_ref.fields["u"]),
                 (U.grad_fields["u"], U_ref.grad_fields["u"])):
        assert a.shape == b.shape
        assert np.array_equal(a.numpy(), np.asarray(b))


def test_elastic_resolves_and_binds_closed_form_with_its_guards():
    """``elastic`` resolves (it raised, naming item 19, before the port
    had it): a deck with it binds its block CLOSED_FORM to the generic
    block, with no state; the CLOSED_FORM guards of cmad_tpu hold."""
    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck
    from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
    from cmad_tpu_torch.io.registry import resolve_model
    from cmad_tpu_torch.models.elastic import Elastic

    assert resolve_model("elastic") is Elastic
    deck = _notch_deck()
    local = deck["residuals"]["local residual"]
    local["type"] = "elastic"
    local["materials"]["block_1"] = {"elastic": {"E": 1000.0, "nu": 0.25}}
    fe = build_fe_problem_from_deck(deck, dtype=torch.float64,
                                    device="cpu").fe_problem
    assert fe.modes_by_block == {"block_1": GlobalResidualMode.CLOSED_FORM}
    assert set(fe.evaluators_by_block["block_1"]) == {
        "block_R_and_K_and_xi", "block_R"}
    assert fe.state_blocks() == []
    model = fe.models_by_block["block_1"]
    with pytest.raises(ValueError, match="only valid in COUPLED"):
        fe.gr.for_model(model, GlobalResidualMode.CLOSED_FORM,
                        local_newton_settings={"max_iters": 5})
    plastic = build_fe_problem_from_deck(
        _notch_deck(), dtype=torch.float64,
        device="cpu").fe_problem.models_by_block["block_1"]
    with pytest.raises(ValueError, match="supports_closed_form_cauchy"):
        fe.gr.for_model(plastic, GlobalResidualMode.CLOSED_FORM)


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
