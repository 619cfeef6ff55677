"""Surface tractions and body forces in cmad_tpu_torch against cmad_tpu's,
on the CPU in float64.

The port's side quadrature, side lifts, in-house meshes, Neumann
resolution and assembly (``fem/neumann.py``), and the body force of the
J2, point-batch and generic blocks, each held to cmad_tpu on the same
inputs. Tolerances:

- the Neumann R vector against cmad_tpu's ``assemble_side_neumann``:
  1e-14 absolute on fluxes of order one (the same f64 products, summed in
  another order); the units' closed forms (traction x area, the linear
  traction's moment, t scaling, side measures summing to face areas):
  1e-13 relative;
- ``StructuredHexMesh`` and ``hex_to_tet_split``: bit for bit;
- the manufactured-solution cube (elastic, exact traction on xmax and
  exact body force, Dirichlet elsewhere, the decks' expressions): U at n
  = 3 against cmad_tpu's to 1e-10 of max|U| (one Newton step of a linear
  problem, direct solves); the port's L2 error rate from n = 3 to 6 above
  1.9 and the H1 rate above 0.9 (cmad_tpu's ``test_mms_cube_neumann``);
- the loaded drives (a traction on xmax and a body force, 3 steps to
  plasticity), U and xi per step against cmad_tpu's to 1e-10 of their
  scales: the J2 block on the 8-hex cube (both stepped drives at Newton
  1e-12), and on one hex the point-batch Hosford block (a = 100) and the
  generic COUPLED block (J2 with ``print convergence: true``), against
  cmad_tpu's jitted ``assemble_global`` under a dense Newton with the
  same stopping rule (its whole drive would compile for about a minute);
- the stepped gradient of the loaded J2 cube (Y and S active,
  ``fe_displacement_match`` against the drive at Y = 200) against
  cmad_tpu's, 1e-9 relative; the stepped Hessian against a central
  difference of the port's own gradient, 1e-6 relative;
- the loaded deck with ``quadrature: surface degree`` through ``python
  -m cmad_tpu_torch primal``: the Exodus U against cmad_tpu's drive,
  1e-10 of max|U|.
"""
from __future__ import annotations

import contextlib
import copy
import io
import runpy
import sys

import numpy as np
import pytest
import sympy as sp
import torch
import yaml

from cmad_tpu_torch.cli.fe_common import (
    build_fe_problem_from_deck,
    build_fe_stepped_hessian_fn,
    build_fe_stepped_vg,
    fe_primal_drive,
)
from cmad_tpu_torch.fem.assembly import (
    assemble_global,
    params_by_block_from_models,
)
from cmad_tpu_torch.fem.bcs import NeumannBC
from cmad_tpu_torch.fem.dof import GlobalFieldLayout, build_dof_map
from cmad_tpu_torch.fem.elements import (
    P1_TET,
    Q1_HEX,
    EntityType,
    FiniteElement,
    hex_linear,
)
from cmad_tpu_torch.fem.fe_problem import build_fe_problem
from cmad_tpu_torch.fem.mesh import StructuredHexMesh, hex_to_tet_split
from cmad_tpu_torch.fem.neumann import (
    assemble_side_neumann,
    build_neumann_side_arrays,
    resolve_neumann_bcs,
)
from cmad_tpu_torch.fem.quadrature import (
    default_side_quadrature,
    quad_quadrature,
    tri_quadrature,
)
from cmad_tpu_torch.fem.topology import ElementFamily, ref_side_lift
from cmad_tpu_torch.global_residuals.small_disp_equilibrium import (
    SmallDispEquilibrium,
)
from cmad_tpu_torch.io.exodus import ExodusWriter, read_results
from cmad_tpu_torch.io.results import FieldSpec
from cmad_tpu_torch.models.elastic import Elastic
from cmad_tpu_torch.models.var_types import VarType
from cmad_tpu_torch.parameters.parameters import parameters_from_numpy

torch.set_num_threads(1)

F64 = torch.float64
NEWTON_TOL = 1e-12
DRIVE_RTOL = 1e-10
E_MOD, NU = 1000.0, 0.3
J2 = {"J2": {}}
HOSFORD = {"hosford": {"a": 100.0}}


# ----------------------------------------------------------- both packages


def _meshes(lengths=(1.0, 1.0, 1.0), div=(2, 2, 2), tets=False):
    """The same structured mesh from both packages' builders."""
    from cmad_tpu.fem.mesh import StructuredHexMesh as JaxHexMesh
    from cmad_tpu.fem.mesh import hex_to_tet_split as jax_split

    port, jax = StructuredHexMesh(lengths, div), JaxHexMesh(lengths, div)
    return (hex_to_tet_split(port), jax_split(jax)) if tets else (port, jax)


def _dof_map(mesh):
    """The displacement field's dof map, no Dirichlet BCs."""
    tet = mesh.element_family == ElementFamily.TET_LINEAR
    return build_dof_map(mesh, [GlobalFieldLayout(
        "u", P1_TET if tet else Q1_HEX)], [], {"u": 3})


def _jax_dof_map(mesh):
    from cmad_tpu.fem.dof import GlobalFieldLayout as JaxLayout
    from cmad_tpu.fem.dof import build_dof_map as jax_dof_map
    from cmad_tpu.fem.elements import P1_TET as JAX_P1
    from cmad_tpu.fem.elements import Q1_HEX as JAX_Q1

    tet = mesh.element_family == ElementFamily.TET_LINEAR
    return jax_dof_map(mesh, [JaxLayout("u", JAX_P1 if tet else JAX_Q1)],
                       [], {"u": 3})


def _neumann_R(port_mesh, values, t=1.0, sidesets=("xmax_sides",)):
    """The port's Neumann vector and its side arrays."""
    dof = _dof_map(port_mesh)
    resolved = resolve_neumann_bcs(port_mesh, dof, [
        NeumannBC(list(sidesets), "u", values)])
    arrays = build_neumann_side_arrays(port_mesh, dof, resolved,
                                       default_side_quadrature())
    return assemble_side_neumann(arrays, resolved, t).numpy(), arrays


def _jax_neumann_R(jax_mesh, values, t=1.0, sidesets=("xmax_sides",)):
    from cmad_tpu.fem.bcs import NeumannBC as JaxNeumannBC
    from cmad_tpu.fem.neumann import assemble_side_neumann as jax_asm
    from cmad_tpu.fem.neumann import build_neumann_side_arrays as jax_arrays
    from cmad_tpu.fem.neumann import resolve_neumann_bcs as jax_resolve
    from cmad_tpu.fem.quadrature import default_side_quadrature as jax_sq

    dof = _jax_dof_map(jax_mesh)
    resolved = jax_resolve(jax_mesh, dof, [
        JaxNeumannBC(list(sidesets), "u", values)])
    arrays = jax_arrays(jax_mesh, dof, resolved, jax_sq())
    return np.asarray(jax_asm(dof, arrays, resolved, t))


def _linear_x(xp):
    """t_x = t y on the face: the reference's linear traction."""
    def traction(coords, t):
        y = coords[:, 1]
        return t * xp.stack([y, 0.0 * y, 0.0 * y], axis=-1)
    return traction


def _ones(xp):
    return lambda c, t: t * xp.ones((c.shape[0], 3))


# ------------------------------------------------------------------ units


def _unit_constant_hex():
    pm, jm = _meshes((2.0, 1.0, 1.0))
    tbar = [3.0, -1.0, 0.5]
    R, _ = _neumann_R(pm, tbar)
    for c in range(3):                     # the x = 2 face has area 1
        np.testing.assert_allclose(R[c::3].sum(), -tbar[c], rtol=1e-13)
    return R, _jax_neumann_R(jm, tbar)


def _unit_constant_tet():
    pm, jm = _meshes(tets=True)
    R, _ = _neumann_R(pm, [0.0, 0.0, 2.0], sidesets=("zmax_sides",))
    np.testing.assert_allclose(R[2::3].sum(), -2.0, rtol=1e-13)
    np.testing.assert_allclose(R[0::3].sum(), 0.0, atol=1e-14)
    return R, _jax_neumann_R(jm, [0.0, 0.0, 2.0], sidesets=("zmax_sides",))


def _unit_linear_moment():
    """t_x = y on the xmax face of the unit cube: total force 1/2 and
    y-weighted moment 1/3 (exact for bilinear faces)."""
    import jax.numpy as jnp

    pm, jm = _meshes()
    R, _ = _neumann_R(pm, _linear_x(np))
    np.testing.assert_allclose(R[0::3].sum(), -0.5, rtol=1e-13)
    np.testing.assert_allclose((R[0::3] * pm.nodes[:, 1]).sum(), -1.0 / 3.0,
                               rtol=1e-13)
    return R, _jax_neumann_R(jm, _linear_x(jnp))


def _unit_scales_with_t():
    import jax.numpy as jnp

    pm, jm = _meshes(div=(1, 1, 1))
    R1 = _neumann_R(pm, _ones(np), 1.0, ("ymax_sides",))[0]
    R2 = _neumann_R(pm, _ones(np), 2.0, ("ymax_sides",))[0]
    np.testing.assert_allclose(R2, 2.0 * R1, rtol=1e-13)
    return R2, _jax_neumann_R(jm, _ones(jnp), 2.0, ("ymax_sides",))


def _unit_face_areas():
    """Every boundary face's side measures sum to its area, on hexes and
    on the tet split of a 2 x 1 x 0.5 box."""
    lengths = (2.0, 1.0, 0.5)
    for tets in (False, True):
        pm, jm = _meshes(lengths, (2, 2, 1), tets)
        for axis, name in enumerate("xyz"):
            area = np.prod(lengths) / lengths[axis]
            for end in ("min", "max"):
                _, arrays = _neumann_R(pm, [1.0, 0.0, 0.0],
                                       sidesets=(f"{name}{end}_sides",))
                total = sum(float((g["dA"] * g["side_w"]).sum())
                            for g in arrays.groups[0].values())
                np.testing.assert_allclose(total, area, rtol=1e-13)
    return (_neumann_R(pm, [1.0, 2.0, 3.0], sidesets=("zmax_sides",))[0],
            _jax_neumann_R(jm, [1.0, 2.0, 3.0], sidesets=("zmax_sides",)))


UNITS = {"constant-traction-hex": _unit_constant_hex,
         "constant-traction-tet": _unit_constant_tet,
         "linear-traction-moment": _unit_linear_moment,
         "scales-with-t": _unit_scales_with_t,
         "side-measures-sum-to-face-areas": _unit_face_areas}


@pytest.mark.parametrize("case", list(UNITS))
def test_neumann_units(case):
    """The closed form of each case, and the port's R vector against
    cmad_tpu's ``assemble_side_neumann``."""
    R, R_jax = UNITS[case]()
    assert R.shape == R_jax.shape
    assert np.abs(R - R_jax).max() <= 1e-14


# ------------------------------------------------------------------ depth


def _resolve_both(nbc_args, mesh_div=(2, 2, 2), fe=None):
    """``resolve_neumann_bcs`` of both packages on a structured cube with
    the NBC ``(sidesets, field, values)``: (port result or exception,
    cmad_tpu's)."""
    from cmad_tpu.fem.bcs import NeumannBC as JaxNeumannBC
    from cmad_tpu.fem.neumann import resolve_neumann_bcs as jax_resolve

    pm, jm = _meshes(div=mesh_div)
    if fe is None:
        dof, jdof = _dof_map(pm), _jax_dof_map(jm)
    else:
        dof, jdof = (build_dof_map(m, [layout], [], {fe[2]: 1})
                     for m, layout in ((pm, fe[0]), (jm, fe[1])))
    out = []
    for fn, cls, m, d in ((resolve_neumann_bcs, NeumannBC, pm, dof),
                          (jax_resolve, JaxNeumannBC, jm, jdof)):
        try:
            out.append(fn(m, d, [cls(*nbc_args)]))
        except Exception as e:                       # noqa: BLE001
            out.append(e)
    return out


def _groups(resolved):
    return {(int(f), s): ids.tolist()
            for (f, s), ids in resolved[0].elem_ids_by_side.items()}


def _depth_grouping():
    for sidesets, want in ((["zmax_sides"], {1: 4}),
                           (["zmax_sides", "xmax_sides"], {1: 4, 3: 4})):
        port, jax = _resolve_both((sidesets, "u", [0.0, 0.0, 1.0]))
        assert _groups(port) == _groups(jax)
        assert {s: len(v) for (_f, s), v in _groups(port).items()} == want
    pm, _ = _meshes()
    dof = _dof_map(pm)
    assert resolve_neumann_bcs(pm, dof, []) == []
    assert build_neumann_side_arrays(pm, dof, [],
                                     default_side_quadrature()) is None


def _error_case(nbc_args, exc, match, **kw):
    """Both packages raise ``exc`` with the same message, which names
    ``match``."""
    def run():
        port, jax = _resolve_both(nbc_args, **kw)
        assert isinstance(port, exc) and isinstance(jax, exc)
        assert str(port) == str(jax) and match in str(port)
    return run


def _non_vertex():
    from cmad_tpu.fem.dof import GlobalFieldLayout as JaxLayout
    from cmad_tpu.fem.elements import EntityType as JaxEntity
    from cmad_tpu.fem.elements import FiniteElement as JaxFE
    from cmad_tpu.fem.elements import hex_linear as jax_hex_linear

    cell = FiniteElement("DG0_HEX", ElementFamily.HEX_LINEAR,
                         {EntityType.CELL: 1}, hex_linear)
    jcell = JaxFE("DG0_HEX", ElementFamily.HEX_LINEAR, {JaxEntity.CELL: 1},
                  jax_hex_linear)
    return (GlobalFieldLayout("p", cell), JaxLayout("p", jcell), "p")


def _forcing_errors():
    """The forcing callables' build-time checks: a block index out of
    range and a probe of the wrong shape."""
    pm, _ = _meshes(div=(1, 1, 1))
    dof = _dof_map(pm)
    model = Elastic(parameters_from_numpy(
        {"elastic": {"E": E_MOD, "nu": NU}}, dtype=F64, device="cpu"))
    for forcing, match in (
            ({1: lambda c, t: np.zeros((c.shape[0], 3))}, "out of range"),
            ({0: lambda c, t: np.zeros((c.shape[0], 2))}, r"\(1, 3\)")):
        with pytest.raises(ValueError, match=match):
            build_fe_problem(pm, dof, SmallDispEquilibrium(ndims=3),
                             {"all": model}, forcing_fns_by_block_idx=forcing,
                             device="cpu")


def _slant_tet_face():
    """The tet split's zmax faces sum to the full square: its slanted
    interior faces never enter a boundary set, and the surface Jacobian
    is exact off the axes (a slanted tet face's measure is its area)."""
    pm, _ = _meshes(tets=True)
    dof = _dof_map(pm)
    resolved = resolve_neumann_bcs(pm, dof, [NeumannBC(["zmax_sides"], "u",
                                                        [0.0, 0.0, 1.0])])
    arrays = build_neumann_side_arrays(
        pm, dof, resolved, {ElementFamily.TET_LINEAR: tri_quadrature(2)})
    total = sum(float((g["dA"] * g["side_w"]).sum())
                for g in arrays.groups[0].values())
    np.testing.assert_allclose(total, 1.0, rtol=1e-14)
    # the slanted face of the reference tet (side 1) has area sqrt(3)/2:
    # the lifted tangents' cross product has that length times 2
    _origin, tangents = ref_side_lift(ElementFamily.TET_LINEAR, 1)
    np.testing.assert_allclose(
        np.linalg.norm(np.cross(tangents[:, 0], tangents[:, 1])) / 2,
        np.sqrt(3.0) / 2.0, rtol=1e-15)
    # and the hex side rule's IPs lie on the face
    pm, _ = _meshes()
    dof = _dof_map(pm)
    resolved = resolve_neumann_bcs(pm, dof, [NeumannBC(["xmax_sides"], "u",
                                                        [1.0, 0.0, 0.0])])
    arrays = build_neumann_side_arrays(
        pm, dof, resolved, {ElementFamily.HEX_LINEAR: quad_quadrature(2)})
    np.testing.assert_array_equal(arrays.coords[0][:, 0], 1.0)


DEPTH = {"grouping": _depth_grouping,
         "unknown-field": _error_case(
             (["zmax_sides"], "v", [1.0]), ValueError, "unknown"),
         "unknown-sideset": _error_case(
             (["nope"], "u", [1.0, 0.0, 0.0]), ValueError, "nope"),
         "values-shape": _error_case(
             (["zmax_sides"], "u", [1.0]), ValueError, "shape"),
         "non-vertex-fe": _error_case(
             (["zmax_sides"], "p", [1.0]), NotImplementedError, "VERTEX",
             mesh_div=(1, 1, 1), fe=_non_vertex()),
         "forcing-checks": _forcing_errors,
         "slant-tet-face": _slant_tet_face}


@pytest.mark.parametrize("case", list(DEPTH))
def test_neumann_depth(case):
    DEPTH[case]()


# ----------------------------------------------------------------- meshes


@pytest.mark.parametrize("lengths, div, origin, tets", [
    ((1.0, 1.0, 1.0), (1, 1, 1), (0.0, 0.0, 0.0), False),
    ((2.0, 1.0, 0.5), (3, 2, 4), (-1.0, 0.5, 2.0), False),
    ((1.0, 1.0, 1.0), (2, 3, 2), (0.0, 0.0, 0.0), True)],
    ids=["one-hex", "box", "tets"])
def test_meshes_match_cmad_tpu_bit_for_bit(lengths, div, origin, tets):
    from cmad_tpu.fem.mesh import StructuredHexMesh as JaxHexMesh
    from cmad_tpu.fem.mesh import hex_to_tet_split as jax_split

    port = StructuredHexMesh(lengths, div, origin)
    jax = JaxHexMesh(lengths, div, origin)
    if tets:
        port, jax = hex_to_tet_split(port), jax_split(jax)
    assert port.element_family == jax.element_family
    for name in ("nodes", "connectivity", "edges", "element_edges", "faces",
                 "element_faces"):
        a, b = getattr(port, name), getattr(jax, name)
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for name in ("element_blocks", "node_sets", "side_sets"):
        a, b = getattr(port, name), getattr(jax, name)
        assert list(a) == list(b)
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


# -------------------------------------------------------------------- MMS


def _mms_expressions():
    """u_exact, its exact traction on x = 1 and the body force -div sigma
    (cmad_tpu's ``test_mms_cube_neumann``), as deck strings times t."""
    x, y, z = sp.symbols("x y z")
    s = 0.01
    u = sp.Matrix([
        s * sp.sin(sp.pi * x) * sp.sin(sp.pi * y) * sp.sin(sp.pi * z),
        s * sp.cos(sp.pi * x) * sp.sin(sp.pi * y) * sp.sin(sp.pi * z),
        s * sp.sin(sp.pi * x) * sp.cos(sp.pi * y) * sp.sin(sp.pi * z)])
    coords = (x, y, z)
    grad_u = u.jacobian(coords)
    eps = (grad_u + grad_u.T) / 2
    lam = E_MOD * NU / ((1 + NU) * (1 - 2 * NU))
    mu = E_MOD / (2 * (1 + NU))
    sigma = lam * eps.trace() * sp.eye(3) + 2 * mu * eps
    traction = (sigma @ sp.Matrix([1, 0, 0])).subs(x, 1)
    body = -sp.Matrix([sum(sp.diff(sigma[i, j], coords[j])
                           for j in range(3)) for i in range(3)])
    return ([f"t * ({e})" for e in u], [f"t * ({e})" for e in traction],
            [f"t * ({e})" for e in body],
            sp.lambdify(coords, list(u), modules="numpy"),
            sp.lambdify(coords, grad_u.tolist(), modules="numpy"))


def _mms_deck(mesh_file):
    u, traction, body, _u, _g = _mms_expressions()
    dirichlet = {f"u{c}_{side}": ["equilibrium", c, side, u[c]]
                 for side in ("xmin_sides", "ymin_sides", "ymax_sides",
                              "zmin_sides", "zmax_sides")
                 for c in range(3)}
    return {
        "problem": {"type": "fe", "name": "mms_neumann"},
        "discretization": {"mesh file": str(mesh_file), "num steps": 1,
                           "step size": 1.0},
        "residuals": {
            "global residual": {"type": "small_disp_equilibrium",
                                "def_type": "full_3d", "driver": "stepped",
                                "nonlinear absolute tol": NEWTON_TOL,
                                "nonlinear relative tol": NEWTON_TOL},
            "local residual": {"type": "elastic", "materials": {"all": {
                "elastic": {"E": E_MOD, "nu": NU}}}}},
        "dirichlet bcs": {"expression": dirichlet},
        "surface flux bcs": {"expression": {
            "exact": ["equilibrium", "xmax_sides", *traction]}},
        "body forces": {"expression": {"exact": ["equilibrium", *body]}},
        "linear solver": {"type": "direct"},
    }


def _write_mesh(path, mesh):
    ExodusWriter(path, mesh).close()
    return path


def _jax_bundle(deck, tmp, subcommand="primal"):
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck as jax_bf

    path = tmp / f"{subcommand}.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    return jax_bf(path, subcommand)


def _jax_drive(bundle):
    from cmad_tpu.cli.fe_subcommands import _nls_settings
    from cmad_tpu.fem.driver import fe_quasistatic_drive_stepped

    return fe_quasistatic_drive_stepped(
        bundle.fe_problem, bundle.t_schedule.tolist(),
        nonlinear_solver_settings=_nls_settings(bundle),
        linear_solver_settings=bundle.resolved["linear solver"])[0]


def _port(deck):
    return build_fe_problem_from_deck(copy.deepcopy(deck), dtype=F64,
                                      device="cpu")


def _mms_errors(bundle, state):
    """Quadrature L2 and H1-seminorm errors of the last step."""
    _u, _t, _b, u_fn, grad_fn = _mms_expressions()
    fe = bundle.fe_problem
    geom = fe.kernel_arrays.geometry_cache["all"]
    U_e = torch.as_tensor(state.U_at(1))[
        fe.kernel_arrays.u_gather_eq_by_block["all"][0]].numpy()
    N = geom["shared"]["N"][0].numpy()
    gradN = geom["per_elem"]["grad_N_phys"][0].numpy()
    dv = (geom["per_elem"]["iso_jac_det"] * geom["shared"]["quad_w"]).numpy()
    c = geom["per_elem"]["coords_ip"].numpy()
    u_h = np.einsum("pa,eak->epk", N, U_e)
    g_h = np.einsum("eak,epaj->epkj", U_e, gradN)
    x, y, z = c[..., 0], c[..., 1], c[..., 2]
    u_ex = np.stack(np.broadcast_arrays(*u_fn(x, y, z)), axis=-1)
    g_ex = np.stack([np.stack(np.broadcast_arrays(*row), axis=-1)
                     for row in grad_fn(x, y, z)], axis=-2)
    return (float(np.sqrt((((u_h - u_ex) ** 2).sum(-1) * dv).sum())),
            float(np.sqrt((((g_h - g_ex) ** 2).sum((-2, -1)) * dv).sum())))


@pytest.fixture(scope="module")
def mms(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mms_neumann")
    out = {}
    for n in (3, 6):
        deck = _mms_deck(_write_mesh(tmp / f"cube{n}.exo", StructuredHexMesh(
            (1.0, 1.0, 1.0), (n, n, n))))
        bundle = _port(deck)
        state, _ = fe_primal_drive(bundle)
        out[n] = (bundle, state, deck)
    out["jax"] = _jax_drive(_jax_bundle(out[3][2], tmp))
    return out


def test_mms_neumann_matches_cmad_tpu(mms):
    U = mms[3][1].U_at(1)
    U_jax = np.asarray(mms["jax"].U_at(1))
    assert np.abs(U).max() > 1e-3
    assert np.abs(U - U_jax).max() <= DRIVE_RTOL * np.abs(U_jax).max()


def test_mms_neumann_convergence_rates(mms):
    (l2_3, h1_3), (l2_6, h1_6) = (_mms_errors(*mms[n][:2]) for n in (3, 6))
    assert np.log2(l2_3 / l2_6) > 1.9, (l2_3, l2_6)
    assert np.log2(h1_3 / h1_6) > 0.9, (h1_3, h1_6)


# ---------------------------------------------------- blocks with loads


def _loaded_deck(mesh_file, effective_stress=J2, Y=200.0, num_steps=3,
                 **local):
    """A cube pinned on its three min faces and loaded by a traction on
    xmax (varying in y) and a body force: sigma_xx runs from 120 t to 240
    t across the cube, so the last step (t = 1) yields where x > 2/3 and
    the first two stay elastic."""
    return {
        "problem": {"type": "fe", "name": "loaded"},
        "discretization": {"mesh file": str(mesh_file),
                           "num steps": num_steps,
                           "step size": 1.0 / num_steps,
                           "quadrature": {"surface degree": 3}},
        "residuals": {
            "global residual": {"type": "small_disp_equilibrium",
                                "def_type": "full_3d", "driver": "stepped",
                                "nonlinear max iters": 30,
                                "nonlinear absolute tol": NEWTON_TOL,
                                "nonlinear relative tol": NEWTON_TOL},
            "local residual": {
                "type": "small_elastic_plastic",
                "nonlinear max iters": 500,
                "nonlinear absolute tol": 1e-12,
                "nonlinear relative tol": 1e-12,
                "line search": {"max evals": 100},
                **local,
                "materials": {"all": {
                    "elastic": {"E": {"value": 200e3},
                                "nu": {"value": 0.3}},
                    "plastic": {
                        "effective stress": effective_stress,
                        "flow stress": {
                            "initial yield": {"Y": {"value": Y}},
                            "hardening": {"voce": {
                                "S": {"value": 200.0},
                                "D": {"value": 20.0}}}}}}}}},
        "dirichlet bcs": {"expression": {
            "pin_x": ["equilibrium", 0, "xmin_sides", "0.0"],
            "pin_y": ["equilibrium", 1, "ymin_sides", "0.0"],
            "pin_z": ["equilibrium", 2, "zmin_sides", "0.0"]}},
        "surface flux bcs": {"expression": {
            "pull": ["equilibrium", "xmax_sides", "240 * t", "10 * t * y",
                     0.0]}},
        "body forces": {"expression": {
            "drag": ["equilibrium", "-120 * t", "-20 * t", "0.0"]}},
        "linear solver": {"type": "direct"},
    }


class JaxDenseDrive:
    """cmad_tpu's ``assemble_global`` (its loads included) jitted once,
    under a dense Newton with the stepped driver's stopping rule and a
    backtracking search on ||R||: cmad_tpu's trajectory without compiling
    its whole drive."""

    def __init__(self, bundle):
        import jax
        import jax.numpy as jnp

        from cmad_tpu.fem.assembly import assemble_global as jax_assemble
        from cmad_tpu.fem.assembly import params_by_block_from_models
        from cmad_tpu.fem.dof import build_dbc_arrays

        fe = self.fe = bundle.fe_problem
        self.ts = bundle.t_schedule.tolist()
        params = params_by_block_from_models(fe)

        def assemble(U, U_prev, t, xi_prev):
            K, R, xi = jax_assemble(fe, fe.kernel_arrays, params, U, U_prev,
                                    t, xi_prev)
            return K.todense(), R, xi

        self.assemble = jax.jit(assemble)
        self.jnp = jnp
        dm = fe.dof_map
        self.n = dm.num_total_dofs
        self.presc = np.asarray(dm.prescribed_indices)
        self.free = np.setdiff1d(np.arange(self.n), self.presc)
        self.dbc = build_dbc_arrays(dm)

    def drive(self):
        from cmad_tpu.fem.fe_problem import FEState as JaxState

        jnp = self.jnp
        U = np.zeros(self.n)
        xi = {b: np.asarray(v[0]) for b, v in
              JaxState.from_problem(self.fe).xi_history_by_block.items()}
        hist = [(U, xi)]
        for t in self.ts[1:]:
            U_prev, xi_prev = U, xi
            U = U_prev.copy()
            U[self.presc] = np.asarray(
                self.fe.dof_map.evaluate_prescribed_values(self.dbc, t))
            f = self.free
            xi_j = {b: jnp.asarray(v) for b, v in xi_prev.items()}

            def at(U, xi_j=xi_j, U_prev=U_prev, t=t):
                K, R, xi = self.assemble(jnp.asarray(U), jnp.asarray(U_prev),
                                         t, xi_j)
                R = np.asarray(R)
                return K, R, xi, float(np.linalg.norm(R[f]))

            K, R, xi, norm = at(U)
            norm0 = norm
            for _ in range(30):
                if norm < NEWTON_TOL or norm < NEWTON_TOL * norm0:
                    break
                dU = np.linalg.solve(np.asarray(K)[np.ix_(f, f)], R[f])
                # halve the step until ||R|| drops (a traction-loaded
                # plastic step overshoots from the elastic guess)
                for k in range(20):
                    trial = U.copy()
                    trial[f] -= 0.5 ** k * dU
                    K_t, R_t, xi_t, norm_t = at(trial)
                    if norm_t < norm:
                        break
                U, K, R, xi, norm = trial, K_t, R_t, xi_t, norm_t
            hist.append((U, {b: np.asarray(v) for b, v in xi.items()}))
        return hist


def _rel(a, b) -> float:
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / np.abs(np.asarray(b)).max())


def _check_trajectory(state, hist):
    """U and xi per step against cmad_tpu's (xi to the scale of its
    whole history: the elastic steps' plastic strains are round-off); the
    last step plastic."""
    assert len(state.U_history) == len(hist)
    xi_scale = max(np.abs(xi["all"]).max() for _U, xi in hist)
    for k, (U_jax, xi_jax) in enumerate(hist[1:], start=1):
        assert _rel(state.U_at(k), U_jax) <= DRIVE_RTOL
        assert np.abs(state.xi_at(k, "all") - xi_jax["all"]).max() \
            <= DRIVE_RTOL * xi_scale
    assert state.xi_at(len(hist) - 1, "all")[..., 6].max() > 0.0


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    """The loaded J2 cube (8 hexes) through both packages' stepped
    drives."""
    tmp = tmp_path_factory.mktemp("loaded_cube")
    mesh = _write_mesh(tmp / "cube.exo",
                       StructuredHexMesh((1.0, 1.0, 1.0), (2, 2, 2)))
    deck = _loaded_deck(mesh)
    port = _port(deck)
    state, log = fe_primal_drive(port)
    return {"tmp": tmp, "mesh": mesh, "deck": deck, "port": port,
            "state": state, "log": log,
            "jax": _jax_drive(_jax_bundle(deck, tmp))}


def test_j2_block_with_loads_matches_cmad_tpu(cube):
    fe = cube["port"].fe_problem
    assert "xi_carrier" in fe.evaluators_by_block["all"]     # the J2 block
    jax = cube["jax"]
    alpha = cube["state"].xi_at(3, "all")[..., 6]
    assert 0.0 < (alpha > 0).mean() < 1.0              # partly plastic
    assert np.all(cube["state"].xi_at(2, "all")[..., 6] == 0.0)
    _check_trajectory(cube["state"], [
        (jax.U_at(k), {"all": jax.xi_at(k, "all")})
        for k in range(len(jax.U_history))])


@pytest.mark.parametrize("kind", ["point-batch-hosford",
                                  "generic-coupled-printing"])
def test_blocks_with_loads_on_one_hex_match_cmad_tpu(cube, kind):
    tmp = cube["tmp"]
    mesh = _write_mesh(tmp / "one.exo",
                       StructuredHexMesh((1.0, 1.0, 1.0), (1, 1, 1)))
    # one hex's IPs sit at x = 0.21 and 0.79, short of the peak stress:
    # a lower yield makes its last step plastic
    if kind == "point-batch-hosford":
        deck = _loaded_deck(mesh, HOSFORD, Y=150.0)
    else:
        deck = _loaded_deck(mesh, Y=150.0, **{"print convergence": True})
    port = _port(deck)
    ev = port.fe_problem.evaluators_by_block["all"]
    assert "local_solve" in ev and "xi_carrier" not in ev
    jax_bundle = _jax_bundle(deck, tmp)
    with contextlib.redirect_stdout(io.StringIO()) as printed:
        state, _ = fe_primal_drive(port)
        hist = JaxDenseDrive(jax_bundle).drive()
    if kind != "point-batch-hosford":
        assert "abs ||C|| =" in printed.getvalue()
    _check_trajectory(state, hist)


def test_loaded_deck_primal_command_matches_cmad_tpu(cube, tmp_path):
    """``python -m cmad_tpu_torch primal`` on the loaded deck (with
    ``quadrature: surface degree``) writes cmad_tpu's U."""
    deck = copy.deepcopy(cube["deck"])
    deck["output"] = {"path": str(tmp_path / "out")}
    (tmp_path / "d.yaml").write_text(yaml.safe_dump(deck, sort_keys=False))
    argv = sys.argv
    sys.argv = ["cmad_tpu_torch", "primal", str(tmp_path / "d.yaml"),
                "--device", "cpu"]
    try:
        with pytest.raises(SystemExit) as done:
            runpy.run_module("cmad_tpu_torch", run_name="__main__")
    finally:
        sys.argv = argv
    assert done.value.code == 0
    res = read_results(tmp_path / "out" / "loaded.exo",
                       nodal_field_specs=[FieldSpec("u", VarType.VECTOR)])
    jax = cube["jax"]
    assert len(res.times) == len(jax.U_history)
    for k in range(1, len(jax.U_history)):
        assert _rel(res.nodal["u"][k],
                    np.asarray(jax.U_at(k)).reshape(-1, 3)) <= DRIVE_RTOL


# ------------------------------------------------- gradient and Hessian


def _sensitivity_deck(mesh, data_file, Y, transform=True):
    deck = _loaded_deck(mesh, Y=Y)
    fs = deck["residuals"]["local residual"]["materials"]["all"]["plastic"][
        "flow stress"]
    fs["initial yield"]["Y"]["active"] = True
    if transform:
        fs["initial yield"]["Y"]["transform"] = {"log": 200.0}
    fs["hardening"]["voce"]["S"]["active"] = True
    deck["qoi"] = {"name": "fe_displacement_match",
                   "data_file": str(data_file), "weight": 1.0e8}
    return deck


@pytest.fixture(scope="module")
def truth(cube):
    data = cube["tmp"] / "u_data.npy"
    U = np.stack(cube["state"].U_history)
    np.save(data, U.reshape(U.shape[0], -1, 3))
    return data


def test_gradient_with_loads_matches_cmad_tpu(cube, truth):
    from cmad_tpu.cli.fe_common import build_fe_stepped_vg as jax_vg

    deck = _sensitivity_deck(cube["mesh"], truth, 230.0)
    p0, s0, ts, vg = jax_vg(_jax_bundle(deck, cube["tmp"], "gradient"))
    J_ref, g_ref = vg(p0, s0, ts)
    q0, r0, qts, pvg = build_fe_stepped_vg(_port(deck))
    np.testing.assert_array_equal(q0.numpy(), np.asarray(p0))
    J, g = pvg(q0, r0, qts)
    assert float(J_ref) > 0.0
    assert abs(float(J) - float(J_ref)) <= 1e-9 * float(J_ref)
    np.testing.assert_allclose(np.asarray(g), np.asarray(g_ref), rtol=1e-9)


def test_hessian_with_loads_matches_a_central_difference(cube, truth):
    """The stepped HVP re-solves each step's Newton with the loads: its
    Hessian in (Y, S) against the central difference of the port's own
    gradient."""
    bundle = _port(_sensitivity_deck(cube["mesh"], truth, 230.0,
                                     transform=False))
    p0, s0, ts, hess = build_fe_stepped_hessian_fn(bundle)
    H, asym = hess(p0, s0, ts)
    _q, _s, _t, vg = build_fe_stepped_vg(bundle)
    H = np.asarray(H)
    assert asym <= 1e-10 * np.abs(H).max()
    for i, h in enumerate((1e-2, 1e-2)):
        e = torch.zeros_like(p0)
        e[i] = h
        fd = (np.asarray(vg(p0 + e, s0, ts)[1])
              - np.asarray(vg(p0 - e, s0, ts)[1])) / (2 * h)
        np.testing.assert_allclose(H[:, i], fd, rtol=1e-6,
                                   atol=1e-6 * np.abs(H).max())


def test_loads_enter_every_assembly_once_per_time(cube):
    """The loads are evaluated once per time: the assembled R is R_int
    less the loads, the same tensors at every assembly of one time."""
    fe = cube["port"].fe_problem
    params = params_by_block_from_models(fe)
    n = fe.dof_map.num_total_dofs
    U = torch.zeros(n, dtype=F64)
    xi = {"all": torch.zeros((8, 8 * 8), dtype=F64)}
    _, R, _ = assemble_global(fe, fe.kernel_arrays, params, U, U, 1.0, xi)
    neumann = fe.load_cache["neumann"]
    body = fe.load_cache["body"]["all"]
    _, R2, _ = assemble_global(fe, fe.kernel_arrays, params, U, U, 1.0, xi)
    assert fe.load_cache["neumann"] is neumann
    assert fe.load_cache["body"]["all"] is body
    assert torch.equal(R, R2)
    # at U = 0 the internal force vanishes: R = -F_ext, and the loads'
    # totals are traction x area plus body force x volume
    totals = R.reshape(-1, 3).sum(0).numpy()
    np.testing.assert_allclose(totals, [-(240.0 - 120.0), -(5.0 - 20.0),
                                        0.0], atol=1e-12)
