"""FE deck builder, the FE primal drive and the sensitivity builders.

Port of ``cmad_tpu/cli/fe_common.py`` (parity: reference
``cmad/cli/common.py:149-785``, FE half): deck -> mesh -> GR -> per-block
models -> Dirichlet BCs -> GlobalDofMap -> surface fluxes and body forces
-> FEProblem + time schedule + QoI, on the card unless the caller asks
for the CPU; the load cases
(:func:`build_fe_cases`); the parameter overlay
(:func:`fe_params_overlay`); the scan driver's ``J(params_flat)``
(:func:`build_fe_J_of_params_flat`, whose gradient and Hessian are
autograd's); the stepped value-and-gradient of every load case
(:func:`build_fe_stepped_vg`) and the stepped Hessian
(:func:`build_fe_stepped_hessian_fn`); the primal drive of the deck's
driver (:func:`fe_primal_drive`).

:func:`build_fe_problem_from_deck` takes a deck path or an
already-loaded deck dict. A dict needs neither PyYAML nor jsonschema and
is not validated; a path needs both (imported when the deck is read and
validated against the schema of its subcommand).
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch import config
from cmad_tpu_torch.cli.common import with_material_defaults
from cmad_tpu_torch.fem.bcs import DirichletBC, NeumannBC
from cmad_tpu_torch.fem.dof import GlobalFieldLayout, build_dof_map
from cmad_tpu_torch.fem.elements import P1_TET, Q1_HEX, FiniteElement
from cmad_tpu_torch.fem.fe_problem import (
    FEProblem,
    FEState,
    build_fe_problem,
)
from cmad_tpu_torch.fem.mesh import coordinate_side_sets
from cmad_tpu_torch.fem.quadrature import (
    hex_quadrature,
    quad_quadrature,
    tet_quadrature,
    tri_quadrature,
)
from cmad_tpu_torch.fem.topology import ElementFamily
from cmad_tpu_torch.global_residuals.global_residual import GlobalResidual
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.io.deck import apply_deck_defaults, load_deck
from cmad_tpu_torch.io.expressions import parse_scalar_expression
from cmad_tpu_torch.io.mesh_io import read_mesh_file
from cmad_tpu_torch.io.params_builder import build_parameters
from cmad_tpu_torch.io.registry import (
    resolve_global_residual,
    resolve_model,
    resolve_qoi,
)
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.model import Model

_DEFAULT_FE = {ElementFamily.HEX_LINEAR: Q1_HEX,
               ElementFamily.TET_LINEAR: P1_TET}
_FE_BY_NAME = {"Q1": Q1_HEX, "Q1_HEX": Q1_HEX,
               "P1": P1_TET, "P1_TET": P1_TET}
_COORD_NAMES = ("x", "y", "z", "t")
_RULES = {("volume", ElementFamily.HEX_LINEAR): hex_quadrature,
          ("volume", ElementFamily.TET_LINEAR): tet_quadrature,
          ("surface", ElementFamily.HEX_LINEAR): quad_quadrature,
          ("surface", ElementFamily.TET_LINEAR): tri_quadrature}


@dataclass(frozen=True)
class FEProblemBundle:
    resolved: dict[str, Any]
    fe_problem: FEProblem
    t_schedule: np.ndarray
    qoi: Any = None


def build_fe_problem_from_deck(
        deck: Path | str | dict[str, Any], subcommand: str | None = None,
        *, dtype: torch.dtype = config.DEFAULT_DTYPE,
        device: torch.device | str = config.DEFAULT_DEVICE
) -> FEProblemBundle:
    """The FE problem of a deck (a path, or the deck as a dict), with its
    QoI when the deck has a ``qoi`` section, on ``device`` in ``dtype``;
    the default device is the card, and without one this raises. A deck
    read from a path is validated against the schema of ``subcommand``
    (by default ``calibrate`` for a deck with an ``optimizer``,
    ``gradient`` for one with a ``qoi``, else ``primal``)."""
    device = config.checked_device(device)
    if isinstance(deck, dict):
        resolved = apply_deck_defaults(deck)
    else:
        from cmad_tpu_torch.io.schema import validate_deck

        resolved = apply_deck_defaults(load_deck(Path(deck)))
        validate_deck(resolved, subcommand or _default_subcommand(resolved))
    disc = resolved["discretization"]

    mesh = read_mesh_file(Path(disc["mesh file"]))
    if disc.get("build coordinate sidesets", False):
        built = coordinate_side_sets(mesh)
        clash = sorted(set(built) & set(mesh.side_sets))
        if clash:
            raise ValueError(
                f"build coordinate sidesets would redefine existing side "
                f"set(s): {clash}")
        mesh = replace(mesh, side_sets={**mesh.side_sets, **built})
    ndims = int(mesh.nodes.shape[1])

    gr_section = resolved["residuals"]["global residual"]
    gr = resolve_global_residual(gr_section["type"]).from_deck(
        gr_section, ndims=ndims)

    def_type = DefType[gr_section["def_type"].upper()]
    local_section = resolved["residuals"]["local residual"]
    models_by_block = _build_models(local_section, mesh, def_type, dtype,
                                    device)
    modes_by_block = {
        b: (GlobalResidualMode.CLOSED_FORM
            if m.supports_closed_form_cauchy
            else GlobalResidualMode.COUPLED)
        for b, m in models_by_block.items()}

    layouts = _build_field_layouts(disc, gr, mesh.element_family)
    components = {str(gr.var_names[r]): int(gr._num_eqs[r])
                  for r in range(gr.num_residuals)}
    dirichlet = _build_dirichlet_bcs(resolved.get("dirichlet bcs"), gr)
    dof_map = build_dof_map(mesh, layouts, dirichlet, components)
    neumann = _build_neumann_bcs(resolved.get("surface flux bcs"), gr)
    forcing = _build_forcing_fns(resolved.get("body forces"), gr)
    assembly_quad, side_quad = _quadrature_overrides(disc,
                                                     mesh.element_family)

    abs_tol, rel_tol = _deck_tols(local_section, "fe_local", dtype)
    fe_problem = build_fe_problem(
        mesh=mesh, dof_map=dof_map, gr=gr,
        models_by_block=models_by_block, modes_by_block=modes_by_block,
        forcing_fns_by_block_idx=forcing or None,
        assembly_quadrature=assembly_quad, neumann_bcs=neumann,
        side_quadrature=side_quad,
        print_local_convergence=bool(
            local_section.get("print convergence", False)),
        local_newton_settings={
            "max_iters": int(local_section["nonlinear max iters"]),
            "abs_tol": abs_tol, "rel_tol": rel_tol,
            "line_search_settings": local_section.get("line search", {}),
        }, dtype=dtype, device=device)

    t_schedule = _load_t_schedule(disc)
    qoi = None
    if "qoi" in resolved:
        qoi_cls = resolve_qoi(resolved["qoi"]["name"])
        if qoi_cls.problem_type != "fe":
            raise ValueError(
                f"qoi {resolved['qoi']['name']!r} is registered for "
                f"problem_type={qoi_cls.problem_type!r}, not 'fe'")
        qoi = qoi_cls.from_deck(resolved["qoi"], fe_problem,
                                t_schedule.tolist())
    return FEProblemBundle(resolved=resolved, fe_problem=fe_problem,
                           t_schedule=t_schedule, qoi=qoi)


def nonlinear_settings(bundle: FEProblemBundle) -> dict[str, Any]:
    """The global Newton's settings from the deck's ``global residual``
    section (the JAX package's ``cli/fe_subcommands._nls_settings``)."""
    gr = bundle.resolved["residuals"]["global residual"]
    abs_tol, rel_tol = _deck_tols(gr, "fe_global", bundle.fe_problem.dtype)
    return {"max iters": int(gr["nonlinear max iters"]),
            "abs tol": abs_tol, "rel tol": rel_tol,
            "print convergence": bool(gr.get("print convergence", False)),
            "line search": gr.get("line search", {})}


def fe_primal_drive(bundle: FEProblemBundle, stats: list | None = None,
                    t_schedule=None, U_init=None, xi_init_by_block=None
                    ) -> tuple[FEState, list[dict[str, float]]]:
    """The deck's quasi-static primal drive, ``(FEState, solver_log)``:
    what ``cmad primal`` computes before it writes. ``stepped`` and
    ``scan`` (the default) both run :func:`fe_quasistatic_drive_stepped`
    (``stats`` receives one dict per step): without an autograd tape the
    scan trajectory is the same Newton per step, with the same bits, and
    the stepped loop also records each step's true residual pair.
    ``t_schedule`` (default: the deck's) and the initial state resume a
    restart. The ``host`` driver raises (ROADMAP queue 1, item 18)."""
    from cmad_tpu_torch.fem.driver import fe_quasistatic_drive_stepped

    gr = bundle.resolved["residuals"]["global residual"]
    fe_driver(bundle)
    ts = bundle.t_schedule.tolist() if t_schedule is None \
        else [float(t) for t in t_schedule]
    return fe_quasistatic_drive_stepped(
        bundle.fe_problem, ts, nonlinear_solver_settings=nonlinear_settings(
            bundle),
        linear_solver_settings=bundle.resolved["linear solver"],
        U_init=U_init, xi_init_by_block=xi_init_by_block,
        max_iters_per_dispatch=gr.get("max iters per dispatch"),
        steps_per_dispatch=gr.get("steps per dispatch"), stats=stats)


def fe_driver(bundle: FEProblemBundle) -> str:
    """The deck's driver, ``scan`` (the default) or ``stepped``; the host
    driver is not ported and raises."""
    driver = bundle.resolved["residuals"]["global residual"].get(
        "driver", "scan")
    if driver == "host":
        raise NotImplementedError(
            "driver 'host' (the host-loop Newton, fe_newton_solve_host) is "
            "not ported yet: ROADMAP queue 1, item 18; use 'scan' or "
            "'stepped'")
    if driver not in ("scan", "stepped"):
        raise ValueError(f"unknown driver {driver!r}; expected 'scan', "
                         "'stepped' or 'host'")
    return driver


def build_fe_cases(bundle: FEProblemBundle):
    """``[(name, weight, t_schedule, qoi)]``: one entry per ``load cases``
    deck entry, or the single base case when the section is absent.

    A load case re-drives the same FEProblem through its own schedule
    (``num steps`` / ``step size`` over the deck's) against its own QoI
    (its ``qoi`` shallow-merged over the deck's), each from the virgin
    state; the objectives add up, times each case's ``weight``."""
    resolved = bundle.resolved
    cases = resolved.get("load cases")
    if not cases:
        return [("base", 1.0, bundle.t_schedule, bundle.qoi)]
    base_disc = resolved["discretization"]
    out = []
    seen: set[str] = set()
    for case in cases:
        name = case["name"]
        if name in seen:
            raise ValueError(f"load cases: duplicate case name {name!r}")
        seen.add(name)
        disc = dict(base_disc)
        for key in ("num steps", "step size"):
            if key in case:
                disc[key] = case[key]
        ts = _load_t_schedule(disc)
        qoi_section = {**resolved["qoi"], **(case.get("qoi") or {})}
        qoi = resolve_qoi(qoi_section["name"]).from_deck(
            qoi_section, bundle.fe_problem, ts.tolist())
        out.append((name, float(case.get("weight", 1.0)), ts, qoi))
    return out


def _state_init(bundle: FEProblemBundle):
    """``(U0, {block: xi0})`` of the virgin state, on the problem's
    device."""
    fe_problem = bundle.fe_problem
    state = FEState.from_problem(fe_problem,
                                 t_init=float(bundle.t_schedule[0]))
    dev, dtype = fe_problem.device, fe_problem.dtype
    return (torch.as_tensor(state.U_at(0), dtype=dtype, device=dev),
            {b: torch.as_tensor(state.xi_at(0, b), dtype=dtype, device=dev)
             for b in fe_problem.models_by_block})


def _checked_cases(bundle: FEProblemBundle):
    """:func:`build_fe_cases`, with every case's boundary values
    evaluated once at its step times (a bad expression fails here)."""
    if bundle.qoi is None:
        raise ValueError("bundle.qoi is required (non-primal subcommand)")
    fe_problem = bundle.fe_problem
    cases = build_fe_cases(bundle)
    dbc_arrays = fe_problem.kernel_arrays.dbc_arrays
    for _name, _w, ts_case, _qoi in cases:
        for t in ts_case[1:]:
            fe_problem.dof_map.evaluate_prescribed_values(dbc_arrays,
                                                          float(t))
    return cases


def build_fe_J_of_params_flat(bundle: FEProblemBundle):
    """``(params_flat_init, state_init, J_of_params_flat)`` for the scan
    driver: ``J_of_params_flat(params_flat, state_init)`` drives every
    load case from the virgin state over its own schedule with the FE
    Newton's rule on the autograd tape (``fem/driver.py
    build_fe_quasistatic_trajectory``) and returns the weighted sum of
    the cases' J as a tensor, so ``torch.autograd.grad`` gives the
    gradient and a double backward the Hessian in the canonical flat
    active vector."""
    from cmad_tpu_torch.fem.driver import build_fe_quasistatic_trajectory

    fe_problem = bundle.fe_problem
    cases = _checked_cases(bundle)
    params_flat_init, params_by_block_of_flat = fe_params_overlay(
        fe_problem)
    trajectory = build_fe_quasistatic_trajectory(
        fe_problem, nonlinear_solver_settings=nonlinear_settings(bundle),
        linear_solver_settings=bundle.resolved["linear solver"])
    fe_arrays = fe_problem.kernel_arrays

    def J_of_params_flat(params_flat, state_init):
        params_by_block = params_by_block_of_flat(params_flat)
        J = torch.zeros((), dtype=fe_problem.dtype, device=fe_problem.device)
        for _name, w, ts_case, qoi_c in cases:
            step = qoi_c.step_contribution(params_by_block, fe_arrays)
            _, _, J_c = trajectory(params_by_block, state_init,
                                   ts_case.tolist(),
                                   qoi_step_contribution=step)
            J = J + w * J_c
        return J

    return params_flat_init, _state_init(bundle), J_of_params_flat


def fe_params_overlay(fe_problem: FEProblem):
    """``(params_flat_init, params_by_block_of_flat)``: the canonical flat
    active-parameter vector over all blocks (each block's in turn) and the
    differentiable overlay that rebuilds the per-block parameter trees
    from it (the log and bounds transforms included, so a gradient is
    taken with respect to the canonical vector)."""
    dtype, dev = fe_problem.dtype, fe_problem.device
    block_names = list(fe_problem.models_by_block)
    inits, lengths = [], []
    for b in block_names:
        po = fe_problem.models_by_block[b].parameters
        flat = po.flat_active_values(return_canonical=True)
        inits.append(torch.as_tensor(flat, dtype=dtype, device=dev))
        lengths.append(int(flat.shape[0]))
    params_flat_init = (torch.cat(inits) if inits
                        else torch.zeros(0, dtype=dtype, device=dev))
    bounds = np.cumsum([0, *lengths])

    def params_by_block_of_flat(params_flat):
        return {b: fe_problem.models_by_block[b].parameters
                .tree_with_flat_active(params_flat[bounds[i]:bounds[i + 1]],
                                       canonical=True)
                for i, b in enumerate(block_names)}

    return params_flat_init, params_by_block_of_flat


def build_fe_stepped_vg(bundle: FEProblemBundle):
    """``(params_flat_init, state_init, t_schedule, vg)`` for the stepped
    sensitivity path (``fem/stepped_adjoint.py``): ``vg(params_flat,
    state_init, t_schedule, stats=None) -> (J, grad)``, the gradient with
    respect to the canonical flat active vector. With ``load cases`` the
    objective is their weighted sum, each case over its own schedule; the
    schedule passed in must then be the base one returned here (it raises
    otherwise, rather than drive the cases over a schedule they ignore)."""
    from cmad_tpu_torch.fem.stepped_adjoint import (
        build_fe_stepped_value_and_grad,
    )

    fe_problem = bundle.fe_problem
    gr_section = bundle.resolved["residuals"]["global residual"]
    if "max iters per dispatch" in gr_section:
        raise ValueError(
            "residuals.global residual: 'max iters per dispatch' "
            "applies to the stepped PRIMAL drive only; the stepped "
            "sensitivity path runs one Newton (+ its adjoint) per time "
            "step. Remove it for gradient/calibrate decks.")
    cases = _checked_cases(bundle)
    params_flat_init, params_by_block_of_flat = fe_params_overlay(
        fe_problem)
    case_vgs = [
        (w, ts_case, build_fe_stepped_value_and_grad(
            fe_problem, params_by_block_of_flat, qoi_c,
            nonlinear_solver_settings={**nonlinear_settings(bundle),
                                       "print convergence": False},
            linear_solver_settings=bundle.resolved["linear solver"],
            steps_per_dispatch=gr_section.get("steps per dispatch")))
        for _name, w, ts_case, qoi_c in cases]
    state_init = _state_init(bundle)
    if len(case_vgs) == 1:
        return params_flat_init, state_init, bundle.t_schedule, \
            case_vgs[0][2]
    base = np.asarray(bundle.t_schedule, dtype=np.float64)

    def vg_multi(params_flat, state_init, t_schedule, stats=None):
        """The weighted sum of the load cases' ``(J, grad)``, each case
        from the virgin state over its own schedule."""
        if not np.array_equal(np.asarray(t_schedule, dtype=np.float64),
                              base):
            raise ValueError(
                "load cases: each case drives its own schedule; pass the "
                "base schedule that build_fe_stepped_vg returned")
        J, grad = 0.0, None
        for w, ts_case, vg_c in case_vgs:
            J_c, g_c = vg_c(params_flat, state_init, ts_case, stats)
            J += w * J_c
            grad = w * g_c if grad is None else grad + w * g_c
        return J, grad

    return params_flat_init, state_init, bundle.t_schedule, vg_multi


def build_fe_stepped_hessian_fn(bundle: FEProblemBundle):
    """``(params_flat_init, state_init, t_schedule, hessian_fn)`` for the
    stepped Hessian (``fem/stepped_adjoint.py build_fe_stepped_hessian``):
    ``hessian_fn(params_flat, state_init, t_schedule, stats=None) -> (H,
    max_asym)``, the ``driver: stepped`` backend of ``cmad hessian``. The
    hessian schema takes no load cases."""
    from cmad_tpu_torch.fem.stepped_adjoint import build_fe_stepped_hessian

    gr_section = bundle.resolved["residuals"]["global residual"]
    for cap in ("max iters per dispatch", "steps per dispatch"):
        if cap in gr_section:
            raise ValueError(
                f"residuals.global residual: '{cap}' is not supported "
                "on the stepped HESSIAN path; each step is one tangent "
                f"and one reverse step. Remove '{cap}' for hessian decks.")
    if bundle.resolved.get("load cases"):
        raise ValueError("load cases are not part of the hessian "
                         "subcommand's deck")
    _checked_cases(bundle)
    fe_problem = bundle.fe_problem
    params_flat_init, params_by_block_of_flat = fe_params_overlay(
        fe_problem)
    hess = build_fe_stepped_hessian(
        fe_problem, params_by_block_of_flat, bundle.qoi,
        nonlinear_solver_settings={**nonlinear_settings(bundle),
                                   "print convergence": False},
        linear_solver_settings=bundle.resolved["linear solver"])
    return params_flat_init, _state_init(bundle), bundle.t_schedule, hess


# ----------------------------------------------------------------------
# deck-section helpers
# ----------------------------------------------------------------------
def _default_subcommand(resolved: dict[str, Any]) -> str:
    if "optimizer" in resolved:
        return "calibrate"
    return "gradient" if "qoi" in resolved else "primal"


def _deck_tols(section, kind: str, dtype: torch.dtype) -> tuple[float, float]:
    """The section's Newton tolerances (``config.clamp_newton_tols``)."""
    return config.clamp_newton_tols(
        float(section["nonlinear absolute tol"]),
        float(section["nonlinear relative tol"]), kind, dtype)


def _build_models(local_section, mesh, def_type, dtype,
                  device) -> dict[str, Model]:
    materials = local_section["materials"]
    if set(materials) != set(mesh.element_blocks):
        raise ValueError(
            f"materials keys {sorted(materials)} must match mesh blocks "
            f"{sorted(mesh.element_blocks)}")
    model_cls = resolve_model(local_section["type"])
    return {
        b: model_cls.from_deck(
            local_section,
            build_parameters(with_material_defaults(materials[b],
                                                    model_cls),
                             dtype=dtype, device=device),
            def_type)
        for b in materials}


def _build_field_layouts(disc, gr: GlobalResidual,
                         family: ElementFamily):
    overrides = disc.get("finite elements") or {}
    var_names = {str(gr.var_names[r]) for r in range(gr.num_residuals)}
    unknown = set(overrides) - var_names
    if unknown:
        raise ValueError(
            f"discretization.finite elements: unknown var_name(s) "
            f"{sorted(unknown)}; GR var_names: {sorted(var_names)}")
    layouts = []
    for r in range(gr.num_residuals):
        var = str(gr.var_names[r])
        fe = (_resolve_fe(overrides[var], family, var)
              if var in overrides else _DEFAULT_FE[family])
        layouts.append(GlobalFieldLayout(name=var, finite_element=fe))
    return layouts


def _resolve_fe(name: str, family: ElementFamily,
                var: str) -> FiniteElement:
    fe = _FE_BY_NAME.get(name)
    if fe is None:
        raise ValueError(
            f"finite elements[{var!r}]: unknown FE {name!r}; known: "
            f"{sorted(_FE_BY_NAME)}")
    if fe.element_family != family:
        raise ValueError(
            f"finite elements[{var!r}]: {name!r} is "
            f"{fe.element_family.name} but the mesh is {family.name}")
    return fe


def _quadrature_overrides(disc, family):
    """The deck's ``quadrature`` degrees as (volume rules, side rules),
    each None where the deck sets none."""
    quad = disc.get("quadrature") or {}
    vol, surf = quad.get("volume degree"), quad.get("surface degree")
    return ({family: _RULES[("volume", family)](int(vol))}
            if vol is not None else None,
            {family: _RULES[("surface", family)](int(surf))}
            if surf is not None else None)


def _resid_idx(resid_name: str, gr: GlobalResidual, where: str) -> int:
    try:
        return gr.resid_names.index(resid_name)
    except ValueError as e:
        raise ValueError(
            f"{where}: residual {resid_name!r} is not declared by the GR "
            f"(known: {gr.resid_names})") from e


def _build_dirichlet_bcs(section, gr: GlobalResidual):
    if not section:
        return []
    bcs = []
    for entry_name, entry in section.get("expression", {}).items():
        resid_name, eq, sideset, expr = entry
        where = f"dirichlet bcs.expression.{entry_name}"
        r = _resid_idx(resid_name, gr, where)
        if not 0 <= int(eq) < int(gr._num_eqs[r]):
            raise ValueError(
                f"{where}: eq {eq} out of range for {resid_name!r}")
        scalar = parse_scalar_expression(expr, _COORD_NAMES)

        def dbc_values(coords, t, scalar=scalar):
            n = coords.shape[0]
            val = np.asarray(scalar(x=coords[:, 0], y=coords[:, 1],
                                    z=coords[:, 2], t=t), dtype=np.float64)
            return np.broadcast_to(val, (n,)).reshape(n, 1)

        bcs.append(DirichletBC([str(sideset)], str(gr.var_names[r]),
                               [int(eq)], dbc_values))
    return bcs


def _component_fns(entry, gr: GlobalResidual, where: str):
    """(residual index, one parsed expression per component) of a ``surface
    flux bcs`` or ``body forces`` entry's residual and expressions."""
    resid_name, *exprs = entry
    r = _resid_idx(resid_name, gr, where)
    ncomp = int(gr._num_eqs[r])
    if len(exprs) != ncomp:
        raise ValueError(
            f"{where}: {resid_name!r} takes {ncomp} components; got "
            f"{len(exprs)}")
    return r, [parse_scalar_expression(e, _COORD_NAMES) for e in exprs]


def _at_points(fns, coords, t) -> np.ndarray:
    """``(n, ncomp)``: the component expressions at ``coords (n, 3)``."""
    n = coords.shape[0]
    return np.stack([np.broadcast_to(np.asarray(f(
        x=coords[:, 0], y=coords[:, 1], z=coords[:, 2], t=t),
        dtype=np.float64), (n,)) for f in fns], axis=-1)


def _build_neumann_bcs(section, gr: GlobalResidual):
    if not section:
        return []
    bcs = []
    for entry_name, entry in section.get("expression", {}).items():
        where = f"surface flux bcs.expression.{entry_name}"
        resid_name, sideset, *exprs = entry
        r, fns = _component_fns([resid_name, *exprs], gr, where)
        bcs.append(NeumannBC([str(sideset)], str(gr.var_names[r]),
                             partial(_at_points, fns)))
    return bcs


def _build_forcing_fns(section, gr: GlobalResidual):
    if not section:
        return {}
    out = {}
    for entry_name, entry in section.get("expression", {}).items():
        where = f"body forces.expression.{entry_name}"
        r, fns = _component_fns(entry, gr, where)
        if r in out:
            raise ValueError(
                f"{where}: residual {entry[0]!r} already has a "
                f"body-force entry")
        out[r] = partial(_at_points, fns)
    return out


def _load_t_schedule(disc) -> np.ndarray:
    if "times" in disc:
        return np.asarray(disc["times"], dtype=np.float64).ravel()
    if "times file" in disc:
        path = Path(disc["times file"])
        suffix = path.suffix.lower()
        if suffix == ".npy":
            return np.load(path).astype(np.float64).ravel()
        if suffix in (".txt", ".csv"):
            return np.loadtxt(path).astype(np.float64).ravel()
        raise ValueError(
            f"discretization.times file: unsupported extension "
            f"{suffix!r}")
    n = int(disc["num steps"])
    dt = float(disc["step size"])
    return np.arange(n + 1, dtype=np.float64) * dt
