"""FE-side output plan resolution + Exodus trajectory writer.

Port of ``cmad_tpu/io/fe_writers.py`` (parity: reference
``cmad/io/writers.py:189-496``, FE half). The output
selection is grouped by source: ``output["global residual"]`` selects GR
nodal fields; ``output["local residual"]`` selects per-block element
fields (state variables on COUPLED blocks + model-advertised derived
fields), IP-averaged to elements for Exodus. ``opt_params.yaml`` is written by
the package's own YAML emitter (``io/writers.dump_yaml``).
"""
from __future__ import annotations

import copy
import json
from collections.abc import Callable, Mapping
from dataclasses import dataclass
from functools import partial
from pathlib import Path
from typing import Any

import numpy as np

from cmad_tpu_torch.fem.fe_problem import FEProblem, FEState
from cmad_tpu_torch.fem.postprocess import (
    DERIVED_OUTPUT_REGISTRY,
    evaluate_state_var_at_ips,
)
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.io.exodus import ExodusWriter
from cmad_tpu_torch.io.results import (
    component_names,
    ip_average_to_element,
    to_exodus_storage,
)
from cmad_tpu_torch.io.writers import dump_yaml, rewrite_values
from cmad_tpu_torch.models.var_types import VarType


@dataclass(frozen=True)
class ResolvedNodalField:
    name: str
    var_type: VarType


@dataclass(frozen=True)
class ResolvedElementField:
    name: str
    var_type: VarType
    evaluator: Callable[[FEProblem, FEState, int, str], np.ndarray]


@dataclass(frozen=True)
class FEOutputPlan:
    nodal: list[ResolvedNodalField]
    element_by_block: dict[str, list[ResolvedElementField]]


def _element_catalog(fe_problem: FEProblem,
                     block: str) -> dict[str, ResolvedElementField]:
    model = fe_problem.models_by_block[block]
    catalog: dict[str, ResolvedElementField] = {}
    if fe_problem.modes_by_block[block] == GlobalResidualMode.COUPLED:
        for ridx, (name, var_type) in enumerate(
                model.state_output_fields()):
            catalog[name] = ResolvedElementField(
                name, var_type,
                partial(evaluate_state_var_at_ips, resid_idx=ridx))
    for name in model.derived_output_field_names():
        # a derived output may shadow a same-named state variable (the
        # COUPLED Elastic model's state IS its Cauchy stress): the
        # derived evaluator wins so 'cauchy' means the physical stress
        # uniformly across models
        derived = DERIVED_OUTPUT_REGISTRY.get(name)
        if derived is None:
            raise ValueError(
                f"block {block!r}: derived output {name!r} is not in "
                f"DERIVED_OUTPUT_REGISTRY "
                f"({sorted(DERIVED_OUTPUT_REGISTRY)})")
        catalog[name] = ResolvedElementField(name, derived.var_type,
                                             derived.evaluator)
    return catalog


def resolve_fe_output_plan(output_section: dict[str, Any],
                           fe_problem: FEProblem) -> FEOutputPlan:
    """Deck selection -> plan; omitted selections write the full
    advertised catalog; unknown names/blocks raise at build time."""
    gr = fe_problem.gr
    nodal_catalog = dict(gr.primary_output_fields())
    sel = output_section.get("global residual")
    names = list(nodal_catalog) if sel is None else list(sel)
    for name in names:
        if name not in nodal_catalog:
            raise ValueError(
                f"output.global residual: unknown field {name!r}; GR "
                f"exposes {sorted(nodal_catalog)}")
    nodal = [ResolvedNodalField(n, nodal_catalog[n]) for n in names]

    blocks = list(fe_problem.mesh.element_blocks)
    esel = output_section.get("local residual")
    if esel is not None:
        unknown = set(esel) - set(blocks)
        if unknown:
            raise ValueError(
                f"output.local residual: unknown block(s) "
                f"{sorted(unknown)}; mesh blocks: {sorted(blocks)}")

    element_by_block = {}
    for block in blocks:
        catalog = _element_catalog(fe_problem, block)
        if esel is None or block not in esel:
            chosen = list(catalog)
        else:
            for name in esel[block]:
                if name not in catalog:
                    raise ValueError(
                        f"output.local residual[{block!r}]: unknown field "
                        f"{name!r}; block exposes {sorted(catalog)}")
            chosen = list(esel[block])
        element_by_block[block] = [catalog[n] for n in chosen]
    return FEOutputPlan(nodal=nodal, element_by_block=element_by_block)


def write_fe_exodus(out_dir: Path, prefix: str, fe_problem: FEProblem,
                    fe_state: FEState, plan: FEOutputPlan,
                    filename: str) -> None:
    """Write the trajectory to one Exodus file per the resolved plan."""
    nodal_names = [c for f in plan.nodal
                   for c in component_names(f.name, f.var_type)]
    # per-block schema: the truth table records exactly which blocks
    # store each variable, so a block whose model lacks a field is not
    # padded with fill values
    element_schema = {
        block: [c for f in fields
                for c in component_names(f.name, f.var_type)]
        for block, fields in plan.element_by_block.items()}

    writer = ExodusWriter(out_dir / f"{prefix}{filename}",
                          fe_problem.mesh,
                          nodal_var_names=nodal_names,
                          element_var_names=element_schema)
    try:
        for step, t in enumerate(fe_state.t_history):
            nodal_values = {}
            for f in plan.nodal:
                vals = fe_problem.gr.evaluate_nodal_field(
                    f.name, fe_problem, fe_state, step)
                vals = to_exodus_storage(np.asarray(vals), f.var_type)
                for c_i, c in enumerate(
                        component_names(f.name, f.var_type)):
                    nodal_values[c] = vals[:, c_i]

            element_values: dict[str, dict[str, np.ndarray]] = {}
            for block, fields in plan.element_by_block.items():
                for f in fields:
                    per_ip = f.evaluator(fe_problem, fe_state, step, block)
                    per_elem = ip_average_to_element(
                        per_ip, fe_problem.geometry_cache, block)
                    per_elem = to_exodus_storage(
                        np.atleast_2d(per_elem), f.var_type)
                    for c_i, c in enumerate(
                            component_names(f.name, f.var_type)):
                        element_values.setdefault(c, {})[block] = \
                            per_elem[:, c_i]
            writer.write_step(t, nodal_values, element_values)
    finally:
        writer.close()


def write_fe_opt_params(out_dir: Path, prefix: str,
                        materials_section: dict[str, Any],
                        values_by_block: Mapping[str, Any]) -> None:
    """Per-block ``materials:`` subtree with optimized physical values."""
    out = copy.deepcopy(materials_section)
    for block, values in values_by_block.items():
        rewrite_values(out[block], values)
    (out_dir / f"{prefix}opt_params.yaml").write_text(dump_yaml(out))


def write_fe_active_params(out_dir: Path, prefix: str,
                           table: dict[str, float]) -> None:
    """Flat '<block>.<dotted path>' -> value table of the calibrated
    parameters."""
    with (out_dir / f"{prefix}active_params.json").open("w") as f:
        json.dump(table, f, indent=2)
