"""Deck schema validation from composable YAML fragments.

Port of ``cmad_tpu/io/schema.py`` (parity: reference
``cmad/io/schema.py:45-263``). A (problem_type, subcommand) pair selects
required/optional sections; each section's JSON-Schema fragment loads
from ``cmad_tpu_torch/io/schemas/`` (the port's copy of the JAX
package's fragments, file for file, so both packages accept the same
decks); the registered model/QoI names stitch in their own fragments.
Errors are aggregated as ``path: reason`` lines.

``jsonschema`` and PyYAML are imported when a deck is validated, not
when this module is: a deck given as a dict (what runs where neither is
installed) is not validated.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any

from cmad_tpu_torch.io.deck import strip_calibr8_only, unwrap_top_level
from cmad_tpu_torch.io.registry import (
    registered_global_residual_names,
    registered_model_names,
    registered_qoi_names,
)

_SCHEMAS_DIR = Path(__file__).parent / "schemas"

# (problem_type, subcommand) -> (required_sections, optional_sections)
_SECTIONS: dict[tuple[str, str], tuple[list[str], list[str]]] = {
    ("material_point", "primal"): (
        ["problem", "model", "parameters", "deformation", "solver"],
        ["output"]),
    ("material_point", "objective"): (
        ["problem", "model", "parameters", "deformation", "qoi", "solver"],
        ["output"]),
    ("material_point", "gradient"): (
        ["problem", "model", "parameters", "deformation", "qoi",
         "sensitivity", "solver"],
        ["output"]),
    ("material_point", "hessian"): (
        ["problem", "model", "parameters", "deformation", "qoi",
         "sensitivity", "solver"],
        ["output"]),
    ("material_point", "calibrate"): (
        ["problem", "model", "parameters", "deformation", "qoi",
         "sensitivity", "solver", "optimizer"],
        ["output"]),
    ("fe", "primal"): (
        ["problem", "discretization", "residuals"],
        ["output", "dirichlet bcs", "surface flux bcs", "body forces",
         "linear solver", "qoi", "restart"]),
    ("fe", "objective"): (
        ["problem", "discretization", "residuals", "qoi"],
        ["output", "dirichlet bcs", "surface flux bcs", "body forces",
         "linear solver", "load cases"]),
    ("fe", "gradient"): (
        ["problem", "discretization", "residuals", "qoi"],
        ["output", "dirichlet bcs", "surface flux bcs", "body forces",
         "linear solver", "load cases"]),
    ("fe", "hessian"): (
        ["problem", "discretization", "residuals", "qoi"],
        ["output", "dirichlet bcs", "surface flux bcs", "body forces",
         "linear solver"]),
    ("fe", "calibrate"): (
        ["problem", "discretization", "residuals", "qoi", "optimizer"],
        ["output", "dirichlet bcs", "surface flux bcs", "body forces",
         "linear solver", "load cases"]),
}


def validate_deck(deck: dict[str, Any], subcommand: str) -> None:
    deck = unwrap_top_level(deck)
    deck = strip_calibr8_only(deck)

    problem = deck.get("problem")
    if not isinstance(problem, dict) or "type" not in problem:
        raise ValueError("problem: missing 'type' field")
    problem_type = problem["type"]

    key = (problem_type, subcommand)
    if key not in _SECTIONS:
        raise ValueError(
            f"unknown (problem.type, subcommand) pair {key}; valid pairs: "
            f"{sorted(_SECTIONS)}")

    required, optional = _SECTIONS[key]
    all_sections = required + optional

    model_name = _checked_model_name(deck, problem_type)
    if problem_type == "fe":
        _check_registered(
            deck.get("residuals", {}).get("global residual", {}).get("type"),
            registered_global_residual_names(),
            "residuals.global residual.type")
        _check_dispatch_caps(
            deck.get("residuals", {}).get("global residual", {}))

    qoi_name = None
    if "qoi" in all_sections and "qoi" in deck:
        qoi_section = deck["qoi"]
        if not isinstance(qoi_section, dict) or "name" not in qoi_section:
            raise ValueError("qoi: missing 'name' field")
        _check_registered(qoi_section["name"], registered_qoi_names(),
                          "qoi.name")
        qoi_name = qoi_section["name"]

    from jsonschema import Draft202012Validator

    composed = _compose_schema(problem_type, subcommand, model_name, qoi_name)
    errors = list(Draft202012Validator(composed).iter_errors(deck))
    if errors:
        lines = "\n".join(
            (".".join(str(p) for p in e.absolute_path) or "<root>")
            + f": {e.message}" for e in errors)
        raise ValueError(f"deck validation failed:\n{lines}")


def _checked_model_name(deck: dict[str, Any],
                        problem_type: str) -> str | None:
    if problem_type == "material_point":
        section = deck.get("model")
        if not isinstance(section, dict) or "name" not in section:
            raise ValueError("model: missing 'name' field")
        _check_registered(section["name"], registered_model_names(),
                          "model.name")
        return section["name"]
    if problem_type == "fe":
        local = deck.get("residuals", {}).get("local residual")
        if not isinstance(local, dict) or "type" not in local:
            raise ValueError("residuals.local residual: missing 'type' field")
        _check_registered(local["type"], registered_model_names(),
                          "residuals.local residual.type")
    return None


def _check_dispatch_caps(global_residual: Any) -> None:
    """Semantic constraints the JSON-Schema fragment cannot express,
    checked at deck-resolution time and phrased in deck-key terms (the
    runtime errors name Python kwargs; a bad deck should never get that
    far — it would fail only after full problem construction)."""
    if not isinstance(global_residual, dict):
        return
    prefix = "residuals.global residual"
    has_iter_cap = "max iters per dispatch" in global_residual
    has_step_cap = "steps per dispatch" in global_residual
    if has_iter_cap and has_step_cap:
        raise ValueError(
            f"{prefix}: 'max iters per dispatch' and 'steps per "
            "dispatch' are mutually exclusive — the first splits one "
            "time step across device dispatches, the second batches "
            "time steps into one dispatch. Remove one of the two keys.")
    driver = global_residual.get("driver", "scan")
    if (has_iter_cap or has_step_cap) and driver != "stepped":
        key = ("max iters per dispatch" if has_iter_cap
               else "steps per dispatch")
        raise ValueError(
            f"{prefix}: '{key}' only applies to the stepped driver, "
            f"but 'driver' is {driver!r} (default: scan). Set "
            f"'{prefix}.driver: stepped' or remove '{key}'.")


def _check_registered(name: Any, known: list[str], path: str) -> None:
    if name is None:
        raise ValueError(f"{path}: missing")
    if name not in known:
        listing = ", ".join(known) if known else "(none)"
        raise ValueError(
            f"{path}: {name!r} is not registered. Registered names: "
            f"{listing}")


def _compose_schema(problem_type: str, subcommand: str,
                    model_name: str | None,
                    qoi_name: str | None) -> dict[str, Any]:
    required, optional = _SECTIONS[(problem_type, subcommand)]
    properties: dict[str, Any] = {}
    merged_defs: dict[str, Any] = {}
    for section in required + optional:
        if section == "model":
            fragment = _load_fragment(f"models/{model_name}.yaml")
        elif section == "qoi":
            if qoi_name is None:
                continue
            fragment = _load_fragment(f"qois/{qoi_name}.yaml")
        else:
            fragment = _load_fragment(section.replace(" ", "_") + ".yaml")
        defs = fragment.pop("$defs", None)
        if defs:
            for dname, dschema in defs.items():
                if dname in merged_defs and merged_defs[dname] != dschema:
                    raise RuntimeError(
                        f"$defs collision on {dname!r} while composing")
                merged_defs[dname] = dschema
        properties[section] = fragment
    composed: dict[str, Any] = {
        "$schema": "https://json-schema.org/draft/2020-12/schema",
        "type": "object",
        "required": required,
        "additionalProperties": False,
        "properties": properties,
    }
    if merged_defs:
        composed["$defs"] = merged_defs
    return composed


def _load_fragment(relative_path: str) -> dict[str, Any]:
    import yaml

    with (_SCHEMAS_DIR / relative_path).open() as f:
        data = yaml.safe_load(f)
    if not isinstance(data, dict):
        raise RuntimeError(
            f"schema fragment {relative_path!r} is empty or not a mapping")
    return data
