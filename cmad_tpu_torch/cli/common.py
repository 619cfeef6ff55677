"""Shared helpers of the deck commands, the command dispatch and the
material-point problem builder.

Port of ``cmad_tpu/cli/common.py`` (parity: reference
``cmad/cli/common.py:59-148``): :func:`build_mp_problem` and
``resolve_output``; and the dispatch on the deck's ``problem.type`` that
each JAX command module does: ``material_point`` runs the MP command
(``cli/mp_subcommands.py``), ``fe`` the FE command
(``cli/fe_subcommands.py``).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass
from pathlib import Path
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch import config
from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.parameters.parameters import Parameters

Deck = Path | str | dict[str, Any]


def run_command(subcommand: str, deck_path: Path, **options) -> int:
    """``cmad <subcommand> <deck_path>``: the deck's MP or FE command,
    with ``options`` (``device``, ``dtype``) passed on."""
    from cmad_tpu_torch.cli import fe_subcommands, mp_subcommands
    from cmad_tpu_torch.io.deck import load_deck, unwrap_top_level

    problem_type = unwrap_top_level(load_deck(Path(deck_path)))[
        "problem"]["type"]
    if problem_type == "material_point":
        run = getattr(mp_subcommands, f"run_{subcommand}_mp")
    elif problem_type == "fe":
        run = getattr(fe_subcommands, f"run_{subcommand}_fe")
    else:
        raise ValueError(
            f"unsupported problem.type {problem_type!r}; expected "
            f"'material_point' or 'fe'")
    return run(Path(deck_path), **options)


def with_out_dir(deck: Deck, out_dir) -> Deck:
    """``deck`` with its ``output.path`` set to ``out_dir`` (a copy);
    ``deck`` itself when ``out_dir`` is None. Only a deck given as a dict
    takes an ``out_dir``."""
    if out_dir is None:
        return deck
    if not isinstance(deck, dict):
        raise ValueError("out_dir goes with a deck given as a dict; a "
                         "deck file names its own output path")
    deck = copy.deepcopy(deck)
    deck["output"] = {**deck.get("output", {}), "path": str(out_dir)}
    return deck


def with_material_defaults(params_section: dict[str, Any],
                           model_cls: type[Model]) -> dict[str, Any]:
    merged = dict(params_section)
    for key, default in model_cls.material_defaults().items():
        merged.setdefault(key, default)
    return merged


@dataclass(frozen=True)
class MPProblem:
    resolved: dict[str, Any]
    parameters: Parameters
    model: Model
    F: np.ndarray
    qoi: Any = None


def build_mp_problem(deck: Deck, subcommand: str, *,
                     dtype: torch.dtype = config.DEFAULT_DTYPE,
                     device: torch.device | str = config.DEFAULT_DEVICE
                     ) -> MPProblem:
    """deck -> (resolved, parameters, model, F history, optional QoI),
    on ``device`` (the card unless the caller asks for the CPU) in
    ``dtype``. A deck read from a path (PyYAML) is validated against the
    schema of ``subcommand`` (jsonschema); a deck given as a dict needs
    neither and is not validated, as for the FE commands."""
    from cmad_tpu_torch.io.deck import apply_deck_defaults, load_deck
    from cmad_tpu_torch.io.deformation import load_history
    from cmad_tpu_torch.io.params_builder import build_parameters
    from cmad_tpu_torch.io.qoi_data import load_qoi_data
    from cmad_tpu_torch.io.registry import resolve_model, resolve_qoi
    from cmad_tpu_torch.models.deformation_types import DefType

    device = config.checked_device(device)
    if isinstance(deck, dict):
        resolved = apply_deck_defaults(deck)
    else:
        from cmad_tpu_torch.io.schema import validate_deck

        resolved = apply_deck_defaults(load_deck(Path(deck)))
        validate_deck(resolved, subcommand)

    model_cls = resolve_model(resolved["model"]["name"])
    parameters = build_parameters(
        with_material_defaults(resolved["parameters"], model_cls),
        dtype=dtype, device=device)
    def_type = DefType[resolved["model"]["def_type"].upper()]
    model = model_cls.from_deck(resolved["model"], parameters, def_type)

    F = load_history(resolved["deformation"], expected_ndims=model.ndims)

    qoi = None
    if subcommand != "primal":
        qoi_cls = resolve_qoi(resolved["qoi"]["name"])
        if qoi_cls.problem_type != "material_point":
            raise ValueError(
                f"qoi.name {resolved['qoi']['name']!r} is registered for "
                f"problem_type={qoi_cls.problem_type!r}, but the deck has "
                f"problem.type='material_point'")
        data, weight = load_qoi_data(resolved["qoi"])
        qoi = qoi_cls.from_deck(resolved["qoi"], model, data, weight)

    return MPProblem(resolved=resolved, parameters=parameters,
                     model=model, F=F, qoi=qoi)


def resolve_output(resolved: dict[str, Any]) -> tuple[Path, str, str]:
    """(out_dir, prefix, format); creates out_dir. The output block is
    optional — absent means cwd / "" / npy."""
    output = resolved.get("output", {})
    out_dir = Path(output.get("path", "."))
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir, output.get("prefix", ""), output.get("format", "npy")
