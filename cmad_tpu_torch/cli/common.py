"""Shared helpers of the deck commands.

Port of ``resolve_output`` of ``cmad_tpu/cli/common.py`` (parity:
reference ``cmad/cli/common.py:59-148``), and the dispatch on the deck's
``problem.type`` that each JAX command module does: ``fe`` runs the FE
command (``cli/fe_subcommands.py``); the material-point problem builder
and its commands are ROADMAP queue 1, item 23.
"""
from __future__ import annotations

from pathlib import Path
from typing import Any


def run_command(subcommand: str, deck_path: Path, **options) -> int:
    """``cmad <subcommand> <deck_path>``: the deck's FE command, with
    ``options`` (``device``, ``dtype``) passed on."""
    from cmad_tpu_torch.cli import fe_subcommands
    from cmad_tpu_torch.io.deck import load_deck, unwrap_top_level

    problem_type = unwrap_top_level(load_deck(Path(deck_path)))[
        "problem"]["type"]
    if problem_type == "material_point":
        raise NotImplementedError(
            f"the material-point {subcommand} command is not ported yet: "
            "ROADMAP queue 1, item 23")
    if problem_type != "fe":
        raise ValueError(
            f"unsupported problem.type {problem_type!r}; expected "
            f"'material_point' or 'fe'")
    run = getattr(fe_subcommands, f"run_{subcommand}_fe")
    return run(Path(deck_path), **options)


def resolve_output(resolved: dict[str, Any]) -> tuple[Path, str, str]:
    """(out_dir, prefix, format); creates out_dir. The output block is
    optional — absent means cwd / "" / npy."""
    output = resolved.get("output", {})
    out_dir = Path(output.get("path", "."))
    out_dir.mkdir(parents=True, exist_ok=True)
    return out_dir, output.get("prefix", ""), output.get("format", "npy")
