"""Decks and builders shared by the tests of cmad_tpu_torch's FE layer
against cmad_tpu's: the notch deck of ``examples/notch_hosford.yaml`` with
the J2 effective stress swapped in, built by both packages.

The port takes the deck as a dict; the JAX package reads it from a YAML
file (and validates it against its schema).
"""
from __future__ import annotations

import copy
from pathlib import Path

import yaml

REPO = Path(__file__).resolve().parents[2]
MESHES = REPO / "examples" / "meshes"
NOTCH_480 = "notch_h0.080.exo"     # 480 tets, 165 nodes, 495 dofs

_FORMS = {"total": "small_elastic_plastic",
          "rate": "small_rate_elastic_plastic"}


def notch_deck(mesh: str = NOTCH_480, form: str = "total",
               num_steps: int | None = None,
               linear_solver: dict | None = None,
               global_tol: float | None = None,
               max_iters: int | None = None) -> dict:
    """The notch deck with J2, the stepped driver and ``mesh`` (a file of
    ``examples/meshes``). ``form`` picks the local residual: the deck's
    total form or the rate form. ``global_tol`` sets both global Newton
    tolerances."""
    deck = yaml.safe_load((REPO / "examples/notch_hosford.yaml").read_text())
    deck.pop("output")
    deck["discretization"]["mesh file"] = str(MESHES / mesh)
    if num_steps is not None:
        deck["discretization"]["num steps"] = num_steps
    local = deck["residuals"]["local residual"]
    local["type"] = _FORMS[form]
    local["materials"]["block_1"]["plastic"]["effective stress"] = {"J2": {}}
    gr = deck["residuals"]["global residual"]
    gr["driver"] = "stepped"
    if global_tol is not None:
        gr["nonlinear absolute tol"] = global_tol
        gr["nonlinear relative tol"] = global_tol
    if max_iters is not None:
        gr["nonlinear max iters"] = max_iters
    if linear_solver is not None:
        deck["linear solver"] = copy.deepcopy(linear_solver)
    return deck


def jax_bundle(deck: dict, tmp_dir: Path):
    """cmad_tpu's ``FEProblemBundle`` of ``deck`` (written as YAML)."""
    from cmad_tpu.cli.fe_common import build_fe_problem_from_deck

    path = Path(tmp_dir) / "deck.yaml"
    path.write_text(yaml.safe_dump(deck, sort_keys=False))
    return build_fe_problem_from_deck(path, "primal")


def port_bundle(deck: dict):
    """cmad_tpu_torch's ``FEProblemBundle`` of ``deck``, on the CPU in
    float64."""
    import torch

    from cmad_tpu_torch.cli.fe_common import build_fe_problem_from_deck

    return build_fe_problem_from_deck(copy.deepcopy(deck),
                                      dtype=torch.float64, device="cpu")
