"""YAML deck loader and defaults filler.

Port of ``cmad_tpu/io/deck.py`` (parity: reference
``cmad/io/deck.py:95-204``). ``yaml`` is imported inside
:func:`load_deck` only: the FE entry point also takes an already-loaded
deck dict, which needs no YAML parser. Three normalization passes:
(1) single-key top-level wrapper auto-unwrap (Calibr8 deck convention),
(2) Calibr8-only section strip (``linear algebra:``, ``regression:``),
(3) per-problem-type default filling so ``deck.resolved.yaml`` records
the values actually used.
"""
from __future__ import annotations

import copy
import warnings
from pathlib import Path
from typing import Any

_MP_NEWTON_DEFAULTS: dict[str, Any] = {
    "max_iters": 10,
    "abs_tol": 1e-14,
    "rel_tol": 1e-14,
    "max_ls_evals": 0,
}
_OPTIMIZER_DEFAULTS: dict[str, Any] = {
    "initial_guess": "from_deck",
    "options": {},
    "log_params": True,
}
_FE_RESIDUALS_DEFAULTS: dict[str, dict[str, Any]] = {
    "global residual": {
        "nonlinear max iters": 10,
        "nonlinear absolute tol": 1.0e-12,
        "nonlinear relative tol": 1.0e-12,
        "print convergence": False,
        "line search": {
            "max evals": 4,
            "sufficient decrease": 1.0e-4,
            "min backtrack factor": 0.5,
            "max backtrack factor": 0.9,
            "print": False,
        },
    },
    "local residual": {
        "nonlinear max iters": 20,
        "nonlinear absolute tol": 1.0e-12,
        "nonlinear relative tol": 1.0e-12,
        "line search": {
            "max evals": 4,
            "sufficient decrease": 1.0e-4,
            "min backtrack factor": 0.5,
            "max backtrack factor": 0.9,
            "print": False,
        },
    },
}
_LINEAR_SOLVER_DEFAULTS: dict[str, Any] = {
    "type": "direct",
    "rtol": 1.0e-10,
    "max iters": None,
    "restart": 20,
    "preconditioner": {"type": "jacobi"},
}

_CALIBR8_ONLY = ("linear algebra", "regression")


def load_deck(path: Path) -> dict[str, Any]:
    """Parse the YAML deck; schema validation happens separately."""
    import yaml

    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"deck not found: {path}")
    with path.open() as f:
        data = yaml.safe_load(f)
    if data is None:
        raise ValueError(f"deck is empty: {path}")
    if not isinstance(data, dict):
        raise ValueError(
            f"deck top-level must be a mapping; got "
            f"{type(data).__name__} at {path}")
    return data


def unwrap_top_level(deck: dict[str, Any]) -> dict[str, Any]:
    """Unwrap a Calibr8-style single-key wrapper; idempotent."""
    if len(deck) == 1:
        (key, val), = deck.items()
        if isinstance(val, dict) and "problem" in val:
            return val
    return deck


def strip_calibr8_only(deck: dict[str, Any]) -> dict[str, Any]:
    """Pop Calibr8-only sections with a one-line warning; idempotent."""
    out = deck
    for section in _CALIBR8_ONLY:
        if section in out:
            if out is deck:
                out = dict(deck)
            del out[section]
            warnings.warn(
                f"deck section {section!r} is recognized but unused by "
                "cmad (Calibr8-only); ignored",
                UserWarning, stacklevel=3)
    return out


def migrate_pyamg(solver: dict[str, Any]) -> None:
    """Map the reference's pyamg arms onto device-native equivalents.

    The reference (``cmad/io/schemas/linear_solver.yaml``) accepts
    ``preconditioner: {type: pyamg, kwargs: ...}`` and ``inner: amg``
    inside the block preconditioner, both backed by host-side pyamg
    V-cycles. This build's algebraic-coarse arm is the device-native
    two-level preconditioner (``fem/two_level.py``: aggregation +
    rigid-body coarse space), so a reference deck naming pyamg runs
    unchanged — mapped with a logged note instead of failing schema
    validation. In-place; idempotent.
    """
    precon = solver.get("preconditioner")
    if not isinstance(precon, dict):
        return
    if precon.get("type") == "pyamg":
        dropped = precon.pop("kwargs", None)
        precon["type"] = "two_level"
        msg = ("linear solver preconditioner 'pyamg' is host-side-only; "
               "mapped to the device-native 'two_level' "
               "(aggregation + rigid-body coarse space) preconditioner")
        if dropped:
            msg += f"; pyamg kwargs {sorted(dropped)} ignored"
        warnings.warn(msg, UserWarning, stacklevel=4)
        # provenance: carried into deck.resolved.yaml so the mapping is
        # auditable after the run, not just a stderr line
        solver.setdefault("migrated", []).append(msg)
    if precon.get("type") == "block" and precon.get("inner") == "amg":
        precon["inner"] = "chebyshev"
        msg = ("block preconditioner inner solve 'amg' is "
               "host-side-only; mapped to the device-native 'chebyshev' "
               "inner solve")
        warnings.warn(msg, UserWarning, stacklevel=4)
        solver.setdefault("migrated", []).append(msg)


def _setdefaults(target: dict, defaults: dict) -> None:
    for k, v in defaults.items():
        if isinstance(v, dict):
            sub = target.setdefault(k, {})
            if isinstance(sub, dict):
                _setdefaults(sub, v)
        else:
            target.setdefault(k, v)


def apply_deck_defaults(deck: dict[str, Any]) -> dict[str, Any]:
    """Normalized deep copy of ``deck`` with defaults merged in."""
    resolved = copy.deepcopy(deck)
    resolved = unwrap_top_level(resolved)
    resolved = strip_calibr8_only(resolved)

    problem_type = resolved.get("problem", {}).get("type")

    if problem_type == "material_point":
        newton = resolved.setdefault("solver", {}).setdefault("newton", {})
        _setdefaults(newton, _MP_NEWTON_DEFAULTS)

    if problem_type == "fe":
        residuals = resolved.setdefault("residuals", {})
        for slot, defaults in _FE_RESIDUALS_DEFAULTS.items():
            _setdefaults(residuals.setdefault(slot, {}), defaults)
        solver = resolved.setdefault("linear solver", {})
        migrate_pyamg(solver)
        _setdefaults(solver, _LINEAR_SOLVER_DEFAULTS)

    if "output" in resolved:
        output = resolved["output"]
        output.setdefault("prefix", "")
        if problem_type == "material_point":
            output.setdefault("format", "npy")

    if "optimizer" in resolved:
        _setdefaults(resolved["optimizer"], _OPTIMIZER_DEFAULTS)

    return resolved
