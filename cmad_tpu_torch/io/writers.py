"""Output writers of the deck commands.

Port of ``cmad_tpu/io/writers.py`` (parity: reference
``cmad/io/writers.py:63-496``). Artifacts: the material-point
trajectories ``cauchy`` ((3, 3, N+1)) and ``xi`` ((N+1, num_dofs), with
one ``xi_block_NN`` file per state variable) as ``.npy`` or ``.csv``,
``solver.json``, ``J.json``, ``grad``/``hess`` ``.npy`` or ``.csv``,
``deck.resolved.yaml``, ``opt_history.json``, ``opt_params.yaml``,
``opt_status.json``.

The YAML files are written by :func:`dump_yaml`, a small block-style
emitter of this package (dicts, lists, strings, numbers, bools, None), so
the same code runs where PyYAML is not installed; ``yaml.safe_load`` of
its output gives back the data it was given.
"""
from __future__ import annotations

import copy
import json
import math
import re
from collections.abc import Mapping
from pathlib import Path
from typing import Any

import numpy as np

# PyYAML (YAML 1.1) reads these plain words as bools or null
_RESERVED = {"y", "n", "yes", "no", "true", "false", "on", "off", "null",
             "~", ""}
_PLAIN = re.compile(r"[A-Za-z_][A-Za-z0-9_ ./\-]*")


def _scalar(v: Any) -> str:
    """One scalar as a YAML 1.1 plain or double-quoted token that
    ``yaml.safe_load`` reads back as the same value."""
    if v is None:
        return "null"
    if isinstance(v, (bool, np.bool_)):
        return "true" if v else "false"
    if isinstance(v, (int, np.integer)):
        return str(int(v))
    if isinstance(v, (float, np.floating)):
        v = float(v)
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        r = repr(v)
        if "e" in r:        # YAML 1.1 floats: a dot and a signed exponent
            mantissa, exp = r.split("e")
            if "." not in mantissa:
                mantissa += ".0"
            if exp[0] not in "+-":
                exp = "+" + exp
            r = f"{mantissa}e{exp}"
        return r
    if isinstance(v, Path):
        v = str(v)
    if isinstance(v, str):
        if (_PLAIN.fullmatch(v) and v.lower() not in _RESERVED
                and not v.endswith(" ")):
            return v
        return json.dumps(v)
    raise TypeError(f"dump_yaml: cannot write a {type(v).__name__}")


def _is_block(v: Any) -> bool:
    if isinstance(v, Mapping):
        return bool(v)
    if isinstance(v, (list, tuple)):
        return any(isinstance(x, (Mapping, list, tuple)) for x in v)
    return False


def _flow(v: Any) -> str:
    if isinstance(v, Mapping):
        return "{}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_scalar(x) for x in v) + "]"
    if isinstance(v, np.ndarray):
        return _flow(v.tolist())
    return _scalar(v)


def _block(node: Any, indent: int) -> list[str]:
    pad = " " * indent
    lines: list[str] = []
    if isinstance(node, Mapping):
        for k, v in node.items():
            if isinstance(v, np.ndarray):
                v = v.tolist()
            if _is_block(v):
                lines.append(f"{pad}{_scalar(k)}:")
                lines.extend(_block(v, indent + 2))
            else:
                lines.append(f"{pad}{_scalar(k)}: {_flow(v)}")
        return lines
    for item in node:
        if isinstance(item, np.ndarray):
            item = item.tolist()
        if _is_block(item):
            sub = _block(item, indent + 2)
            lines.append(f"{pad}- {sub[0].lstrip()}")
            lines.extend(sub[1:])
        else:
            lines.append(f"{pad}- {_flow(item)}")
    return lines


def dump_yaml(data: Any) -> str:
    """``data`` (nested dicts and lists of strings, numbers, bools and
    None) as block-style YAML."""
    if not _is_block(data):
        return _flow(data) + "\n"
    return "\n".join(_block(data, 0)) + "\n"


def _check_fmt(fmt: str) -> None:
    if fmt not in ("npy", "text"):
        raise ValueError(f"output.format: expected 'npy' or 'text', got "
                         f"{fmt!r}")


_CAUCHY_HEADER = "S11 S12 S13 S21 S22 S23 S31 S32 S33"


def write_cauchy(out_dir: Path, prefix: str, cauchy, fmt: str) -> None:
    """The (3, 3, N+1) stress trajectory; as text, one row of nine
    components per step."""
    _check_fmt(fmt)
    if fmt == "npy":
        np.save(out_dir / f"{prefix}cauchy.npy", cauchy)
    else:
        flat = np.asarray(cauchy).transpose(2, 0, 1).reshape(-1, 9)
        np.savetxt(out_dir / f"{prefix}cauchy.csv", flat,
                   header=_CAUCHY_HEADER, delimiter=",")


def write_xi(out_dir: Path, prefix: str, xi_trajectory, layout,
             fmt: str) -> None:
    """The flat state trajectory ``xi_trajectory`` (N+1, num_dofs) and
    one file per variable of the model's ``layout``."""
    _check_fmt(fmt)
    xi = np.asarray(xi_trajectory)
    if fmt == "npy":
        np.save(out_dir / f"{prefix}xi.npy", xi)
    else:
        np.savetxt(out_dir / f"{prefix}xi.csv", xi, delimiter=",")
    for k, name in enumerate(layout.var_names):
        block = xi[:, layout.slc(name)]
        if fmt == "npy":
            np.save(out_dir / f"{prefix}xi_block_{k:02d}.npy", block)
        else:
            np.savetxt(out_dir / f"{prefix}xi_block_{k:02d}.csv", block,
                       delimiter=",")


def write_solver_log(out_dir: Path, prefix: str,
                     solver_log: list[dict[str, Any]]) -> None:
    with (out_dir / f"{prefix}solver.json").open("w") as f:
        json.dump(solver_log, f, indent=2)


def write_J(out_dir: Path, prefix: str, J: float) -> None:
    with (out_dir / f"{prefix}J.json").open("w") as f:
        json.dump({"J": J}, f, indent=2)


def write_grad(out_dir: Path, prefix: str, grad, fmt: str) -> None:
    _check_fmt(fmt)
    if fmt == "npy":
        np.save(out_dir / f"{prefix}grad.npy", grad)
    else:
        np.savetxt(out_dir / f"{prefix}grad.csv", grad, delimiter=",")


def write_hessian(out_dir: Path, prefix: str, hessian, fmt: str) -> None:
    _check_fmt(fmt)
    if fmt == "npy":
        np.save(out_dir / f"{prefix}hess.npy", hessian)
    else:
        np.savetxt(out_dir / f"{prefix}hess.csv", hessian, delimiter=",")


def write_resolved_deck(out_dir: Path, prefix: str,
                        resolved_deck: dict[str, Any]) -> None:
    (out_dir / f"{prefix}deck.resolved.yaml").write_text(
        dump_yaml(resolved_deck))


def write_opt_history(out_dir: Path, prefix: str,
                      history: list[dict[str, Any]],
                      active_param_paths: list[str] | None) -> None:
    payload: dict[str, Any] = {"history": history}
    if active_param_paths is not None:
        payload["active_param_paths"] = active_param_paths
    with (out_dir / f"{prefix}opt_history.json").open("w") as f:
        json.dump(payload, f, indent=2)


def write_opt_params(out_dir: Path, prefix: str,
                     parameters_section: dict[str, Any],
                     optimized_values) -> None:
    """Deck ``parameters:`` subtree with active leaves rewritten to the
    optimized physical values (directly reusable in a follow-up deck)."""
    out = copy.deepcopy(parameters_section)
    rewrite_values(out, optimized_values)
    (out_dir / f"{prefix}opt_params.yaml").write_text(dump_yaml(out))


def rewrite_values(section: Any, values: Any) -> None:
    """Set each ``value`` leaf of the deck subtree ``section`` to the
    matching entry of the parameter tree ``values``, in place."""
    if isinstance(section, dict) and "value" in section:
        section["value"] = to_native(values)
        return
    if isinstance(section, dict):
        for k in section:
            if isinstance(values, dict) and k in values:
                rewrite_values(section[k], values[k])


def to_native(x: Any) -> Any:
    """A tensor or array as a float or a nested list of floats."""
    if hasattr(x, "detach"):
        x = x.detach().cpu().numpy()
    arr = np.asarray(x)
    if arr.ndim == 0:
        return float(arr)
    return arr.tolist()


def write_opt_status(out_dir: Path, prefix: str,
                     status: dict[str, Any]) -> None:
    with (out_dir / f"{prefix}opt_status.json").open("w") as f:
        json.dump(status, f, indent=2)
