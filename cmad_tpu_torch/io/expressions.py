"""Sandboxed sympy scalar-expression parser for deck values.

Port of ``cmad_tpu/io/expressions.py`` (parity: reference
``cmad/io/expressions.py:51-168``). Turns string-form BC / forcing values
(``"0.01 * t"``, ``"sin(pi*x)*cos(pi*y)"``) into numpy callables via
``sympy.parse_expr`` + ``lambdify(modules="numpy")`` with Python
builtins masked and undefined applied functions rejected: the FE drivers
evaluate them on the host, on coordinate arrays and a float time.
Numeric literals short-circuit to constant callables.
"""
from __future__ import annotations

import math
from collections.abc import Callable
from typing import Any

import sympy
from sympy.core.function import AppliedUndef
from sympy.parsing.sympy_parser import parse_expr


class ExpressionError(ValueError):
    """A deck expression failed to parse or referenced unknown names."""


def _safe_globals() -> dict[str, Any]:
    # parse_expr routes through eval(); masking __builtins__ makes names
    # like __import__/open resolve as undefined symbols, which the
    # AppliedUndef rejection below then catches.
    ns: dict[str, Any] = {}
    exec("from sympy import *", ns)  # noqa: S102 - sympy namespace only
    ns["__builtins__"] = {}
    return ns


_SAFE_GLOBALS = _safe_globals()


def parse_scalar_expression(
        expr: str | int | float,
        names: tuple[str, ...]) -> Callable[..., Any]:
    """Compile ``expr`` into ``f(**names) -> scalar or array`` (numpy).

    Numeric literals become constant callables; booleans are rejected.
    Free symbols outside ``names`` raise :class:`ExpressionError` at
    parse time.
    """
    if isinstance(expr, bool):
        raise ExpressionError(
            f"boolean deck value {expr!r} is not a valid expression")
    if isinstance(expr, (int, float)):
        value = float(expr)
        if not math.isfinite(value):
            raise ExpressionError(
                f"non-finite numeric deck value {expr!r} is not a valid "
                "expression")

        def constant(**kwargs: Any):
            return value

        return constant
    if not isinstance(expr, str):
        raise ExpressionError(
            f"expected a string or numeric deck value; got {type(expr)}")

    symbols = {name: sympy.Symbol(name) for name in names}
    try:
        parsed = parse_expr(expr, local_dict=symbols,
                            global_dict=_SAFE_GLOBALS)
    except Exception as e:
        raise ExpressionError(f"failed to parse expression {expr!r}: {e}") \
            from e

    if not isinstance(parsed, sympy.Basic):
        # attribute access like "x.__class__" evaluates to non-expression
        # Python objects; reject anything that is not sympy math
        raise ExpressionError(
            f"expression {expr!r} does not evaluate to a scalar "
            f"expression (got {type(parsed).__name__})")

    if parsed.atoms(AppliedUndef):
        bad = sorted(str(f.func) for f in parsed.atoms(AppliedUndef))
        raise ExpressionError(
            f"expression {expr!r} calls unknown function(s): {bad}")

    free = {str(s) for s in parsed.free_symbols}
    unknown = free - set(names)
    if unknown:
        raise ExpressionError(
            f"expression {expr!r} references unknown name(s) "
            f"{sorted(unknown)}; available: {list(names)}")

    ordered = [symbols[n] for n in names]
    compiled = sympy.lambdify(ordered, parsed, modules="numpy")

    def fn(**kwargs: Any):
        missing = [n for n in names if n not in kwargs]
        if missing:
            raise ExpressionError(
                f"expression {expr!r} called without required keyword "
                f"argument(s) {missing}; expected {list(names)}")
        return compiled(*[kwargs[n] for n in names])

    return fn
