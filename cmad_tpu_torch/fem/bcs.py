"""Boundary-condition declarations (sideset-keyed).

Port of ``cmad_tpu/fem/bcs.py`` (parity: reference
``cmad/fem/bcs.py``). DirichletBC constrains named field
components on the vertices of one or more side sets; NeumannBC applies a
surface flux over side sets. Value forms: None (DBC only; homogeneous),
constant sequence, or a callable ``(coords, t) -> values``.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass


@dataclass(frozen=True)
class DirichletBC:
    sideset_names: Sequence[str]
    field_name: str
    dofs: Sequence[int]
    values: Sequence[float] | Callable | None = None

    def __post_init__(self):
        if not self.sideset_names:
            raise ValueError("DirichletBC.sideset_names must be non-empty")
        if not self.dofs:
            raise ValueError("DirichletBC.dofs must be non-empty")
        if (self.values is not None and not callable(self.values)
                and len(self.values) != len(self.dofs)):
            raise ValueError(
                f"DirichletBC values length ({len(self.values)}) does not "
                f"match dofs length ({len(self.dofs)})")


@dataclass(frozen=True)
class NeumannBC:
    sideset_names: Sequence[str]
    field_name: str
    values: Sequence[float] | Callable = None

    def __post_init__(self):
        if not self.sideset_names:
            raise ValueError("NeumannBC.sideset_names must be non-empty")
        if self.values is None or (
                not callable(self.values) and len(self.values) == 0):
            raise ValueError("NeumannBC.values must be non-empty")
