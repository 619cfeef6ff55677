"""Finite-element specs + reference-frame interpolants.

Port of ``cmad_tpu/fem/elements.py`` (parity: reference
``cmad/fem/{shapes,interpolants,finite_element}.py`` merged). A
:class:`FiniteElement` pairs a geometric family with per-entity DOF
placement and a reference-frame interpolant; the canonical P1_TET /
Q1_HEX instances cover the linear Lagrange cases. The interpolants take
and return torch tensors.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass
from enum import IntEnum

import numpy as np
import torch

from cmad_tpu_torch.fem.topology import (
    ElementFamily,
    HEX_REF_NODES,
    LOCAL_SIDES,
)
from cmad_tpu_torch.typing import Tensor


@dataclass(frozen=True)
class ShapeFunctionsAtIP:
    """Shape values + gradients of one basis at one integration point.

    ``N``: (num_basis_fns,); ``grad_N``: (num_basis_fns, ndims) with
    ``grad_N[a, j] = dN_a/dxi_j`` (reference frame; assembly lifts to
    physical frame via the isoparametric Jacobian).
    """

    N: Tensor
    grad_N: Tensor


def hex_linear(xi: Tensor) -> ShapeFunctionsAtIP:
    """Trilinear shape functions on [-1,1]^3 at one point.

    N_a = (1/8) prod_k (1 + xi_k * xi_{k,a}). Gradients enumerated
    explicitly (the divide-out-one-factor trick is singular at corners).
    """
    node_xi = torch.as_tensor(HEX_REF_NODES, dtype=xi.dtype,
                              device=xi.device)
    terms = 1.0 + xi * node_xi                       # (8, 3)
    N = torch.prod(terms, dim=1) / 8.0
    grad_N = torch.stack([
        node_xi[:, 0] * terms[:, 1] * terms[:, 2],
        node_xi[:, 1] * terms[:, 0] * terms[:, 2],
        node_xi[:, 2] * terms[:, 0] * terms[:, 1]], dim=1) / 8.0
    return ShapeFunctionsAtIP(N=N, grad_N=grad_N)


def tet_linear(xi: Tensor) -> ShapeFunctionsAtIP:
    """Linear shape functions on the unit simplex at one point."""
    N = torch.stack([1.0 - xi[0] - xi[1] - xi[2], xi[0], xi[1], xi[2]])
    grad_N = torch.tensor([
        [-1.0, -1.0, -1.0],
        [1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, 0.0, 1.0]], dtype=xi.dtype, device=xi.device)
    return ShapeFunctionsAtIP(N=N, grad_N=grad_N)


class EntityType(IntEnum):
    """Mesh entity a DOF anchors to; per-element DOF layout order is
    VERTEX < EDGE < FACE < CELL, then local-entity index, then
    multiplicity."""

    VERTEX = 0
    EDGE = 1
    FACE = 2
    CELL = 3


_ENTITY_COUNTS: dict[ElementFamily, dict[EntityType, int]] = {
    ElementFamily.HEX_LINEAR: {EntityType.VERTEX: 8, EntityType.EDGE: 12,
                               EntityType.FACE: 6, EntityType.CELL: 1},
    ElementFamily.TET_LINEAR: {EntityType.VERTEX: 4, EntityType.EDGE: 6,
                               EntityType.FACE: 4, EntityType.CELL: 1},
}


@dataclass(frozen=True, eq=False)
class FiniteElement:
    """DOF placement spec + reference interpolant for one field.

    ``dofs_per_entity`` maps entity types to per-entity DOF counts
    (P1/Q1: {VERTEX: 1}); missing entries mean zero. ``interpolant_fn``
    evaluates the reference shape functions at one point. Frozen with
    identity equality (dict field is unhashable).
    """

    name: str
    element_family: ElementFamily
    dofs_per_entity: dict[EntityType, int]
    interpolant_fn: Callable[[Tensor], ShapeFunctionsAtIP]

    def __post_init__(self):
        for et, count in self.dofs_per_entity.items():
            if not isinstance(et, EntityType) or count < 0:
                raise ValueError(
                    f"FiniteElement {self.name!r}: bad dofs_per_entity "
                    f"entry ({et!r}: {count!r})")

    @property
    def num_dofs_per_element(self) -> int:
        counts = _ENTITY_COUNTS[self.element_family]
        return sum(counts[et] * n for et, n in self.dofs_per_entity.items())

    def vertex_only(self) -> bool:
        return all(count == 0 for et, count in self.dofs_per_entity.items()
                   if et != EntityType.VERTEX)

    def side_basis_fns(self, local_side_id: int) -> np.ndarray:
        """Element-local basis-fn indices on one local side (VERTEX-only
        placement)."""
        if not self.vertex_only():
            raise NotImplementedError(
                f"FiniteElement {self.name!r}: side_basis_fns supports "
                "VERTEX-only DOF placement")
        sides = LOCAL_SIDES[self.element_family]
        if not 0 <= local_side_id < sides.shape[0]:
            raise ValueError(
                f"FiniteElement {self.name!r}: local_side_id "
                f"{local_side_id} out of range [0, {sides.shape[0]})")
        return sides[local_side_id]

    def at_points(self, xi: Tensor) -> ShapeFunctionsAtIP:
        """The interpolant at each of ``xi (npts, ndims)``: ``N (npts,
        nb)``, ``grad_N (npts, nb, ndims)``."""
        shapes = [self.interpolant_fn(x) for x in xi]
        return ShapeFunctionsAtIP(
            N=torch.stack([s.N for s in shapes]),
            grad_N=torch.stack([s.grad_N for s in shapes]))


P1_TET = FiniteElement("P1_TET", ElementFamily.TET_LINEAR,
                       {EntityType.VERTEX: 1}, tet_linear)
Q1_HEX = FiniteElement("Q1_HEX", ElementFamily.HEX_LINEAR,
                       {EntityType.VERTEX: 1}, hex_linear)

GEOMETRIC_FE = {ElementFamily.HEX_LINEAR: Q1_HEX,
                ElementFamily.TET_LINEAR: P1_TET}
