"""3D mesh with element blocks, node sets, and side sets.

Port of ``cmad_tpu/fem/mesh.py`` (numpy only; parity: reference
``cmad/fem/mesh.py:184-636``): the :class:`Mesh` container, the
bounding-box side sets a deck asks for with ``build coordinate
sidesets``, and the element sizes. Exodus-convention naming so Exodus IO
is a thin translation. The in-house builders (``StructuredHexMesh``,
``hex_to_tet_split``) are not ported: the FE slice reads its meshes from
Exodus files.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cmad_tpu_torch.fem.elements import EntityType, FiniteElement, GEOMETRIC_FE
from cmad_tpu_torch.fem.topology import (
    ElementFamily,
    FACES_PER_ELEMENT,
    LOCAL_EDGES,
    LOCAL_FACES,
    NODES_PER_ELEMENT,
)


def _dedup_subentities(connectivity: np.ndarray,
                       local_table: np.ndarray):
    """Unique sub-entity table + per-element index map via sorted-vertex
    canonicalization (edges and faces share this)."""
    n_elems = connectivity.shape[0]
    verts = np.sort(connectivity[:, local_table], axis=2)
    flat = verts.reshape(-1, local_table.shape[1])
    unique, inverse = np.unique(flat, axis=0, return_inverse=True)
    return (unique.astype(np.intp),
            inverse.reshape(n_elems, local_table.shape[0]).astype(np.intp))


@dataclass(frozen=True)
class Mesh:
    """Immutable 3D mesh.

    ``nodes (N_nodes, 3)``; ``connectivity (N_elems, npe)``;
    ``element_blocks`` a strict partition of element ids;
    ``node_sets`` name -> node ids; ``side_sets`` name ->
    ``(elem_id, local_face_id)`` pairs. The ``*_ids`` dicts carry
    Exodus interchange ids (empty for in-house builders). Derived
    edge/face tables are computed at construction.
    """

    nodes: np.ndarray
    connectivity: np.ndarray
    element_family: ElementFamily
    element_blocks: dict[str, np.ndarray]
    node_sets: dict[str, np.ndarray]
    side_sets: dict[str, np.ndarray]
    element_block_ids: dict[str, int] = field(default_factory=dict)
    node_set_ids: dict[str, int] = field(default_factory=dict)
    side_set_ids: dict[str, int] = field(default_factory=dict)
    geometric_finite_element: FiniteElement | None = None
    edges: np.ndarray = field(init=False, default=None)
    element_edges: np.ndarray = field(init=False, default=None)
    faces: np.ndarray = field(init=False, default=None)
    element_faces: np.ndarray = field(init=False, default=None)

    def __post_init__(self):
        n_nodes, n_elems = self.nodes.shape[0], self.connectivity.shape[0]
        if self.nodes.ndim != 2 or self.nodes.shape[1] != 3:
            raise ValueError(f"nodes must be (N, 3); got {self.nodes.shape}")
        npe = NODES_PER_ELEMENT[self.element_family]
        if self.connectivity.ndim != 2 or self.connectivity.shape[1] != npe:
            raise ValueError(
                f"connectivity must be (N_elems, {npe}) for "
                f"{self.element_family.name}; got {self.connectivity.shape}")
        if n_elems and not (0 <= self.connectivity.min()
                            and self.connectivity.max() < n_nodes):
            raise ValueError("connectivity indices out of range")

        counts = np.zeros(n_elems, dtype=np.intp)
        for name, idx in self.element_blocks.items():
            if idx.ndim != 1:
                raise ValueError(f"element_blocks[{name!r}] must be 1D")
            if idx.size and not (0 <= idx.min() and idx.max() < n_elems):
                raise ValueError(
                    f"element_blocks[{name!r}] indices out of range")
            np.add.at(counts, idx, 1)
        if not np.all(counts == 1):
            raise ValueError(
                f"element_blocks must partition [0, {n_elems}): "
                f"{int((counts == 0).sum())} unassigned, "
                f"{int((counts > 1).sum())} multiply-assigned")

        for name, idx in self.node_sets.items():
            if idx.size and not (0 <= idx.min() and idx.max() < n_nodes):
                raise ValueError(f"node_sets[{name!r}] out of range")
        nf = FACES_PER_ELEMENT[self.element_family]
        for name, pairs in self.side_sets.items():
            if pairs.ndim != 2 or pairs.shape[1] != 2:
                raise ValueError(f"side_sets[{name!r}] must be (n, 2)")
            if pairs.shape[0] and not (
                    pairs[:, 0].min() >= 0 and pairs[:, 0].max() < n_elems
                    and pairs[:, 1].min() >= 0 and pairs[:, 1].max() < nf):
                raise ValueError(f"side_sets[{name!r}] out of range")

        for sets, ids, kind in (
                (self.element_blocks, self.element_block_ids,
                 "element_block_ids"),
                (self.node_sets, self.node_set_ids, "node_set_ids"),
                (self.side_sets, self.side_set_ids, "side_set_ids")):
            if not ids:
                continue
            if set(ids) != set(sets):
                raise ValueError(f"{kind} keys must match the sets dict")
            vals = list(ids.values())
            if min(vals) < 1 or len(set(vals)) != len(vals):
                raise ValueError(f"{kind} must be unique positive ints")

        edges, element_edges = _dedup_subentities(
            self.connectivity, LOCAL_EDGES[self.element_family])
        faces, element_faces = _dedup_subentities(
            self.connectivity, LOCAL_FACES[self.element_family])
        object.__setattr__(self, "edges", edges)
        object.__setattr__(self, "element_edges", element_edges)
        object.__setattr__(self, "faces", faces)
        object.__setattr__(self, "element_faces", element_faces)
        if self.geometric_finite_element is None:
            object.__setattr__(self, "geometric_finite_element",
                               GEOMETRIC_FE[self.element_family])

    def entity_count(self, entity_type: EntityType) -> int:
        return {
            EntityType.VERTEX: self.nodes.shape[0],
            EntityType.EDGE: self.edges.shape[0],
            EntityType.FACE: self.faces.shape[0],
            EntityType.CELL: self.connectivity.shape[0],
        }[entity_type]


def coordinate_side_sets(mesh: Mesh, rel_tol: float = 1e-7):
    """``{x,y,z}{min,max}_sides`` sets for faces on the bounding box;
    extremes with no faces are omitted."""
    local = LOCAL_FACES[mesh.element_family]
    face_coords = mesh.nodes[mesh.connectivity[:, local]]
    lo, hi = mesh.nodes.min(axis=0), mesh.nodes.max(axis=0)
    tol = rel_tol * (hi - lo)
    out: dict[str, np.ndarray] = {}
    for axis, prefix in enumerate("xyz"):
        coord = face_coords[..., axis]
        for suffix, plane in (("min", lo[axis]), ("max", hi[axis])):
            on = np.all(np.abs(coord - plane) < tol[axis], axis=2)
            pairs = np.column_stack(np.nonzero(on)).astype(np.intp)
            if pairs.shape[0]:
                out[f"{prefix}{suffix}_sides"] = pairs
    return out


def element_rms_edge_sizes(mesh: Mesh) -> np.ndarray:
    """RMS edge length per element — the stabilization length scale h."""
    local = LOCAL_EDGES[mesh.element_family]
    pts = mesh.nodes[mesh.connectivity[:, local]]
    vec = pts[:, :, 1] - pts[:, :, 0]
    return np.sqrt(np.mean(np.sum(vec**2, axis=-1), axis=-1))
