"""3D mesh with element blocks, node sets, and side sets.

Port of ``cmad_tpu/fem/mesh.py`` (numpy only; parity: reference
``cmad/fem/mesh.py:184-636``): the :class:`Mesh` container, the in-house
builders, the bounding-box side sets a deck asks for with ``build
coordinate sidesets``, and the element sizes. Exodus-convention naming
so Exodus IO is a thin translation. The structured-hex builder emits the
``all`` block plus six ``{x,y,z}{min,max}_{nodes,sides}`` sets;
``hex_to_tet_split`` applies the 6-tet body-diagonal split.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from cmad_tpu_torch.fem.elements import EntityType, FiniteElement, GEOMETRIC_FE
from cmad_tpu_torch.fem.topology import (
    ElementFamily,
    FACES_PER_ELEMENT,
    HEX_FACE_TO_TET_FACES,
    HEX_TO_TET_LOCAL,
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


def StructuredHexMesh(lengths, divisions, origin=(0.0, 0.0, 0.0)) -> Mesh:
    """Structured linear-hex box mesh with the six built-in node/side
    sets; element index ``e = i*ny*nz + j*nz + k``."""
    nx, ny, nz = divisions
    if min(nx, ny, nz) < 1:
        raise ValueError(f"divisions must be >= 1; got {divisions}")
    axes = [np.linspace(o, o + L, d + 1)
            for o, L, d in zip(origin, lengths, divisions, strict=True)]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([X, Y, Z], axis=-1).reshape(-1, 3)

    vid = np.arange((nx + 1) * (ny + 1) * (nz + 1),
                    dtype=np.intp).reshape(nx + 1, ny + 1, nz + 1)
    I, J, K = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                          indexing="ij")
    connectivity = np.stack([
        vid[I, J, K], vid[I + 1, J, K], vid[I + 1, J + 1, K],
        vid[I, J + 1, K],
        vid[I, J, K + 1], vid[I + 1, J, K + 1], vid[I + 1, J + 1, K + 1],
        vid[I, J + 1, K + 1]], axis=-1).reshape(-1, 8)

    n_elems = nx * ny * nz
    eid = np.arange(n_elems, dtype=np.intp).reshape(nx, ny, nz)

    def side(elems, face):
        return np.column_stack(
            [elems, np.full(elems.shape, face, dtype=np.intp)])

    node_sets = {
        "xmin_nodes": vid[0].ravel(), "xmax_nodes": vid[-1].ravel(),
        "ymin_nodes": vid[:, 0].ravel(), "ymax_nodes": vid[:, -1].ravel(),
        "zmin_nodes": vid[:, :, 0].ravel(),
        "zmax_nodes": vid[:, :, -1].ravel()}
    side_sets = {
        "xmin_sides": side(eid[0].ravel(), 5),
        "xmax_sides": side(eid[-1].ravel(), 3),
        "ymin_sides": side(eid[:, 0].ravel(), 2),
        "ymax_sides": side(eid[:, -1].ravel(), 4),
        "zmin_sides": side(eid[:, :, 0].ravel(), 0),
        "zmax_sides": side(eid[:, :, -1].ravel(), 1)}

    return Mesh(nodes=nodes, connectivity=connectivity,
                element_family=ElementFamily.HEX_LINEAR,
                element_blocks={"all": np.arange(n_elems, dtype=np.intp)},
                node_sets=node_sets, side_sets=side_sets)


def hex_to_tet_split(mesh: Mesh) -> Mesh:
    """Split each hex into 6 positive-volume tets along the 0-6 body
    diagonal; blocks/nodesets/sidesets remap accordingly."""
    if mesh.element_family != ElementFamily.HEX_LINEAR:
        raise ValueError("hex_to_tet_split requires a HEX_LINEAR mesh")

    connectivity = mesh.connectivity[:, HEX_TO_TET_LOCAL].reshape(-1, 4)
    blocks = {
        name: (idx[:, None] * 6 + np.arange(6, dtype=np.intp)).ravel()
        for name, idx in mesh.element_blocks.items()}

    side_sets: dict[str, np.ndarray] = {}
    for name, pairs in mesh.side_sets.items():
        if pairs.shape[0] == 0:
            side_sets[name] = np.empty((0, 2), dtype=np.intp)
            continue
        tet_pairs = HEX_FACE_TO_TET_FACES[pairs[:, 1]]   # (n, 2, 2)
        tet_ids = pairs[:, 0, None] * 6 + tet_pairs[:, :, 0]
        side_sets[name] = np.stack(
            [tet_ids, tet_pairs[:, :, 1]], axis=-1).reshape(-1, 2)

    return Mesh(nodes=mesh.nodes.copy(), connectivity=connectivity,
                element_family=ElementFamily.TET_LINEAR,
                element_blocks=blocks,
                node_sets={k: v.copy() for k, v in mesh.node_sets.items()},
                side_sets=side_sets,
                element_block_ids=dict(mesh.element_block_ids),
                node_set_ids=dict(mesh.node_set_ids),
                side_set_ids=dict(mesh.side_set_ids))


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
