"""Element families + reference-element topology tables.

Port of ``cmad_tpu/fem/topology.py`` (numpy only, unchanged; parity:
reference ``cmad/fem/element_family.py`` + ``cmad/fem/topology.py``
merged into one leaf module). Owns the per-family static tables: local
face/edge/vertex incidence, reference node coordinates, the hex->tet body
diagonal split, and the affine side lifts used by surface integration.

Conventions (Exodus 0-based):
- hex local faces: 0:-z 1:+z 2:-y 3:+x 4:+y 5:-x
- tet local faces: 0:-y 1:slant 2:-x 3:-z (tet nodes origin,+x,+y,+z)
- hex nodes: bottom face CCW from (-,-,-), then top face CCW from (-,-,+)
- face vertex rows are CCW viewed from outside, so the right-hand-rule
  cross product of the side-lift tangent columns points outward.
"""
from __future__ import annotations

from enum import IntEnum

import numpy as np


class ElementFamily(IntEnum):
    HEX_LINEAR = 0
    TET_LINEAR = 1


NODES_PER_ELEMENT = {ElementFamily.HEX_LINEAR: 8,
                     ElementFamily.TET_LINEAR: 4}
FACES_PER_ELEMENT = {ElementFamily.HEX_LINEAR: 6,
                     ElementFamily.TET_LINEAR: 4}

HEX_REF_NODES = np.array([
    [-1, -1, -1], [1, -1, -1], [1, 1, -1], [-1, 1, -1],
    [-1, -1, 1], [1, -1, 1], [1, 1, 1], [-1, 1, 1]], dtype=float)

TET_REF_NODES = np.array([
    [0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1]], dtype=float)

REF_NODES = {ElementFamily.HEX_LINEAR: HEX_REF_NODES,
             ElementFamily.TET_LINEAR: TET_REF_NODES}

HEX_FACE_NODES = np.array([
    [0, 3, 2, 1],   # -z
    [4, 5, 6, 7],   # +z
    [0, 1, 5, 4],   # -y
    [1, 2, 6, 5],   # +x
    [2, 3, 7, 6],   # +y
    [3, 0, 4, 7],   # -x
], dtype=np.intp)

TET_FACE_NODES = np.array([
    [0, 1, 3],   # -y
    [1, 2, 3],   # slant
    [0, 3, 2],   # -x
    [0, 2, 1],   # -z
], dtype=np.intp)

LOCAL_FACES = {ElementFamily.HEX_LINEAR: HEX_FACE_NODES,
               ElementFamily.TET_LINEAR: TET_FACE_NODES}
# sides == faces for 3D families (2D families would alias edge tables)
LOCAL_SIDES = LOCAL_FACES

HEX_LOCAL_EDGES = np.array([
    [0, 1], [1, 2], [2, 3], [3, 0],
    [4, 5], [5, 6], [6, 7], [7, 4],
    [0, 4], [1, 5], [2, 6], [3, 7]], dtype=np.intp)

TET_LOCAL_EDGES = np.array([
    [0, 1], [0, 2], [0, 3], [1, 2], [1, 3], [2, 3]], dtype=np.intp)

LOCAL_EDGES = {ElementFamily.HEX_LINEAR: HEX_LOCAL_EDGES,
               ElementFamily.TET_LINEAR: TET_LOCAL_EDGES}

# 6-tet split of a hex along the 0-6 body diagonal; rows are tet nodes in
# tet_linear order. All positive-volume on a positively-oriented hex.
HEX_TO_TET_LOCAL = np.array([
    [0, 1, 2, 6],
    [0, 2, 3, 6],
    [0, 3, 7, 6],
    [0, 7, 4, 6],
    [0, 4, 5, 6],
    [0, 5, 1, 6]], dtype=np.intp)

# hex face id -> the 2 (tet_local_idx, tet_face_id) pairs it splits into
HEX_FACE_TO_TET_FACES = np.array([
    [[0, 3], [1, 3]],   # -z
    [[3, 1], [4, 1]],   # +z
    [[4, 3], [5, 3]],   # -y
    [[0, 1], [5, 1]],   # +x
    [[1, 1], [2, 1]],   # +y
    [[2, 3], [3, 3]],   # -x
], dtype=np.intp)


def ref_side_lift(family: ElementFamily,
                  local_side_id: int) -> tuple[np.ndarray, np.ndarray]:
    """(origin, tangents) such that a side quadrature point ``(s, t)``
    lifts to the reference-volume coordinate ``origin + tangents @ [s,t]``.

    Hex faces parameterize over [-1,1]^2 (pairs with quad_quadrature);
    tet faces over the unit triangle (pairs with tri_quadrature). The
    tangent-column cross product points outward.
    """
    verts = REF_NODES[family][LOCAL_SIDES[family][local_side_id]]
    if family == ElementFamily.HEX_LINEAR:
        origin = verts.mean(axis=0)
        ds = 0.25 * (-verts[0] + verts[1] + verts[2] - verts[3])
        dt = 0.25 * (-verts[0] - verts[1] + verts[2] + verts[3])
    else:
        origin = verts[0]
        ds = verts[1] - verts[0]
        dt = verts[2] - verts[0]
    return origin, np.stack([ds, dt], axis=1)
