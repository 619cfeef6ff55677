"""Element families + reference-element topology tables.

Port of ``cmad_tpu/fem/topology.py`` (numpy only, unchanged; parity:
reference ``cmad/fem/element_family.py`` + ``cmad/fem/topology.py``
merged into one leaf module). Owns the per-family static tables: local
face/edge/vertex incidence and the reference node coordinates. The
hex->tet split and the side lifts of surface integration come with the
in-house mesh builders and Neumann loads (ROADMAP queue 1, item 8).

Conventions (Exodus 0-based):
- hex local faces: 0:-z 1:+z 2:-y 3:+x 4:+y 5:-x
- tet local faces: 0:-y 1:slant 2:-x 3:-z (tet nodes origin,+x,+y,+z)
- hex nodes: bottom face CCW from (-,-,-), then top face CCW from (-,-,+)
- face vertex rows are CCW viewed from outside.
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
