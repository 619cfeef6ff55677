"""Mesh-file suffix dispatch.

Port of ``cmad_tpu/io/mesh_io.py`` (parity: reference
``cmad/io/mesh_io.py``). The gmsh reader is not ported yet (ROADMAP
queue 1, item 9).
"""
from __future__ import annotations

from pathlib import Path

from cmad_tpu_torch.fem.mesh import Mesh


def read_mesh_file(path: Path) -> Mesh:
    path = Path(path)
    suffix = path.suffix.lower()
    if suffix in (".exo", ".e", ".ex2"):
        from cmad_tpu_torch.io.exodus import read_mesh
        return read_mesh(path)
    if suffix == ".msh":
        raise NotImplementedError(
            "gmsh meshes (.msh) are not ported yet: ROADMAP queue 1, "
            "item 9 (io/gmsh.py)")
    raise ValueError(
        f"unsupported mesh extension {suffix!r} (path: {path}); "
        f"supported: .exo, .e, .ex2")
