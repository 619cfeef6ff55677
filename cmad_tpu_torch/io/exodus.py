"""Exodus II mesh reader (pure Python, no netCDF4 dependency).

Port of the read path of ``cmad_tpu/io/exodus.py`` (parity: reference
``cmad/io/exodus.py:247``); the writers come with the FE CLI (ROADMAP
queue 1, item 18). Reading sniffs the magic bytes and dispatches:
NetCDF3 classic/64-bit-offset files go through scipy; netCDF4/HDF5
files (the default output of modern Exodus producers — SEACAS, Cubit,
meshio) go through an h5py-backed view of the netCDF4-on-HDF5 layout
(:class:`_H5NetCDF`), so both formats read through the same code paths.
``h5py`` is imported only for an HDF5 file.

Supported subset: coordinates, element blocks (hex8 / tet4), node sets,
side sets, names + integer ids.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import netcdf_file

from cmad_tpu_torch.fem.mesh import Mesh
from cmad_tpu_torch.fem.topology import ElementFamily

_FAMILY_BY_ELEM_TYPE = {
    "HEX8": ElementFamily.HEX_LINEAR, "HEX": ElementFamily.HEX_LINEAR,
    "TETRA4": ElementFamily.TET_LINEAR, "TETRA": ElementFamily.TET_LINEAR,
    "TET4": ElementFamily.TET_LINEAR,
}


class ExodusFormatError(ValueError):
    pass


def _decode_names(char_array) -> list[str]:
    out = []
    for row in np.asarray(char_array):
        s = b"".join(x if isinstance(x, bytes) else bytes([x])
                     for x in row.tolist())
        out.append(s.split(b"\x00")[0].decode().strip())
    return out


_HDF5_MAGIC = b"\x89HDF"
_NOT_A_VARIABLE = b"This is a netCDF dimension but not a netCDF variable"


class _H5Var:
    """``netcdf_file``-variable shim over one h5py dataset: ``[...]``
    slicing plus NetCDF attributes as (bytes-normalized) attributes."""

    def __init__(self, ds) -> None:
        object.__setattr__(self, "_ds", ds)

    def __getitem__(self, key):
        return self._ds[key]

    def __getattr__(self, name):
        try:
            val = self._ds.attrs[name]
        except KeyError:
            raise AttributeError(name) from None
        if isinstance(val, str):
            return val.encode()
        if isinstance(val, np.ndarray) and val.dtype.kind == "S" \
                and val.shape == ():
            return bytes(val)
        return val


class _H5NetCDF:
    """Read-only ``netcdf_file``-compatible view of a netCDF4 (HDF5)
    Exodus file: ``dimensions`` from the HDF5 dimension scales,
    ``variables`` from the data-carrying datasets. Covers the flat
    (root-group) layout netCDF4 classic-model writers produce — which
    is what every Exodus producer emits."""

    def __init__(self, path: Path) -> None:
        import h5py

        self._f = h5py.File(str(path), "r")
        self.dimensions: dict[str, int] = {}
        self.variables: dict[str, _H5Var] = {}
        for name, ds in self._f.items():
            if not isinstance(ds, h5py.Dataset):
                continue
            cls = ds.attrs.get("CLASS", b"")
            if isinstance(cls, str):
                cls = cls.encode()
            if cls == b"DIMENSION_SCALE":
                self.dimensions[name] = (int(ds.shape[0]) if ds.shape
                                         else 0)
                nm = ds.attrs.get("NAME", b"")
                if isinstance(nm, str):
                    nm = nm.encode()
                if bytes(nm).startswith(_NOT_A_VARIABLE):
                    continue  # pure dimension — no variable data
            self.variables[name] = _H5Var(ds)

    def close(self) -> None:
        self._f.close()


def _open_read(path: Path):
    with open(path, "rb") as fh:
        magic = fh.read(4)
    if magic.startswith(_HDF5_MAGIC):
        try:
            return _H5NetCDF(path)
        except Exception as e:
            raise ExodusFormatError(
                f"cannot read {path} as a netCDF4/HDF5 Exodus file: "
                f"{e}") from e
    try:
        return netcdf_file(str(path), "r", mmap=False)
    except Exception as e:
        raise ExodusFormatError(
            f"cannot read {path} as NetCDF3 (magic {magic!r}): "
            f"{e}") from e


def read_mesh(path: Path) -> Mesh:
    """Read an Exodus II mesh (blocks, node sets, side sets, names/ids)."""
    path = Path(path)
    if not path.exists():
        raise FileNotFoundError(f"mesh file not found: {path}")
    nc = _open_read(path)
    try:
        dims = nc.dimensions
        n_nodes = int(dims["num_nodes"])
        ndim = int(dims["num_dim"])
        if ndim != 3:
            raise ExodusFormatError(f"only 3D meshes supported; got {ndim}")

        if "coord" in nc.variables:
            nodes = np.asarray(nc.variables["coord"][:]).T.astype(float)
        else:
            nodes = np.stack(
                [np.asarray(nc.variables[f"coord{ax}"][:])
                 for ax in "xyz"], axis=1).astype(float)
        assert nodes.shape == (n_nodes, 3)

        n_blocks = int(dims.get("num_el_blk", 1))
        block_ids = (np.asarray(nc.variables["eb_prop1"][:]).astype(int)
                     if "eb_prop1" in nc.variables
                     else np.arange(1, n_blocks + 1))
        block_names = (_decode_names(nc.variables["eb_names"][:])
                       if "eb_names" in nc.variables else [""] * n_blocks)

        conns, families, block_slices = [], [], {}
        offset = 0
        for b in range(n_blocks):
            conn = np.asarray(
                nc.variables[f"connect{b + 1}"][:]).astype(np.intp) - 1
            etype = getattr(nc.variables[f"connect{b + 1}"], "elem_type",
                            b"").decode().upper().rstrip("\x00")
            fam = _FAMILY_BY_ELEM_TYPE.get(etype)
            if fam is None:
                raise ExodusFormatError(
                    f"unsupported element type {etype!r} in block "
                    f"{b + 1}; supported: {sorted(_FAMILY_BY_ELEM_TYPE)}")
            families.append(fam)
            conns.append(conn)
            name = block_names[b] or f"block_{block_ids[b]}"
            block_slices[name] = (offset, offset + conn.shape[0],
                                  int(block_ids[b]))
            offset += conn.shape[0]
        if len(set(families)) != 1:
            raise ExodusFormatError(
                "mixed element families are not supported")
        connectivity = np.vstack(conns)

        element_blocks = {n: np.arange(lo, hi, dtype=np.intp)
                          for n, (lo, hi, _id) in block_slices.items()}
        element_block_ids = {n: bid
                             for n, (_lo, _hi, bid) in block_slices.items()}

        node_sets, node_set_ids = {}, {}
        n_ns = int(dims.get("num_node_sets", 0))
        if n_ns:
            ns_ids = np.asarray(nc.variables["ns_prop1"][:]).astype(int)
            ns_names = (_decode_names(nc.variables["ns_names"][:])
                        if "ns_names" in nc.variables else [""] * n_ns)
            for k in range(n_ns):
                name = ns_names[k] or f"nodeset_{ns_ids[k]}"
                node_sets[name] = np.asarray(
                    nc.variables[f"node_ns{k + 1}"][:]
                ).astype(np.intp) - 1
                node_set_ids[name] = int(ns_ids[k])

        side_sets, side_set_ids = {}, {}
        n_ss = int(dims.get("num_side_sets", 0))
        if n_ss:
            ss_ids = np.asarray(nc.variables["ss_prop1"][:]).astype(int)
            ss_names = (_decode_names(nc.variables["ss_names"][:])
                        if "ss_names" in nc.variables else [""] * n_ss)
            for k in range(n_ss):
                name = ss_names[k] or f"sideset_{ss_ids[k]}"
                elems = np.asarray(
                    nc.variables[f"elem_ss{k + 1}"][:]).astype(np.intp) - 1
                sides = np.asarray(
                    nc.variables[f"side_ss{k + 1}"][:]).astype(np.intp) - 1
                side_sets[name] = np.column_stack([elems, sides])
                side_set_ids[name] = int(ss_ids[k])

        return Mesh(nodes=nodes, connectivity=connectivity,
                    element_family=families[0],
                    element_blocks=element_blocks, node_sets=node_sets,
                    side_sets=side_sets,
                    element_block_ids=element_block_ids,
                    node_set_ids=node_set_ids, side_set_ids=side_set_ids)
    finally:
        nc.close()
