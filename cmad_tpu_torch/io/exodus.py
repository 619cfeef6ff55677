"""Exodus II mesh and results I/O (pure Python, no netCDF4 dependency).

Port of ``cmad_tpu/io/exodus.py`` (parity: reference
``cmad/io/exodus.py:247,433,846``). Files are written in NetCDF3
64-bit-offset through ``scipy.io.netcdf_file``, readable by every Exodus
consumer (and by the JAX package's reader, bit for bit).
Reading sniffs the magic bytes and dispatches:
NetCDF3 classic/64-bit-offset files go through scipy; netCDF4/HDF5
files (the default output of modern Exodus producers — SEACAS, Cubit,
meshio) go through an h5py-backed view of the netCDF4-on-HDF5 layout
(:class:`_H5NetCDF`), so both formats read through the same code paths.
``h5py`` is imported only for an HDF5 file.

Supported subset (everything the framework produces/consumes):
- mesh: coordinates, element blocks (hex8 / tet4), node sets, side sets,
  names + integer ids
- results: time steps, nodal variables, per-block element variables

Component order note: cmad's sym-tensor storage is
[00, 01, 02, 11, 12, 22]; Exodus convention is XX YY ZZ XY YZ ZX. The
writer/reader permute at the boundary (see results.py).
"""
from __future__ import annotations

from pathlib import Path

import numpy as np
from scipy.io import netcdf_file

from cmad_tpu_torch.fem.mesh import Mesh
from cmad_tpu_torch.fem.topology import ElementFamily

_LEN_STRING = 33
_LEN_LINE = 81

_ELEM_TYPE_BY_FAMILY = {ElementFamily.HEX_LINEAR: "HEX8",
                        ElementFamily.TET_LINEAR: "TETRA4"}
_FAMILY_BY_ELEM_TYPE = {
    "HEX8": ElementFamily.HEX_LINEAR, "HEX": ElementFamily.HEX_LINEAR,
    "TETRA4": ElementFamily.TET_LINEAR, "TETRA": ElementFamily.TET_LINEAR,
    "TET4": ElementFamily.TET_LINEAR,
}


class ExodusFormatError(ValueError):
    pass


def _pad_name(name: str, length: int = _LEN_STRING) -> np.ndarray:
    raw = name.encode()[: length - 1]
    out = np.zeros(length, dtype="S1")
    out[: len(raw)] = np.frombuffer(raw, dtype="S1")
    return out


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


class ExodusWriter:
    """Write a mesh skeleton + time-stepped nodal / element variables.

    Variable schemas are fixed at open; steps append via
    :meth:`write_step`. Sym-tensor permutation to Exodus order is the
    caller's job (io/results.py helpers).
    """

    def __init__(self, path: Path, mesh: Mesh,
                 nodal_var_names: list[str] | None = None,
                 element_var_names=None,
                 title: str = "cmad_tpu_torch output") -> None:
        self._mesh = mesh
        self._nodal = list(nodal_var_names or [])
        # element_var_names: flat list (every block stores every
        # variable) or per-block dict {block name: [var names]} — the
        # reference's per-block element schema with an elem_var_tab
        # truth table (cmad/io/exodus.py:813-828)
        if isinstance(element_var_names, dict):
            unknown = sorted(set(element_var_names)
                             - set(mesh.element_blocks))
            if unknown:
                raise ValueError(
                    f"element schema names unknown blocks {unknown}; "
                    f"mesh blocks: {sorted(mesh.element_blocks)}")
            self._elem = []
            for names in element_var_names.values():
                for n in names:
                    if n not in self._elem:
                        self._elem.append(n)
            self._elem_blocks_by_var = {
                n: {b for b, names in element_var_names.items()
                    if n in names}
                for n in self._elem}
        else:
            self._elem = list(element_var_names or [])
            self._elem_blocks_by_var = {
                n: set(mesh.element_blocks) for n in self._elem}
        self._num_steps = 0

        nc = netcdf_file(str(path), "w", version=2, mmap=False)
        self._nc = nc
        nc.title = title.encode()
        nc.api_version = np.float32(8.03)
        nc.version = np.float32(8.03)
        nc.floating_point_word_size = np.int32(8)
        nc.file_size = np.int32(1)

        n_nodes, n_elems = mesh.nodes.shape[0], mesh.connectivity.shape[0]
        blocks = list(mesh.element_blocks.items())

        # scipy's NetCDF3 writer requires the unlimited dimension first
        nc.createDimension("time_step", None)
        nc.createDimension("len_string", _LEN_STRING)
        nc.createDimension("len_line", _LEN_LINE)
        nc.createDimension("four", 4)
        nc.createDimension("num_dim", 3)
        nc.createDimension("num_nodes", n_nodes)
        nc.createDimension("num_elem", n_elems)
        nc.createDimension("num_el_blk", len(blocks))

        v = nc.createVariable("time_whole", "d", ("time_step",))
        del v

        for ax_i, ax in enumerate("xyz"):
            var = nc.createVariable(f"coord{ax}", "d", ("num_nodes",))
            var[:] = np.asarray(mesh.nodes[:, ax_i], dtype=float)
        names = nc.createVariable("coor_names", "c",
                                  ("num_dim", "len_string"))
        for i, ax in enumerate("xyz"):
            names[i] = _pad_name(ax)

        eb_prop = nc.createVariable("eb_prop1", "i", ("num_el_blk",))
        eb_prop.name = b"ID"
        eb_names = nc.createVariable("eb_names", "c",
                                     ("num_el_blk", "len_string"))
        etype = _ELEM_TYPE_BY_FAMILY[mesh.element_family]
        npe = mesh.connectivity.shape[1]
        for b, (name, idx) in enumerate(blocks):
            bid = mesh.element_block_ids.get(name, b + 1)
            eb_prop[b] = bid
            eb_names[b] = _pad_name(name)
            nc.createDimension(f"num_el_in_blk{b + 1}", len(idx))
            nc.createDimension(f"num_nod_per_el{b + 1}", npe)
            conn = nc.createVariable(
                f"connect{b + 1}", "i",
                (f"num_el_in_blk{b + 1}", f"num_nod_per_el{b + 1}"))
            conn.elem_type = etype.encode()
            conn[:] = np.asarray(mesh.connectivity[idx] + 1,
                                 dtype=np.int32)

        if mesh.node_sets:
            ns = list(mesh.node_sets.items())
            nc.createDimension("num_node_sets", len(ns))
            prop = nc.createVariable("ns_prop1", "i", ("num_node_sets",))
            prop.name = b"ID"
            ns_names = nc.createVariable("ns_names", "c",
                                         ("num_node_sets", "len_string"))
            for k, (name, idx) in enumerate(ns):
                prop[k] = mesh.node_set_ids.get(name, k + 1)
                ns_names[k] = _pad_name(name)
                nc.createDimension(f"num_nod_ns{k + 1}", len(idx))
                var = nc.createVariable(f"node_ns{k + 1}", "i",
                                        (f"num_nod_ns{k + 1}",))
                var[:] = np.asarray(idx + 1, dtype=np.int32)

        if mesh.side_sets:
            ss = list(mesh.side_sets.items())
            nc.createDimension("num_side_sets", len(ss))
            prop = nc.createVariable("ss_prop1", "i", ("num_side_sets",))
            prop.name = b"ID"
            ss_names = nc.createVariable("ss_names", "c",
                                         ("num_side_sets", "len_string"))
            for k, (name, pairs) in enumerate(ss):
                prop[k] = mesh.side_set_ids.get(name, k + 1)
                ss_names[k] = _pad_name(name)
                nc.createDimension(f"num_side_ss{k + 1}", pairs.shape[0])
                ev = nc.createVariable(f"elem_ss{k + 1}", "i",
                                       (f"num_side_ss{k + 1}",))
                sv = nc.createVariable(f"side_ss{k + 1}", "i",
                                       (f"num_side_ss{k + 1}",))
                ev[:] = np.asarray(pairs[:, 0] + 1, dtype=np.int32)
                sv[:] = np.asarray(pairs[:, 1] + 1, dtype=np.int32)

        if self._nodal:
            nc.createDimension("num_nod_var", len(self._nodal))
            names = nc.createVariable("name_nod_var", "c",
                                      ("num_nod_var", "len_string"))
            for i, name in enumerate(self._nodal):
                names[i] = _pad_name(name)
            self._nodal_vars = [
                nc.createVariable(f"vals_nod_var{i + 1}", "d",
                                  ("time_step", "num_nodes"))
                for i in range(len(self._nodal))]

        if self._elem:
            nc.createDimension("num_elem_var", len(self._elem))
            names = nc.createVariable("name_elem_var", "c",
                                      ("num_elem_var", "len_string"))
            for i, name in enumerate(self._elem):
                names[i] = _pad_name(name)
            truth = np.zeros((len(blocks), len(self._elem)),
                             dtype=np.int32)
            for i, name in enumerate(self._elem):
                for b, (bname, _) in enumerate(blocks):
                    if bname in self._elem_blocks_by_var[name]:
                        truth[b, i] = 1
            tab = nc.createVariable("elem_var_tab", "i",
                                    ("num_el_blk", "num_elem_var"))
            tab[:] = truth
            self._elem_vars = {}
            for i in range(len(self._elem)):
                for b in range(len(blocks)):
                    if truth[b, i]:
                        self._elem_vars[(i, b)] = nc.createVariable(
                            f"vals_elem_var{i + 1}eb{b + 1}", "d",
                            ("time_step", f"num_el_in_blk{b + 1}"))

        self._block_names = [n for n, _ in blocks]

    def write_step(self, t: float,
                   nodal_values: dict[str, np.ndarray] | None = None,
                   element_values: dict[str, dict[str, np.ndarray]]
                   | None = None) -> None:
        """Append one time step.

        ``nodal_values``: var name -> (num_nodes,) array;
        ``element_values``: var name -> {block name -> (n_elems_b,)}.
        """
        n_nodes = self._mesh.nodes.shape[0]
        for name, vals in (nodal_values or {}).items():
            if name not in self._nodal:
                raise ValueError(
                    f"nodal variable {name!r} not in the writer schema "
                    f"{self._nodal}; schemas are fixed at open")
            vals = np.asarray(vals, dtype=float)
            if vals.shape != (n_nodes,):
                raise ValueError(
                    f"nodal variable {name!r}: shape {vals.shape} != "
                    f"({n_nodes},)")
        for name, by_block in (element_values or {}).items():
            if name not in self._elem:
                raise ValueError(
                    f"element variable {name!r} not in the writer schema "
                    f"{self._elem}; schemas are fixed at open")
            for bname, vals in by_block.items():
                if bname not in self._block_names:
                    raise ValueError(
                        f"element variable {name!r}: unknown block "
                        f"{bname!r}; blocks: {self._block_names}")
                if bname not in self._elem_blocks_by_var[name]:
                    raise ValueError(
                        f"element variable {name!r} is not declared on "
                        f"block {bname!r} (truth-table bit is 0; "
                        f"declared blocks: "
                        f"{sorted(self._elem_blocks_by_var[name])})")
                vals = np.asarray(vals, dtype=float)
                n_b = len(self._mesh.element_blocks[bname])
                if vals.shape != (n_b,):
                    raise ValueError(
                        f"element variable {name!r} block {bname!r}: "
                        f"shape {vals.shape} != ({n_b},)")

        s = self._num_steps
        self._nc.variables["time_whole"][s] = float(t)
        for name, vals in (nodal_values or {}).items():
            i = self._nodal.index(name)
            self._nodal_vars[i][s] = np.asarray(vals, dtype=float)
        for name, by_block in (element_values or {}).items():
            i = self._elem.index(name)
            for b, bname in enumerate(self._block_names):
                if bname in by_block:
                    self._elem_vars[(i, b)][s] = np.asarray(
                        by_block[bname], dtype=float)
        self._num_steps += 1

    def close(self) -> None:
        self._nc.close()


def read_results(path: Path, nodal_field_specs=None,
                 element_field_specs=None,
                 field_name_aliases=None):
    """Read time steps + named nodal/element variables.

    Returns an :class:`cmad_tpu_torch.io.results.ExodusResults`. Vector/tensor
    fields are reassembled from their per-component variables using the
    component suffix conventions in io/results.py. With no specs, every
    stored variable is returned raw under its per-component name (nodal
    arrays ``(steps, nodes)``; element fields as ``{block: array}``).

    ``element_field_specs`` takes either a flat sequence of FieldSpecs
    (read from every block that stores the variable — blocks whose
    truth-table bit is 0 are skipped) or, for reference parity
    (``cmad/io/exodus.py:433`` ``read_results``), a per-block dict
    ``{block name: [FieldSpec, ...]}``; explicitly requesting a
    variable on a block that does not store it raises
    :class:`ExodusFormatError`, as does naming a block not in the file.

    ``field_name_aliases`` maps requested spec name -> on-disk root
    name (read-side only; returned keys are always the spec name). An
    alias key that no spec declares raises — reference parity with
    ``cmad/io/exodus.py:447-451``.
    """
    from cmad_tpu_torch.io.results import ExodusResults, component_names

    aliases = dict(field_name_aliases or {})
    declared = {s.name for s in (nodal_field_specs or [])}
    if isinstance(element_field_specs, dict):
        for specs in element_field_specs.values():
            declared |= {s.name for s in specs}
    elif element_field_specs:
        declared |= {s.name for s in element_field_specs}
    unknown = sorted(set(aliases) - declared)
    if unknown:
        raise ExodusFormatError(
            f"field name aliases {unknown} do not match any requested "
            f"spec name (specs declare {sorted(declared)})")

    nc = _open_read(Path(path))
    try:
        times = np.asarray(nc.variables["time_whole"][:]).astype(float)

        def nodal_series(idx):
            """Per-variable series (steps, nodes): handles both the
            large-model layout (vals_nod_var{i}) this writer emits and
            the classic packed layout (vals_nod_var[time, var, node])
            netCDF4-based writers like the reference produce."""
            key = f"vals_nod_var{idx + 1}"
            if key in nc.variables:
                return np.asarray(nc.variables[key][:]).astype(float)
            return np.asarray(
                nc.variables["vals_nod_var"][:, idx, :]).astype(float)

        nodal = {}
        if nodal_field_specs is None and "name_nod_var" in nc.variables:
            names = _decode_names(nc.variables["name_nod_var"][:])
            for i, name in enumerate(names):
                nodal[name] = nodal_series(i)
        if nodal_field_specs:
            names = (_decode_names(nc.variables["name_nod_var"][:])
                     if "name_nod_var" in nc.variables else [])
            for spec in nodal_field_specs:
                root = aliases.get(spec.name, spec.name)
                comps = component_names(root, spec.var_type)
                cols = []
                for comp in comps:
                    if comp not in names:
                        raise ExodusFormatError(
                            f"requested nodal component {comp!r} not "
                            f"found in file (have {sorted(names)})")
                    cols.append(nodal_series(names.index(comp)))
                nodal[spec.name] = np.stack(cols, axis=-1)

        def elem_context():
            names = (_decode_names(nc.variables["name_elem_var"][:])
                     if "name_elem_var" in nc.variables else [])
            n_blocks = int(nc.dimensions.get("num_el_blk", 1))
            block_names = (_decode_names(nc.variables["eb_names"][:])
                           if "eb_names" in nc.variables
                           else [f"block_{b+1}" for b in range(n_blocks)])
            return names, n_blocks, block_names

        def elem_block_series(names, spec, b, block_name, required):
            """(steps, n_elems_b, n_comps) for one spec on one block, or
            None when the block does not store it and not required."""
            root = aliases.get(spec.name, spec.name)
            comps = component_names(root, spec.var_type)
            cols = []
            for comp in comps:
                if comp not in names:
                    raise ExodusFormatError(
                        f"requested element component {comp!r} not "
                        f"found in file (have {sorted(names)})")
                key = f"vals_elem_var{names.index(comp) + 1}eb{b + 1}"
                if key not in nc.variables:
                    if required or cols:
                        raise ExodusFormatError(
                            f"element variable {comp!r} not stored on "
                            f"block {block_name!r} (truth-table bit is "
                            f"0 / no {key} variable)")
                    return None
                cols.append(np.asarray(
                    nc.variables[key][:]).astype(float))
            return np.stack(cols, axis=-1)

        element = {}
        if element_field_specs is None and "name_elem_var" in nc.variables:
            names, n_blocks, block_names = elem_context()
            for i, name in enumerate(names):
                by_block = {}
                for b in range(n_blocks):
                    key = f"vals_elem_var{i + 1}eb{b + 1}"
                    if key in nc.variables:
                        by_block[block_names[b]] = np.asarray(
                            nc.variables[key][:]).astype(float)
                element[name] = by_block
        elif isinstance(element_field_specs, dict):
            names, n_blocks, block_names = elem_context()
            for block_name, specs in element_field_specs.items():
                if block_name not in block_names:
                    raise ExodusFormatError(
                        f"requested block {block_name!r} not in file "
                        f"(blocks: {block_names})")
                b = block_names.index(block_name)
                for spec in specs:
                    series = elem_block_series(
                        names, spec, b, block_name, required=True)
                    element.setdefault(spec.name, {})[block_name] = series
        elif element_field_specs:
            names, n_blocks, block_names = elem_context()
            for spec in element_field_specs:
                by_block = {}
                for b in range(n_blocks):
                    series = elem_block_series(
                        names, spec, b, block_names[b], required=False)
                    if series is not None:
                        by_block[block_names[b]] = series
                element[spec.name] = by_block
        return ExodusResults(times=times, nodal=nodal, element=element)
    finally:
        nc.close()
