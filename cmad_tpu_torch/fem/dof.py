"""Global DOF management with formula-based equation numbering.

Port of ``cmad_tpu/fem/dof.py`` (parity: reference
``cmad/fem/dof.py:91-678``), numpy only: the FE drivers evaluate the
prescribed values on the host once per time step (``t`` is a host
float) and move them to the device once. Field-major numbering:
``eq = block_offsets[f] + basis_fn * ndofs_per_basis_fn[f] + component``;
no eq table is stored. Dirichlet BCs resolve to per-BC flat equation
indices plus a global sorted-deduped ``prescribed_indices`` union;
structurally overprescribed positions are recorded at build time so the
runtime value-consistency check only walks that (usually tiny) set.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from cmad_tpu_torch.fem.bcs import DirichletBC
from cmad_tpu_torch.fem.elements import EntityType, FiniteElement
from cmad_tpu_torch.fem.mesh import Mesh

# Per-BC (positions, set_coords) pairs for prescribed-value evaluation:
# positions index into the flat prescribed vector, set_coords are the
# BC's deduplicated boundary-vertex coordinates (numpy, host).
DBCArrays = tuple


@dataclass(frozen=True)
class GlobalFieldLayout:
    """One field's name + FiniteElement; component count is owned by the
    GR and threaded through build_dof_map's components_by_field."""

    name: str
    finite_element: FiniteElement


@dataclass(frozen=True)
class ResolvedDirichletBC:
    """BC + cached boundary-vertex coords + flat global eq numbers
    (vertex-major, dof-minor)."""

    bc: DirichletBC
    set_coords: np.ndarray
    eq_indices: np.ndarray


@dataclass(frozen=True)
class GlobalDofMap:
    field_layouts: list[GlobalFieldLayout]
    num_dofs_per_basis_fn: np.ndarray
    block_offsets: np.ndarray
    prescribed_indices: np.ndarray
    resolved_bcs: list[ResolvedDirichletBC]
    # positions into prescribed_indices written by >1 BC, with
    # (bc_idx, bc_eq_idx) contributors
    overprescribed: list[tuple[int, list[tuple[int, int]]]]

    @property
    def num_total_dofs(self) -> int:
        return int(self.block_offsets[-1])

    def _decode_eq(self, eq: int) -> tuple[int, int, int]:
        f = int(np.searchsorted(self.block_offsets, eq, side="right")) - 1
        local = eq - int(self.block_offsets[f])
        nd = int(self.num_dofs_per_basis_fn[f])
        return f, local // nd, local % nd

    def dirichlet_eqs_for_component(self, sideset: str, field: str,
                                    component: int) -> np.ndarray:
        """Global eqs of (field, component) prescribed on ``sideset``,
        sorted and unique: where the load-matching QoI reads its
        reaction."""
        cols = []
        for rbc in self.resolved_bcs:
            bc = rbc.bc
            if (sideset in bc.sideset_names and bc.field_name == field
                    and component in bc.dofs):
                dofs = list(bc.dofs)
                n_set = rbc.eq_indices.shape[0] // len(dofs)
                cols.append(rbc.eq_indices.reshape(n_set, len(dofs))[
                    :, dofs.index(component)])
        if not cols:
            raise ValueError(
                f"no Dirichlet BC prescribes component {component} of "
                f"field {field!r} on sideset {sideset!r}")
        return np.unique(np.concatenate(cols))

    def evaluate_prescribed_values(self, dbc_arrays: DBCArrays,
                                   t: float = 0.0) -> np.ndarray:
        """Prescribed values at the host time ``t`` (float64, numpy).

        Materializes each BC (None / constants / callable), scatters into
        the flat prescribed vector (last-writer-wins), then validates
        agreement on the overprescribed set.
        """
        n = len(self.prescribed_indices)
        if n == 0:
            return np.empty(0, dtype=np.float64)

        bc_vals = []
        for rbc, (_pos, coords) in zip(self.resolved_bcs, dbc_arrays,
                                       strict=True):
            n_set = coords.shape[0]
            n_dofs = len(rbc.bc.dofs)
            v = rbc.bc.values
            if v is None:
                vals = np.zeros((n_set, n_dofs), dtype=np.float64)
            elif callable(v):
                vals = np.asarray(v(coords, t), dtype=np.float64)
                if vals.shape != (n_set, n_dofs):
                    raise ValueError(
                        f"DirichletBC values callable returned "
                        f"{vals.shape}; expected {(n_set, n_dofs)}")
            else:
                vals = np.broadcast_to(
                    np.asarray(v, dtype=np.float64), (n_set, n_dofs))
            bc_vals.append(vals.ravel())

        out = np.zeros(n, dtype=np.float64)
        for (pos, _coords), vals in zip(dbc_arrays, bc_vals, strict=True):
            out[pos] = vals

        for position, contributors in self.overprescribed:
            ref_bc, ref_eq = contributors[0]
            ref = float(bc_vals[ref_bc][ref_eq])
            for bc_i, eq_i in contributors[1:]:
                v = float(bc_vals[bc_i][eq_i])
                if not np.isclose(v, ref, rtol=1e-12, atol=1e-12):
                    eq = int(self.prescribed_indices[position])
                    f, bfn, dof = self._decode_eq(eq)
                    raise ValueError(
                        f"inconsistent DirichletBC values at eq {eq} "
                        f"(field={self.field_layouts[f].name!r}, "
                        f"basis_fn={bfn}, dof={dof}, t={t}): "
                        f"BC #{ref_bc} gives {ref}, BC #{bc_i} "
                        f"gives {v}")
        return out


def _num_basis_fns(layout: GlobalFieldLayout, mesh: Mesh) -> int:
    return sum(mesh.entity_count(et) * n
               for et, n in layout.finite_element.dofs_per_entity.items())


def build_dof_map(mesh: Mesh, field_layouts: list[GlobalFieldLayout],
                  bcs: list[DirichletBC],
                  components_by_field: dict[str, int]) -> GlobalDofMap:
    """Resolve field layouts + DBCs against the mesh.

    Validates name uniqueness, FE/mesh family agreement, and component
    counts; resolves each BC's sidesets to deduped boundary vertices and
    flat equation numbers; builds the sorted global prescribed union and
    the overprescribed contributor groups.
    """
    names = [fl.name for fl in field_layouts]
    if len(set(names)) != len(names):
        raise ValueError(f"field layout names must be unique; got {names}")
    for fl in field_layouts:
        if fl.finite_element.element_family != mesh.element_family:
            raise ValueError(
                f"field {fl.name!r}: FE family "
                f"{fl.finite_element.element_family.name} != mesh family "
                f"{mesh.element_family.name}")
    if set(components_by_field) != set(names):
        raise ValueError(
            f"components_by_field keys {sorted(components_by_field)} must "
            f"match field names {sorted(names)}")
    if any(v < 1 for v in components_by_field.values()):
        raise ValueError("components_by_field values must be >= 1")

    ndofs = np.array([components_by_field[n] for n in names], dtype=np.intp)
    sizes = [_num_basis_fns(fl, mesh) * int(ndofs[i])
             for i, fl in enumerate(field_layouts)]
    block_offsets = np.concatenate([[0], np.cumsum(sizes)]).astype(np.intp)
    name_to_idx = {n: i for i, n in enumerate(names)}

    resolved: list[ResolvedDirichletBC] = []
    for bc in bcs:
        if bc.field_name not in name_to_idx:
            raise ValueError(
                f"DirichletBC field {bc.field_name!r} unknown; "
                f"fields: {names}")
        fi = name_to_idx[bc.field_name]
        fe = field_layouts[fi].finite_element
        nd = int(ndofs[fi])
        if any(d < 0 or d >= nd for d in bc.dofs):
            raise ValueError(
                f"DirichletBC on {bc.field_name!r}: dofs {list(bc.dofs)} "
                f"outside [0, {nd})")
        vpd = fe.dofs_per_entity.get(EntityType.VERTEX, 0)
        if vpd == 0:
            raise ValueError(
                f"DirichletBC on {bc.field_name!r}: FE {fe.name!r} has no "
                "VERTEX DOFs; sideset BCs address vertex DOFs only")
        if vpd > 1:
            raise NotImplementedError(
                f"DirichletBC on {bc.field_name!r}: multiplicity "
                f"{vpd} > 1 per vertex is unsupported")

        vert_lists = []
        for ss in bc.sideset_names:
            if ss not in mesh.side_sets:
                raise KeyError(
                    f"DirichletBC sideset {ss!r} unknown; sidesets: "
                    f"{sorted(mesh.side_sets)}")
            pairs = mesh.side_sets[ss]
            if pairs.shape[0]:
                slots = np.stack([fe.side_basis_fns(int(s))
                                  for s in pairs[:, 1]])
                vert_lists.append(
                    mesh.connectivity[pairs[:, 0, None], slots].ravel())
        verts = (np.unique(np.concatenate(vert_lists))
                 if vert_lists else np.empty(0, dtype=np.intp))

        dofs = np.asarray(list(bc.dofs), dtype=np.intp)
        eq = (block_offsets[fi] + verts[:, None] * nd
              + dofs[None, :]).ravel().astype(np.intp)
        resolved.append(ResolvedDirichletBC(
            bc=bc, set_coords=mesh.nodes[verts].astype(np.float64),
            eq_indices=eq))

    if resolved:
        chunks = [r.eq_indices for r in resolved]
        all_eqs = np.concatenate(chunks)
        bc_idx = np.repeat(np.arange(len(chunks)),
                           [c.size for c in chunks])
        bc_eq_idx = np.concatenate(
            [np.arange(c.size) for c in chunks])
        order = np.argsort(all_eqs, kind="stable")
        prescribed, starts, counts = np.unique(
            all_eqs[order], return_index=True, return_counts=True)
        over = []
        for p in np.flatnonzero(counts > 1):
            contribs = [(int(bc_idx[order[starts[p] + k]]),
                         int(bc_eq_idx[order[starts[p] + k]]))
                        for k in range(int(counts[p]))]
            over.append((int(p), contribs))
        prescribed = prescribed.astype(np.intp)
    else:
        prescribed = np.empty(0, dtype=np.intp)
        over = []

    return GlobalDofMap(field_layouts=list(field_layouts),
                        num_dofs_per_basis_fn=ndofs,
                        block_offsets=block_offsets,
                        prescribed_indices=prescribed,
                        resolved_bcs=resolved,
                        overprescribed=over)


def build_dbc_arrays(dof_map: GlobalDofMap) -> DBCArrays:
    """Per-BC (positions, set_coords) scatter arrays, precomputed once
    (numpy, host)."""
    presc = dof_map.prescribed_indices
    return tuple(
        (np.searchsorted(presc, rbc.eq_indices), rbc.set_coords)
        for rbc in dof_map.resolved_bcs)
