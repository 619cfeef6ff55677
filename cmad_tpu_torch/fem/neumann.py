"""Neumann (surface-flux) BC resolution and assembly.

Port of ``cmad_tpu/fem/neumann.py`` (parity: reference
``cmad/fem/neumann.py``). NBCs resolve at build time to
per-(family, local_side) element groups. Each group's surface geometry
comes from the isoparametric lift of the side quadrature
(``topology.ref_side_lift``): the area measure ``dA = |J t1 x J t2|`` at
each side IP, the physical IP coordinates and the side-restricted shape
values, computed once in float64 on the problem's device. The assembly
adds ``-N . tbar . dA . w`` into R, so ``R = R_int - F_ext``; K gets
nothing, since a prescribed traction does not depend on U.

The flux values are evaluated on the host (numpy callables, as the
Dirichlet values are): one call per NBC over all of its side IPs, then
one copy to the device. The sum into R is a segment sum over a plan fixed
at build (``ops/segment_sum.py``), so it adds each equation's entries in
the same order on the card as on the CPU, run after run.
"""
from __future__ import annotations

from collections.abc import Callable, Sequence
from dataclasses import dataclass

import numpy as np
import torch

from cmad_tpu_torch.fem.bcs import NeumannBC
from cmad_tpu_torch.fem.dof import GlobalDofMap
from cmad_tpu_torch.fem.elements import EntityType, FiniteElement
from cmad_tpu_torch.fem.mesh import Mesh
from cmad_tpu_torch.fem.quadrature import QuadratureRule
from cmad_tpu_torch.fem.topology import ElementFamily, ref_side_lift
from cmad_tpu_torch.ops.segment_sum import (
    SegmentPlan,
    plan_from_target,
    segment_sum,
)
from cmad_tpu_torch.typing import Tensor


@dataclass(frozen=True)
class ResolvedNeumannBC:
    field_idx: int
    num_components: int
    finite_element: FiniteElement
    elem_ids_by_side: dict[tuple[ElementFamily, int], np.ndarray]
    values: np.ndarray | Callable


@dataclass(frozen=True)
class NeumannSideArrays:
    """Per NBC, a dict keyed by (family, local_side_id) whose values are
    ``{"dA": (n_e, n_ip), "N_side": (n_ip, n_side_bf), "side_w": (n_ip,)}``
    on the device; ``coords`` holds each NBC's side-IP coordinates on the
    host, (n, 3) float64 over its groups in order, where the flux is
    evaluated; ``plan`` sums every (NBC, group, element, side basis fn,
    component) entry into its global equation."""

    groups: tuple[dict[tuple[ElementFamily, int], dict[str, Tensor]], ...]
    coords: tuple[np.ndarray, ...]
    plan: SegmentPlan


def resolve_neumann_bcs(mesh: Mesh, dof_map: GlobalDofMap,
                        neumann_bcs: Sequence[NeumannBC]
                        ) -> list[ResolvedNeumannBC]:
    name_to_idx = {fl.name: i for i, fl in enumerate(dof_map.field_layouts)}
    out: list[ResolvedNeumannBC] = []
    for k, bc in enumerate(neumann_bcs):
        if bc.field_name not in name_to_idx:
            raise ValueError(
                f"NeumannBC[{k}] field {bc.field_name!r} unknown; fields: "
                f"{sorted(name_to_idx)}")
        fi = name_to_idx[bc.field_name]
        fe = dof_map.field_layouts[fi].finite_element
        if not fe.vertex_only() or fe.dofs_per_entity.get(
                EntityType.VERTEX, 0) != 1:
            raise NotImplementedError(
                f"NeumannBC[{k}]: side resolution requires 1 VERTEX DOF "
                f"per basis fn (FE {fe.name!r})")
        ncomp = int(dof_map.num_dofs_per_basis_fn[fi])

        groups: dict[tuple[ElementFamily, int], list[int]] = {}
        for ss in bc.sideset_names:
            if ss not in mesh.side_sets:
                raise ValueError(
                    f"NeumannBC[{k}] sideset {ss!r} unknown; known: "
                    f"{sorted(mesh.side_sets)}")
            for elem_id, side_id in mesh.side_sets[ss]:
                groups.setdefault(
                    (mesh.element_family, int(side_id)), []).append(
                        int(elem_id))
        elem_ids = {key: np.unique(np.asarray(v, dtype=np.intp))
                    for key, v in groups.items()}

        if callable(bc.values):
            values = bc.values
        else:
            values = np.asarray(bc.values, dtype=np.float64)
            if values.shape != (ncomp,):
                raise ValueError(
                    f"NeumannBC[{k}] values shape {values.shape} != "
                    f"({ncomp},) for field {bc.field_name!r}")
        out.append(ResolvedNeumannBC(
            field_idx=fi, num_components=ncomp, finite_element=fe,
            elem_ids_by_side=elem_ids, values=values))
    return out


def build_neumann_side_arrays(
        mesh: Mesh, dof_map: GlobalDofMap,
        resolved: Sequence[ResolvedNeumannBC],
        side_quadrature: dict[ElementFamily, QuadratureRule],
        device: torch.device | str = "cpu") -> NeumannSideArrays | None:
    """Per-side-group surface geometry and the scatter's plan, in float64
    on ``device``; None without NBCs."""
    if not resolved:
        return None
    f64 = torch.float64
    geom_fe = mesh.geometric_finite_element

    per_nbc, coords, eqs = [], [], []
    for nbc in resolved:
        fe = nbc.finite_element
        ncomp = nbc.num_components
        offset = int(dof_map.block_offsets[nbc.field_idx])
        groups, nbc_coords = {}, []
        for (family, side_id), elem_ids in nbc.elem_ids_by_side.items():
            sq = side_quadrature[family]
            origin, tangents = ref_side_lift(family, side_id)
            xi_vol = torch.as_tensor(origin[None, :] + sq.xi @ tangents.T,
                                     dtype=f64, device=device)
            geom = geom_fe.at_points(xi_vol)
            side_bf = fe.side_basis_fns(side_id)
            N_side = fe.at_points(xi_vol).N[:, side_bf]

            conn = mesh.connectivity[elem_ids].astype(np.intp)
            X = torch.as_tensor(mesh.nodes[conn], dtype=f64, device=device)
            iso_jac = torch.einsum("eai,paj->epij", X, geom.grad_N)
            surf = torch.einsum("epij,jm->epim", iso_jac, torch.as_tensor(
                tangents, dtype=f64, device=device))
            dA = torch.linalg.vector_norm(
                torch.linalg.cross(surf[..., 0], surf[..., 1]), dim=-1)
            coords_ip = torch.einsum("pa,eai->epi", geom.N, X)

            groups[(family, side_id)] = {
                "dA": dA, "N_side": N_side,
                "side_w": torch.as_tensor(sq.w, dtype=f64, device=device)}
            nbc_coords.append(coords_ip.reshape(-1, 3).cpu().numpy())
            eqs.append((offset + conn[:, side_bf, None] * ncomp
                        + np.arange(ncomp)[None, None, :]).ravel())
        per_nbc.append(groups)
        coords.append(np.concatenate(nbc_coords))
    return NeumannSideArrays(
        groups=tuple(per_nbc), coords=tuple(coords),
        plan=plan_from_target(np.concatenate(eqs), dof_map.num_total_dofs,
                              device))


def neumann_values(nbc: ResolvedNeumannBC, coords: np.ndarray,
                   t: float) -> np.ndarray:
    """The flux ``(n, ncomp)`` at the host coordinates ``coords (n, 3)``
    and time ``t`` (float64, numpy)."""
    n, ncomp = coords.shape[0], nbc.num_components
    if not callable(nbc.values):
        return np.broadcast_to(nbc.values, (n, ncomp))
    vals = np.asarray(nbc.values(coords, t), dtype=np.float64)
    if vals.shape != (n, ncomp):
        raise ValueError(f"NeumannBC values callable returned {vals.shape}; "
                         f"expected {(n, ncomp)}")
    return vals


def assemble_side_neumann(side_arrays: NeumannSideArrays,
                          resolved: Sequence[ResolvedNeumannBC],
                          t: float) -> Tensor:
    """Surface-flux contribution to R (sign: R -= integral N . tbar dA),
    float64 on the side arrays' device; K gets nothing (explicit
    tractions are U-independent)."""
    t = float(t)
    host = np.concatenate([
        neumann_values(nbc, coords, t).ravel()
        for nbc, coords in zip(resolved, side_arrays.coords, strict=True)])
    plan = side_arrays.plan
    tbar_all = torch.as_tensor(host, device=plan.offsets.device)

    parts, start = [], 0
    for nbc, groups in zip(resolved, side_arrays.groups, strict=True):
        ncomp = nbc.num_components
        for g in groups.values():
            n_e, n_ip = g["dA"].shape
            tbar = tbar_all[start:start + n_e * n_ip * ncomp].reshape(
                n_e, n_ip, ncomp)
            start += tbar.numel()
            parts.append(-torch.einsum("pa,epc,ep,p->eac", g["N_side"], tbar,
                                       g["dA"], g["side_w"]).reshape(-1))
    return segment_sum(torch.cat(parts), plan)
