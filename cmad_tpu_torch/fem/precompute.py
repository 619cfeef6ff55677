"""Per-element-block reference-frame geometry cache.

Port of ``cmad_tpu/fem/precompute.py`` (parity: reference
``cmad/fem/precompute.py:50-296``). Total-Lagrangian geometry
(iso-Jacobian dets, physical-frame field-shape gradients, IP coords,
element sizes) is solution-independent, so it is computed once at
FEProblem build, on the problem's device. Stored as plain dicts of
tensors:

per-elem (leading element axis):
  ``{"iso_jac_det": (n_b, n_ip), "coords_ip": (n_b, n_ip, 3),
     "grad_N_phys": tuple[(n_b, n_ip, n_dofs_r, 3)], "h": (n_b,)}``
shared (element-invariant):
  ``{"quad_w": (n_ip,), "N": tuple[(n_ip, n_dofs_r)]}``
"""
from __future__ import annotations

from collections.abc import Sequence

import torch

from cmad_tpu_torch.fem.dof import GlobalFieldLayout
from cmad_tpu_torch.fem.mesh import Mesh, element_rms_edge_sizes
from cmad_tpu_torch.fem.quadrature import QuadratureRule
from cmad_tpu_torch.fem.topology import ElementFamily
from cmad_tpu_torch.ops.linalg import det3, inv3


def precompute_block_geometry(
        mesh: Mesh,
        quadrature_by_family: dict[ElementFamily, QuadratureRule],
        field_layouts_per_block: Sequence[GlobalFieldLayout],
        dtype: torch.dtype, device: torch.device) -> dict[str, dict]:
    """Geometry cache per element block; see module docstring for layout.

    ``iso_jac_det`` is signed so inverted elements surface as Newton
    divergence instead of being silently absorbed.
    """
    rule = quadrature_by_family[mesh.element_family]
    quad_xi = torch.as_tensor(rule.xi, dtype=dtype, device=device)
    quad_w = torch.as_tensor(rule.w, dtype=dtype, device=device)

    geom = mesh.geometric_finite_element.at_points(quad_xi)

    field_N, field_grad_ref = [], []
    for layout in field_layouts_per_block:
        shapes = layout.finite_element.at_points(quad_xi)
        field_N.append(shapes.N)
        field_grad_ref.append(shapes.grad_N)

    shared = {"quad_w": quad_w, "N": tuple(field_N)}
    h_all = element_rms_edge_sizes(mesh)

    cache: dict[str, dict] = {}
    for name, elems in mesh.element_blocks.items():
        X = torch.as_tensor(mesh.nodes[mesh.connectivity[elems]],
                            dtype=dtype, device=device)   # (n_b, ng, 3)
        # iso_jac[e, p, i, j] = dx_i/dxi_j
        iso_jac = torch.einsum("eai,paj->epij", X, geom.grad_N)
        det = det3(iso_jac)
        inv = inv3(iso_jac)
        coords_ip = torch.einsum("pa,eai->epi", geom.N, X)
        grad_N_phys = tuple(
            torch.einsum("pnj,epji->epni", g_ref, inv)
            for g_ref in field_grad_ref)
        cache[name] = {
            "per_elem": {
                "iso_jac_det": det,
                "coords_ip": coords_ip,
                "grad_N_phys": grad_N_phys,
                "h": torch.as_tensor(h_all[elems], dtype=dtype,
                                     device=device),
            },
            "shared": shared,
        }
    return cache
