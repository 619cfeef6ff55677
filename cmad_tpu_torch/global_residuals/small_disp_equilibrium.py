"""3D quasi-static small-deformation equilibrium weak form.

Port of the displacement form of
``cmad_tpu/global_residuals/small_disp_equilibrium.py`` (parity:
reference ``cmad/global_residuals/small_disp_equilibrium.py``): one
block, ``u``, with ``R[a, i] = grad_N_phys[a, j] sigma[j, i] w dv``. A
block binds, in the JAX package's order, to the J2 block
(``fem/j2_block.py``) for J2+Voce, else to the point-batch block
(``fem/coupled_block.py``) for the other small-strain elastic-plastic
models, else to the generic per-point block (``fem/generic_block.py``)
with this weak form: CLOSED_FORM blocks (the elastic model) and the
COUPLED blocks the first two decline (another model, or per-point
convergence printing). The near-null space is the rigid-body basis,
computed directly from node coordinates.

The mixed u-p form is not ported yet and raises
``NotImplementedError`` with its ROADMAP item (22).
"""
from __future__ import annotations

from typing import Any

import numpy as np

from cmad_tpu_torch.global_residuals.global_residual import GlobalResidual
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.io.registry import register_global_residual
from cmad_tpu_torch.models.deformation_types import DefType, def_type_ndims
from cmad_tpu_torch.models.var_types import VarType


def rigid_body_modes(coords: np.ndarray) -> np.ndarray:
    """Six 3D rigid-body modes (3 translations + 3 rotations e_k x r) in
    interleaved-by-node DOF order; shape (3 n_nodes, 6)."""
    n = coords.shape[0]
    x, y, z = coords[:, 0], coords[:, 1], coords[:, 2]
    modes = np.zeros((n, 3, 6))
    for k in range(3):
        modes[:, k, k] = 1.0
    # rotation about x: (0, -z, y); about y: (z, 0, -x); about z: (-y, x, 0)
    modes[:, 1, 3], modes[:, 2, 3] = -z, y
    modes[:, 0, 4], modes[:, 2, 4] = z, -x
    modes[:, 0, 5], modes[:, 1, 5] = -y, x
    return modes.reshape(3 * n, 6)


@register_global_residual("small_disp_equilibrium")
class SmallDispEquilibrium(GlobalResidual):

    def __init__(self, ndims: int = 3, mixed: bool = False,
                 stabilization_multiplier: float = 1.0) -> None:
        if mixed:
            raise NotImplementedError(
                "the mixed u-p form of small_disp_equilibrium is not "
                "ported yet: ROADMAP queue 1, item 22")
        self._ndims = ndims
        self._stab = stabilization_multiplier
        self._init_residuals(1)
        self._var_types[0] = VarType.VECTOR
        self._num_eqs[0] = ndims
        self.resid_names[0] = "equilibrium"
        self.var_names[0] = "u"

        def residual_fn(xi, xi_prev, params, U, U_prev, model, mode,
                        shapes_ip, w, dv, h, ip_set):
            U_ip = self.interpolate_global_fields_at_ip(U, shapes_ip)
            Up_ip = self.interpolate_global_fields_at_ip(U_prev, shapes_ip)
            if mode == GlobalResidualMode.CLOSED_FORM:
                sigma = model.cauchy_closed_form_fun(params, U_ip, Up_ip)
            else:
                sigma = model.cauchy_fun(xi, xi_prev, params, U_ip, Up_ip)
            return [(shapes_ip[0].grad_N @ sigma) * w * dv]

        super().__init__(residual_fn)

    @property
    def mixed(self) -> bool:
        return False

    def for_model(self, model, mode=GlobalResidualMode.COUPLED,
                  local_newton_settings=None,
                  print_local_convergence=False) -> dict:
        """The J2 block evaluators (``fem/j2_block.py``) when the model
        and mode admit them, else the point-batch block
        (``fem/coupled_block.py``), else the generic per-point block
        (:meth:`GlobalResidual.for_model`). ``local_newton_settings``
        reaches the point-batch and generic blocks' local Newton, not
        the J2 block: its radial return runs a fixed number of scalar
        Newton iterations."""
        from cmad_tpu_torch.fem.coupled_block import (
            make_pointbatch_block_kernels,
            pointbatch_applicable,
        )
        from cmad_tpu_torch.fem.j2_block import (
            j2_block_applicable,
            make_j2_block_kernels,
        )
        if j2_block_applicable(self, model, mode, print_local_convergence):
            return make_j2_block_kernels(model)
        if pointbatch_applicable(self, model, mode, print_local_convergence):
            return make_pointbatch_block_kernels(model,
                                                 local_newton_settings)
        return super().for_model(model, mode, local_newton_settings,
                                 print_local_convergence)

    def near_null_space(self, mesh) -> np.ndarray:
        return rigid_body_modes(np.asarray(mesh.nodes, dtype=np.float64))

    def evaluate_nodal_field(self, name, fe_problem, fe_state, step):
        """The displacement ``u`` at the nodes, ``(n_nodes, ndims)``."""
        if name == "u":
            U = np.asarray(fe_state.U_at(step))
            return U.reshape(-1, int(self._num_eqs[0]))
        return super().evaluate_nodal_field(name, fe_problem, fe_state,
                                            step)

    @classmethod
    def from_deck(cls, gr_section: dict[str, Any],
                  ndims: int) -> "SmallDispEquilibrium":
        name = gr_section.get("def_type")
        if name is None:
            raise ValueError(
                "residuals.global residual: small_disp_equilibrium "
                "requires 'def_type'")
        expected = def_type_ndims(DefType[name.upper()])
        if expected != ndims:
            raise ValueError(
                f"def_type {name!r} implies ndims={expected} but the mesh "
                f"has ndims={ndims}")
        return cls(ndims=ndims, mixed=bool(gr_section.get("mixed", False)),
                   stabilization_multiplier=gr_section.get(
                       "stabilization multiplier", 1.0))
