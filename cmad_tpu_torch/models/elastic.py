"""General elastic model (closed-form-capable).

Port of ``cmad_tpu/models/elastic.py`` (parity: reference
``cmad/models/elastic.py:30-223``). Flat state layout:
FULL_3D          xi = [cauchy6]                      (6 dofs)
PLANE_STRAIN     xi = [cauchy6]                      (6 dofs)
PLANE_STRESS     xi = [cauchy6, oop_stretch]         (7 dofs)
UNIAXIAL_STRESS  xi = [cauchy6, off_axis_stretch2]   (8 dofs)

PLANE_STRAIN (F_33 = 1 kinematically prescribed) shares the FULL_3D
layout and closed form. In the FE a FULL_3D block binds CLOSED_FORM
(``cli/fe_common.py``): its stress is :meth:`Elastic.cauchy_closed_form_fun`
of the displacement gradient, and the block carries no state. The
residual (the state's Cauchy stress against the stress of F) is what a
COUPLED binding and the material-point drivers solve. Every function is
written for one point and functional, so ``torch.func`` batches and
differentiates it.
"""
from __future__ import annotations

from collections.abc import Callable
from functools import partial
from typing import Any, ClassVar

import torch

from cmad_tpu_torch.io.registry import register_model
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.models.elastic_stress import (
    conventional_elastic_stress_fun,
    isotropic_linear_elastic_cauchy_stress,
    two_mu_scale_factor,
)
from cmad_tpu_torch.models.kinematics import gather_F
from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.models.state import StateBlock, StateLayout
from cmad_tpu_torch.models.var_types import (
    VarType,
    sym_tensor_from_vector,
    vector_from_sym_tensor,
)
from cmad_tpu_torch.parameters.parameters import Parameters
from cmad_tpu_torch.typing import Scalar, Tensor


def _build_layout(def_type: int) -> StateLayout:
    blocks = [StateBlock.zeros("cauchy", "elastic stress",
                               VarType.SYM_TENSOR, 6)]
    if def_type == DefType.PLANE_STRESS:
        blocks.append(StateBlock.ones(
            "out of plane stretch", "cauchy_33", VarType.SCALAR, 1))
    elif def_type == DefType.UNIAXIAL_STRESS:
        blocks.append(StateBlock.ones(
            "off-axis stretches", "off-axis normal stress", VarType.VECTOR, 2))
    elif def_type not in (DefType.FULL_3D, DefType.PLANE_STRAIN):
        raise NotImplementedError(f"Elastic: def_type {def_type}")
    return StateLayout(blocks)


def _small_strain(U) -> tuple[Tensor, Tensor]:
    """``(eps, tr eps)`` of the point's displacement gradient."""
    grad_u = U.grad_fields["u"]
    eps = 0.5 * (grad_u + grad_u.transpose(-1, -2))
    return eps, torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)


@register_model("elastic")
class Elastic(Model):
    """Elastic model: residual ``C = (sigma - sigma(F)) / 2mu`` plus
    stress-free constraints on the constrained stretches."""

    supports_closed_form_cauchy: ClassVar[bool] = True
    supports_mixed: ClassVar[bool] = True

    def __init__(
            self, parameters: Parameters,
            elastic_stress_fun: Callable[
                ..., Tensor] = isotropic_linear_elastic_cauchy_stress,
            def_type: int = DefType.FULL_3D,
    ) -> None:
        layout = _build_layout(def_type)
        stretch_slc = layout.slc(layout.var_names[1]) \
            if len(layout) > 1 else None

        residual = partial(self._residual_fn, def_type=def_type,
                           elastic_stress=elastic_stress_fun,
                           stretch_slc=stretch_slc)
        closed_form = None
        if def_type in (DefType.FULL_3D, DefType.PLANE_STRAIN):
            closed_form = partial(self._cauchy_closed_form_fn,
                                  def_type=def_type,
                                  elastic_stress=elastic_stress_fun)
        super().__init__(residual, self._cauchy_fn, layout, parameters,
                         def_type, cauchy_closed_form_fun=closed_form)

    @classmethod
    def from_deck(cls, model_section: dict[str, Any],
                  parameters: Parameters, def_type: int) -> "Elastic":
        return cls(
            parameters=parameters,
            def_type=def_type,
            elastic_stress_fun=conventional_elastic_stress_fun(
                model_section.get("elastic_stress", "isotropic_linear")),
        )

    def derived_output_field_names(self) -> list[str]:
        return ["cauchy"]

    @staticmethod
    def _residual_fn(xi, xi_prev, params, U, U_prev, *,
                     def_type, elastic_stress, stretch_slc) -> Tensor:
        cauchy = sym_tensor_from_vector(xi[..., :6])
        stretches = xi[stretch_slc] if stretch_slc is not None else None
        F = gather_F(U.grad_fields["u"], def_type, stretches)

        scale = two_mu_scale_factor(params)
        C_cauchy = vector_from_sym_tensor(
            cauchy - elastic_stress(F, params)) / scale

        if def_type in (DefType.FULL_3D, DefType.PLANE_STRAIN):
            return C_cauchy
        if def_type == DefType.PLANE_STRESS:
            return torch.cat([C_cauchy, cauchy[2:3, 2] / scale])
        if def_type == DefType.UNIAXIAL_STRESS:
            off = torch.stack([cauchy[1, 1], cauchy[2, 2]]) / scale
            return torch.cat([C_cauchy, off])
        raise NotImplementedError

    @staticmethod
    def _cauchy_fn(xi, xi_prev, params, U, U_prev) -> Tensor:
        return sym_tensor_from_vector(xi[..., :6])

    @staticmethod
    def _cauchy_closed_form_fn(params, U, U_prev, *, def_type,
                               elastic_stress) -> Tensor:
        F = gather_F(U.grad_fields["u"], def_type)
        return elastic_stress(F, params)

    @staticmethod
    def dev_cauchy_closed_form(params, U, U_prev) -> Tensor:
        eps, tr = _small_strain(U)
        eye = torch.eye(3, dtype=eps.dtype, device=eps.device)
        dev = eps - tr[..., None, None] / 3.0 * eye
        return 2.0 * ElasticConstants.from_params(params["elastic"]).mu * dev

    @staticmethod
    def hydro_cauchy_closed_form(params, U, U_prev) -> Scalar:
        _eps, tr = _small_strain(U)
        return ElasticConstants.from_params(params["elastic"]).kappa * tr

    @staticmethod
    def pressure_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).kappa

    @staticmethod
    def shear_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).mu
