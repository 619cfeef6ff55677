"""Total-form small-strain elastic-plastic model.

Port of ``cmad_tpu/models/small_elastic_plastic.py`` (parity: reference
``cmad/models/small_elastic_plastic.py:96-347``). Flat state layout:
FULL_3D          xi = [plastic_strain6, alpha]                  (7)
PLANE_STRAIN     xi = [plastic_strain6, alpha]                  (7)
PLANE_STRESS     xi = [..., oop_stretch]                        (8)
UNIAXIAL_STRESS  xi = [..., off_axis_stretch2]                  (9)

Functional per-point residual, as in ``small_rate_elastic_plastic``.
"""
from __future__ import annotations

from collections.abc import Callable
from functools import partial
from typing import Any, ClassVar

import torch
from torch.func import grad

from cmad_tpu_torch.io.registry import register_model
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.effective_stress import (
    conventional_effective_stress_fun,
)
from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.models.elastic_stress import (
    isotropic_linear_elastic_stress,
    two_mu_scale_factor,
)
from cmad_tpu_torch.models.hardening import (
    combined_hardening_fun,
    get_hardening_funs,
)
from cmad_tpu_torch.models.kinematics import gather_F, off_axis_idx
from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.models.paths import cond_residual
from cmad_tpu_torch.models.state import StateBlock, StateLayout
from cmad_tpu_torch.models.var_types import (
    VarType,
    sym_tensor_from_vector,
    vector_from_sym_tensor,
)
from cmad_tpu_torch.parameters.parameters import Parameters
from cmad_tpu_torch.typing import Scalar, Tensor


def _build_layout(def_type: int) -> StateLayout:
    blocks = [
        StateBlock.zeros("plastic strain", "flow rule", VarType.SYM_TENSOR, 6),
        StateBlock.zeros("alpha", "yield surface", VarType.SCALAR, 1),
    ]
    if def_type == DefType.PLANE_STRESS:
        blocks.append(StateBlock.ones(
            "out of plane stretch", "cauchy_33", VarType.SCALAR, 1))
    elif def_type == DefType.UNIAXIAL_STRESS:
        blocks.append(StateBlock.ones(
            "off-axis stretches", "off-axis normal stress",
            VarType.VECTOR, 2))
    elif def_type not in (DefType.FULL_3D, DefType.PLANE_STRAIN):
        raise NotImplementedError(f"SmallElasticPlastic: def_type {def_type}")
    return StateLayout(blocks)


def compute_elastic_strain(xi, params, U, layout, def_type,
                           uniaxial_stress_idx) -> Tensor:
    """Material-frame elastic strain: total strain (with constrained
    off-axis shear slaved to the plastic strain for UNIAXIAL) minus the
    plastic strain state."""
    stretch_slc = None
    if def_type == DefType.PLANE_STRESS:
        stretch_slc = layout.slc("out of plane stretch")
    elif def_type == DefType.UNIAXIAL_STRESS:
        stretch_slc = layout.slc("off-axis stretches")
    stretches = xi[stretch_slc] if stretch_slc is not None else None

    F = gather_F(U.grad_fields["u"], def_type, stretches,
                 uniaxial_stress_idx)
    pstrain = sym_tensor_from_vector(xi[..., :6])
    grad_u = F - torch.eye(3, dtype=F.dtype, device=F.device)
    eps = 0.5 * (grad_u + grad_u.T)

    Q = params["rotation matrix"]
    if def_type == DefType.UNIAXIAL_STRESS:
        # off-axis shears track the plastic strain (zero off-axis stress)
        p_glob = Q @ pstrain @ Q.T
        eps = torch.stack([
            torch.stack([eps[0, 0], p_glob[0, 1], p_glob[0, 2]]),
            torch.stack([p_glob[1, 0], eps[1, 1], p_glob[1, 2]]),
            torch.stack([p_glob[2, 0], p_glob[2, 1], eps[2, 2]]),
        ])
    return Q.T @ eps @ Q - pstrain


@register_model("small_elastic_plastic")
class SmallElasticPlastic(Model):
    """Total-form small-strain elastic-plastic model with modular
    elasticity, effective stress, and hardening."""

    supports_mixed: ClassVar[bool] = True

    def __init__(
            self, parameters: Parameters,
            def_type: int = DefType.FULL_3D,
            elastic_stress_fun: Callable[
                ..., Tensor] = isotropic_linear_elastic_stress,
            effective_stress_fun: Callable[..., Tensor] | None = None,
            hardening_funs: dict | None = None,
            yield_tol: float = 1e-14,
            uniaxial_stress_idx: int = 0,
    ) -> None:
        # analytic return-map specialization keys on the params
        # structure, which only describes the DEFAULT constitutive funs
        self._uses_default_funs = (
            elastic_stress_fun is isotropic_linear_elastic_stress
            and effective_stress_fun is None and hardening_funs is None)
        if hardening_funs is None:
            hardening_funs = get_hardening_funs()
        if effective_stress_fun is None:
            es_type = next(iter(
                parameters.values["plastic"]["effective stress"]))
            effective_stress_fun = conventional_effective_stress_fun(es_type)

        layout = _build_layout(def_type)
        residual = partial(
            self._residual_fn, layout=layout, def_type=def_type,
            elastic_stress=elastic_stress_fun,
            effective_stress=effective_stress_fun,
            hardening=partial(combined_hardening_fun,
                              hardening_funs=hardening_funs),
            yield_tol=yield_tol,
            uniaxial_stress_idx=uniaxial_stress_idx)
        cauchy = partial(self._cauchy_fn, layout=layout, def_type=def_type,
                         elastic_stress=elastic_stress_fun,
                         uniaxial_stress_idx=uniaxial_stress_idx)
        super().__init__(residual, cauchy, layout, parameters, def_type)

    @classmethod
    def from_deck(cls, model_section: dict[str, Any],
                  parameters: Parameters,
                  def_type: int) -> "SmallElasticPlastic":
        return cls(parameters=parameters, def_type=def_type,
                   uniaxial_stress_idx=model_section.get(
                       "uniaxial_stress_idx", 0))

    @classmethod
    def material_defaults(cls) -> dict[str, Any]:
        return {"rotation matrix": [[1.0, 0.0, 0.0],
                                    [0.0, 1.0, 0.0],
                                    [0.0, 0.0, 1.0]]}

    def derived_output_field_names(self) -> list[str]:
        return ["cauchy"]

    @staticmethod
    def _yield_fun_normal_cauchy(xi, params, U, layout, def_type,
                                 elastic_stress, effective_stress,
                                 hardening, uniaxial_stress_idx):
        plastic = params["plastic"]
        Y = plastic["flow stress"]["initial yield"]["Y"]
        eps_e = compute_elastic_strain(xi, params, U, layout, def_type,
                                       uniaxial_stress_idx)
        cauchy = elastic_stress(eps_e, params)
        phi = effective_stress(cauchy, plastic)
        alpha = xi[..., 6]
        sigma_flow = Y + hardening(alpha, plastic["flow stress"]["hardening"])
        yield_fun = (phi - sigma_flow) / two_mu_scale_factor(params)
        normal = grad(effective_stress)(cauchy, plastic)
        return cauchy, yield_fun, normal

    @staticmethod
    def _residual_fn(xi, xi_prev, params, U, U_prev, *,
                     layout, def_type, elastic_stress, effective_stress,
                     hardening, yield_tol, uniaxial_stress_idx) -> Tensor:
        pstrain = sym_tensor_from_vector(xi[..., :6])
        pstrain_prev = sym_tensor_from_vector(xi_prev[..., :6])
        delta_gamma = xi[..., 6] - xi_prev[..., 6]

        cauchy, yield_fun, normal = \
            SmallElasticPlastic._yield_fun_normal_cauchy(
                xi, params, U, layout, def_type, elastic_stress,
                effective_stress, hardening, uniaxial_stress_idx)

        dp = pstrain - pstrain_prev
        C_e = torch.cat([
            vector_from_sym_tensor(dp), delta_gamma[None]])
        C_p = torch.cat([
            vector_from_sym_tensor(dp - delta_gamma * normal),
            yield_fun[None]])

        if def_type in (DefType.PLANE_STRESS, DefType.UNIAXIAL_STRESS):
            scale = two_mu_scale_factor(params)
            Q = params["rotation matrix"]
            g_cauchy = Q @ cauchy @ Q.T
            if def_type == DefType.PLANE_STRESS:
                C_stretch = g_cauchy[2:3, 2] / scale
            else:
                i, j = (int(k) for k in off_axis_idx(uniaxial_stress_idx))
                C_stretch = torch.stack(
                    [g_cauchy[i, i], g_cauchy[j, j]]) / scale
            C_e = torch.cat([C_e, C_stretch])
            C_p = torch.cat([C_p, C_stretch])

        return cond_residual(yield_fun, C_e, C_p, yield_tol)

    @staticmethod
    def _cauchy_fn(xi, xi_prev, params, U, U_prev, *,
                   layout, def_type, elastic_stress,
                   uniaxial_stress_idx) -> Tensor:
        eps_e = compute_elastic_strain(xi, params, U, layout, def_type,
                                       uniaxial_stress_idx)
        Q = params["rotation matrix"]
        return Q @ elastic_stress(eps_e, params) @ Q.T

    def dev_cauchy(self, xi, xi_prev, params, U, U_prev) -> Tensor:
        sigma = self.cauchy_fun(xi, xi_prev, params, U, U_prev)
        eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
        return sigma - torch.trace(sigma) / 3.0 * eye

    @staticmethod
    def hydro_cauchy(xi, xi_prev, params, U, U_prev) -> Scalar:
        grad_u = U.grad_fields["u"]
        eps = 0.5 * (grad_u + grad_u.transpose(-1, -2))
        return ElasticConstants.from_params(params["elastic"]).kappa \
            * torch.diagonal(eps, dim1=-2, dim2=-1).sum(-1)

    @staticmethod
    def pressure_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).kappa

    @staticmethod
    def shear_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).mu
