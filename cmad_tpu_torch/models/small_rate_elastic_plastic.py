"""Rate-form small-strain elastic-plastic model (return map).

Port of ``cmad_tpu/models/small_rate_elastic_plastic.py`` (parity:
reference ``cmad/models/small_rate_elastic_plastic.py:104-383``). Flat
state layout:
FULL_3D          xi = [unrotated_cauchy6, alpha]                      (7)
PLANE_STRAIN     xi = [unrotated_cauchy6, alpha]                      (7)
PLANE_STRESS     xi = [..., oop_stretch]                              (8)
UNIAXIAL_STRESS  xi = [..., off_axis_stretch2, off_axis_dstrain3]     (12)

The residual is written for one point and is functional (no in-place
ops, no host reads, no Python branch on a tensor value): the elastic or
plastic branch is a ``torch.where`` (``paths.cond_residual``) and the
yield normal a ``torch.func.grad``, so ``vmap(jacfwd(residual))`` runs
over it.
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
        StateBlock.zeros("unrotated_cauchy", "material stress",
                         VarType.SYM_TENSOR, 6),
        StateBlock.zeros("alpha", "yield surface", VarType.SCALAR, 1),
    ]
    if def_type == DefType.PLANE_STRESS:
        blocks.append(StateBlock.ones(
            "out of plane stretch", "cauchy_33", VarType.SCALAR, 1))
    elif def_type == DefType.UNIAXIAL_STRESS:
        blocks.append(StateBlock.ones(
            "off-axis stretches", "off-axis normal stress",
            VarType.VECTOR, 2))
        blocks.append(StateBlock.zeros(
            "off-axis delta strains", "off-axis shear stress",
            VarType.VECTOR, 3))
    elif def_type not in (DefType.FULL_3D, DefType.PLANE_STRAIN):
        raise NotImplementedError(
            f"SmallRateElasticPlastic: def_type {def_type}")
    return StateLayout(blocks)


def _eye3(like: Tensor) -> Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def compute_delta_strain(xi, xi_prev, params, U, U_prev, layout,
                         def_type, uniaxial_stress_idx) -> Tensor:
    """Material-frame strain increment, with the constrained off-axis
    shear-strain slots substituted in for UNIAXIAL_STRESS."""
    stretch_slc = layout.slc("off-axis stretches") \
        if def_type == DefType.UNIAXIAL_STRESS else (
            layout.slc("out of plane stretch")
            if def_type == DefType.PLANE_STRESS else None)
    stretches = xi[stretch_slc] if stretch_slc is not None else None
    stretches_prev = xi_prev[stretch_slc] if stretch_slc is not None else None

    F = gather_F(U.grad_fields["u"], def_type, stretches,
                 uniaxial_stress_idx)
    F_prev = gather_F(U_prev.grad_fields["u"], def_type, stretches_prev,
                      uniaxial_stress_idx)

    grad_u, grad_u_prev = F - _eye3(F), F_prev - _eye3(F)
    eps = 0.5 * (grad_u + grad_u.T)
    eps_prev = 0.5 * (grad_u_prev + grad_u_prev.T)
    deps = eps - eps_prev

    Q = params["rotation matrix"]
    if def_type == DefType.UNIAXIAL_STRESS:
        # free off-axis shear strain increments come from the state
        ds = xi[layout.slc("off-axis delta strains")]
        deps = torch.stack([
            torch.stack([deps[0, 0], ds[0], ds[1]]),
            torch.stack([ds[0], deps[1, 1], ds[2]]),
            torch.stack([ds[1], ds[2], deps[2, 2]]),
        ])
    return Q.T @ deps @ Q


def compute_yield_fun_and_normal(cauchy, alpha, params,
                                 effective_stress, hardening):
    """(yield_fun, yield_normal): f = (phi - Y - H(alpha)) / 2mu; the
    normal is the gradient of the effective stress (``torch.func.grad``)."""
    plastic = params["plastic"]
    Y = plastic["flow stress"]["initial yield"]["Y"]
    hardening_params = plastic["flow stress"]["hardening"]

    phi = effective_stress(cauchy, plastic)
    sigma_flow = Y + hardening(alpha, hardening_params)
    yield_fun = (phi - sigma_flow) / two_mu_scale_factor(params)
    yield_normal = grad(effective_stress)(cauchy, plastic)
    return yield_fun, yield_normal


@register_model("small_rate_elastic_plastic")
class SmallRateElasticPlastic(Model):
    """Rate-form small-strain elastic-plastic model with modular
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
        cauchy = self._cauchy_fn
        super().__init__(residual, cauchy, layout, parameters, def_type)

    @classmethod
    def from_deck(cls, model_section: dict[str, Any],
                  parameters: Parameters,
                  def_type: int) -> "SmallRateElasticPlastic":
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
    def _residual_fn(xi, xi_prev, params, U, U_prev, *,
                     layout, def_type, elastic_stress, effective_stress,
                     hardening, yield_tol, uniaxial_stress_idx) -> Tensor:
        cauchy = sym_tensor_from_vector(xi[..., :6])
        cauchy_prev = sym_tensor_from_vector(xi_prev[..., :6])
        alpha = xi[..., 6]
        alpha_prev = xi_prev[..., 6]
        delta_gamma = alpha - alpha_prev

        deps_trial = compute_delta_strain(
            xi, xi_prev, params, U, U_prev, layout, def_type,
            uniaxial_stress_idx)
        dsig_trial = elastic_stress(deps_trial, params)
        scale = two_mu_scale_factor(params)

        yield_fun, normal = compute_yield_fun_and_normal(
            cauchy, alpha, params, effective_stress, hardening)
        dsig_plastic = dsig_trial - elastic_stress(
            delta_gamma * normal, params)

        C_e_sig = vector_from_sym_tensor(
            cauchy - cauchy_prev - dsig_trial) / scale
        C_p_sig = vector_from_sym_tensor(
            cauchy - cauchy_prev - dsig_plastic) / scale

        C_e = torch.cat([C_e_sig, delta_gamma[None]])
        C_p = torch.cat([C_p_sig, yield_fun[None]])

        if def_type in (DefType.PLANE_STRESS, DefType.UNIAXIAL_STRESS):
            Q = params["rotation matrix"]
            g_trial = Q @ dsig_trial @ Q.T
            g_plastic = Q @ dsig_plastic @ Q.T

            if def_type == DefType.PLANE_STRESS:
                C_e = torch.cat([C_e, g_trial[2:3, 2] / scale])
                C_p = torch.cat([C_p, g_plastic[2:3, 2] / scale])
            else:
                i, j = (int(k) for k in off_axis_idx(uniaxial_stress_idx))
                C_e = torch.cat([
                    C_e,
                    torch.stack([g_trial[i, i], g_trial[j, j]]) / scale,
                    torch.stack([g_trial[0, 1], g_trial[0, 2],
                                 g_trial[1, 2]]) / scale])
                C_p = torch.cat([
                    C_p,
                    torch.stack([g_plastic[i, i], g_plastic[j, j]]) / scale,
                    torch.stack([g_plastic[0, 1], g_plastic[0, 2],
                                 g_plastic[1, 2]]) / scale])

        return cond_residual(yield_fun, C_e, C_p, yield_tol)

    @staticmethod
    def _cauchy_fn(xi, xi_prev, params, U, U_prev) -> Tensor:
        Q = params["rotation matrix"]
        return Q @ sym_tensor_from_vector(xi[..., :6]) @ Q.T

    def dev_cauchy(self, xi, xi_prev, params, U, U_prev) -> Tensor:
        sigma = self.cauchy_fun(xi, xi_prev, params, U, U_prev)
        return sigma - torch.trace(sigma) / 3.0 * _eye3(sigma)

    def hydro_cauchy(self, xi, xi_prev, params, U, U_prev) -> Scalar:
        sigma = self.cauchy_fun(xi, xi_prev, params, U, U_prev)
        return torch.trace(sigma) / 3.0

    @staticmethod
    def pressure_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).kappa

    @staticmethod
    def shear_scale_factor(params: dict[str, Any]) -> Scalar:
        return ElasticConstants.from_params(params["elastic"]).mu
