"""Elastic stress functions (batched: 3x3 tensors with leading batch
dims).

Port of ``cmad_tpu/models/elastic_stress.py`` (parity: reference
``cmad/models/elastic_stress.py:14-71``): the Lame form the plasticity
models use, and the two Cauchy stresses of the elasticity-only model
(``models/elastic.py``) with the deck's names for them
(:func:`conventional_elastic_stress_fun`).

Two departures from the JAX package, both at the level of rounding: the
determinant is the closed-form 3x3 one (``ops/linalg.det3``, a few
elementwise ops where ``torch.linalg.det`` would run a batched LU on the
card), and ``J^(-2/3)`` is ``J.pow(-2/3)`` where the JAX package takes
``cbrt(J) ** -2`` (PyTorch has no cube root); both forms hold for
``J > 0``, which a deformation gradient has.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import torch

from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.ops.linalg import det3
from cmad_tpu_torch.typing import Scalar, Tensor


def _eye_like(x: Tensor) -> Tensor:
    return torch.eye(3, dtype=x.dtype, device=x.device)


def _trace(A: Tensor) -> Tensor:
    """(..., 3, 3) -> (..., 1, 1), ready to scale the identity."""
    return torch.diagonal(A, dim1=-2, dim2=-1).sum(-1)[..., None, None]


def isotropic_linear_elastic_stress(
        elastic_strain: Tensor, params: dict[str, Any]) -> Tensor:
    """sigma = lmbda tr(eps) I + 2 mu eps (form used by plasticity models)."""
    ec = ElasticConstants.from_params(params["elastic"])
    return (ec.lmbda * _trace(elastic_strain) * _eye_like(elastic_strain)
            + 2.0 * ec.mu * elastic_strain)


def isotropic_linear_elastic_cauchy_stress(
        F: Tensor, params: dict[str, Any]) -> Tensor:
    """Kappa/mu volumetric-deviatoric split form used by elasticity-only
    models; takes the deformation gradient."""
    eye = _eye_like(F)
    grad_u = F - eye
    eps = 0.5 * (grad_u + grad_u.transpose(-1, -2))
    tr = _trace(eps)
    dev = eps - tr / 3.0 * eye
    ec = ElasticConstants.from_params(params["elastic"])
    return ec.kappa * tr * eye + 2.0 * ec.mu * dev


def compressible_neohookean_cauchy_stress(
        F: Tensor, params: dict[str, Any]) -> Tensor:
    """Simo-Hughes compressible neo-Hookean Cauchy stress from F."""
    J = det3(F)[..., None, None]
    Jm23 = J.pow(-2.0 / 3.0)
    eye = _eye_like(F)
    bbar = Jm23 * (F @ F.transpose(-1, -2))
    dev_bbar = bbar - _trace(bbar) / 3.0 * eye
    ec = ElasticConstants.from_params(params["elastic"])
    return (1.0 / J) * (0.5 * ec.kappa * (J**2 - 1.0) * eye
                        + ec.mu * dev_bbar)


def conventional_elastic_stress_fun(name: str) -> Callable[..., Tensor]:
    if name == "isotropic_linear":
        return isotropic_linear_elastic_cauchy_stress
    if name == "neohookean":
        return compressible_neohookean_cauchy_stress
    raise NotImplementedError(f"unknown elastic_stress type: {name!r}")


def two_mu_scale_factor(params: dict[str, Any]) -> Scalar:
    return 2.0 * ElasticConstants.from_params(params["elastic"]).mu
