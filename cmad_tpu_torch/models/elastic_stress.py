"""Elastic stress of the plasticity models (batched: 3x3 tensors with
leading batch dims).

Port of the part of ``cmad_tpu/models/elastic_stress.py`` that the
elastic-plastic models use (parity: reference
``cmad/models/elastic_stress.py:14-71``). The Cauchy stresses of the
elasticity-only models (``isotropic_linear_elastic_cauchy_stress``,
``compressible_neohookean_cauchy_stress``) come with those models.
"""
from __future__ import annotations

from typing import Any

import torch

from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.typing import Scalar, Tensor


def isotropic_linear_elastic_stress(
        elastic_strain: Tensor, params: dict[str, Any]) -> Tensor:
    """sigma = lmbda tr(eps) I + 2 mu eps (form used by plasticity models)."""
    ec = ElasticConstants.from_params(params["elastic"])
    tr = torch.diagonal(elastic_strain, dim1=-2, dim2=-1).sum(-1)
    eye = torch.eye(3, dtype=elastic_strain.dtype,
                    device=elastic_strain.device)
    return ec.lmbda * tr[..., None, None] * eye + 2.0 * ec.mu * elastic_strain


def two_mu_scale_factor(params: dict[str, Any]) -> Scalar:
    return 2.0 * ElasticConstants.from_params(params["elastic"]).mu
