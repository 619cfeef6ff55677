"""Uniaxial stress + off-axis-stretch calibration QoI.

Port of ``cmad_tpu/qois/uniaxial_calibration.py`` (parity: reference
``cmad/qois/uniaxial_calibration.py:21``).
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np
import torch

from cmad_tpu_torch.io.registry import register_qoi
from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.qois.qoi import QoI


@register_qoi("uniaxial_calibration")
class UniaxialCalibration(QoI):
    """Match the axial stress and the two off-axis stretch strains.

    data/weight: (3, num_steps + 1) — rows are
    [sigma_axial, strain_off1, strain_off2].
    """

    def __init__(self, model: Model, data: np.ndarray, weight: np.ndarray,
                 uniaxial_stress_idx: int = 0,
                 stretch_var_name: str = "off-axis stretches") -> None:
        # per-row weights broadcast over the step axis
        weight = np.broadcast_to(np.asarray(weight), data.shape)
        qoi_fun = partial(
            self._qoi, cauchy_fun=model.cauchy_fun,
            uniaxial_stress_idx=uniaxial_stress_idx,
            stretch_slc=model.layout.slc(stretch_var_name))
        super().__init__(qoi_fun, model, data, weight)

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], model: Model,
                  data: np.ndarray, weight: np.ndarray
                  ) -> "UniaxialCalibration":
        return cls(model=model, data=data, weight=weight,
                   uniaxial_stress_idx=qoi_section.get(
                       "uniaxial_stress_idx", 0))

    def update_data(self, data: np.ndarray) -> None:
        assert data.shape == self._data.shape
        self._data = data
        self._data_t = self._on_device(data)

    def data_at_step(self, step):
        return self._data_t[..., step]

    def weight_at_step(self, step):
        return self._weight_t[:, step]

    @staticmethod
    def _qoi(xi, xi_prev, params, U, U_prev, data_at_step, weight_at_step,
             cauchy_fun, uniaxial_stress_idx, stretch_slc):
        sigma = cauchy_fun(xi, xi_prev, params, U, U_prev)
        axial = sigma[uniaxial_stress_idx, uniaxial_stress_idx]
        stretches = xi[stretch_slc]
        pred = torch.cat([axial[None], stretches - 1.0])
        mismatch = (pred - data_at_step) * weight_at_step
        return 0.5 * (mismatch * mismatch).sum()
