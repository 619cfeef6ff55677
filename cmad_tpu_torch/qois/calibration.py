"""Weighted Cauchy-mismatch calibration QoI.

Port of ``cmad_tpu/qois/calibration.py`` (parity: reference
``cmad/qois/calibration.py:21``).
"""
from __future__ import annotations

from functools import partial
from typing import Any

import numpy as np

from cmad_tpu_torch.io.registry import register_qoi
from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.qois.qoi import QoI


@register_qoi("calibration")
class Calibration(QoI):
    """J = 0.5 || w * (sigma(xi) - data) ||_F^2 at each step; data is a
    (3, 3, num_steps + 1) stress history, weight a fixed (3, 3) mask."""

    def __init__(self, model: Model, data: np.ndarray,
                 weight: np.ndarray) -> None:
        assert weight.shape == (3, 3)
        qoi_fun = partial(self._qoi, cauchy_fun=model.cauchy_fun)
        super().__init__(qoi_fun, model, data, weight)

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], model: Model,
                  data: np.ndarray, weight: np.ndarray) -> "Calibration":
        return cls(model, data, weight)

    def data_at_step(self, step):
        return self._data_t[..., step]

    def weight_at_step(self, step):
        return self._weight_t

    @staticmethod
    def _qoi(xi, xi_prev, params, U, U_prev, data_at_step, weight_at_step,
             cauchy_fun):
        sigma = cauchy_fun(xi, xi_prev, params, U, U_prev)
        mismatch = weight_at_step * (sigma - data_at_step)
        return 0.5 * (mismatch * mismatch).sum()
