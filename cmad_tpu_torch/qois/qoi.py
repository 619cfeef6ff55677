"""Material-point QoI contract (functional, flat-state).

Port of ``cmad_tpu/qois/qoi.py`` (parity: reference
``cmad/qois/qoi.py:17-281``), with the same redesign as
:class:`cmad_tpu_torch.models.model.Model`: no mutable deriv-mode state
machine; every derivative is a pure function of explicit state, built
lazily as a cached ``torch.func`` composition (the JAX package cached
``jit``-compiled ones), and parameter derivatives take the flat
full-parameter vector so Hessian blocks come out dense.

A concrete QoI supplies
``qoi_fun(xi, xi_prev, params, U, U_prev, data_at_step, weight_at_step)``
returning a scalar, plus ``data_at_step`` / ``weight_at_step`` hooks.
``data()`` and ``weight()`` are the numpy arrays the QoI was given; the
hooks return slices of their copies on the model's device, in its
parameters' dtype.
"""
from __future__ import annotations

from abc import ABC
from functools import cached_property
from typing import Any, ClassVar

import numpy as np
import torch
from torch.func import hessian, jacfwd, jacrev

from cmad_tpu_torch.models.model import Model
from cmad_tpu_torch.qois.qoi_base import QoIBase
from cmad_tpu_torch.typing import QoIFn, Tensor


class QoI(QoIBase, ABC):
    problem_type: ClassVar[str] = "material_point"

    def __init__(self, qoi_fun: QoIFn, model: Model,
                 data: np.ndarray, weight: np.ndarray) -> None:
        self.qoi_fun = qoi_fun
        self._model = model
        self._data = data
        self._weight = weight
        self._data_t = self._on_device(data)
        self._weight_t = self._on_device(weight)

        unravel_p = model.parameters.reconstruct_from_flat

        def qoi_flatp(xi, xi_prev, p_flat, U, U_prev, data, weight):
            return qoi_fun(xi, xi_prev, unravel_p(p_flat), U, U_prev,
                           data, weight)

        self._qoi_flatp = qoi_flatp

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], model: Model,
                  data: np.ndarray, weight: np.ndarray) -> "QoI":
        raise NotImplementedError

    def _on_device(self, a) -> Tensor:
        p = self._model.parameters
        return torch.as_tensor(np.ascontiguousarray(a), dtype=p.dtype,
                               device=p.device)

    # ------------------------------------------------------------------
    # evaluators (cached compositions)
    # ------------------------------------------------------------------
    @cached_property
    def J(self):
        return self.qoi_fun

    @cached_property
    def dJ_dxi(self):
        return jacfwd(self.qoi_fun, argnums=0)

    @cached_property
    def dJ_dxi_prev(self):
        return jacfwd(self.qoi_fun, argnums=1)

    @cached_property
    def dJ_du(self):
        return jacfwd(self.qoi_fun, argnums=3)

    @cached_property
    def dJ_du_prev(self):
        return jacfwd(self.qoi_fun, argnums=4)

    @cached_property
    def dJ_dparams_flat(self):
        return jacrev(self._qoi_flatp, argnums=2)

    @cached_property
    def hess_xi_xi(self):
        return hessian(self.qoi_fun, argnums=0)

    @cached_property
    def hess_xi_params_flat(self):
        """d2J/(dxi dp) -> (nxi, P)."""
        return jacrev(jacfwd(self._qoi_flatp, argnums=0), argnums=2)

    @cached_property
    def hess_params_params_flat(self):
        return hessian(self._qoi_flatp, argnums=2)

    def dJ_dparams_active(self, xi, xi_prev, U, U_prev,
                          data, weight) -> Tensor:
        p_flat = self._model.flat_params()
        dJ = self.dJ_dparams_flat(xi, xi_prev, p_flat, U, U_prev,
                                  data, weight)
        return dJ[torch.as_tensor(self._model.parameters.active_idx,
                                  device=dJ.device)]

    # ------------------------------------------------------------------
    # data access
    # ------------------------------------------------------------------
    def model(self) -> Model:
        return self._model

    def data(self) -> np.ndarray:
        return self._data

    def weight(self) -> np.ndarray:
        return self._weight

    def data_at_step(self, step):
        raise NotImplementedError

    def weight_at_step(self, step):
        raise NotImplementedError
