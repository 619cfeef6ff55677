"""Material-point objective differentiated end to end by autograd.

Port of ``cmad_tpu/objectives/mp_jvp_objective.py`` (parity: reference
``cmad/objectives/mp_jvp_objective.py:14-80``). J is a function of the
canonical active parameters: ``Parameters.tree_with_flat_active`` feeds
them to a Python loop over the steps, whose update is the implicit
Newton solve (``make_newton_solve``: the implicit-function rules carry
the derivatives through each step). The JAX package scanned the steps
with ``lax.scan`` and took ``value_and_grad`` and ``hessian`` of the
scan.

The gradient is one backward pass. The Hessian is reverse-over-reverse:
one backward with ``create_graph=True``, then a backward of each of the
gradient's entries, through the solve's ``backward``, which is written
in differentiable ops. ``torch.func.hessian`` (forward over reverse)
would ``vmap`` the solve, which has no batching rule.
"""
from __future__ import annotations

from collections.abc import Callable

import numpy as np
import torch

from cmad_tpu_torch.objectives.mp_objective import MPDrive
from cmad_tpu_torch.typing import Tensor


class MPJVPObjective:

    def __init__(self, qoi, global_state: np.ndarray,
                 update_fun: Callable) -> None:
        """``update_fun(xi_prev_guess, xi_prev, params, U, U_prev) -> xi``
        (typically ``make_newton_solve(model.residual_fun)``)."""
        model = qoi.model()
        self._parameters = parameters = model.parameters
        dtype, device = parameters.dtype, parameters.device
        self._qoi, self._update = qoi, update_fun
        self._drive = MPDrive(global_state, dtype, device)
        self._init_xi = model.init_xi(dtype, device)
        data = torch.as_tensor(np.asarray(qoi.data()), dtype=dtype,
                               device=device)
        weight = torch.as_tensor(np.ascontiguousarray(qoi.weight()),
                                 dtype=dtype, device=device)
        # a weight with a step axis (as data has) is sliced per step,
        # any other broadcast to every step
        per_step = weight.ndim == data.ndim
        self._data_weight = [
            (data[..., k], weight[..., k] if per_step else weight)
            for k in range(self._drive.num_steps + 1)]

    def objective(self, flat_canonical_active: Tensor) -> Tensor:
        """J at the canonical active parameters, on the autograd tape."""
        params = self._parameters.tree_with_flat_active(
            flat_canonical_active, canonical=True)
        xi_prev = self._init_xi
        J = torch.zeros((), dtype=xi_prev.dtype, device=xi_prev.device)
        for step in range(1, self._drive.num_steps + 1):
            U, U_prev = self._drive.U(step), self._drive.U(step - 1)
            xi = self._update(xi_prev, xi_prev, params, U, U_prev)
            J = J + self._qoi.qoi_fun(xi, xi_prev, params, U, U_prev,
                                      *self._data_weight[step])
            xi_prev = xi
        return J

    def _leaf(self, x) -> Tensor:
        p = self._parameters
        return torch.as_tensor(np.asarray(x), dtype=p.dtype,
                               device=p.device).detach().clone()

    def evaluate_objective(self, x) -> Tensor:
        with torch.no_grad():
            return self.objective(self._leaf(x))

    def evaluate_objective_and_grad(self, x) -> tuple[Tensor, Tensor]:
        """(J, dJ/dx) in canonical coordinates."""
        x = self._leaf(x).requires_grad_(True)
        J = self.objective(x)
        (g,) = torch.autograd.grad(J, x)
        return J.detach(), g

    def evaluate_hessian(self, x) -> Tensor:
        """The dense (P, P) Hessian in canonical coordinates."""
        x = self._leaf(x).requires_grad_(True)
        (g,) = torch.autograd.grad(self.objective(x), x, create_graph=True)
        n = int(x.shape[0])
        rows = [torch.autograd.grad(g[i], x, retain_graph=i < n - 1,
                                    allow_unused=True)[0]
                for i in range(n)]
        return torch.stack([torch.zeros_like(x) if r is None else r.detach()
                            for r in rows]) if n else x.new_zeros((0, 0))
