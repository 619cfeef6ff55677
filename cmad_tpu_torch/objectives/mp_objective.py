"""Material-point calibration objectives (adjoint / direct / direct-adjoint).

Port of ``cmad_tpu/objectives/mp_objective.py`` (parity: reference
``cmad/objectives/mp_objective.py:22-345``). Three sibling strategies
over the model/QoI derivative surface, orchestrated on the host with
numpy linear algebra. After the forward pass, every step's derivative
blocks are evaluated on the problem's device, one batched call per block
(``vmap`` over the steps, where the JAX package called each block once
per step), and read back in one transfer. The Hessian formula of
:class:`MPDirectAdjointObjective` follows the direct-adjoint method of
arXiv:2501.04584.

As in the JAX package:

- the state is explicit (no mutable seed/evaluate machine);
- the forward pass solves each step with
  ``make_newton_solve(model.residual_fun)`` at its defaults (10
  iterations, the dtype's ``mp_local`` tolerances) and ignores the deck's
  ``solver.newton``; on the card it replays CUDA graphs of the
  residual and its Jacobian (``cuda_graphs``: the same kernels without
  the host's per-operation dispatch, which sets a single point's pace);
- the QoI mixed Hessian is taken with respect to (xi, params); the
  reference takes it with respect to (xi_prev, params) (qoi.py:55, latent
  because its QoIs do not depend on xi_prev and params enter only via
  inactive rotations).
"""
from __future__ import annotations

from abc import ABC, abstractmethod

import numpy as np
import torch
from torch.func import vmap

from cmad_tpu_torch.models.global_fields import (
    GlobalFieldsAtPoint,
    mp_U_from_F,
)
from cmad_tpu_torch.models.nonlinear_solver import make_newton_solve
from cmad_tpu_torch.typing import GradientResult, HessianResult, Tensor


def to_host(*tensors: Tensor) -> list[np.ndarray]:
    """The tensors as numpy arrays, read back in one transfer."""
    flat = torch.cat([t.detach().reshape(-1) for t in tensors]).cpu().numpy()
    out, k = [], 0
    for t in tensors:
        n = t.numel()
        out.append(flat[k:k + n].reshape(t.shape))
        k += n
    return out


class MPDrive:
    """A deformation-gradient history ``F`` (d, d, num_steps + 1) on a
    device, as the global fields of every step (one batched
    ``mp_U_from_F``)."""

    def __init__(self, F: np.ndarray, dtype: torch.dtype,
                 device: torch.device) -> None:
        F_t = torch.as_tensor(np.asarray(F), dtype=dtype, device=device)
        self.num_steps = F_t.shape[-1] - 1
        self._U = mp_U_from_F(F_t.movedim(-1, 0))

    def U(self, steps: int | slice) -> GlobalFieldsAtPoint:
        """Step ``steps``' global fields, or those of a slice of steps
        stacked on a leading axis (views)."""
        return GlobalFieldsAtPoint(
            fields={"u": self._U.fields["u"][steps]},
            grad_fields={"u": self._U.grad_fields["u"][steps]})


class MPObjective(ABC):
    """Shared scaffolding: parameter injection, the stored forward pass,
    and every step's derivative blocks in one batched evaluation."""

    def __init__(self, qoi, global_state: np.ndarray) -> None:
        self._qoi = qoi
        self._model = qoi.model()
        self._parameters = self._model.parameters
        self._num_steps = qoi.data().shape[-1] - 1
        self._solve = make_newton_solve(self._model.residual_fun,
                                        cuda_graphs=True)
        self._drive = MPDrive(global_state, self._parameters.dtype,
                              self._parameters.device)

    def evaluate(self, flat_active_values) -> GradientResult | HessianResult:
        self._parameters.set_active_values_from_flat(flat_active_values)
        with torch.no_grad():
            return self._evaluate()

    @abstractmethod
    def _evaluate(self) -> GradientResult | HessianResult: ...

    def _forward_pass(self) -> Tensor:
        """The state after every step, (num_steps + 1, num_dofs)."""
        p = self._parameters
        xi = self._model.init_xi(p.dtype, p.device)
        xi_at_step = [xi]
        for step in range(1, self._num_steps + 1):
            xi = self._solve(xi, xi, p.values, self._drive.U(step),
                             self._drive.U(step - 1))
            xi_at_step.append(xi)
        return torch.stack(xi_at_step)

    # ------------------------------------------------------------------
    # derivative blocks (active physical params) of every step at once:
    # the model's and the QoI's evaluators under vmap over the steps,
    # read back to the host in one transfer
    # ------------------------------------------------------------------
    def _aidx(self):
        return self._parameters.active_idx

    def _step_inputs(self):
        """(U, U_prev, data, weight) of steps 1..N, stacked."""
        qoi, N = self._qoi, self._num_steps
        steps = range(1, N + 1)
        return (self._drive.U(slice(1, N + 1)), self._drive.U(slice(0, N)),
                torch.stack([qoi.data_at_step(k) for k in steps]),
                torch.stack([qoi.weight_at_step(k) for k in steps]))

    def _blocks(self, xi_traj: Tensor, second: bool = False) -> dict:
        """Every step's blocks as numpy, step k's at index k - 1: the
        per-step J, the first derivatives and, with ``second``, the
        second derivatives of the model's residual and of the QoI."""
        model, qoi = self._model, self._qoi
        params = self._parameters.values
        p_flat = model.flat_params()
        U, U_prev, data, weight = self._step_inputs()
        xi, xi_prev = xi_traj[1:], xi_traj[:-1]
        m_args = (xi, xi_prev, params, U, U_prev)
        mf_args = (xi, xi_prev, p_flat, U, U_prev)
        q_args, qf_args = m_args + (data, weight), mf_args + (data, weight)
        calls = [("J", qoi.J, q_args),
                 ("dC_dxi", model.jac_xi, m_args),
                 ("dC_dxi_prev", model.jac_xi_prev, m_args),
                 ("dC_dp", model.jac_params_flat, mf_args),
                 ("dJ_dxi", qoi.dJ_dxi, q_args),
                 ("dJ_dp", qoi.dJ_dparams_flat, qf_args)]
        if second:
            calls += [("Cxx", model.hess_xi_xi, m_args),
                      ("Cxxp", model.hess_xi_xi_prev, m_args),
                      ("Cxpxp", model.hess_xi_prev_xi_prev, m_args),
                      ("Cxp", model.hess_xi_params_flat, mf_args),
                      ("Cxprevp", model.hess_xi_prev_params_flat, mf_args),
                      ("Cpp", model.hess_params_params_flat, mf_args),
                      ("Jxx", qoi.hess_xi_xi, q_args),
                      ("Jxp", qoi.hess_xi_params_flat, qf_args),
                      ("Jpp", qoi.hess_params_params_flat, qf_args)]
        out = to_host(*(_over_steps(fn, len(args))(*args)
                        for _name, fn, args in calls))
        blocks = {name: o for (name, _fn, _args), o in zip(calls, out,
                                                            strict=True)}
        aidx = self._aidx()
        blocks["dC_dp"] = blocks["dC_dp"][:, :, aidx]
        blocks["dJ_dp"] = blocks["dJ_dp"][:, aidx]
        return blocks

    @staticmethod
    def _J(blocks) -> float:
        """The steps' J summed in step order, as the JAX package's host
        loop did."""
        J = 0.0
        for J_step in blocks["J"]:
            J += float(J_step)
        return J


def _over_steps(fn, n_args: int):
    """``fn`` under vmap over the steps: every argument but the
    parameters (the third) carries a leading step axis."""
    return vmap(fn, in_dims=(0, 0, None, *(0,) * (n_args - 3)))


class MPAdjointObjective(MPObjective):
    """Gradient via the discrete reverse-time adjoint recursion."""

    def _evaluate(self) -> GradientResult:
        b = self._blocks(self._forward_pass())

        grad = np.zeros(self._parameters.num_active_params)
        history = np.zeros(self._model.num_dofs)
        for k in range(self._num_steps - 1, -1, -1):
            phi = np.linalg.solve(b["dC_dxi"][k].T,
                                  -b["dJ_dxi"][k] + history)
            history = -b["dC_dxi_prev"][k].T @ phi
            grad += phi @ b["dC_dp"][k] + b["dJ_dp"][k]

        grad = self._parameters.transform_grad(grad)
        return GradientResult(J=self._J(b), grad=grad)


class MPDirectObjective(MPObjective):
    """Gradient via the forward (tangent) sensitivity recursion."""

    def _evaluate(self) -> GradientResult:
        b = self._blocks(self._forward_pass())

        n_active = self._parameters.num_active_params
        grad = np.zeros(n_active)
        dxi_dp = np.zeros((self._model.num_dofs, n_active))
        for k in range(self._num_steps):
            dxi_dp = np.linalg.solve(
                b["dC_dxi"][k], -b["dC_dp"][k] - b["dC_dxi_prev"][k] @ dxi_dp)
            grad += b["dJ_dxi"][k] @ dxi_dp + b["dJ_dp"][k]

        grad = self._parameters.transform_grad(grad)
        return GradientResult(J=self._J(b), grad=grad)


class MPDirectAdjointObjective(MPObjective):
    """Gradient + Hessian via the direct-adjoint method (arXiv:2501.04584)."""

    def _evaluate(self) -> HessianResult:
        aidx = self._aidx()
        n_active = self._parameters.num_active_params
        n = self._model.num_dofs

        b = self._blocks(self._forward_pass(), second=True)

        # adjoint pass: gradient + stored multipliers
        grad = np.zeros(n_active)
        history = np.zeros(n)
        phi_at_step = [np.zeros(n)] * self._num_steps
        for k in range(self._num_steps - 1, -1, -1):
            phi = np.linalg.solve(b["dC_dxi"][k].T,
                                  -b["dJ_dxi"][k] + history)
            phi_at_step[k] = phi
            history = -b["dC_dxi_prev"][k].T @ phi
            grad += phi @ b["dC_dp"][k] + b["dJ_dp"][k]

        untransformed_grad = grad.copy()
        grad = self._parameters.transform_grad(grad)

        # forward pass for the Hessian accumulation
        hess = np.zeros((n_active, n_active))
        D_prev = np.zeros((n, n_active))

        for k in range(self._num_steps):
            D = np.linalg.solve(
                b["dC_dxi"][k], -b["dC_dp"][k] - b["dC_dxi_prev"][k] @ D_prev)

            # model second derivatives (active columns), (q, p, xi)
            # orderings
            Cxx, Cxxp, Cxpxp = b["Cxx"][k], b["Cxxp"][k], b["Cxpxp"][k]
            Cpx = b["Cxp"][k][:, :, aidx].transpose((0, 2, 1))
            Cpxprev = b["Cxprevp"][k][:, :, aidx].transpose((0, 2, 1))
            Cpp = b["Cpp"][k][:, aidx][:, :, aidx]

            # qoi second derivatives
            Jxx = b["Jxx"][k]
            Jxp = b["Jxp"][k][:, aidx]
            Jpp = b["Jpp"][k][aidx][:, aidx]
            Jpx = Jxp.T

            phi = phi_at_step[k]

            hess += Jpp \
                + np.einsum("q,qij->ij", phi, Cpp) \
                + Jpx @ D \
                + np.einsum("q,qik,kj->ij", phi, Cpx, D) \
                + (Jpx @ D).T \
                + np.einsum("q,qjk,ki->ij", phi, Cpx, D) \
                + np.einsum("km,ki,mj->ij", Jxx, D, D) \
                + np.einsum("q,qkm,ki,mj->ij", phi, Cxx, D, D) \
                + np.einsum("q,qik,kj->ij", phi, Cpxprev, D_prev) \
                + np.einsum("q,qkm,ki,mj->ij", phi, Cxxp, D, D_prev) \
                + np.einsum("q,qmk,ki,mj->ij", phi, Cxxp, D_prev, D) \
                + np.einsum("q,qkm,ki,mj->ij", phi, Cxpxp, D_prev, D_prev) \
                + np.einsum("q,qjk,ki->ij", phi, Cpxprev, D_prev)

            D_prev = D

        hess = self._parameters.transform_hessian(hess, untransformed_grad)
        return HessianResult(J=self._J(b), grad=grad, hessian=hess)
