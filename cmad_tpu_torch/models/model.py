"""Material-point model contract (functional, flat-state).

Port of ``cmad_tpu/models/model.py`` (parity: reference
``cmad/models/model.py:25-563``):

- the local state is a flat vector addressed through a
  :class:`~cmad_tpu_torch.models.state.StateLayout`;
- every evaluator is a pure function of explicit
  ``(xi, xi_prev, params, U, U_prev)``;
- the full derivative surface (five Jacobians, mixed Hessians, the
  dcauchy family) is built lazily as cached ``torch.func`` compositions,
  where the JAX package cached ``jit``-compiled ones. PyTorch runs them
  eagerly; nothing is compiled. Derivatives with respect to parameters
  take the flat full-parameter vector (``Parameters`` keeps the JAX
  package's ``ravel_pytree`` order), so Hessian blocks come out as dense
  matrices.

The residual and Cauchy functions are written for one point; the
``*_batched`` evaluators are ``torch.func.vmap`` over a leading point
batch on (xi, xi_prev, U, U_prev) with shared params.
"""
from __future__ import annotations

from abc import ABC
from collections.abc import Callable
from functools import cached_property
from typing import Any, ClassVar

import torch
from torch.func import hessian, jacfwd, jacrev, vmap

from cmad_tpu_torch.config import DEFAULT_DEVICE
from cmad_tpu_torch.models.deformation_types import def_type_ndims
from cmad_tpu_torch.models.state import StateLayout
from cmad_tpu_torch.parameters.parameters import Parameters
from cmad_tpu_torch.typing import CauchyFn, ResidualFn, Tensor

_BATCHED = (0, 0, None, 0, 0)


class Model(ABC):
    """Base class wiring a pure residual + cauchy pair into the full
    derivative surface."""

    supports_closed_form_cauchy: ClassVar[bool] = False
    supports_mixed: ClassVar[bool] = False

    def __init__(
            self,
            residual_fun: ResidualFn,
            cauchy_fun: CauchyFn,
            layout: StateLayout,
            parameters: Parameters,
            def_type: int,
            cauchy_closed_form_fun: Callable[..., Tensor] | None = None,
    ) -> None:
        self.residual_fun = residual_fun
        self.cauchy_fun = cauchy_fun
        self.layout = layout
        self.parameters = parameters
        self._def_type = def_type
        self._ndims = def_type_ndims(def_type)
        self.cauchy_closed_form_fun = cauchy_closed_form_fun

        self.num_dofs = layout.num_dofs
        self.num_residuals = len(layout)
        self.var_names = layout.var_names
        self.resid_names = layout.resid_names

        # flat-params adapter: p_flat is the ravel of parameters.values
        unravel_p = parameters.reconstruct_from_flat
        self._unravel_params = unravel_p

        def res_flatp(xi, xi_prev, p_flat, U, U_prev):
            return residual_fun(xi, xi_prev, unravel_p(p_flat), U, U_prev)

        def cauchy_flatp(xi, xi_prev, p_flat, U, U_prev):
            return cauchy_fun(xi, xi_prev, unravel_p(p_flat), U, U_prev)

        self._res_flatp = res_flatp
        self._cauchy_flatp = cauchy_flatp

    # ------------------------------------------------------------------
    # deck integration hooks
    # ------------------------------------------------------------------
    @classmethod
    def from_deck(cls, model_section: dict[str, Any],
                  parameters: Parameters, def_type: int) -> "Model":
        raise NotImplementedError

    @classmethod
    def material_defaults(cls) -> dict[str, Any]:
        return {}

    def derived_output_field_names(self) -> list[str]:
        return []

    def state_output_fields(self):
        return list(zip(self.layout.var_names, self.layout.var_types,
                        strict=True))

    # ------------------------------------------------------------------
    # basic properties
    # ------------------------------------------------------------------
    @property
    def ndims(self) -> int:
        return self._ndims

    @property
    def def_type(self) -> int:
        return self._def_type

    def init_xi(self, dtype: torch.dtype | None = None,
                device: torch.device | str = DEFAULT_DEVICE) -> Tensor:
        """The initial state, on the card unless ``device`` says
        otherwise."""
        return self.layout.init_xi(dtype, device)

    def flat_params(self) -> Tensor:
        return Parameters._ravel(self.parameters.values)

    # ------------------------------------------------------------------
    # residual + first derivatives (cached compositions)
    # ------------------------------------------------------------------
    @cached_property
    def C(self):
        """Residual C(xi, xi_prev, params, U, U_prev) -> (n,)."""
        return self.residual_fun

    @cached_property
    def jac_xi(self):
        return jacfwd(self.residual_fun, argnums=0)

    @cached_property
    def jac_xi_prev(self):
        return jacfwd(self.residual_fun, argnums=1)

    @cached_property
    def jac_params(self):
        """dC/dparams as a dict matching the params structure."""
        return jacrev(self.residual_fun, argnums=2)

    @cached_property
    def jac_u(self):
        return jacfwd(self.residual_fun, argnums=3)

    @cached_property
    def jac_u_prev(self):
        return jacfwd(self.residual_fun, argnums=4)

    @cached_property
    def jac_params_flat(self):
        """dC/dp_flat -> (n, P) dense (full parameter vector)."""
        return jacrev(self._res_flatp, argnums=2)

    def jac_params_active(self, xi, xi_prev, U, U_prev) -> Tensor:
        """dC/d(active params) -> (n, n_active) at current values."""
        J = self.jac_params_flat(xi, xi_prev, self.flat_params(), U, U_prev)
        idx = torch.as_tensor(self.parameters.active_idx, device=J.device)
        return J[:, idx]

    # ------------------------------------------------------------------
    # second derivatives (direct-adjoint Hessian surface;
    # parity with model.py:245-271 evaluate_hessians)
    # ------------------------------------------------------------------
    @cached_property
    def hess_xi_xi(self):
        return jacfwd(jacfwd(self.residual_fun, argnums=0), argnums=0)

    @cached_property
    def hess_xi_xi_prev(self):
        return jacfwd(jacfwd(self.residual_fun, argnums=0), argnums=1)

    @cached_property
    def hess_xi_prev_xi_prev(self):
        return jacfwd(jacfwd(self.residual_fun, argnums=1), argnums=1)

    @cached_property
    def hess_xi_params_flat(self):
        """d2C/(dxi dp) -> (n, nxi, P)."""
        return jacrev(jacfwd(self._res_flatp, argnums=0), argnums=2)

    @cached_property
    def hess_xi_prev_params_flat(self):
        return jacrev(jacfwd(self._res_flatp, argnums=1), argnums=2)

    @cached_property
    def hess_params_params_flat(self):
        """d2C/dp2 -> (n, P, P)."""
        return hessian(self._res_flatp, argnums=2)

    # ------------------------------------------------------------------
    # cauchy stress + derivatives
    # ------------------------------------------------------------------
    @cached_property
    def cauchy(self):
        return self.cauchy_fun

    @cached_property
    def dcauchy_dxi(self):
        return jacfwd(self.cauchy_fun, argnums=0)

    @cached_property
    def dcauchy_dxi_prev(self):
        return jacfwd(self.cauchy_fun, argnums=1)

    @cached_property
    def dcauchy_dparams_flat(self):
        return jacrev(self._cauchy_flatp, argnums=2)

    @cached_property
    def cauchy_closed_form(self):
        return self.cauchy_closed_form_fun

    # ------------------------------------------------------------------
    # batched (structure-of-arrays) evaluators: leading point batch on
    # xi/xi_prev/U/U_prev, shared params
    # ------------------------------------------------------------------
    @cached_property
    def C_batched(self):
        return vmap(self.residual_fun, in_dims=_BATCHED)

    @cached_property
    def jac_xi_batched(self):
        return vmap(jacfwd(self.residual_fun, argnums=0), in_dims=_BATCHED)

    @cached_property
    def cauchy_batched(self):
        return vmap(self.cauchy_fun, in_dims=_BATCHED)

    # convenience: deviatoric / hydrostatic splits used by mixed u-p
    def dev_cauchy(self, xi, xi_prev, params, U, U_prev) -> Tensor:
        sigma = self.cauchy_fun(xi, xi_prev, params, U, U_prev)
        tr = torch.diagonal(sigma, dim1=-2, dim2=-1).sum(-1)
        eye = torch.eye(3, dtype=sigma.dtype, device=sigma.device)
        return sigma - tr[..., None, None] / 3.0 * eye

    def hydro_cauchy(self, xi, xi_prev, params, U, U_prev) -> Tensor:
        sigma = self.cauchy_fun(xi, xi_prev, params, U, U_prev)
        return torch.diagonal(sigma, dim1=-2, dim2=-1).sum(-1) / 3.0
