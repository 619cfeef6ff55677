"""GlobalResidual contract + mode-bound evaluator factory.

Port of ``cmad_tpu/global_residuals/global_residual.py`` (parity:
reference ``cmad/global_residuals/global_residual.py:26-400``). A GR
supplies a pure per-point weak-form residual

    residual_fn(xi, xi_prev, params, U, U_prev, model, mode,
                shapes_ip, w, dv, h, ip_set) -> list[Tensor]

with ``xi`` the model's flat local state, ``U``/``U_prev`` the element's
basis coefficients per residual block, ``shapes_ip`` the per-block
physical-frame shape functions at the point and ``(w, dv, h)`` the
quadrature weight, the measure and the element size. It declares its
residual blocks (equation counts, variable kinds, names), its near-null
space and its nodal output fields.

``for_model(model, mode)`` binds a model to the generic per-point block
(``fem/generic_block.py``), whose evaluators have the signature of the
J2 and point-batch blocks, so assembly has one dispatch:

- CLOSED_FORM: the stress from ``model.cauchy_closed_form_fun``, the
  tangent ``jacfwd`` of the point's residual in the element's
  coefficients; the block carries no state;
- COUPLED: one batched local Newton of ``model.residual_fun`` over the
  block's points (:meth:`GlobalResidual._build_local_solve`), the
  tangent by the implicit-function rule, the converged state returned.

A GR may take a block first with a faster path of its own
(``SmallDispEquilibrium``: the J2 block, then the point-batch block).
"""
from __future__ import annotations

from abc import ABC
from typing import TYPE_CHECKING, Any

import numpy as np

from cmad_tpu_torch import config
from cmad_tpu_torch.global_residuals.interpolation import (
    interpolate_global_fields_at_ip,
)
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.nonlinear_solver import LocalSolve
from cmad_tpu_torch.models.var_types import VarType, sym_tensor_from_vector
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.mesh import Mesh


class GlobalResidual(ABC):

    def __init__(self, residual_fn) -> None:
        self._residual_fn = residual_fn

    @classmethod
    def from_deck(cls, gr_section: dict[str, Any],
                  ndims: int) -> "GlobalResidual":
        raise NotImplementedError

    def _init_residuals(self, num_residuals: int) -> None:
        self.num_residuals = num_residuals
        self._num_eqs = np.zeros(num_residuals, dtype=int)
        self._var_types = np.zeros(num_residuals, dtype=int)
        self.resid_names: list[str | None] = [None] * num_residuals
        self.var_names: list[str | None] = [None] * num_residuals

    def var_type(self, residual: int) -> int:
        return int(self._var_types[residual])

    def resid_name(self, residual: int) -> str | None:
        return self.resid_names[residual]

    @property
    def ndims(self) -> int:
        return self._ndims

    def interpolate_global_fields_at_ip(self, U, shapes_ip
                                        ) -> GlobalFieldsAtPoint:
        return interpolate_global_fields_at_ip(U, shapes_ip, self.var_names)

    def near_null_space(self, mesh: "Mesh") -> np.ndarray | None:
        """Near-null-space basis for multilevel/deflation preconditioners;
        mechanics GRs override with rigid-body modes. Default None."""
        return None

    def primary_output_fields(self) -> list[tuple[str, VarType]]:
        """``(var_name, kind)`` of each residual block: the nodal fields
        the Exodus writer can write."""
        return [(self.var_names[r], VarType(int(self._var_types[r])))
                for r in range(self.num_residuals)]

    def evaluate_nodal_field(self, name: str, fe_problem, fe_state,
                             step: int) -> np.ndarray:
        raise ValueError(
            f"{type(self).__name__} does not implement nodal field "
            f"{name!r}")

    def for_model(self, model,
                  mode: GlobalResidualMode = GlobalResidualMode.COUPLED,
                  local_newton_settings: dict[str, Any] | None = None,
                  print_local_convergence: bool = False) -> dict:
        """The generic block evaluators ``fem/assembly.py`` calls for
        ``model`` in ``mode``."""
        if mode == GlobalResidualMode.CLOSED_FORM:
            if local_newton_settings is not None:
                raise ValueError(
                    "local_newton_settings is only valid in COUPLED mode")
            if not model.supports_closed_form_cauchy:
                raise ValueError(
                    f"CLOSED_FORM binding requires "
                    f"supports_closed_form_cauchy; "
                    f"{type(model).__name__} lacks it")
            return self._bind_closed_form(model)
        if mode == GlobalResidualMode.COUPLED:
            if local_newton_settings is None:
                local_newton_settings = default_local_newton_settings(model)
            return self._bind_coupled(model, local_newton_settings,
                                      print_local_convergence)
        raise ValueError(f"unknown GlobalResidualMode: {mode}")

    def _bind_closed_form(self, model) -> dict:
        from cmad_tpu_torch.fem.generic_block import (
            make_generic_block_kernels,
        )
        return make_generic_block_kernels(self, model,
                                          GlobalResidualMode.CLOSED_FORM)

    def _bind_coupled(self, model, local_newton_settings: dict[str, Any],
                      print_local_convergence: bool) -> dict:
        from cmad_tpu_torch.fem.generic_block import (
            make_generic_block_kernels,
        )
        solve = self._build_local_solve(
            model, local_newton_settings, print_local_convergence,
            point_fields=self.point_fields)
        return make_generic_block_kernels(
            self, model, GlobalResidualMode.COUPLED, local_solve=solve)

    def point_fields(self, U: Tensor, aux
                     ) -> tuple[GlobalFieldsAtPoint, GlobalFieldsAtPoint]:
        """``(U, U_prev)`` at one point from the element's coefficients
        ``U`` (nd, ncomp) and ``aux = (U_prev, N, grad_N)``: the generic
        block's local-solve input (single residual block)."""
        from cmad_tpu_torch.fem.elements import ShapeFunctionsAtIP

        U_prev, N, grad_N = aux
        shapes = [ShapeFunctionsAtIP(N=N, grad_N=grad_N)]
        return (self.interpolate_global_fields_at_ip([U], shapes),
                self.interpolate_global_fields_at_ip([U_prev], shapes))

    @staticmethod
    def _build_local_solve(model, local_newton_settings: dict[str, Any],
                           print_local_convergence: bool = False,
                           point_fields=None) -> LocalSolve:
        """The batched local solve of a block's points. Its input is the
        strain rows (``point_fields`` None: the point-batch block) or
        what ``point_fields(g, aux) -> (U, U_prev)`` reads (the generic
        block: the element's coefficients, with the previous ones and
        the shape functions as ``aux``). In strain space a model that
        admits one gets a reduced Newton, in the JAX package's order: the
        diagonal Hosford one (``ops/hosford_return.py``), the principal
        Hosford one (``ops/principal_return.py``), the Hill one
        (``ops/hill_return.py``); the J2 block takes J2+Voce before this
        menu. Everything else, and every model when
        ``print_local_convergence`` asks for each iteration, gets the
        generic implicit-function Newton on ``model.residual_fun``."""
        from cmad_tpu_torch.ops.hill_return import (
            hill_reducible,
            make_hill_strain_solve,
        )
        from cmad_tpu_torch.ops.hosford_return import (
            hosford_reducible,
            make_hosford_strain_solve,
        )
        from cmad_tpu_torch.ops.principal_return import (
            make_principal_hosford_strain_solve,
            principal_hosford_reducible,
        )

        strain = point_fields is None
        if strain and not print_local_convergence:
            for reducible, make in (
                    (hosford_reducible, make_hosford_strain_solve),
                    (principal_hosford_reducible,
                     make_principal_hosford_strain_solve),
                    (hill_reducible, make_hill_strain_solve)):
                if reducible(model):
                    return make(model, **local_newton_settings)
        return LocalSolve(
            _model_residual(model, strain_fields if strain else point_fields),
            _identity, _keep_state,
            print_local_convergence=print_local_convergence,
            n_aux=0 if strain else 1, **local_newton_settings)


def default_local_newton_settings(model) -> dict[str, Any]:
    """The FE local Newton's settings when a binding is given none: the
    ``fe_local`` tolerances of the parameters' dtype, 20 iterations."""
    abs_tol, rel_tol = config.newton_tols("fe_local",
                                          model.parameters.dtype)
    return {"abs_tol": abs_tol, "rel_tol": rel_tol, "max_iters": 20}


def strain_fields(g6: Tensor
                  ) -> tuple[GlobalFieldsAtPoint, GlobalFieldsAtPoint]:
    """``(U, U_prev)`` at one point from its strain rows ``g6``: the
    gradient ``sym(g6)`` and a zero previous gradient. Both small-strain
    families read the fields only through ``sym(grad u)`` (the rate form
    through its increment), so this pair reproduces any pair with that
    strain (increment)."""
    zero3 = g6.new_zeros(3)
    return (GlobalFieldsAtPoint(fields={"u": zero3},
                                grad_fields={"u": sym_tensor_from_vector(g6)}),
            GlobalFieldsAtPoint(fields={"u": zero3},
                                grad_fields={"u": g6.new_zeros((3, 3))}))


def _model_residual(model, point_fields):
    def residual(xi, xi_prev, params, g, *aux):
        U, U_prev = point_fields(g, *aux)
        return model.residual_fun(xi, xi_prev, params, U, U_prev)
    return residual


def _identity(xi_prev: Tensor) -> Tensor:
    return xi_prev


def _keep_state(xi, xi_prev, params, g, *aux) -> Tensor:
    return xi
