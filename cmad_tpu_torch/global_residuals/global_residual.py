"""GlobalResidual contract.

Port of the contract of ``cmad_tpu/global_residuals/global_residual.py``
(parity: reference ``cmad/global_residuals/global_residual.py:26-400``):
the residual blocks a global residual declares (equation counts,
variable kinds, names), its near-null space, and ``for_model``, which
binds a material model to the element-block evaluators that assembly
calls (``fem/assembly.py``), and the nodal output fields.

The local-solve menu (:meth:`GlobalResidual._build_local_solve`) picks
the per-point local solve of the point-batch block
(``fem/coupled_block.py``). The JAX package also binds a generic
per-integration-point weak form (``_bind_closed_form`` and
``_bind_coupled``: a local Newton per point and a ``jacfwd`` tangent);
the port's FE blocks are the J2 block (``fem/j2_block.py``) and the
point-batch block, and the per-point binding comes with ROADMAP queue 1,
items 11 and 19.
"""
from __future__ import annotations

from abc import ABC
from typing import TYPE_CHECKING, Any

import numpy as np

from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.nonlinear_solver import StrainLocalSolve
from cmad_tpu_torch.models.var_types import VarType, sym_tensor_from_vector
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.mesh import Mesh


class GlobalResidual(ABC):

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
        """The block evaluators ``fem/assembly.py`` calls for ``model``
        in ``mode``."""
        raise NotImplementedError(
            f"{type(self).__name__} binds no element evaluators")

    @staticmethod
    def _build_local_solve(model, local_newton_settings: dict[str, Any]
                           ) -> StrainLocalSolve:
        """The local solve of a small-strain elastic-plastic model in
        strain space: the reduced 4-dof Hosford Newton when the model
        admits it (``ops/hosford_return.py``), else the generic 7-dof
        implicit-function Newton on ``model.residual_fun``. The JAX
        package's principal-Hosford and Hill arms come with item 21;
        J2+Voce never reaches this menu here, since the J2 block takes
        it first."""
        from cmad_tpu_torch.ops.hosford_return import (
            hosford_reducible,
            make_hosford_strain_solve,
        )

        if hosford_reducible(model):
            return make_hosford_strain_solve(model, **local_newton_settings)
        return StrainLocalSolve(_model_residual(model), _identity,
                                _keep_state, **local_newton_settings)


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


def _model_residual(model):
    def residual(xi, xi_prev, params, g6):
        U, U_prev = strain_fields(g6)
        return model.residual_fun(xi, xi_prev, params, U, U_prev)
    return residual


def _identity(xi_prev: Tensor) -> Tensor:
    return xi_prev


def _keep_state(xi, xi_prev, params, g6) -> Tensor:
    return xi
