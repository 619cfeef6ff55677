"""GlobalResidual contract.

Port of the contract of ``cmad_tpu/global_residuals/global_residual.py``
(parity: reference ``cmad/global_residuals/global_residual.py:26-400``):
the residual blocks a global residual declares (equation counts,
variable kinds, names), its near-null space, and ``for_model``, which
binds a material model to the element-block evaluators that assembly
calls (``fem/assembly.py``), and the nodal output fields.

The JAX package also binds a generic per-integration-point weak form
(``_bind_closed_form`` and ``_bind_coupled``: a local Newton per point
and a ``jacfwd`` tangent). The port's FE slice runs the J2 block
evaluators only (``fem/j2_block.py``); the generic binding comes with
ROADMAP queue 1, items 11, 19 and 21.
"""
from __future__ import annotations

from abc import ABC
from typing import TYPE_CHECKING, Any

import numpy as np

from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.models.var_types import VarType

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
