"""FE-side QoI contract: per-step closure factory.

Port of ``cmad_tpu/qois/fe_qoi.py`` (parity: reference
``cmad/qois/fe_qoi.py``). An FE QoI builds a per-step closure
``(U, U_prev, xi, xi_prev, t, t_prev) -> J_n`` via
``step_contribution(params_by_block, fe_arrays)``; the drivers add the
increments into J. The closure reads only tensors it is given or that the
QoI holds as data (the target, the quadrature weights), so autograd sees
every use of the state and the parameters.
"""
from __future__ import annotations

from abc import ABC, abstractmethod
from collections.abc import Callable, Mapping, Sequence
from typing import TYPE_CHECKING, Any, ClassVar

from cmad_tpu_torch.qois.qoi_base import QoIBase
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.fe_problem import FEProblem, FEState
    from cmad_tpu_torch.fem.kernel_arrays import FEKernelArrays

# (U, U_prev, xi, xi_prev, t, t_prev) -> scalar step increment
StepContribution = Callable[..., Tensor]


class FEQoI(QoIBase, ABC):
    problem_type: ClassVar[str] = "fe"

    @abstractmethod
    def step_contribution(self, params_by_block: Mapping[str, dict],
                          fe_arrays: "FEKernelArrays") -> StepContribution:
        ...

    @classmethod
    @abstractmethod
    def from_deck(cls, qoi_section: dict[str, Any],
                  fe_problem: "FEProblem",
                  t_schedule: Sequence[float]) -> "FEQoI":
        ...

    def produces_primal_output(self) -> bool:
        """True for a QoI that ``cmad primal`` writes instead of J."""
        return False

    def write_primal_outputs(self, fe_problem: "FEProblem",
                             fe_state: "FEState") -> None:
        raise NotImplementedError(
            f"{type(self).__name__} does not produce a primal output")
