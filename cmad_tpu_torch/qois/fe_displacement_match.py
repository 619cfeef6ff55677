"""Time- and space-averaged displacement-mismatch FE QoI.

Port of ``cmad_tpu/qois/fe_displacement_match.py`` (parity: reference
``cmad/qois/fe_displacement_match.py``):
``J = (w / (T |Omega|)) sum_n dt_n int |u_n - u_data_n|^2 dV``.

The step's target is found on the host (the schedule time nearest to
``t``); the element gather of the mismatch goes through the residual
scatter's segment plan, so its transpose in the reverse sweep is the
reproducible segment sum (``ops/segment_sum.py``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, ClassVar

import numpy as np
import torch

from cmad_tpu_torch.io.qoi_data import load_displacement_data
from cmad_tpu_torch.io.registry import register_qoi
from cmad_tpu_torch.qois.fe_displacement_l2 import (
    _displacement_block,
    _total_volume,
    _u_blocks,
    integrate_squared,
)
from cmad_tpu_torch.qois.fe_qoi import FEQoI, StepContribution


@register_qoi("fe_displacement_match")
class FEDisplacementMatch(FEQoI):
    problem_type: ClassVar[str] = "fe"

    def __init__(self, fe_problem, t_schedule: Sequence[float], data,
                 weight: float = 1.0) -> None:
        self._fe_problem = fe_problem
        self._r_disp, self._field_idx = _displacement_block(fe_problem)

        num_steps = len(t_schedule)
        data = torch.as_tensor(np.asarray(data), dtype=fe_problem.dtype,
                               device=fe_problem.device)
        if data.shape[0] != num_steps:
            raise ValueError(
                f"data has {data.shape[0]} steps; schedule has "
                f"{num_steps} (one field per schedule time incl. t0)")
        flat = data.reshape(num_steps, -1)
        n_dofs = fe_problem.dof_map.num_total_dofs
        if flat.shape[1] != n_dofs:
            raise ValueError(
                f"data flattens to {flat.shape[1]} dofs/step; problem has "
                f"{n_dofs} (single-displacement-field problems only)")
        self._data_flat = flat
        self._t_schedule = np.asarray([float(t) for t in t_schedule])
        T = float(t_schedule[-1]) - float(t_schedule[0])
        self._norm = float(weight) / (T * _total_volume(fe_problem))

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], fe_problem,
                  t_schedule) -> "FEDisplacementMatch":
        return cls(fe_problem, t_schedule,
                   load_displacement_data(qoi_section),
                   weight=float(qoi_section.get("weight", 1.0)))

    def step_contribution(self, params_by_block: Mapping[str, dict],
                          fe_arrays) -> StepContribution:
        del params_by_block  # enters only through the solved state
        blocks = _u_blocks(self._fe_problem, fe_arrays, self._r_disp,
                           self._field_idx)
        norm, data_flat = self._norm, self._data_flat
        t_schedule = self._t_schedule

        def closure(U, U_prev, xi, xi_prev, t, t_prev):
            dt = float(t) - float(t_prev)
            step = int(np.argmin(np.abs(t_schedule - float(t))))
            return norm * dt * integrate_squared(blocks, U - data_flat[step])

        return closure
