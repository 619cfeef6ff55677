"""Boundary-reaction FE QoI: match a measured load, or write the computed
reaction series.

Port of ``cmad_tpu/qois/fe_load_match.py`` (parity: reference
``cmad/qois/fe_load_match.py``). The reaction is the global residual
summed over the sideset's Dirichlet-prescribed dofs (the consistent nodal
reaction). It depends on the parameters directly through the assembly:
the closure assembles with the parameter trees its ``step_contribution``
is given, which the sensitivity sweeps build from the parameter vector
at every step, so autograd sees that term as well as the state's.
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, ClassVar

import numpy as np
import torch

from cmad_tpu_torch.io.qoi_data import load_reaction_data
from cmad_tpu_torch.io.registry import register_qoi
from cmad_tpu_torch.qois.fe_qoi import FEQoI, StepContribution


@register_qoi("fe_load_match")
class FELoadMatch(FEQoI):
    problem_type: ClassVar[str] = "fe"

    def __init__(self, fe_problem, t_schedule: Sequence[float],
                 sideset: str, components: Sequence[int],
                 data=None, output_file: str | None = None,
                 weight: float = 1.0) -> None:
        comps = [int(c) for c in components]
        self._fe_problem = fe_problem
        self._eq_per_component = [
            torch.as_tensor(fe_problem.dof_map.dirichlet_eqs_for_component(
                sideset, "u", c), device=fe_problem.device) for c in comps]
        self._t_schedule = np.asarray([float(t) for t in t_schedule])
        self._norm = float(weight) / (float(t_schedule[-1])
                                      - float(t_schedule[0]))
        self._output_file = output_file
        if data is None:
            self._data = None
        else:
            data = np.asarray(data, dtype=np.float64)
            if data.ndim == 1 and len(comps) == 1:
                data = data.reshape(-1, 1)
            expected = (len(t_schedule), len(comps))
            if data.shape != expected:
                raise ValueError(
                    f"FELoadMatch: data shape {tuple(data.shape)} != "
                    f"{expected}")
            self._data = torch.as_tensor(data, dtype=fe_problem.dtype,
                                         device=fe_problem.device)

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], fe_problem,
                  t_schedule) -> "FELoadMatch":
        sideset = qoi_section["sideset"]
        components = qoi_section["components"]
        if "data_file" in qoi_section:
            return cls(fe_problem, t_schedule, sideset, components,
                       data=load_reaction_data(qoi_section),
                       weight=float(qoi_section.get("weight", 1.0)))
        return cls(fe_problem, t_schedule, sideset, components,
                   output_file=qoi_section["output_file"])

    def _reaction_at(self, params_by_block, fe_arrays, U, U_prev, t,
                     xi_prev):
        from cmad_tpu_torch.fem.assembly import assemble_global_residual

        R = assemble_global_residual(
            self._fe_problem, fe_arrays, params_by_block, U, U_prev, t,
            xi_prev_by_block=xi_prev)
        return torch.stack([torch.sum(R[eq])
                            for eq in self._eq_per_component])

    def step_contribution(self, params_by_block: Mapping[str, dict],
                          fe_arrays) -> StepContribution:
        if self._data is None:
            raise ValueError(
                "fe_load_match in write mode (output_file) has no "
                "objective; use it under cmad primal")
        data, t_schedule, norm = self._data, self._t_schedule, self._norm

        def closure(U, U_prev, xi, xi_prev, t, t_prev):
            dt = float(t) - float(t_prev)
            step = int(np.argmin(np.abs(t_schedule - float(t))))
            reaction = self._reaction_at(params_by_block, fe_arrays, U,
                                         U_prev, float(t), xi_prev)
            return norm * dt * torch.sum((reaction - data[step]) ** 2)

        return closure

    def produces_primal_output(self) -> bool:
        return self._output_file is not None

    def write_primal_outputs(self, fe_problem, fe_state) -> None:
        """The reaction after every recorded step, one row per step, to
        ``output_file`` (CSV)."""
        from cmad_tpu_torch.fem.assembly import params_by_block_from_models
        from cmad_tpu_torch.fem.xi_carrier import pack_xi_by_block

        assert self._output_file is not None
        params = params_by_block_from_models(fe_problem)
        dtype, dev = fe_problem.dtype, fe_problem.device
        n = len(fe_state.t_history)
        series = np.zeros((n, len(self._eq_per_component)))
        with torch.no_grad():
            for k in range(n):
                kp = max(k - 1, 0)
                xi_prev = pack_xi_by_block(fe_problem, {
                    b: torch.as_tensor(fe_state.xi_at(kp, b), dtype=dtype,
                                       device=dev)
                    for b in fe_problem.models_by_block}, layout="aos")
                series[k] = self._reaction_at(
                    params, fe_problem.kernel_arrays,
                    torch.as_tensor(fe_state.U_at(k), dtype=dtype,
                                    device=dev),
                    torch.as_tensor(fe_state.U_at(kp), dtype=dtype,
                                    device=dev),
                    float(fe_state.t_history[k]), xi_prev).cpu().numpy()
        np.savetxt(self._output_file, series, delimiter=",")
