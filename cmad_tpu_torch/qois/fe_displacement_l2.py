"""Time- and space-averaged squared-displacement FE QoI.

Port of ``cmad_tpu/qois/fe_displacement_l2.py`` (parity: reference
``cmad/qois/fe_displacement_l2.py``):
``J = (1 / (T |Omega|)) sum_n dt_n int |u_n|^2 dV`` with u_0 = 0. The
closure reads only the ``u`` block; its element gather goes through the
residual scatter's segment plan, so its transpose in the reverse sweep
is the reproducible segment sum (``ops/segment_sum.py``).
"""
from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any, ClassVar

import torch

from cmad_tpu_torch.io.registry import register_qoi
from cmad_tpu_torch.ops.segment_sum import segment_gather
from cmad_tpu_torch.qois.fe_qoi import FEQoI, StepContribution


def _displacement_block(fe_problem) -> tuple[int, int]:
    """(residual index, field index) of the ``u`` block."""
    var_names = list(fe_problem.gr.var_names)
    try:
        r = var_names.index("u")
    except ValueError as e:
        raise ValueError(
            f"QoI requires a residual block with var_name 'u'; got "
            f"{var_names}") from e
    return r, fe_problem.field_idx_per_block[r]


def _total_volume(fe_problem) -> float:
    """The sum of every block's ``iso_jac_det * quad_w``."""
    return float(sum(
        (c["per_elem"]["iso_jac_det"].double()
         * c["shared"]["quad_w"].double()[None, :]).sum()
        for c in fe_problem.geometry_cache.values()))


def _u_blocks(fe_problem, fe_arrays, r: int, field_idx: int) -> list:
    """Per block: the ``u`` field's gather plan, its element shape, the
    shape functions at the IPs and ``iso_jac_det * quad_w``."""
    blocks = []
    for name in fe_problem.models_by_block:
        geom = fe_arrays.geometry_cache[name]
        blocks.append((fe_arrays.eq_plan_by_block[name][field_idx],
                       fe_arrays.u_gather_eq_by_block[name][field_idx].shape,
                       geom["shared"]["N"][r],
                       geom["per_elem"]["iso_jac_det"]
                       * geom["shared"]["quad_w"][None, :]))
    return blocks


def integrate_squared(blocks: list, v) -> torch.Tensor:
    """``int |v|^2 dV`` of a nodal vector field ``v`` (flat, the ``u``
    block's layout) over the blocks of :func:`_u_blocks`."""
    total = v.new_zeros(())
    for plan, shape, N, w_dv in blocks:
        v_elem = segment_gather(v, plan).reshape(shape)
        v_ip = torch.einsum("pa,eak->epk", N, v_elem)
        total = total + torch.sum(torch.sum(v_ip * v_ip, dim=-1) * w_dv)
    return total


@register_qoi("fe_displacement_l2")
class FEDisplacementL2(FEQoI):
    problem_type: ClassVar[str] = "fe"

    def __init__(self, fe_problem, t_schedule: Sequence[float]) -> None:
        self._fe_problem = fe_problem
        self._r_disp, self._field_idx = _displacement_block(fe_problem)
        T = float(t_schedule[-1]) - float(t_schedule[0])
        self._norm = 1.0 / (T * _total_volume(fe_problem))

    @classmethod
    def from_deck(cls, qoi_section: dict[str, Any], fe_problem,
                  t_schedule) -> "FEDisplacementL2":
        return cls(fe_problem, t_schedule)

    def step_contribution(self, params_by_block: Mapping[str, dict],
                          fe_arrays) -> StepContribution:
        del params_by_block  # enters only through the solved state
        blocks = _u_blocks(self._fe_problem, fe_arrays, self._r_disp,
                           self._field_idx)
        norm = self._norm

        def closure(U, U_prev, xi, xi_prev, t, t_prev):
            dt = float(t) - float(t_prev)
            return norm * dt * integrate_squared(blocks, U)

        return closure
