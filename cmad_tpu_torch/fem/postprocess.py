"""Derived quantities of a converged FE trajectory, per integration
point, for the Exodus writer.

Port of ``cmad_tpu/fem/postprocess.py`` (parity: reference
``cmad/fem/postprocess.py``) for the single displacement field: a state
variable is a slice of the per-IP state; the Cauchy stress is the
model's ``cauchy_fun`` at every (element, IP), with the displacement and
its gradient interpolated from the cached shape functions. The mixed u-p
branch (ROADMAP queue 1, item 22) and the closed-form models (item 19)
are not ported. The recorded history comes in as numpy; the stress is
evaluated on the problem's device, and only its (E, Q, 6) result is
copied back for the writer.
"""
from __future__ import annotations

from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch
from torch.func import vmap

from cmad_tpu_torch.fem.fe_problem import FEProblem, FEState
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.models.global_fields import GlobalFieldsAtPoint
from cmad_tpu_torch.models.var_types import VarType, vector_from_sym_tensor


def evaluate_cauchy_at_ips(fe_problem: FEProblem, fe_state: FEState,
                           step: int, block_name: str) -> np.ndarray:
    """(n_elems, n_ip, 6) Cauchy stress in internal sym-vec order."""
    if fe_problem.modes_by_block[block_name] != GlobalResidualMode.COUPLED:
        raise NotImplementedError(
            "the Cauchy output of a closed-form block is not ported yet: "
            "ROADMAP queue 1, item 19")
    model = fe_problem.models_by_block[block_name]
    geom = fe_problem.geometry_cache[block_name]
    dtype, dev = fe_problem.dtype, fe_problem.device
    r = 0
    name = fe_problem.gr.var_names[r]
    gather = fe_problem.kernel_arrays.u_gather_eq_by_block[block_name][
        fe_problem.field_idx_per_block[r]]
    N = geom["shared"]["N"][r]                               # (Q, nd)
    gradN = geom["per_elem"]["grad_N_phys"][r]               # (E, Q, nd, 3)
    E, Q = gradN.shape[0], gradN.shape[1]

    def on_dev(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)

    def fields_at(U):
        U_e = on_dev(U)[gather]                             # (E, nd, 3)
        return GlobalFieldsAtPoint(
            fields={name: torch.einsum("qa,eai->eqi", N, U_e)
                    .reshape(E * Q, -1)},
            grad_fields={name: torch.einsum("eai,eqaj->eqij", U_e, gradN)
                         .reshape(E * Q, 3, 3)})

    U_now = fields_at(fe_state.U_at(step))
    U_prev = fields_at(fe_state.U_at(step - 1) if step > 0
                       else np.zeros_like(fe_state.U_at(step)))
    xi = on_dev(fe_state.xi_at(step, block_name))
    xi_prev = (on_dev(fe_state.xi_at(step - 1, block_name)) if step > 0
               else torch.zeros_like(xi))
    cauchy = vmap(model.cauchy_fun, in_dims=(0, 0, None, 0, 0))
    with torch.no_grad():
        sigma = cauchy(xi.reshape(E * Q, -1), xi_prev.reshape(E * Q, -1),
                       model.parameters.values, U_now, U_prev)
    return vector_from_sym_tensor(sigma).reshape(E, Q, 6).cpu().numpy()


def evaluate_state_var_at_ips(fe_problem: FEProblem, fe_state: FEState,
                              step: int, block_name: str,
                              resid_idx: int) -> np.ndarray:
    """One state variable at every (elem, IP): a slice of the state."""
    model = fe_problem.models_by_block[block_name]
    xi = np.asarray(fe_state.xi_at(step, block_name))
    slc = model.layout.slc(model.layout.var_names[resid_idx])
    return xi[..., slc]


@dataclass(frozen=True)
class DerivedOutput:
    var_type: VarType
    evaluator: Callable[[FEProblem, FEState, int, str], np.ndarray]


DERIVED_OUTPUT_REGISTRY: dict[str, DerivedOutput] = {
    "cauchy": DerivedOutput(VarType.SYM_TENSOR, evaluate_cauchy_at_ips),
}
