"""Point-batch COUPLED block for displacement-form equilibrium.

Port of ``cmad_tpu/fem/coupled_block.py``. For the small-strain
displacement residual the element tangent has B-matrix structure: with
``sigma`` a function of the symmetric strain alone,

    R[a, i]          = grad_N[a, j] sigma[j, i] w dv
    K[(a,i), (b,k)]  = c_A B[A,(a,i)] D66[A, B] B[B,(b,k)] w dv

where ``B[A,(b,k)] = d eps6_A / d U[b,k]`` is the strain-displacement
operator, ``D66 = d sigma6 / d eps6`` the 6x6 algorithmic tangent and
``c = [1, 2, 2, 1, 2, 1]`` counts the off-diagonal pairs (sym-vec order
[xx, xy, xz, yy, yz, zz]). A whole element block is evaluated as:

1. the strain rows (rate form: the increment; total form: the strain) of
   every (element, IP) in one einsum;
2. the local solve the menu ``GlobalResidual._build_local_solve`` picks
   (the reduced Hosford Newton, or the generic 7-dof Newton) over the
   flat ``E*Q`` point batch, and the stress through ``model.cauchy_fun``;
3. ``D66`` by the implicit-function rule in strain space: at the
   converged unknowns, one batched solve of the local Jacobian with six
   right-hand sides gives ``dx/dg6``, then
   ``D66 = ds/dg6 + ds/dx dx/dg6`` through the state's reconstruction
   and ``cauchy_fun``;
4. ``R`` (less the body force ``N f w dv`` when there is one) and
   ``K = B^T (c D66 w dv) B`` as batched einsums.

The JAX package took ``D66`` from a six-wide ``jacfwd`` over the point
function, local solve included. The port's implicit solve
(``models/nonlinear_solver._ImplicitSolve``) is a host-driven Newton
loop with a ``jvp`` but no batching rule, so it cannot sit under
``jacfwd``; the rule above is the same derivative, written in
differentiable ops, so ``K``'s dependence on the parameters reaches the
second-derivative sweeps. Both families read the global fields only
through ``sym(grad u)`` (the rate form through its increment), so
driving the point with the strain rows reproduces the element path.

The JAX package's ``CMAD_FE_POINTBATCH`` switch is not ported: every
block :func:`pointbatch_applicable` accepts, and the J2 block does not
take first, runs here.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch
from torch.func import jacfwd, vmap

from cmad_tpu_torch.global_residuals.global_residual import (
    GlobalResidual,
    default_local_newton_settings,
    strain_fields,
)
from cmad_tpu_torch.models.deformation_types import DefType
from cmad_tpu_torch.models.var_types import (
    sym_tensor_from_vector,
    vector_from_sym_tensor,
)

# off-diagonal sym-vec entries stand for two tensor slots
_PAIR_WEIGHT = (1.0, 2.0, 2.0, 1.0, 2.0, 1.0)
_PAIRS = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _strain_dof_tensor() -> np.ndarray:
    """T[A, k, j] with ``B[e,q,A,b,k] = T[A,k,j] grad_N[e,q,b,j]``:
    d eps6_A / d U[b,k] for eps = sym(grad u), grad_u[i,j] =
    U[b,i] grad_N[b,j]."""
    T = np.zeros((6, 3, 3))
    for A, (m, n) in enumerate(_PAIRS):
        T[A, m, n] += 0.5
        T[A, n, m] += 0.5
    return T


def pointbatch_applicable(gr, model, mode, print_local_convergence) -> bool:
    """True when the displacement-form COUPLED block can assemble through
    the point batch: single-residual 3D equilibrium, either small-strain
    elastic-plastic family at FULL_3D (7-dof local state), per-IP
    convergence printing off."""
    from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
    from cmad_tpu_torch.models.small_elastic_plastic import (
        SmallElasticPlastic,
    )
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        SmallRateElasticPlastic,
    )

    return (mode == GlobalResidualMode.COUPLED
            and not print_local_convergence
            and gr.num_residuals == 1
            and getattr(gr, "ndims", None) == 3
            and type(model) in (SmallRateElasticPlastic,
                                SmallElasticPlastic)
            and model._def_type == DefType.FULL_3D
            and model.num_dofs == 7)


def make_pointbatch_block_kernels(
        model, local_newton_settings: dict[str, Any] | None = None) -> dict:
    """The ``{"block_R_and_K_and_xi", "block_R"}`` evaluators consumed by
    ``fem/assembly.py`` for blocks passing :func:`pointbatch_applicable`,
    with the contract of ``fem/j2_block.py``: both take ``(params, U_elem,
    U_prev_elem, geom, f_ip, t, xi_prev)`` with ``U_elem`` (E, nd, 3),
    ``f_ip`` the body force at the IPs (E, Q, 3) or None, and ``xi_prev``
    the AoS state (E, Q, 7). ``"local_solve"`` is the
    :class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve`
    they run (its ``newton.log`` records iterations when set to a
    list)."""
    from cmad_tpu_torch.models.small_rate_elastic_plastic import (
        SmallRateElasticPlastic,
    )

    if local_newton_settings is None:
        local_newton_settings = default_local_newton_settings(model)
    solve = GlobalResidual._build_local_solve(model, local_newton_settings)
    rate = type(model) is SmallRateElasticPlastic

    def stress(x, xi_prev, params, g6):
        """One point's stress rows from its unknowns."""
        xi = solve.expand(x, xi_prev, params, g6)
        U, U_prev = strain_fields(g6)
        return vector_from_sym_tensor(
            model.cauchy_fun(xi, xi_prev, params, U, U_prev))

    in_dims = (0, 0, None, 0)
    stress_b = vmap(stress, in_dims=in_dims)
    stress_jac_b = vmap(jacfwd(stress, argnums=(0, 3)), in_dims=in_dims)

    def _common(U_e, Up_e, geom, xi_prev):
        gradN = geom["per_elem"]["grad_N_phys"][0]     # (E, Q, nd, 3)
        wdv = (geom["shared"]["quad_w"][None, :]
               * geom["per_elem"]["iso_jac_det"])      # (E, Q)
        E, Q = wdv.shape
        dU = (U_e - Up_e) if rate else U_e
        G = torch.einsum("eai,eqaj->eqij", dU, gradN)  # grad u (E,Q,3,3)
        g6 = vector_from_sym_tensor(0.5 * (G + G.transpose(-1, -2)))
        return gradN, wdv, g6.reshape(E * Q, 6), xi_prev.reshape(E * Q, 7)

    def _residual(s6, gradN, wdv, f_ip, geom):
        E, Q = wdv.shape
        sigma = sym_tensor_from_vector(s6.reshape(E, Q, 6))
        R = torch.einsum("eqaj,eqji,eq->eai", gradN, sigma, wdv)
        if f_ip is not None:
            N0 = geom["shared"]["N"][0]                 # (Q, nd)
            R = R - torch.einsum("qa,eqi,eq->eai", N0, f_ip, wdv)
        return R

    def block_r_and_k_and_xi(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        gradN, wdv, g6, xi_p = _common(U_e, Up_e, geom, xi_prev)
        E, Q = wdv.shape
        x, x_prev = solve.unknowns(xi_p, params, g6)
        ds_dx, ds_dg = stress_jac_b(x, xi_p, params, g6)
        D66 = ds_dg + ds_dx @ solve.tangent(x, x_prev, params, g6)
        s6 = stress_b(x, xi_p, params, g6)
        R = _residual(s6, gradN, wdv, f_ip, geom)

        T = torch.as_tensor(_strain_dof_tensor(), dtype=wdv.dtype,
                            device=wdv.device)
        B = torch.einsum("Akj,eqbj->eqAbk", T, gradN)  # (E,Q,6,nd,3)
        c = torch.as_tensor(_PAIR_WEIGHT, dtype=wdv.dtype, device=wdv.device)
        Dw = (c[:, None] * D66.reshape(E, Q, 6, 6)
              * wdv[..., None, None])
        K = torch.einsum("eqAai,eqAB,eqBbk->eaibk", B, Dw, B)
        xi = solve.state(x, xi_p, params, g6)
        return R, K, xi.reshape(E, Q, 7)

    def block_r(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        gradN, wdv, g6, xi_p = _common(U_e, Up_e, geom, xi_prev)
        x, _x_prev = solve.unknowns(xi_p, params, g6)
        return _residual(stress_b(x, xi_p, params, g6), gradN, wdv, f_ip,
                         geom)

    return {"block_R_and_K_and_xi": block_r_and_k_and_xi,
            "block_R": block_r, "local_solve": solve}
