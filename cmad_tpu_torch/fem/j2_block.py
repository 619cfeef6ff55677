"""Block-level COUPLED J2 path: SoA radial return + analytic tangent.

Port of ``cmad_tpu/fem/j2_block.py``. For the J2+Voce displacement
problem, the FE evaluation of a whole element block runs in four dense
batched stages:

1. strain rows for every (element, IP) in one component-major einsum
   (``de[i,j][e,q] = sym(dU[e,a,i] grad_N[e,q,a,j])``);
2. ONE radial-return step over the flattened (E*Q) point batch through
   :class:`~cmad_tpu_torch.ops.j2_soa_ad.SoaStep`: the CUDA kernel
   ``j2_soa_step`` on CUDA tensors (the TPU's ``_kernel_soa``, K1), its
   plain version on CPU tensors; no other path;
3. the residual ``R[e,a,i] = grad_N[e,q,a,j] sigma[j,i] w dv`` from the
   component-major stress rows, less the body force
   ``N[q,a] f[e,q,i] w dv`` when there is one;
4. the element stiffness from the consistent tangent
   ``D_alg = kappa I(x)I + A (I_sym - I(x)I/3) - c d(x)d`` contracted
   against the shape gradients (``consistent_tangent_rows``).

Under ``torch.no_grad()`` (the FE Newton's primal) ``SoaStep.apply``
runs its forward alone, so a CUDA block launches ``j2_soa_step`` once per
evaluation and records nothing for autograd. Outside it, the step
carries its closed-form derivative rules.

The JAX package's ``CMAD_FE_BLOCK_FASTPATH`` switch is not ported: every
block that :func:`j2_block_applicable` accepts runs here, and no other
block evaluator exists in the port yet.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.ops.j2_radial_return import j2_voce_scalars
from cmad_tpu_torch.ops.j2_soa_ad import (
    consistent_tangent_rows,
    make_soa_step_ad,
)
from cmad_tpu_torch.typing import Tensor


def j2_block_applicable(gr, model, mode, print_local_convergence) -> bool:
    """True when the displacement-form COUPLED block can run the SoA
    path: single-residual 3D equilibrium, J2+Voce in either the rate or
    the total form (identity rotation), per-IP convergence printing
    off."""
    from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
    from cmad_tpu_torch.ops.return_map import j2_voce_kind

    return (mode == GlobalResidualMode.COUPLED
            and not print_local_convergence
            and gr.num_residuals == 1
            and getattr(gr, "ndims", None) == 3
            and j2_voce_kind(model) in ("rate", "total")
            and model.num_dofs == 7)


def _sigma_cm(rows):
    """(3, 3, ...) symmetric tensor view from internal sym-vec rows
    [xx, xy, xz, yy, yz, zz]."""
    r0, r1, r2, r3, r4, r5 = rows
    return torch.stack([
        torch.stack([r0, r1, r2]),
        torch.stack([r1, r3, r4]),
        torch.stack([r2, r4, r5]),
    ])


def soa_step_inputs(kind: str, params, U_e: Tensor, Up_e: Tensor,
                    gradN: Tensor, xi_prev: Tensor):
    """The block's return-map step inputs ``(xi_soa, de_soa, scalars)``:
    (8, E*Q) state rows, (8, E*Q) strain rows and ``[mu, lam, Y, S, D]``,
    from the displacements ``U_e``/``Up_e`` (E, nd, 3), the shape
    gradients ``gradN`` (E, Q, nd, 3) and the state ``xi_prev``, AoS
    (E, Q, 7) or carrier (8, E*Q). ``kind`` is ``"rate"`` or
    ``"total"`` (``ops/return_map.j2_voce_kind``)."""
    E, Q = gradN.shape[0], gradN.shape[1]
    n = E * Q
    carrier = xi_prev.dim() == 2

    # component-major strain rows: (3, 3, E, Q). Rate form: the strain
    # INCREMENT from dU; total form: the TOTAL strain from U.
    dU = (U_e - Up_e) if kind == "rate" else U_e
    G = torch.einsum("eai,eqaj->ijeq", dU, gradN)
    rows = [G[0, 0], 0.5 * (G[0, 1] + G[1, 0]),
            0.5 * (G[0, 2] + G[2, 0]), G[1, 1],
            0.5 * (G[1, 2] + G[2, 1]), G[2, 2]]
    z = torch.zeros_like(rows[0])
    de_soa = torch.stack(rows + [z, z]).reshape(8, n)
    scalars = j2_voce_scalars(params, de_soa.dtype)

    if kind == "rate":
        # stress IS the state: rows go in as-is
        xi_soa = xi_prev if carrier else torch.cat(
            [xi_prev.reshape(n, 7).T, xi_prev.new_zeros((1, n))])
    else:
        # virtual previous stress -C : p_prev, so the step's trial
        # xi + C : de equals C : (eps - p_prev)
        mu, lam = scalars[0], scalars[1]
        p = xi_prev if carrier else xi_prev.reshape(n, 7).T
        ltrp = lam * (p[0] + p[3] + p[5])
        two_mu = 2.0 * mu
        xi_soa = torch.stack([
            -(ltrp + two_mu * p[0]), -two_mu * p[1],
            -two_mu * p[2], -(ltrp + two_mu * p[3]),
            -two_mu * p[4], -(ltrp + two_mu * p[5]),
            p[6], torch.zeros_like(p[0])])
    return xi_soa, de_soa, scalars


def make_j2_block_kernels(model) -> dict:
    """The ``{"block_R_and_K_and_xi", "block_R"}`` evaluators consumed by
    ``fem/assembly.py`` for blocks passing :func:`j2_block_applicable`.

    Both take ``(params, U_elem, U_prev_elem, geom, f_ip, t, xi_prev)``
    with ``U_elem`` (E, nd, 3) displacement coefficients, ``geom`` the
    block's geometry-cache entry, ``f_ip`` the body force at the block's
    IPs (E, Q, 3) or None (``fem/assembly.external_loads``, evaluated
    once per time), and ``xi_prev`` the state, either AoS
    (E, Q, 7) or the component-major carrier (8, E*Q)
    (``fem/xi_carrier.py``); each returns the state in the layout it was
    given.

    The TOTAL form (``models/small_elastic_plastic.py``,
    xi = [plastic_strain6, alpha]) maps EXACTLY onto the rate-form SoA
    step: feeding virtual previous-stress rows ``-C : p_prev`` with the
    CURRENT total strain as the "increment" reproduces the total form's
    trial stress ``C : (eps - p_prev)``, and the corrector, stress output
    and consistent tangent are then identical algebra. The plastic strain
    carry is recovered explicitly afterwards as
    ``p_new = eps - C^{-1} : sigma_new``.
    """
    from cmad_tpu_torch.ops.return_map import j2_voce_kind

    kind = j2_voce_kind(model)
    step = make_soa_step_ad()

    def _solve(params, U_e, Up_e, geom, xi_prev):
        gradN = geom["per_elem"]["grad_N_phys"][0]     # (E, Q, nd, 3)
        wdv = (geom["shared"]["quad_w"][None, :]
               * geom["per_elem"]["iso_jac_det"])      # (E, Q)
        E, Q = wdv.shape
        carrier = xi_prev.dim() == 2
        xi_soa, de_soa, scalars = soa_step_inputs(kind, params, U_e, Up_e,
                                                  gradN, xi_prev)
        out = step(xi_soa, de_soa, scalars).reshape(8, E, Q)
        return out, scalars, gradN, wdv, de_soa.reshape(8, E, Q), carrier

    def _residual(out, gradN, wdv, f_ip, geom):
        sigma = _sigma_cm(tuple(out[r] for r in range(6)))  # (3,3,E,Q)
        R = torch.einsum("eqaj,jieq,eq->eai", gradN, sigma, wdv)
        if f_ip is not None:
            N0 = geom["shared"]["N"][0]                     # (Q, nd)
            R = R - torch.einsum("qa,eqi,eq->eai", N0, f_ip, wdv)
        return R

    def _xi_out(out, eps_rows, scalars, carrier) -> Tensor:
        """Updated state in the INPUT's layout: carrier (8, E*Q) rows
        (row 7 zero) or AoS (E, Q, 7)."""
        E, Q = out.shape[1], out.shape[2]
        if kind == "rate":
            if carrier:
                return out.reshape(8, E * Q)   # free: the kernel layout
            return torch.movedim(out[:7], 0, -1)            # (E, Q, 7)
        # total form: p_new = eps - C^{-1} : sigma_new (elastic
        # compliance on sym-vec rows), alpha_new from the step
        mu, lam = scalars[0], scalars[1]
        inv_two_mu = 1.0 / (2.0 * mu)
        tr_sig = out[0] + out[3] + out[5]
        lam_tr_e = lam * tr_sig / (3.0 * lam + 2.0 * mu)
        p_rows = [
            eps_rows[0] - (out[0] - lam_tr_e) * inv_two_mu,
            eps_rows[1] - out[1] * inv_two_mu,
            eps_rows[2] - out[2] * inv_two_mu,
            eps_rows[3] - (out[3] - lam_tr_e) * inv_two_mu,
            eps_rows[4] - out[4] * inv_two_mu,
            eps_rows[5] - (out[5] - lam_tr_e) * inv_two_mu,
            out[6],
        ]
        if carrier:
            return torch.stack(
                p_rows + [torch.zeros_like(p_rows[0])]).reshape(8, E * Q)
        return torch.movedim(torch.stack(p_rows), 0, -1)    # (E, Q, 7)

    def block_r_and_k_and_xi(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        out, scalars, gradN, wdv, eps_rows, carrier = _solve(
            params, U_e, Up_e, geom, xi_prev)
        E, Q = wdv.shape
        alpha_prev = (xi_prev[6].reshape(E, Q) if carrier
                      else xi_prev[..., 6])
        R = _residual(out, gradN, wdv, f_ip, geom)

        A, c, d_rows = consistent_tangent_rows(out, alpha_prev, scalars)
        mu, lam = scalars[0], scalars[1]
        kappa = lam + 2.0 * mu / 3.0
        C1 = (kappa - A / 3.0) * wdv
        C2 = 0.5 * A * wdv
        C3 = c * wdv
        d_cm = _sigma_cm(d_rows)                            # (3,3,E,Q)
        v = torch.einsum("eqaj,jieq->eqai", gradN, d_cm)
        eye = torch.eye(3, dtype=wdv.dtype, device=wdv.device)
        K = (torch.einsum("eq,eqai,eqbk->eaibk", C1, gradN, gradN)
             + torch.einsum("eq,eqak,eqbi->eaibk", C2, gradN, gradN)
             + torch.einsum("eab,ik->eaibk",
                            torch.einsum("eq,eqaj,eqbj->eab", C2, gradN,
                                         gradN), eye)
             - torch.einsum("eq,eqai,eqbk->eaibk", C3, v, v))
        return R, K, _xi_out(out, eps_rows, scalars, carrier)

    def block_r(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        out, _scalars, gradN, wdv, _eps, _carrier = _solve(
            params, U_e, Up_e, geom, xi_prev)
        return _residual(out, gradN, wdv, f_ip, geom)

    # "xi_carrier": the drivers keep this block's state component-major
    # (8, E*Q) across the whole drive (fem/xi_carrier.py)
    return {"block_R_and_K_and_xi": block_r_and_k_and_xi,
            "block_R": block_r,
            "xi_carrier": True}
