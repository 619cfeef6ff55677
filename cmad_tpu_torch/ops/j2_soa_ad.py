"""Differentiable SoA J2+Voce radial return + analytic consistent tangent.

Port of ``cmad_tpu/ops/j2_soa_ad.py``. The FE COUPLED J2 path evaluates
the per-IP return map through the CUDA kernel ``j2_soa_step``, which
autograd cannot trace, so :class:`SoaStep` wraps the step in a
``torch.autograd.Function`` whose derivative is the closed-form implicit
linearization of the radial return, from the scalar consistency equation

    g(dg) = phi_tr - 3 mu dg - Y - S (1 - exp(-D (alpha_prev + dg))) = 0.

Differentiating g = 0 gives ``dg_dot = rhs / (3 mu + S D e)`` with
``e = exp(-D (alpha_prev + dg))``; every other output is explicit
algebra in the tangents. :meth:`SoaStep.jvp` is that linear map (forward
mode) and :meth:`SoaStep.backward` its transpose (reverse mode), both
written in differentiable torch ops of the saved primals, so double
backward (Hessian-vector products) flows through them.

The material scalars ``[mu, lam, Y, S, D]`` are an explicit (5,) input,
never a closure, so autograd sees their use.

Also here: :func:`consistent_tangent_rows`, the classical consistent
(algorithmic) tangent operator coefficients

    D_alg = kappa I (x) I + A (I_sym - I (x) I / 3) - c d (x) d,
    A = 2 mu (1 - beta),  beta = 3 mu dg / phi_tr,
    c = (9 mu^2 / phi_tr^2) (1 / (3 mu + H') - dg / phi_tr),

reconstructed exactly from the kernel OUTPUT (Simo & Hughes,
Computational Inelasticity, box 3.2).
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.ops.cuda_radial_return import (
    on_cuda,
    soa_step_scalars_cuda,
)
from cmad_tpu_torch.ops.j2_radial_return import soa_step_scalars
from cmad_tpu_torch.typing import Tensor


def _trial_rows(xi_soa, de_soa, mu, lam):
    """Trial stress rows + deviator rows + phi_tr from primal inputs
    (the elastic predictor — cheap explicit algebra)."""
    tr = de_soa[0] + de_soa[3] + de_soa[5]
    diag = lam * tr
    s0 = xi_soa[0] + diag + 2.0 * mu * de_soa[0]
    s1 = xi_soa[1] + 2.0 * mu * de_soa[1]
    s2 = xi_soa[2] + 2.0 * mu * de_soa[2]
    s3 = xi_soa[3] + diag + 2.0 * mu * de_soa[3]
    s4 = xi_soa[4] + 2.0 * mu * de_soa[4]
    s5 = xi_soa[5] + diag + 2.0 * mu * de_soa[5]
    p = (s0 + s3 + s5) / 3.0
    d0, d3, d5 = s0 - p, s3 - p, s5 - p
    phi_tr = torch.sqrt(1.5 * (d0 * d0 + d3 * d3 + d5 * d5
                               + 2.0 * (s1 * s1 + s2 * s2 + s4 * s4)))
    return (s0, s1, s2, s3, s4, s5), (d0, d3, d5), phi_tr


def _linearization_point(xi, de, scalars, out):
    """Primal intermediates of the tangent map: trial state by explicit
    algebra, the converged dg recovered from the kernel output (no
    Newton re-run), the yield mask by the forward's own criterion."""
    mu, lam, Y, S, D = scalars.unbind()
    s, d, phi_tr = _trial_rows(xi, de, mu, lam)
    alpha_prev = xi[6]
    dg = out[6] - alpha_prev
    e = torch.exp(-D * (alpha_prev + dg))
    f_trial = phi_tr - Y - S * (1.0 - torch.exp(-D * alpha_prev))
    mask = f_trial > 0.0
    safe_phi = torch.where(phi_tr > 0.0, phi_tr, torch.ones_like(phi_tr))
    sc = torch.where(mask, 3.0 * mu * dg / safe_phi, torch.zeros_like(dg))
    return s, d, alpha_prev, dg, e, mask, safe_phi, sc


class SoaStep(torch.autograd.Function):
    """``SoaStep.apply(xi_soa, de_soa, scalars) -> xi_soa'`` (contract of
    ``j2_radial_return.soa_step_scalars``). The forward is the CUDA
    kernel ``j2_soa_step`` for CUDA tensors and the plain step for CPU
    tensors."""

    @staticmethod
    def forward(xi_soa: Tensor, de_soa: Tensor, scalars: Tensor) -> Tensor:
        if on_cuda(xi_soa):
            return soa_step_scalars_cuda(xi_soa.contiguous(),
                                         de_soa.contiguous(),
                                         scalars.contiguous())
        return soa_step_scalars(xi_soa, de_soa, scalars)

    @staticmethod
    def setup_context(ctx, inputs, output):
        xi, de, scalars = inputs
        ctx.save_for_backward(xi, de, scalars, output)
        ctx.save_for_forward(xi, de, scalars, output)

    @staticmethod
    def jvp(ctx, xi_t, de_t, sc_t):
        xi, de, scalars, out = ctx.saved_tensors
        xi_t = torch.zeros_like(xi) if xi_t is None else xi_t
        de_t = torch.zeros_like(de) if de_t is None else de_t
        sc_t = torch.zeros_like(scalars) if sc_t is None else sc_t
        mu, lam, Y, S, D = scalars.unbind()
        mu_t, lam_t, Y_t, S_t, D_t = sc_t.unbind()
        (s0, s1, s2, s3, s4, s5), (d0, d3, d5), alpha_prev, dg, e, mask, \
            safe_phi, sc = _linearization_point(xi, de, scalars, out)
        zeros = torch.zeros_like(dg)

        # tangent side — LINEAR in (xi_t, de_t, sc_t) throughout
        tr = de[0] + de[3] + de[5]
        tr_t = de_t[0] + de_t[3] + de_t[5]
        diag_t = lam_t * tr + lam * tr_t
        s0_t = xi_t[0] + diag_t + 2.0 * (mu_t * de[0] + mu * de_t[0])
        s1_t = xi_t[1] + 2.0 * (mu_t * de[1] + mu * de_t[1])
        s2_t = xi_t[2] + 2.0 * (mu_t * de[2] + mu * de_t[2])
        s3_t = xi_t[3] + diag_t + 2.0 * (mu_t * de[3] + mu * de_t[3])
        s4_t = xi_t[4] + 2.0 * (mu_t * de[4] + mu * de_t[4])
        s5_t = xi_t[5] + diag_t + 2.0 * (mu_t * de[5] + mu * de_t[5])
        p_t = (s0_t + s3_t + s5_t) / 3.0
        d0_t, d3_t, d5_t = s0_t - p_t, s3_t - p_t, s5_t - p_t

        phi_t = (1.5 / safe_phi) * (d0 * d0_t + d3 * d3_t + d5 * d5_t
                                    + 2.0 * (s1 * s1_t + s2 * s2_t
                                             + s4 * s4_t))
        alpha_t = xi_t[6]

        # implicit differentiation of g(dg) = 0 (plastic branch)
        denom = 3.0 * mu + S * D * e
        dg_t = torch.where(
            mask,
            (phi_t - 3.0 * mu_t * dg - Y_t - S_t * (1.0 - e)
             - S * e * D_t * (alpha_prev + dg)
             - S * e * D * alpha_t) / denom,
            zeros)
        sc_dot = torch.where(
            mask,
            3.0 * (mu_t * dg + mu * dg_t) / safe_phi
            - sc * phi_t / safe_phi,
            zeros)

        one_m_sc = 1.0 - sc
        return torch.stack([
            s0_t - sc_dot * d0 - sc * d0_t,
            s1_t * one_m_sc - s1 * sc_dot,
            s2_t * one_m_sc - s2 * sc_dot,
            s3_t - sc_dot * d3 - sc * d3_t,
            s4_t * one_m_sc - s4 * sc_dot,
            s5_t - sc_dot * d5 - sc * d5_t,
            alpha_t + dg_t,
            zeros,
        ])

    @staticmethod
    def backward(ctx, g):
        """The transpose of :meth:`jvp`, term by term."""
        xi, de, scalars, out = ctx.saved_tensors
        mu, lam, Y, S, D = scalars.unbind()
        (s0, s1, s2, s3, s4, s5), (d0, d3, d5), alpha_prev, dg, e, mask, \
            safe_phi, sc = _linearization_point(xi, de, scalars, out)
        zeros = torch.zeros_like(dg)
        g0, g1, g2, g3, g4, g5, g6 = (g[r] for r in range(7))
        one_m_sc = 1.0 - sc

        # out_t -> (sc_dot, dg_t); sc_dot -> (mu_t, dg_t, phi_t)
        sc_bar = torch.where(
            mask, -(g0 * d0 + g1 * s1 + g2 * s2 + g3 * d3 + g4 * s4
                    + g5 * d5), zeros)
        dg_t_bar = g6 + 3.0 * mu * sc_bar / safe_phi
        # dg_t -> (phi_t, mu_t, Y_t, S_t, D_t, alpha_t)
        denom = 3.0 * mu + S * D * e
        q = torch.where(mask, dg_t_bar / denom, zeros)
        phi_bar = q - sc * sc_bar / safe_phi
        # phi_t -> trial deviator and shear rows
        k = 1.5 * phi_bar / safe_phi
        d0_bar = k * d0 - sc * g0
        d3_bar = k * d3 - sc * g3
        d5_bar = k * d5 - sc * g5
        p_bar = -(d0_bar + d3_bar + d5_bar) / 3.0
        s0_bar = g0 + d0_bar + p_bar
        s3_bar = g3 + d3_bar + p_bar
        s5_bar = g5 + d5_bar + p_bar
        s1_bar = g1 * one_m_sc + 2.0 * k * s1
        s2_bar = g2 * one_m_sc + 2.0 * k * s2
        s4_bar = g4 * one_m_sc + 2.0 * k * s4
        # elastic predictor -> (xi_t, de_t, mu_t, lam_t)
        diag_bar = s0_bar + s3_bar + s5_bar
        two_mu = 2.0 * mu
        xi_bar = torch.stack([s0_bar, s1_bar, s2_bar, s3_bar, s4_bar,
                              s5_bar, g6 - S * e * D * q, zeros])
        de_bar = torch.stack([
            two_mu * s0_bar + lam * diag_bar, two_mu * s1_bar,
            two_mu * s2_bar, two_mu * s3_bar + lam * diag_bar,
            two_mu * s4_bar, two_mu * s5_bar + lam * diag_bar,
            zeros, zeros])

        tr = de[0] + de[3] + de[5]
        mu_bar = (3.0 * dg * sc_bar / safe_phi - 3.0 * dg * q
                  + 2.0 * (s0_bar * de[0] + s1_bar * de[1]
                           + s2_bar * de[2] + s3_bar * de[3]
                           + s4_bar * de[4] + s5_bar * de[5]))
        sc_grad = torch.stack([
            mu_bar.sum(),
            (tr * diag_bar).sum(),
            -q.sum(),
            -((1.0 - e) * q).sum(),
            -(S * e * (alpha_prev + dg) * q).sum(),
        ])
        return xi_bar, de_bar, sc_grad


def make_soa_step_ad():
    """``step(xi_soa, de_soa, scalars) -> xi_soa'`` with the closed-form
    derivative rules of :class:`SoaStep`; runs ``j2_soa_step`` on CUDA
    tensors and the plain step on CPU tensors."""
    return SoaStep.apply


def consistent_tangent_rows(out: Tensor, alpha_prev: Tensor,
                            scalars: Tensor):
    """Coefficients of the consistent tangent ``D_alg`` at the converged
    state, from the kernel OUTPUT rows alone.

    ``out``: (8, ...) updated state rows; ``alpha_prev``: (...,) previous
    accumulated plastic strain; ``scalars``: ``[mu, lam, Y, S, D]``.

    Returns ``(A, c, d_rows)`` with ``A = 2 mu (1 - beta)`` (elastic
    points: ``A = 2 mu``), the rank-one coefficient ``c`` (elastic: 0),
    and the TRIAL deviator rows ``d_rows = (d0, d1, d2, d3, d4, d5)``
    (internal sym-vec order), so that

        D_alg = kappa I(x)I + A (I_sym - I(x)I/3) - c d(x)d.
    """
    mu, _lam, _Y, S, D = scalars.unbind()
    s0, s1, s2, s3, s4, s5 = out[0], out[1], out[2], out[3], out[4], out[5]
    alpha_new = out[6]
    dg = alpha_new - alpha_prev
    mask = dg > 0.0
    zeros = torch.zeros_like(dg)

    p = (s0 + s3 + s5) / 3.0
    q0, q3, q5 = s0 - p, s3 - p, s5 - p
    phi_out = torch.sqrt(1.5 * (q0 * q0 + q3 * q3 + q5 * q5
                                + 2.0 * (s1 * s1 + s2 * s2 + s4 * s4)))
    # radial-return identities (exact algebra, not convergence-dependent):
    # phi_tr = phi_out + 3 mu dg;  dev_tr = dev_out / (1 - beta)
    phi_tr = phi_out + 3.0 * mu * dg
    safe_phi = torch.where(phi_tr > 0.0, phi_tr, torch.ones_like(phi_tr))
    beta = torch.where(mask, 3.0 * mu * dg / safe_phi, zeros)
    # beta < 1 strictly: phi_out = Y + H(alpha_new) > 0 on plastic points
    inv_1mb = 1.0 / (1.0 - beta)
    d_rows = (q0 * inv_1mb, s1 * inv_1mb, s2 * inv_1mb,
              q3 * inv_1mb, s4 * inv_1mb, q5 * inv_1mb)

    Hp = S * D * torch.exp(-D * alpha_new)
    c = torch.where(
        mask,
        (9.0 * mu * mu / (safe_phi * safe_phi))
        * (1.0 / (3.0 * mu + Hp) - dg / safe_phi),
        zeros)
    A = 2.0 * mu * (1.0 - beta)
    return A, c, d_rows
