"""Analytic J2+Voce radial returns (rate and total form), plain PyTorch.

Port of ``cmad_tpu/ops/j2_radial_return.py``: the classical radial
return (elastic predictor + scalar Newton corrector on the plastic
multiplier) specialised to J2 + Voce. This module is the plain version
of every return-map kernel: the CUDA kernels in
``csrc/j2_radial_return.cu`` are checked against :func:`soa_step_scalars`
and a loop of it, and the CPU path of every dispatching function runs
it. The arithmetic order follows the JAX package line for line.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.typing import Tensor

# the scalar corrector converges quadratically; 8 iterations reach the
# f32 floor from any trial state the FE drivers produce
_SCALAR_NEWTON_ITERS = 8


def _constants(params):
    ec = ElasticConstants.from_params(params["elastic"])
    plastic = params["plastic"]
    voce = plastic["flow stress"]["hardening"]["voce"]
    return (ec.mu, ec.lmbda,
            plastic["flow stress"]["initial yield"]["Y"],
            voce["S"], voce["D"])


def _scalar_corrector(phi_tr, alpha_prev, mu, Y, S, D, newton_iters):
    """Masked, unrolled Newton on the plastic multiplier dg solving
    phi_tr - 3 mu dg = Y + H(alpha_prev + dg)."""
    f_trial = phi_tr - Y - S * (1.0 - torch.exp(-D * alpha_prev))
    mask = f_trial > 0.0
    dg = torch.zeros_like(alpha_prev)
    for _ in range(newton_iters):
        e = torch.exp(-D * (alpha_prev + dg))
        g = phi_tr - 3.0 * mu * dg - Y - S * (1.0 - e)
        dgd = -3.0 * mu - S * D * e
        dg = torch.where(mask, torch.clamp(dg - g / dgd, min=0.0),
                         torch.zeros_like(dg))
    return dg, mask


def _sym_from_six(c00, c01, c02, c11, c12, c22):
    return torch.stack([c00, c01, c02, c01, c11, c12, c02, c12, c22],
                       dim=-1).reshape(*c00.shape, 3, 3)


def _pack(c00, c01, c02, c11, c12, c22, alpha):
    """(xi, sigma) from the six unique components + alpha."""
    xi = torch.stack([c00, c01, c02, c11, c12, c22, alpha], dim=-1)
    return xi, _sym_from_six(c00, c01, c02, c11, c12, c22)


def _trial_and_return(sxx, sxy, sxz, syy, syz, szz, alpha_prev,
                      mu, Y, S, D, newton_iters):
    p = (sxx + syy + szz) / 3.0
    dxx, dyy, dzz = sxx - p, syy - p, szz - p
    phi_tr = torch.sqrt(1.5 * (dxx * dxx + dyy * dyy + dzz * dzz
                               + 2.0 * (sxy * sxy + sxz * sxz
                                        + syz * syz)))
    dg, mask = _scalar_corrector(phi_tr, alpha_prev, mu, Y, S, D,
                                 newton_iters)
    safe_phi = torch.where(phi_tr > 0.0, phi_tr, torch.ones_like(phi_tr))
    return (dxx, dyy, dzz), dg, mask, safe_phi


def make_j2_radial_return(parameters, newton_iters: int =
                          _SCALAR_NEWTON_ITERS):
    """Build ``step(xi_prev, grad_u, grad_u_prev, params) -> (xi, sigma)``
    batched over the leading axis, with the J2+Voce flat state layout
    xi = [cauchy6 (internal order), alpha] (AoS, (N, 7)).

    ``params`` must carry ``elastic`` (any two constants) and ``plastic``
    with a Voce hardening block. Plain version of the TPU kernel
    ``_kernel`` (K4) of ``cmad_tpu/ops/pallas_radial_return.py``.
    """
    del parameters  # layout is fixed by the J2+Voce model

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor,
             params) -> tuple[Tensor, Tensor]:
        mu, lam, Y, S, D = _constants(params)
        g, g0 = grad_u, grad_u_prev

        # strain increment components (sym part of grad_u - grad_u_prev)
        exx = g[..., 0, 0] - g0[..., 0, 0]
        eyy = g[..., 1, 1] - g0[..., 1, 1]
        ezz = g[..., 2, 2] - g0[..., 2, 2]
        exy = 0.5 * (g[..., 0, 1] + g[..., 1, 0]
                     - g0[..., 0, 1] - g0[..., 1, 0])
        exz = 0.5 * (g[..., 0, 2] + g[..., 2, 0]
                     - g0[..., 0, 2] - g0[..., 2, 0])
        eyz = 0.5 * (g[..., 1, 2] + g[..., 2, 1]
                     - g0[..., 1, 2] - g0[..., 2, 1])
        tr = exx + eyy + ezz

        # trial stress: previous stress + isotropic elastic increment
        # (xi internal sym-vec order is [xx, xy, xz, yy, yz, zz])
        sxx = xi_prev[..., 0] + lam * tr + 2.0 * mu * exx
        sxy = xi_prev[..., 1] + 2.0 * mu * exy
        sxz = xi_prev[..., 2] + 2.0 * mu * exz
        syy = xi_prev[..., 3] + lam * tr + 2.0 * mu * eyy
        syz = xi_prev[..., 4] + 2.0 * mu * eyz
        szz = xi_prev[..., 5] + lam * tr + 2.0 * mu * ezz
        alpha_prev = xi_prev[..., 6]

        (dxx, dyy, dzz), dg, mask, safe_phi = _trial_and_return(
            sxx, sxy, sxz, syy, syz, szz, alpha_prev, mu, Y, S, D,
            newton_iters)
        sc = torch.where(mask, 3.0 * mu * dg / safe_phi,
                         torch.zeros_like(dg))
        return _pack(sxx - sc * dxx, sxy * (1.0 - sc), sxz * (1.0 - sc),
                     syy - sc * dyy, syz * (1.0 - sc), szz - sc * dzz,
                     alpha_prev + dg)

    return step


# ---------------------------------------------------------------------------
# Component-major (SoA) contract, shared with the CUDA kernels
# (ops/cuda_radial_return.py):
#
#   xi_soa: (8, N) rows [sxx, sxy, sxz, syy, syz, szz, alpha, pad]
#   de_soa: (8, N) rows [exx, exy, exz, eyy, eyz, ezz, pad, pad]
#             (sym strain increment, internal sym-vec order)
#   step(xi_soa, de_soa, scalars) -> xi_soa'   (stress IS the rate-form
#             state; row 7 of the output is zero)
#
# Point j of row r sits at flat offset r*N + j, so neighbouring points
# are neighbouring addresses: one thread per point reads coalesced rows.
# ---------------------------------------------------------------------------

SOA_ROWS = 8


def pack_state_soa(xi: Tensor) -> Tensor:
    """(N, 7) AoS rate-form state -> (8, N) component-major rows."""
    pad = torch.zeros((1, xi.shape[0]), dtype=xi.dtype, device=xi.device)
    return torch.cat([xi.T, pad])


def unpack_state_soa(xi_soa: Tensor) -> Tensor:
    """(8, N) component-major rows -> (N, 7) AoS rate-form state."""
    return xi_soa[:7].T


def strain_increment_soa(grad_u: Tensor, grad_u_prev: Tensor) -> Tensor:
    """(N, 3, 3) current/previous displacement gradients -> (8, N)
    component-major sym strain-increment rows."""
    g, g0 = grad_u, grad_u_prev
    rows = [
        g[..., 0, 0] - g0[..., 0, 0],
        0.5 * (g[..., 0, 1] + g[..., 1, 0] - g0[..., 0, 1] - g0[..., 1, 0]),
        0.5 * (g[..., 0, 2] + g[..., 2, 0] - g0[..., 0, 2] - g0[..., 2, 0]),
        g[..., 1, 1] - g0[..., 1, 1],
        0.5 * (g[..., 1, 2] + g[..., 2, 1] - g0[..., 1, 2] - g0[..., 2, 1]),
        g[..., 2, 2] - g0[..., 2, 2],
    ]
    z = torch.zeros_like(rows[0])
    return torch.stack(rows + [z, z])


def stress_from_state_soa(xi_soa: Tensor) -> Tensor:
    """(8, N) component-major state -> (N, 3, 3) Cauchy stress."""
    s = xi_soa
    return _sym_from_six(s[0], s[1], s[2], s[3], s[4], s[5])


def j2_voce_scalars(params, dtype: torch.dtype) -> Tensor:
    """The five J2+Voce material scalars ``[mu, lambda, Y, S, D]`` as one
    differentiable (5,) tensor on the device of ``params`` — the form
    both CUDA kernels read through a device pointer."""
    consts = [c if isinstance(c, Tensor)
              else torch.tensor(c, dtype=torch.float64)
              for c in _constants(params)]
    return torch.stack(consts).to(dtype)


def soa_step_scalars(xi_soa: Tensor, de_soa: Tensor, scalars: Tensor,
                     newton_iters: int = _SCALAR_NEWTON_ITERS) -> Tensor:
    """Component-major radial return with the material constants
    pre-stacked by :func:`j2_voce_scalars` (rows contract above). The
    plain version of the CUDA kernel ``j2_soa_step``."""
    mu, lam, Y, S, D = (scalars[0], scalars[1], scalars[2], scalars[3],
                        scalars[4])
    exx, exy, exz = de_soa[0], de_soa[1], de_soa[2]
    eyy, eyz, ezz = de_soa[3], de_soa[4], de_soa[5]
    tr = exx + eyy + ezz
    diag = lam * tr
    sxx = xi_soa[0] + diag + 2.0 * mu * exx
    sxy = xi_soa[1] + 2.0 * mu * exy
    sxz = xi_soa[2] + 2.0 * mu * exz
    syy = xi_soa[3] + diag + 2.0 * mu * eyy
    syz = xi_soa[4] + 2.0 * mu * eyz
    szz = xi_soa[5] + diag + 2.0 * mu * ezz
    alpha_prev = xi_soa[6]

    (dxx, dyy, dzz), dg, mask, safe_phi = _trial_and_return(
        sxx, sxy, sxz, syy, syz, szz, alpha_prev, mu, Y, S, D,
        newton_iters)
    sc = torch.where(mask, 3.0 * mu * dg / safe_phi, torch.zeros_like(dg))
    return torch.stack([sxx - sc * dxx, sxy * (1.0 - sc),
                        sxz * (1.0 - sc), syy - sc * dyy,
                        syz * (1.0 - sc), szz - sc * dzz,
                        alpha_prev + dg, torch.zeros_like(dg)])


def make_j2_radial_return_soa(parameters, newton_iters: int =
                              _SCALAR_NEWTON_ITERS):
    """Plain component-major radial return (rate form):
    ``step(xi_soa, de_soa, params) -> xi_soa'`` on any device."""
    del parameters  # layout is fixed by the J2+Voce model

    def step(xi_soa: Tensor, de_soa: Tensor, params) -> Tensor:
        scalars = j2_voce_scalars(params, xi_soa.dtype)
        return soa_step_scalars(xi_soa, de_soa, scalars,
                                newton_iters=newton_iters)

    return step


def make_j2_radial_return_total(parameters, newton_iters: int =
                                _SCALAR_NEWTON_ITERS):
    """Radial return for the TOTAL-form small-strain J2+Voce model:
    xi = [plastic_strain6, alpha].

    Same scalar corrector as :func:`make_j2_radial_return`; the state
    update is the plastic strain, ``dp = dg * (3/2) s_tr / phi_tr``.
    The total form is history-parametrized by the CURRENT strain only,
    so ``grad_u_prev`` is accepted for interface parity but unused.
    Returns ``(xi, sigma)`` like the rate form. Plain version of the TPU
    kernel ``_kernel_total`` (K5).
    """
    del parameters

    def step(xi_prev: Tensor, grad_u: Tensor, grad_u_prev: Tensor,
             params) -> tuple[Tensor, Tensor]:
        del grad_u_prev
        mu, lam, Y, S, D = _constants(params)
        g = grad_u

        # trial elastic strain components eps - pstrain_prev
        exx = g[..., 0, 0] - xi_prev[..., 0]
        exy = 0.5 * (g[..., 0, 1] + g[..., 1, 0]) - xi_prev[..., 1]
        exz = 0.5 * (g[..., 0, 2] + g[..., 2, 0]) - xi_prev[..., 2]
        eyy = g[..., 1, 1] - xi_prev[..., 3]
        eyz = 0.5 * (g[..., 1, 2] + g[..., 2, 1]) - xi_prev[..., 4]
        ezz = g[..., 2, 2] - xi_prev[..., 5]
        alpha_prev = xi_prev[..., 6]
        tr = exx + eyy + ezz

        sxx = lam * tr + 2.0 * mu * exx
        sxy = 2.0 * mu * exy
        sxz = 2.0 * mu * exz
        syy = lam * tr + 2.0 * mu * eyy
        syz = 2.0 * mu * eyz
        szz = lam * tr + 2.0 * mu * ezz

        (dxx, dyy, dzz), dg, mask, safe_phi = _trial_and_return(
            sxx, sxy, sxz, syy, syz, szz, alpha_prev, mu, Y, S, D,
            newton_iters)
        coef = torch.where(mask, 1.5 * dg / safe_phi, torch.zeros_like(dg))
        # dp = coef * s_tr; pstrain += dp; sigma = sigma_tr - 2 mu dp
        pxx = xi_prev[..., 0] + coef * dxx
        pxy = xi_prev[..., 1] + coef * sxy
        pxz = xi_prev[..., 2] + coef * sxz
        pyy = xi_prev[..., 3] + coef * dyy
        pyz = xi_prev[..., 4] + coef * syz
        pzz = xi_prev[..., 5] + coef * dzz
        two_mu_c = 2.0 * mu * coef
        xi = torch.stack([pxx, pxy, pxz, pyy, pyz, pzz,
                          alpha_prev + dg], dim=-1)
        sigma = _sym_from_six(sxx - two_mu_c * dxx, sxy * (1.0 - two_mu_c),
                              sxz * (1.0 - two_mu_c), syy - two_mu_c * dyy,
                              syz * (1.0 - two_mu_c), szz - two_mu_c * dzz)
        return xi, sigma

    return step
