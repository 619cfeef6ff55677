"""Reduced 4-dof local Newton in the trial eigenbasis for the
frame-invariant (principal-stress) Hosford yield.

Port of ``cmad_tpu/ops/principal_return.py``. For an isotropic yield and
isotropic elasticity the backward-Euler return map is coaxial with the
trial state: at the root of the 7-dof rate-form residual,

    sigma + dg * C : n(sigma) = sigma_tr,      n = dphi/dsigma,

the left side is an isotropic tensor function of ``sigma``, so ``sigma``
keeps the trial stress's eigenvectors and only its three principal
values move. The coupled solve has four unknowns: the principal stresses
(rate form) or principal plastic-strain increments (total form), and
alpha, after one eigendecomposition of the trial state (the guarded
closed-form Cardano solution, ``util/eigen_decomposition.py``).

The Newton runs on principal values only: no eigenvector derivative
enters the solve. The state is rebuilt as ``trial + sum_i c_i P_i`` with
``c_i`` the principal corrections (zero on the elastic branch, so the
elastic state is exact at any degeneracy) and ``P_i`` the spectral
projectors of the trial tensor (:func:`coaxial_recompose`).

Material rotations are allowed: the solve runs in the material frame, as
the full residual does (the isotropic yield never sees the rotation, but
the state stays in the frame ``xi`` is stored in).

The solve is written in strain space
(:class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve`) like
``ops/hosford_return.py``'s: the residual reads the previous state whole
and the strain rows, and computes the trial eigenvalues from them, so the
strain tangent ``dx/dg`` (``jacfwd`` of the residual in ``g``) carries the
trial's dependence on the strain. The Newton starts from the trial
eigenvalues (rate form) or zero increments (total form), as the JAX
package's does.
"""
from __future__ import annotations

import numpy as np
import torch
from torch.func import grad_and_value

from cmad_tpu_torch.models.effective_stress import hosford_phi_of_principal
from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.models.nonlinear_solver import LocalSolve
from cmad_tpu_torch.models.paths import cond_residual
from cmad_tpu_torch.models.var_types import (
    sym_tensor_from_vector,
    vector_from_sym_tensor,
)
from cmad_tpu_torch.ops.hosford_return import (
    _YIELD_TOL,
    _flow_stress,
    points_local_solve,
    whole_state,
)
from cmad_tpu_torch.typing import Tensor
from cmad_tpu_torch.util.eigen_decomposition import compute_eigenvalues

_TINY = 1e-30


def principal_hosford_kind(model) -> str | None:
    """``"rate"`` / ``"total"`` when ``model`` admits the reduced
    principal-space solve (``ops/return_map.elastic_plastic_kind`` with
    the effective stress ``{hosford_principal}``, any material rotation);
    ``None`` otherwise."""
    from cmad_tpu_torch.ops.return_map import elastic_plastic_kind

    return elastic_plastic_kind(model, "hosford_principal",
                                any_rotation=True)


def principal_hosford_reducible(model) -> bool:
    return principal_hosford_kind(model) is not None


def _gap_rtol(dtype: torch.dtype) -> float:
    """Relative eigenvalue gap below which a pair counts as degenerate:
    sqrt(eps) balances the O(eps/gap) conditioning error of the
    distinct-pair projectors against the O(gap) error of the
    pair-averaged correction."""
    return float(np.sqrt(torch.finfo(dtype).eps))


def coaxial_recompose(A: Tensor, s: Tensor, c: Tensor) -> Tensor:
    """``sum_i c_i P_i`` for the spectral projectors ``P_i`` of the
    symmetric ``A (..., 3, 3)`` with eigenvalues ``s (..., 3)``
    (descending) and coefficients ``c (..., 3)`` in the same order.

    The projectors are Cayley-Hamilton products with guarded
    denominators, and a three-case select on dtype-scaled gaps picks the
    form: distinct values; one repeated pair (the well-conditioned
    complementary projector and the pair's mean coefficient, the two
    coefficients coinciding at the pair since the yield is a symmetric
    function of the principal values); a triple (the mean times I)."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    s0, s1, s2 = (s[..., i, None, None] for i in range(3))
    c0, c1, c2 = (c[..., i, None, None] for i in range(3))
    g01 = s0 - s1
    g12 = s1 - s2
    scale = torch.clamp_min(torch.maximum(torch.abs(s0), torch.abs(s2)),
                            _TINY)
    tol = _gap_rtol(A.dtype) * scale
    near01 = g01 <= tol
    near12 = g12 <= tol

    def safe(x):
        return torch.where(torch.abs(x) > _TINY, x, torch.ones_like(x))

    A0 = A - s0 * eye
    A1 = A - s1 * eye
    A2 = A - s2 * eye
    # denominators guarded so the branches a select rejects stay finite
    P0 = (A1 @ A2) / safe(g01 * (g01 + g12))
    P1 = (A0 @ A2) / safe(-g01 * g12)
    P2 = (A0 @ A1) / safe((g01 + g12) * g12)
    distinct = c0 * P0 + c1 * P1 + c2 * P2
    # s0 ~= s1: P2 stays well-conditioned and the pair's projector is
    # its complement
    pair01 = 0.5 * (c0 + c1) * (eye - P2) + c2 * P2
    # s1 ~= s2: P0 stays well-conditioned
    pair12 = c0 * P0 + 0.5 * (c1 + c2) * (eye - P0)
    triple = (c0 + c1 + c2) / 3.0 * eye
    return torch.where(near01 & near12, triple,
                       torch.where(near01, pair01,
                                   torch.where(near12, pair12, distinct)))


def _phi_and_normal(s: Tensor, plastic: dict) -> tuple[Tensor, Tensor]:
    """The Hosford effective stress of a principal-stress 3-vector and
    its flow normal's principal values."""
    a = plastic["effective stress"]["hosford_principal"]["a"]
    normal, phi = grad_and_value(hosford_phi_of_principal)(s, a)
    return phi, normal


def _lame(params) -> tuple[Tensor, Tensor]:
    ec = ElasticConstants.from_params(params["elastic"])
    return ec.mu, ec.lmbda


def _material(g6: Tensor, Q: Tensor) -> Tensor:
    """The strain rows as a material-frame tensor: Q^T sym(g) Q."""
    return Q.T @ sym_tensor_from_vector(g6) @ Q


def _rate_trial(xi_prev: Tensor, params, g6: Tensor) -> Tensor:
    """The trial stress tensor (material frame) of the rate form."""
    mu, lam = _lame(params)
    deps = _material(g6, params["rotation matrix"])
    eye = torch.eye(3, dtype=deps.dtype, device=deps.device)
    return (sym_tensor_from_vector(xi_prev[:6])
            + lam * torch.trace(deps) * eye + 2.0 * mu * deps)


def _total_trial(xi_prev: Tensor, params, g6: Tensor) -> Tensor:
    """The trial elastic strain tensor (material frame) of the total
    form."""
    eps = _material(g6, params["rotation matrix"])
    return eps - sym_tensor_from_vector(xi_prev[:6])


def _rate_residual(x4, xi_prev, params, g6):
    """Rate form, one point: ``x4`` = (principal stresses, alpha)."""
    mu, lam = _lame(params)
    plastic = params["plastic"]
    s_tr = compute_eigenvalues(_rate_trial(xi_prev, params, g6))
    d, alpha = x4[:3], x4[3]
    dg = alpha - xi_prev[6]
    phi, n = _phi_and_normal(d, plastic)
    yield_fun = (phi - _flow_stress(alpha, plastic)) / (2.0 * mu)
    # C : n with isotropic C; lam sum(n) vanishes analytically (phi
    # depends on stress differences) but is kept, as the full residual has
    # it
    corr = dg * (lam * torch.sum(n) + 2.0 * mu * n)
    C_e = torch.cat([(d - s_tr) / (2.0 * mu), dg[None]])
    C_p = torch.cat([(d - s_tr + corr) / (2.0 * mu), yield_fun[None]])
    return cond_residual(yield_fun, C_e, C_p, _YIELD_TOL)


def _total_residual(x4, xi_prev, params, g6):
    """Total form, one point: ``x4`` = (principal plastic-strain
    increments, alpha)."""
    mu, lam = _lame(params)
    plastic = params["plastic"]
    e_tr = compute_eigenvalues(_total_trial(xi_prev, params, g6))
    dp, alpha = x4[:3], x4[3]
    dg = alpha - xi_prev[6]
    e = e_tr - dp
    s = lam * torch.sum(e) + 2.0 * mu * e  # principal stresses
    phi, n = _phi_and_normal(s, plastic)
    yield_fun = (phi - _flow_stress(alpha, plastic)) / (2.0 * mu)
    C_e = torch.cat([dp, dg[None]])
    C_p = torch.cat([dp - dg * n, yield_fun[None]])
    return cond_residual(yield_fun, C_e, C_p, _YIELD_TOL)


def _rate_seed(xi_prev, params, g6):
    """The elastic predictor: the trial eigenvalues and alpha_prev."""
    s_tr = compute_eigenvalues(_rate_trial(xi_prev, params, g6))
    return torch.cat([s_tr, xi_prev[6:7]])


def _total_seed(xi_prev, params, g6):
    return torch.cat([torch.zeros_like(xi_prev[:3]), xi_prev[6:7]])


def _rate_expand(x4, xi_prev, params, g6):
    A_tr = _rate_trial(xi_prev, params, g6)
    s_tr = compute_eigenvalues(A_tr)
    sigma = A_tr + coaxial_recompose(A_tr, s_tr, x4[:3] - s_tr)
    return torch.cat([vector_from_sym_tensor(sigma), x4[3:4]])


def _total_expand(x4, xi_prev, params, g6):
    A_tr = _total_trial(xi_prev, params, g6)
    dP = coaxial_recompose(A_tr, compute_eigenvalues(A_tr), x4[:3])
    return torch.cat([xi_prev[:6] + vector_from_sym_tensor(dP), x4[3:4]])


def make_principal_hosford_strain_solve(
        model, max_iters: int = 10, abs_tol: float | None = None,
        rel_tol: float | None = None,
        line_search_settings=None) -> LocalSolve:
    """The reduced solve in strain space (requires
    ``principal_hosford_reducible(model)``): ``solve(xi_prev, params,
    g6) -> xi``, batched."""
    kind = principal_hosford_kind(model)
    if kind is None:
        raise ValueError(
            f"{type(model).__name__} is not principal-Hosford-reducible")
    residual, seed, expand = (
        (_rate_residual, _rate_seed, _rate_expand) if kind == "rate"
        else (_total_residual, _total_seed, _total_expand))
    return LocalSolve(residual, whole_state, expand, max_iters=max_iters,
                      abs_tol=abs_tol, rel_tol=rel_tol,
                      line_search_settings=line_search_settings, seed=seed)


def make_principal_hosford_local_solve(model, max_iters: int = 10,
                                       abs_tol: float | None = None,
                                       rel_tol: float | None = None,
                                       line_search_settings=None):
    """``local_solve(xi_guess, xi_prev, params, U, U_prev)`` over a batch
    of points: the reduced system solved and the 7-dof state rebuilt
    (requires ``principal_hosford_reducible(model)``). The guess is
    ignored: the reduced solve seeds from the trial state."""
    return points_local_solve(
        principal_hosford_kind(model), make_principal_hosford_strain_solve(
            model, max_iters=max_iters, abs_tol=abs_tol, rel_tol=rel_tol,
            line_search_settings=line_search_settings))
