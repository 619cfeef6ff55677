"""Reduced 1-dof local Newton for the Hill-1948 quadratic yield.

Port of ``cmad_tpu/ops/hill_return.py``. The Hill effective stress is a
constant quadratic form, so its flow normal is linear in stress:
n = B sigma / phi with a constant symmetric 6x6 operator B
(:func:`cmad_tpu_torch.models.effective_stress.hill_effective_stress`).
The backward-Euler return map

    sigma = sigma_tr - dg * C : n(sigma),    C : n = 2 mu n

is then a linear stress recovery per candidate plastic multiplier: with
s = 2 mu dg / phi(sigma),

    (I + s B) sigma = sigma_tr,

leaving one scalar unknown s >= 0, fixed by the yield condition

    phi(sigma(s)) = Y + H(alpha_prev + s * phi(sigma(s)) / (2 mu)).

Each residual evaluation is a closed-form solve of the 6x6 system
(:func:`_recover`) and the closed-form phi. Both model families are
covered (the rate form updates the stress, the total form
the plastic strain by dp = (s / 2 mu) B sigma), with any material
rotation (the solve runs in the material frame, as the full residual
does) and any ``combined_hardening_fun`` hardening.

The solve is written in strain space
(:class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve`): the
residual reads the previous state whole and the strain rows and forms
the trial stress from them, so the strain tangent carries the trial's
dependence on the strain. The Newton starts from s = 0, as the JAX
package's does.
"""
from __future__ import annotations

import torch

from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.models.nonlinear_solver import LocalSolve
from cmad_tpu_torch.models.var_types import sym_tensor_from_vector
from cmad_tpu_torch.ops.linalg import inv3
from cmad_tpu_torch.ops.hosford_return import (
    _YIELD_TOL,
    _flow_stress,
    points_local_solve,
    whole_state,
)
from cmad_tpu_torch.typing import Tensor


def hill_kind(model) -> str | None:
    """``"rate"`` / ``"total"`` when ``model`` admits the reduced Hill
    solve (``ops/return_map.elastic_plastic_kind`` with the effective
    stress ``{hill}``, any material rotation); ``None`` otherwise."""
    from cmad_tpu_torch.ops.return_map import elastic_plastic_kind

    return elastic_plastic_kind(model, "hill", any_rotation=True)


def hill_reducible(model) -> bool:
    return hill_kind(model) is not None


def _hill_operator(coeffs: dict) -> Tensor:
    """The constant symmetric B with n6 = B v / phi, in the sym-vec order
    [xx, xy, xz, yy, yz, zz], stacked from the coefficient tensors."""
    F, G, H = coeffs["F"], coeffs["G"], coeffs["H"]
    L, M, N = coeffs["L"], coeffs["M"], coeffs["N"]
    z = torch.zeros_like(F)
    return torch.stack([
        torch.stack([G + H, z, z, -H, z, -G]),
        torch.stack([z, N, z, z, z, z]),
        torch.stack([z, z, M, z, z, z]),
        torch.stack([-H, z, z, F + H, z, -F]),
        torch.stack([z, z, z, z, L, z]),
        torch.stack([-G, z, z, -F, z, F + G]),
    ])


def _phi6(v: Tensor, coeffs: dict) -> Tensor:
    """Hill effective stress of a sym-vec; equals
    ``hill_effective_stress`` of the symmetric tensor. At a zero stress
    its derivative is 0 (a double ``where`` keeps the sqrt off 0; JAX's
    is NaN there): the state of an elastic point with no strain (s = 0,
    v = 0) then has a finite tangent, as the FE block's first iterate
    needs."""
    F, G, H = coeffs["F"], coeffs["G"], coeffs["H"]
    L, M, N = coeffs["L"], coeffs["M"], coeffs["N"]
    q = (F * (v[..., 3] - v[..., 5]) ** 2
         + G * (v[..., 5] - v[..., 0]) ** 2
         + H * (v[..., 0] - v[..., 3]) ** 2
         + 2.0 * L * v[..., 4] ** 2
         + 2.0 * M * v[..., 2] ** 2
         + 2.0 * N * v[..., 1] ** 2)
    nonzero = q > 0.0
    return torch.where(nonzero, torch.sqrt(torch.where(nonzero, q, 1.0)),
                       0.0)


def _sym_vec_material(g6: Tensor, Q: Tensor) -> Tensor:
    """The material-frame sym-vec of the strain rows: Q^T sym(g) Q."""
    m = Q.T @ sym_tensor_from_vector(g6) @ Q
    return torch.stack([m[0, 0], m[0, 1], m[0, 2],
                        m[1, 1], m[1, 2], m[2, 2]])


def _trial_stress(kind: str, xi_prev: Tensor, params, g6: Tensor
                  ) -> Tensor:
    """The trial stress sym-vec (material frame): the previous stress
    plus C deps (rate form), or C (eps - pe_prev) (total form)."""
    ec = ElasticConstants.from_params(params["elastic"])
    mu, lam = ec.mu, ec.lmbda
    e = _sym_vec_material(g6, params["rotation matrix"])
    if kind == "total":
        e = e - xi_prev[:6]
    tr = e[0] + e[3] + e[5]
    z = 0.0 * tr
    iso = torch.stack([lam * tr, z, z, lam * tr, z, lam * tr])
    if kind == "rate":
        return xi_prev[:6] + iso + 2.0 * mu * e
    return iso + 2.0 * mu * e


def _recover(s: Tensor, v_tr: Tensor, coeffs: dict) -> Tensor:
    """The stress of multiplier ``s``: (I + s B)^-1 v_tr. The system
    splits: B's shear rows are diagonal, and its normal rows (xx, yy, zz)
    a 3x3 block, solved by the closed-form inverse ``ops/linalg.inv3``.
    Elementwise, so it runs under ``vmap`` with forward-mode AD and in a
    CUDA graph: under ``vmap`` the forward-mode derivatives of
    ``torch.linalg.solve`` and of ``lu_solve`` in the right-hand side
    were wrong (torch 2.13)."""
    F, G, H = coeffs["F"], coeffs["G"], coeffs["H"]
    L, M, N = coeffs["L"], coeffs["M"], coeffs["N"]
    one = 1.0 + 0.0 * s
    A = torch.stack([
        torch.stack([one + s * (G + H), -s * H, -s * G]),
        torch.stack([-s * H, one + s * (F + H), -s * F]),
        torch.stack([-s * G, -s * F, one + s * (F + G)]),
    ])
    d = inv3(A) @ torch.stack([v_tr[0], v_tr[3], v_tr[5]])
    return torch.stack([d[0], v_tr[1] / (1.0 + s * N),
                        v_tr[2] / (1.0 + s * M), d[1],
                        v_tr[4] / (1.0 + s * L), d[2]])


def _make(kind: str):
    def residual(s_vec, xi_prev, params, g6):
        """The scalar residual in s (one point)."""
        mu = ElasticConstants.from_params(params["elastic"]).mu
        plastic = params["plastic"]
        coeffs = plastic["effective stress"]["hill"]
        s = s_vec[0]
        alpha_prev = xi_prev[6]
        v_tr = _trial_stress(kind, xi_prev, params, g6)
        phi = _phi6(_recover(s, v_tr, coeffs), coeffs)
        dg = s * phi / (2.0 * mu)
        rho = (phi - _flow_stress(alpha_prev + dg, plastic)) / (2.0 * mu)
        f_trial = (_phi6(v_tr, coeffs)
                   - _flow_stress(alpha_prev, plastic)) / (2.0 * mu)
        is_plastic = torch.logical_or(f_trial > _YIELD_TOL,
                                      torch.abs(f_trial) < _YIELD_TOL)
        # elastic points solve s = 0 (the branch-free shape of
        # cond_residual)
        return torch.where(is_plastic, rho, s)[None]

    def expand(s_vec, xi_prev, params, g6):
        mu = ElasticConstants.from_params(params["elastic"]).mu
        coeffs = params["plastic"]["effective stress"]["hill"]
        s = s_vec[0]
        v_tr = _trial_stress(kind, xi_prev, params, g6)
        v = _recover(s, v_tr, coeffs)
        alpha = xi_prev[6] + s * _phi6(v, coeffs) / (2.0 * mu)
        if kind == "rate":
            state6 = v
        else:
            state6 = xi_prev[:6] + (s / (2.0 * mu)) * (
                _hill_operator(coeffs) @ v)
        return torch.cat([state6, alpha[None]])

    return residual, expand


def _seed(xi_prev, params, g6):
    return torch.zeros_like(xi_prev[:1])


def make_hill_strain_solve(model, max_iters: int = 10,
                           abs_tol: float | None = None,
                           rel_tol: float | None = None,
                           line_search_settings=None) -> LocalSolve:
    """The reduced solve in strain space (requires
    ``hill_reducible(model)``): ``solve(xi_prev, params, g6) -> xi``,
    batched."""
    kind = hill_kind(model)
    if kind is None:
        raise ValueError(f"{type(model).__name__} is not Hill-reducible")
    residual, expand = _make(kind)
    return LocalSolve(residual, whole_state, expand, max_iters=max_iters,
                      abs_tol=abs_tol, rel_tol=rel_tol,
                      line_search_settings=line_search_settings,
                      seed=_seed)


def make_hill_local_solve(model, max_iters: int = 10,
                          abs_tol: float | None = None,
                          rel_tol: float | None = None,
                          line_search_settings=None):
    """``local_solve(xi_guess, xi_prev, params, U, U_prev)`` over a batch
    of points: the scalar system solved and the 7-dof state rebuilt
    (requires ``hill_reducible(model)``). The guess is ignored."""
    return points_local_solve(hill_kind(model), make_hill_strain_solve(
        model, max_iters=max_iters, abs_tol=abs_tol, rel_tol=rel_tol,
        line_search_settings=line_search_settings))
