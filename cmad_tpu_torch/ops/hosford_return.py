"""Reduced 4-dof local Newton for diagonal-isotropic (Hosford) yields.

Port of ``cmad_tpu/ops/hosford_return.py``. The Hosford effective stress
(:func:`cmad_tpu_torch.models.effective_stress.hosford_effective_stress`)
depends only on the diagonal of the stress tensor, so its flow normal is
diagonal and traceless. In the 7-dof local return map (6 stress or
plastic-strain components + alpha) the three off-diagonal state slots
therefore evolve elastically (rate form: trial off-diagonal stress; total
form: frozen off-diagonal plastic strain), and the coupled solve has FOUR
unknowns: the three diagonal components and alpha.

- ``SmallRateElasticPlastic`` (xi = [cauchy6, alpha]): the unknowns are
  the diagonal stresses; the off-diagonals get the trial elastic
  increment.
- ``SmallElasticPlastic`` (xi = [plastic_strain6, alpha]): the unknowns
  are the diagonal plastic strains; the off-diagonals keep their previous
  values.

The reduced residual reproduces the full model residual's branch select,
scaling and hardening (the same ``cond_residual`` and yield tolerance,
the same ``combined_hardening_fun``), so the converged reduced state
matches the 7-dof solve to the Newton tolerance while each iteration
solves a 4x4 system. The flow normal is ``torch.func.grad`` of the same
tensor-form effective stress the full model differentiates, so the
Newton's Jacobian (``jacfwd`` of the residual) is the second derivative
of the function JAX differentiates.

The solve is written in strain space
(:class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve`): the
residual reads the symmetric strain rows (the increment in the rate form,
the total strain in the total form), which the point-batch FE block
(``fem/coupled_block.py``) needs for its strain tangent, and
:func:`make_hosford_local_solve` wraps it in the models'
``(xi_guess, xi_prev, params, U, U_prev)`` signature, batched over points.
"""
from __future__ import annotations

import torch
from torch.func import grad_and_value

from cmad_tpu_torch.models.effective_stress import hosford_effective_stress
from cmad_tpu_torch.models.elastic_constants import ElasticConstants
from cmad_tpu_torch.models.hardening import (
    combined_hardening_fun,
    get_hardening_funs,
)
from cmad_tpu_torch.models.nonlinear_solver import LocalSolve
from cmad_tpu_torch.models.paths import cond_residual
from cmad_tpu_torch.models.var_types import vector_from_sym_tensor
from cmad_tpu_torch.typing import Tensor

# both model families are built with yield_tol = 1e-14 and from_deck
# never overrides it
_YIELD_TOL = 1e-14


def hosford_kind(model) -> str | None:
    """``"rate"`` / ``"total"`` when ``model`` admits the reduced
    diagonal-space Hosford solve (``ops/return_map.elastic_plastic_kind``
    with the effective stress ``{hosford}``; any hardening
    ``combined_hardening_fun`` supports); ``None`` otherwise."""
    from cmad_tpu_torch.ops.return_map import elastic_plastic_kind

    return elastic_plastic_kind(model, "hosford")


def hosford_reducible(model) -> bool:
    return hosford_kind(model) is not None


def _diag(v6: Tensor) -> Tensor:
    return torch.stack([v6[0], v6[3], v6[5]])


def _phi_of(d: Tensor, es: dict) -> Tensor:
    return hosford_effective_stress(torch.diag_embed(d), es)


def _phi_and_normal(d: Tensor, plastic: dict) -> tuple[Tensor, Tensor]:
    """The Hosford effective stress of a diagonal stress 3-vector and its
    (diagonal, traceless) flow normal, through the tensor form the full
    model differentiates."""
    normal, phi = grad_and_value(_phi_of)(
        d, {"effective stress": plastic["effective stress"]})
    return phi, normal


def _flow_stress(alpha: Tensor, plastic: dict) -> Tensor:
    Y = plastic["flow stress"]["initial yield"]["Y"]
    return Y + combined_hardening_fun(
        alpha, plastic["flow stress"]["hardening"],
        hardening_funs=get_hardening_funs())


def _rate_residual(x4, x4_prev, params, g6):
    """Rate form, one point: ``x4`` = (diagonal stress, alpha), ``g6``
    the strain increment."""
    ec = ElasticConstants.from_params(params["elastic"])
    mu, lam = ec.mu, ec.lmbda
    plastic = params["plastic"]
    d, alpha = x4[:3], x4[3]
    d_prev, alpha_prev = x4_prev[:3], x4_prev[3]
    dg = alpha - alpha_prev
    tr = g6[0] + g6[3] + g6[5]
    d_tr = d_prev + (lam * tr + 2.0 * mu * _diag(g6))
    phi, n = _phi_and_normal(d, plastic)
    yield_fun = (phi - _flow_stress(alpha, plastic)) / (2.0 * mu)
    # C(sigma): lam tr(n) vanishes analytically (the yield is a function
    # of stress differences) but is kept as the full model has it
    corr = dg * (lam * torch.sum(n) + 2.0 * mu * n)
    C_e = torch.cat([(d - d_tr) / (2.0 * mu), dg[None]])
    C_p = torch.cat([(d - d_tr + corr) / (2.0 * mu), yield_fun[None]])
    return cond_residual(yield_fun, C_e, C_p, _YIELD_TOL)


def _total_residual(x4, x4_prev, params, g6):
    """Total form, one point: ``x4`` = (diagonal plastic strain, alpha),
    ``g6`` the total strain. The off-diagonal plastic strain is frozen,
    so it never enters the diagonal rows."""
    ec = ElasticConstants.from_params(params["elastic"])
    mu, lam = ec.mu, ec.lmbda
    plastic = params["plastic"]
    pe_d, alpha = x4[:3], x4[3]
    pe_d_prev, alpha_prev = x4_prev[:3], x4_prev[3]
    dg = alpha - alpha_prev
    tr_e = (g6[0] + g6[3] + g6[5]) - torch.sum(pe_d)
    d_sigma = lam * tr_e + 2.0 * mu * (_diag(g6) - pe_d)
    phi, n = _phi_and_normal(d_sigma, plastic)
    yield_fun = (phi - _flow_stress(alpha, plastic)) / (2.0 * mu)
    dp = pe_d - pe_d_prev
    C_e = torch.cat([dp, dg[None]])
    C_p = torch.cat([dp - dg * n, yield_fun[None]])
    return cond_residual(yield_fun, C_e, C_p, _YIELD_TOL)


def _reduce(xi_prev: Tensor) -> Tensor:
    return torch.stack([xi_prev[0], xi_prev[3], xi_prev[5], xi_prev[6]])


def _state(x4: Tensor, od: tuple) -> Tensor:
    """The 7-dof state [xx, xy, xz, yy, yz, zz, alpha] from the diagonal
    unknowns and the off-diagonal (xy, xz, yz)."""
    return torch.stack([x4[0], od[0], od[1], x4[1], od[2], x4[2], x4[3]])


def _expand_rate(x4, xi_prev, params, g6):
    two_mu = 2.0 * ElasticConstants.from_params(params["elastic"]).mu
    return _state(x4, (xi_prev[1] + two_mu * g6[1],
                       xi_prev[2] + two_mu * g6[2],
                       xi_prev[4] + two_mu * g6[4]))


def _expand_total(x4, xi_prev, params, g6):
    return _state(x4, (xi_prev[1], xi_prev[2], xi_prev[4]))


def make_hosford_strain_solve(model, max_iters: int = 10,
                              abs_tol: float | None = None,
                              rel_tol: float | None = None,
                              line_search_settings=None) -> LocalSolve:
    """The reduced solve in strain space (requires
    ``hosford_reducible(model)``): ``solve(xi_prev, params, g6) -> xi``,
    batched, seeded from the previous state."""
    kind = hosford_kind(model)
    if kind is None:
        raise ValueError(
            f"{type(model).__name__} is not Hosford-reducible")
    residual, expand = ((_rate_residual, _expand_rate) if kind == "rate"
                        else (_total_residual, _expand_total))
    return LocalSolve(residual, _reduce, expand, max_iters=max_iters,
                      abs_tol=abs_tol, rel_tol=rel_tol,
                      line_search_settings=line_search_settings)


def strain_rows(kind: str, U, U_prev) -> Tensor:
    """The strain rows (..., 6) a model of ``kind`` reads from the
    displacement gradients: ``sym(grad u) - sym(grad u_prev)`` in the
    rate form, ``sym(grad u)`` in the total form."""
    def sym(t):
        return 0.5 * (t + t.transpose(-1, -2))

    g = sym(U.grad_fields["u"])
    if kind == "rate":
        g = g - sym(U_prev.grad_fields["u"])
    return vector_from_sym_tensor(g)


def make_hosford_local_solve(model, max_iters: int = 10,
                             abs_tol: float | None = None,
                             rel_tol: float | None = None,
                             line_search_settings=None):
    """``local_solve(xi_guess, xi_prev, params, U, U_prev)`` over a batch
    of points (``xi_prev`` (B, 7), ``U``/``U_prev`` holding (B, 3, 3)
    gradients, ``params`` shared): the reduced system solved and the
    7-dof state rebuilt (requires ``hosford_reducible(model)``). The
    guess is ignored: the reduced solve seeds from the previous state."""
    kind = hosford_kind(model)
    solve = make_hosford_strain_solve(
        model, max_iters=max_iters, abs_tol=abs_tol, rel_tol=rel_tol,
        line_search_settings=line_search_settings)

    def local_solve(xi_guess, xi_prev, params, U, U_prev):
        del xi_guess
        return solve(xi_prev, params, strain_rows(kind, U, U_prev))

    return local_solve
