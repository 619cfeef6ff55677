"""Backtracking Armijo line search, per point of a batch.

Port of ``cmad_tpu/util/line_search.py`` (parity: reference
``cmad/util/line_search.py:95``). The merit is
``phi(alpha) = 0.5 ||r(x + alpha dx)||^2``; a trial is accepted on the
Armijo condition ``phi <= phi0 + c1 * alpha * dphi0``. Rejected steps
contract to the minimizer of a two-point Hermite cubic (when the caller
supplies the trial slope) or a quadratic (when it does not), clipped to
``[min_factor, max_factor] * alpha``.

The JAX package wrote the search as a ``lax.while_loop`` that its callers
``vmap`` over points, which makes every lane stop at its own acceptance
and keep its carry once done. Here the batch is explicit: ``phi_0`` and
``dphi_0`` carry a leading point shape (or none, for one point), each
point has its own ``alpha``, and a point's carry is updated only while
that point is still searching. The loop ends when every point has
accepted or the budget is spent.
"""
from __future__ import annotations

from collections.abc import Callable, Mapping
from typing import Any

import torch
import torch.utils._pytree as pytree

from cmad_tpu_torch.typing import PyTree, Tensor

DEFAULT_LINE_SEARCH_SETTINGS: dict[str, Any] = {
    "max evals": 4,
    "sufficient decrease": 1.0e-4,
    "min backtrack factor": 0.5,
    "max backtrack factor": 0.9,
    "nonmonotone": False,
    "print": False,
}


def cubic_min(phi_0, dphi_0, a, phi_a, slope_a):
    """Interior minimizer of the Hermite cubic through (0, phi_0, dphi_0)
    and (a, phi_a, slope_a); falls back to a/2 when degenerate."""
    d1 = dphi_0 + slope_a + 3.0 * (phi_0 - phi_a) / a
    radicand = d1 * d1 - dphi_0 * slope_a
    d2 = torch.sqrt(torch.clamp(radicand, min=0.0))
    denom = slope_a - dphi_0 + 2.0 * d2
    alpha = a - a * (slope_a + d2 - d1) / torch.where(
        denom == 0.0, torch.ones_like(denom), denom)
    bad = torch.logical_or(radicand < 0.0, denom == 0.0)
    return torch.where(bad, 0.5 * a, alpha)


def quad_min(phi_0, dphi_0, a, phi_a):
    """Minimizer of the quadratic through (0, phi_0, dphi_0) and
    (a, phi_a); falls back to a/2 when curvature vanishes."""
    denom = 2.0 * (phi_a - phi_0 - dphi_0 * a)
    alpha = -dphi_0 * a * a / torch.where(
        denom == 0.0, torch.ones_like(denom), denom)
    return torch.where(denom == 0.0, 0.5 * a, alpha)


def _where_tree(pred: Tensor, a: PyTree, b: PyTree) -> PyTree:
    """Per point: leaves of ``a`` where ``pred``, else of ``b``; leaves
    carry the point shape of ``pred`` as their leading dims."""
    def pick(x, y):
        p = pred.reshape(pred.shape + (1,) * (x.dim() - pred.dim()))
        return torch.where(p, x, y)
    return pytree.tree_map(pick, a, b)


def line_search(
        eval_fn: Callable[[Tensor], tuple[Tensor, Tensor | None, PyTree]],
        phi_0: Tensor,
        dphi_0: Tensor,
        settings: Mapping[str, Any],
        init_aux: PyTree,
) -> tuple[Tensor, PyTree]:
    """Returns ``(alpha, aux)``, per point, where ``aux`` is whatever
    ``eval_fn`` produced at the returned step (so callers can reuse e.g.
    the residual instead of recomputing).

    ``eval_fn(alpha) -> (phi, slope_or_None, aux)`` evaluates every point
    at its own ``alpha``. With ``max evals = 0`` the full step is
    returned untried. If no trial satisfies Armijo within the budget, the
    lowest-merit trial wins. Non-finite merits (diverged probes) halve
    the step.

    ``nonmonotone`` (default off): when NO trial satisfies Armijo, accept
    the FULL step anyway unless it blew the merit up past
    ``100 x phi_0``, in which case fall back to the lowest-merit trial
    (the host FE Newton's acceptance policy in the JAX package).
    """
    max_evals = settings["max evals"]
    c1 = settings["sufficient decrease"]
    f_lo = settings["min backtrack factor"]
    f_hi = settings["max backtrack factor"]
    nonmonotone = bool(settings.get("nonmonotone", False))

    one = torch.ones_like(phi_0)
    inf = torch.full_like(phi_0, float("inf"))
    evals = torch.zeros(phi_0.shape, dtype=torch.int64, device=phi_0.device)
    alpha, ok, aux = one, torch.zeros_like(phi_0, dtype=torch.bool), init_aux
    best_a, best_phi, best_aux = one, inf, init_aux
    full_phi, full_aux = inf, init_aux

    for n in range(max_evals):
        live = ~ok
        if not bool(live.any()):
            break
        phi, slope, trial_aux = eval_fn(alpha)
        finite = torch.isfinite(phi)

        if n == 0:  # the alpha = 1 (full-step) probe, taken by every point
            full_phi, full_aux = phi, trial_aux

        better = finite & (phi < best_phi) & live
        best_a = torch.where(better, alpha, best_a)
        best_phi = torch.where(better, phi, best_phi)
        best_aux = _where_tree(better, trial_aux, best_aux)

        accept = finite & (phi <= phi_0 + c1 * alpha * dphi_0)
        if slope is None:
            model_min = quad_min(phi_0, dphi_0, alpha, phi)
        else:
            model_min = cubic_min(phi_0, dphi_0, alpha, phi, slope)
        contracted = torch.clamp(model_min, min=f_lo * alpha,
                                 max=f_hi * alpha)
        next_alpha = torch.where(
            accept, alpha, torch.where(finite, contracted, 0.5 * alpha))

        alpha = torch.where(live, next_alpha, alpha)
        aux = _where_tree(live, trial_aux, aux)
        ok = torch.where(live, accept, ok)
        evals = evals + live

    if nonmonotone:
        accept_full = torch.isfinite(full_phi) & (full_phi <= 100.0 * phi_0)
        fallback_a = torch.where(accept_full, one, best_a)
        fallback_aux = _where_tree(accept_full, full_aux, best_aux)
    else:
        fallback_a, fallback_aux = best_a, best_aux
    out_alpha = torch.where(ok, alpha, fallback_a)
    out_aux = _where_tree(ok, aux, fallback_aux)
    if settings.get("print", False):
        print(f" > line search: alpha = {out_alpha.tolist()} "
              f"({evals.tolist()} evals)")
    return out_alpha, out_aux
