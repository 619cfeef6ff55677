"""Generic per-point block: any model through a GR's weak form.

Port of the generic per-integration-point assembly of
``cmad_tpu/fem/assembly.py`` (``_closed_r_and_k_kernel``,
``_closed_r_kernel``, ``_coupled_r_and_k_kernel``, ``_coupled_r_kernel``,
``_coupled_block_generic``) and of the evaluators
``cmad_tpu/global_residuals/global_residual.py`` binds for them
(``_bind_closed_form``, ``_bind_coupled``). It serves the blocks the J2
block (``fem/j2_block.py``) and the point-batch block
(``fem/coupled_block.py``) decline, with their evaluator signature
``(params, U_e, Up_e, geom, f_ip, t, xi_prev) -> (R_e, K_e, xi |
None)``, so ``fem/assembly.py`` has one dispatch and one scatter.

The GR's per-point residual ``residual_fn`` (one point, functional) runs
over the block's flat ``E*Q`` point batch under ``torch.func.vmap``,
each point with its element's coefficients, less the point's body force
``N (x) f w dv`` when there is one (``_apply_body_force`` in the JAX
package); each element's residual and matrix are the sum of its points'
in ascending point order, a fixed order on the card as on the CPU:

- CLOSED_FORM: the stress from ``model.cauchy_closed_form_fun``; the
  tangent is ``vmap(jacfwd(...))`` of the point's residual in the
  element's coefficients; the block returns no state, as the JAX
  package's does;
- COUPLED: one batched local solve of ``model.residual_fun`` over the
  points from the previous state
  (:class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve`, the menu
  ``GlobalResidual._build_local_solve``; it prints each iteration when
  the deck asks), then ``dR/dU = dR/dU|xi + dR/dxi dxi/dU`` with
  ``dxi/dU`` from :meth:`LocalSolve.tangent` (one batched solve of the
  local Jacobian against ``dC/dU``). The JAX package took this tangent
  from ``jacfwd`` through its ``custom_jvp`` Newton; the port's implicit
  solve is a host-driven loop with no batching rule, so the rule is
  written out in differentiable ops, as the point-batch block's is.

The parameters are an explicit input of every batched function and of
the implicit solve, so ``K``'s dependence on them reaches the
second-derivative sweeps. The GR's residual keeps the JAX package's
per-residual-block lists and (r, s) tangent blocks; the block emits the
single displacement field's (the mixed u-p form raises, ROADMAP queue 1,
item 22).
"""
from __future__ import annotations

import torch
from torch.func import jacfwd, vmap

from cmad_tpu_torch.fem.elements import ShapeFunctionsAtIP
from cmad_tpu_torch.global_residuals.modes import GlobalResidualMode
from cmad_tpu_torch.typing import Tensor


def _sum_points(x: Tensor, E: int, Q: int) -> Tensor:
    """(E*Q, ...) point values -> (E, ...) element sums, adding the
    points in ascending order."""
    x = x.reshape(E, Q, *x.shape[1:])
    out = x[:, 0]
    for q in range(1, Q):
        out = out + x[:, q]
    return out


def _points(U_e, Up_e, geom):
    """The block's per-point inputs over the flat E*Q batch: each point's
    element coefficients (current and previous), shape functions,
    quadrature weight, measure and element size."""
    gradN = geom["per_elem"]["grad_N_phys"][0]          # (E, Q, nd, 3)
    E, Q, nd = gradN.shape[0], gradN.shape[1], gradN.shape[2]

    def per_point(a):
        return a[:, None].expand(E, Q, *a.shape[1:]).reshape(E * Q,
                                                             *a.shape[1:])

    N = geom["shared"]["N"][0]                           # (Q, nd)
    w = geom["shared"]["quad_w"]                         # (Q,)
    return (E, Q), (per_point(U_e), per_point(Up_e),
                    N[None].expand(E, Q, nd).reshape(E * Q, nd),
                    gradN.reshape(E * Q, nd, gradN.shape[3]),
                    w[None].expand(E, Q).reshape(E * Q),
                    geom["per_elem"]["iso_jac_det"].reshape(E * Q),
                    per_point(geom["per_elem"]["h"]))


def make_generic_block_kernels(gr, model, mode, local_solve=None) -> dict:
    """The ``{"block_R_and_K_and_xi", "block_R"}`` evaluators of ``model``
    in ``mode`` through ``gr``'s weak form, with the contract of
    ``fem/j2_block.py``: ``U_elem`` (E, nd, 3), ``f_ip`` the body force
    at the IPs (E, Q, 3) or None, ``xi_prev`` the AoS state (E, Q, nxi)
    in COUPLED mode (ignored in CLOSED_FORM, whose ``xi`` is None).
    COUPLED takes ``local_solve``, the
    :class:`~cmad_tpu_torch.models.nonlinear_solver.LocalSolve` of the
    model's residual in the element's coefficients, with ``aux = (U_prev,
    N, grad_N)`` (``GlobalResidual.point_fields``); it is returned as
    ``"local_solve"`` (its ``newton.log`` records iterations when set to
    a list)."""
    if gr.num_residuals != 1:
        raise NotImplementedError(
            "the generic block of a multi-field (mixed u-p) weak form is "
            "not ported yet: ROADMAP queue 1, item 22")
    residual_fn = gr._residual_fn
    coupled = mode == GlobalResidualMode.COUPLED

    def point_r(xi, xi_prev, params, U, U_prev, N, grad_N, w, dv, h):
        """One point's residual rows (nd, 3) of the single field."""
        shapes = [ShapeFunctionsAtIP(N=N, grad_N=grad_N)]
        return residual_fn(xi, xi_prev, params, [U], [U_prev], model, mode,
                           shapes, w, dv, h, 0)[0]

    def closed_r(params, U, U_prev, N, grad_N, w, dv, h):
        """The point's residual with the stress in closed form (the
        state slot is a zero the weak form does not read)."""
        xi0 = U.new_zeros(model.num_dofs)
        return point_r(xi0, xi0, params, U, U_prev, N, grad_N, w, dv, h)

    def with_value(f):
        """``f`` returning its value twice: the aux of ``jacfwd``, so the
        residual comes out of the tangent's own evaluation."""
        def g(*args):
            r = f(*args)
            return r, r
        return g

    cf_dims = (None, 0, 0, 0, 0, 0, 0, 0)
    closed_r_b = vmap(closed_r, in_dims=cf_dims)
    closed_k_b = vmap(jacfwd(with_value(closed_r), argnums=1,
                             has_aux=True), in_dims=cf_dims)
    cp_dims = (0, 0, None, 0, 0, 0, 0, 0, 0, 0)
    coupled_r_b = vmap(point_r, in_dims=cp_dims)
    coupled_k_b = vmap(jacfwd(with_value(point_r), argnums=(0, 3),
                              has_aux=True), in_dims=cp_dims)

    def _residual(R, pts, f_ip, E, Q):
        """The element residuals: each point's residual less its body
        force, summed over the element's points."""
        if f_ip is not None:
            N, w, dv = pts[2], pts[4], pts[5]
            R = R - (N[:, :, None] * f_ip.reshape(E * Q, 1, -1)
                     * w[:, None, None] * dv[:, None, None])
        return _sum_points(R, E, Q)

    def _state(params, pts, xi_prev):
        """The converged states (E*Q, nxi), their previous values, and
        the local solve's inputs besides the parameters."""
        U, aux = pts[0], pts[1:4]              # aux: (U_prev, N, grad_N)
        xi_p = xi_prev.reshape(U.shape[0], -1)
        x, x_prev = local_solve.unknowns(xi_p, params, U, aux)
        return x, x_prev, xi_p, (U, aux)

    def block_r_and_k_and_xi(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        (E, Q), pts = _points(U_e, Up_e, geom)
        if not coupled:
            K, R = closed_k_b(params, *pts)
            return _residual(R, pts, f_ip, E, Q), _sum_points(K, E, Q), None
        x, x_prev, xi_p, inputs = _state(params, pts, xi_prev)
        (dR_dxi, dR_dU), R = coupled_k_b(x, xi_p, params, *pts)
        dxi_dU = local_solve.tangent(x, x_prev, params, *inputs)
        K = dR_dU + torch.einsum("paix,pxbk->paibk", dR_dxi, dxi_dU)
        xi = local_solve.state(x, xi_p, params, *inputs)
        return (_residual(R, pts, f_ip, E, Q), _sum_points(K, E, Q),
                xi.reshape(E, Q, -1))

    def block_r(params, U_e, Up_e, geom, f_ip, t, xi_prev):
        (E, Q), pts = _points(U_e, Up_e, geom)
        if not coupled:
            return _residual(closed_r_b(params, *pts), pts, f_ip, E, Q)
        x, _x_prev, xi_p, _inputs = _state(params, pts, xi_prev)
        return _residual(coupled_r_b(x, xi_p, params, *pts), pts, f_ip,
                         E, Q)

    evaluators = {"block_R_and_K_and_xi": block_r_and_k_and_xi,
                  "block_R": block_r}
    if coupled:
        evaluators["local_solve"] = local_solve
    return evaluators
