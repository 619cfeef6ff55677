"""Local (material-point) Newton solvers with implicit-function AD.

Port of ``cmad_tpu/models/nonlinear_solver.py`` (parity: reference
``cmad/models/nonlinear_solver.py:14,88,158``). ``make_newton_solve``
wraps a damped Newton in an ``autograd.Function`` whose rules implement
the implicit function theorem at the converged state:

    r(x*, args) = 0  =>  dx*/dargs = -(dr/dx)^{-1} (dr/dargs)

so gradients of anything downstream flow through converged solves
without differentiating the iteration. ``backward`` is written in
differentiable torch ops, so it nests (double backward, Hessians).

The JAX package wrote one point's solve as a ``lax.while_loop`` and
``vmap``-ed it; under ``vmap`` every lane stops at its own convergence
and keeps its carry once done. A Python loop cannot be ``vmap``-ed, so
here the batch is explicit: the residual is written for one point and
evaluated as ``vmap(residual)``, its Jacobian as
``vmap(jacfwd(residual))``, and each point has its own ``norm0``,
tolerances test, line-search ``alpha`` and iteration count. A point's
state is updated only while it is unconverged; the loop ends when every
point has converged or ``max_iters`` is reached. So every point gets the
result of its own unbatched solve.

The state ``x`` is a flat tensor (the models' ``xi``). The per-point
linear systems go to batched ``torch.linalg.solve``; the one-hot
Gauss-Jordan ``solve_dense`` of the JAX package worked around the TPU's
slow batched LU and is not ported.
"""
from __future__ import annotations

from collections.abc import Callable
from typing import Any

import numpy as np
import torch
import torch.utils._pytree as pytree
from torch.func import jacfwd, vmap

from cmad_tpu_torch import config
from cmad_tpu_torch.typing import Tensor
from cmad_tpu_torch.util.line_search import (
    DEFAULT_LINE_SEARCH_SETTINGS,
    line_search,
)


class _Newton:
    """A damped Newton on ``residual(x, *args) = 0`` over a batch of
    points: ``x0`` is (B, n); ``in_dims`` gives, per argument, its batch
    axis or None for an argument shared by every point (pytree prefixes,
    as for ``torch.func.vmap``)."""

    def __init__(self, residual, in_dims, max_iters, abs_tol, rel_tol,
                 line_search_settings, print_local_convergence=False,
                 graphs: dict | None = None):
        self.r_b = vmap(residual, in_dims=(0, *in_dims))
        self.j_b = vmap(jacfwd(residual, argnums=0), in_dims=(0, *in_dims))
        # with a dict, the CUDA graphs of r_b and j_b, keyed by their
        # inputs' structure (see evaluators)
        self.graphs = graphs
        self.max_iters = max_iters
        self.abs_tol, self.rel_tol = abs_tol, rel_tol
        self.ls = {**DEFAULT_LINE_SEARCH_SETTINGS,
                   **(line_search_settings or {})}
        self.print = print_local_convergence
        # when a list, each call appends (iterations of its slowest point,
        # the sum of every point's iterations as a 0-d tensor, points)
        self.log: list | None = None

    def tols(self, dtype: torch.dtype) -> tuple[float, float]:
        d_abs, d_rel = config.newton_tols("mp_local", dtype)
        return (d_abs if self.abs_tol is None else self.abs_tol,
                d_rel if self.rel_tol is None else self.rel_tol)

    def evaluators(self, x: Tensor, args: tuple):
        """``(r_of(x), j_of(x))``: the residual and its Jacobian at ``x``
        with ``args`` fixed. On a CUDA tensor with ``graphs`` set they
        replay CUDA graphs of ``r_b`` and ``j_b`` (:class:`_CudaGraph`,
        captured at the first call with inputs of this structure): the
        same kernels without the host's eager dispatch of each, which
        sets the pace of a single point's Newton. Otherwise they are
        ``r_b`` and ``j_b``."""
        if self.graphs is None or not x.is_cuda:
            return (lambda y: self.r_b(y, *args),
                    lambda y: self.j_b(y, *args))
        spec = _Args(args)
        key = (x.shape, x.dtype, spec.key())
        if key not in self.graphs:
            self.graphs[key] = tuple(
                _CudaGraph(lambda y, *lv, f=f: f(y, *spec(lv)),
                           [x, *spec.tensors])
                for f in (self.r_b, self.j_b))
        r_g, j_g = self.graphs[key]
        return (lambda y: r_g(y, *spec.tensors),
                lambda y: j_g(y, *spec.tensors))

    def __call__(self, x0: Tensor, args: tuple) -> tuple[Tensor, Tensor,
                                                          Tensor]:
        """(x*, iterations, final ||r||), each per point."""
        abs_tol, rel_tol = self.tols(x0.dtype)
        r_of, j_of = self.evaluators(x0, args)
        x = x0
        r = r_of(x)
        norm0 = torch.linalg.vector_norm(r, dim=-1)
        iters = torch.zeros(x.shape[:1], dtype=torch.int64, device=x.device)
        done = 0
        for k in range(self.max_iters):
            norm = torch.linalg.vector_norm(r, dim=-1)
            live = ~((norm < abs_tol) | (norm / norm0 < rel_tol))
            if not bool(live.any()):
                break
            done = k + 1
            if self.print:
                print(f"  ({k + 1}) abs ||C|| = {float(norm.max()):.6e} "
                      f"rel ||C|| = {float((norm / norm0).max()):.6e}")
            J = j_of(x)
            dx = torch.linalg.solve_ex(J, r.unsqueeze(-1))[0].squeeze(-1)

            def probe(alpha, x=x, dx=dx):
                r_trial = r_of(x - alpha[:, None] * dx)
                return 0.5 * (r_trial * r_trial).sum(-1), None, r_trial

            rr = (r * r).sum(-1)
            # a converged point's step is discarded: it must not keep
            # the search going (in the JAX package's vmapped loop it did,
            # with the same result for every point)
            alpha, r_next = line_search(probe, 0.5 * rr, -rr, self.ls, r,
                                        active=live)
            x = torch.where(live[:, None], x - alpha[:, None] * dx, x)
            r = torch.where(live[:, None], r_next, r)
            iters = iters + live
        if self.log is not None:
            self.log.append((done, iters.sum(), int(iters.shape[0])))
        return x, iters, torch.linalg.vector_norm(r, dim=-1)


class _Args:
    """Rebuilds a solve's ``args`` from its tensor leaves: the pytree
    spec and the leaves that are not tensors (plain numbers)."""

    def __init__(self, args: tuple):
        leaves, self.spec = pytree.tree_flatten(args)
        self.consts = [None if isinstance(v, Tensor) else v for v in leaves]
        self.tensors = [v for v in leaves if isinstance(v, Tensor)]

    def __call__(self, tensors) -> tuple:
        it = iter(tensors)
        leaves = [next(it) if c is None else c for c in self.consts]
        return pytree.tree_unflatten(leaves, self.spec)

    def key(self) -> tuple:
        """The structure the args' values fill: the spec, the plain
        numbers, and each tensor's shape and dtype."""
        return (str(self.spec), repr(self.consts),
                tuple((t.shape, t.dtype) for t in self.tensors))


class _CudaGraph:
    """``fn(*inputs)`` (CUDA tensors in, one tensor out) captured once in
    a CUDA graph. A call copies its inputs into the captured ones,
    replays the graph and returns a copy of the captured output: the
    same kernels as an eager call of ``fn``, launched without the host's
    per-operation dispatch. ``fn`` must not read anything back to the
    host (the model residuals are written so). Primal only: it runs
    under ``no_grad``."""

    def __init__(self, fn, inputs) -> None:
        with torch.no_grad():
            self._in = [t.detach().clone() for t in inputs]
            # warm up on a side stream, as capture requires
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                fn(*self._in)
            torch.cuda.current_stream().wait_stream(side)
            self._graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(self._graph):
                self._out = fn(*self._in)

    def __call__(self, *inputs) -> Tensor:
        with torch.no_grad():
            for held, t in zip(self._in, inputs, strict=True):
                held.copy_(t)
            self._graph.replay()
            return self._out.clone()


class _ImplicitSolve(torch.autograd.Function):
    """``x* = solve(x0, args)`` with the implicit-function rules. Every
    tensor leaf of ``args`` is its own input of ``apply`` (a closure
    would hide it from autograd); ``spec`` (an :class:`_Args`) rebuilds
    ``args`` from them. The guess ``x0`` gets no gradient: the solution
    does not depend on it."""

    @staticmethod
    def forward(x0, newton, spec, *leaves):
        x, _iters, _norm = newton(x0, spec(leaves))
        # a batch converged at its guess returns the guess itself, which
        # autograd may not save as an output
        return x.clone() if x is x0 else x

    @staticmethod
    def setup_context(ctx, inputs, output):
        _x0, newton, spec, *leaves = inputs
        ctx.newton, ctx.spec = newton, spec
        ctx.save_for_backward(output, *leaves)
        ctx.save_for_forward(output, *leaves)

    @staticmethod
    def backward(ctx, x_bar):
        x_star, *leaves = ctx.saved_tensors
        newton, spec = ctx.newton, ctx.spec
        want = [i for i, need in enumerate(ctx.needs_input_grad[3:])
                if need]
        grads: list[Tensor | None] = [None] * len(leaves)
        if want:
            # a first-order backward may replay the Newton's graph; one
            # that builds a graph (create_graph) differentiates j_b itself
            A = (newton.j_b(x_star, *spec(leaves)) if torch.is_grad_enabled()
                 else newton.evaluators(x_star, spec(leaves))[1](x_star))
            lam = torch.linalg.solve(A.mT, x_bar.unsqueeze(-1)).squeeze(-1)

            def r_of(*chosen):
                lv = list(leaves)
                for i, t in zip(want, chosen, strict=True):
                    lv[i] = t
                return newton.r_b(x_star, *spec(lv))

            _, vjp_fn = torch.func.vjp(r_of, *(leaves[i] for i in want))
            for i, g in zip(want, vjp_fn(-lam), strict=True):
                grads[i] = g
        return (None, None, None, *grads)

    @staticmethod
    def jvp(ctx, _x0_dot, _newton_dot, _spec_dot, *leaf_dots):
        x_star, *leaves = ctx.saved_tensors
        newton, spec = ctx.newton, ctx.spec
        args = spec(leaves)
        dots = tuple(torch.zeros_like(t) if d is None else d
                     for t, d in zip(leaves, leaf_dots, strict=True))

        def r_of(*lv):
            return newton.r_b(x_star, *spec(lv))

        _, b = torch.func.jvp(r_of, tuple(leaves), dots)
        A = newton.j_b(x_star, *args)
        return -torch.linalg.solve(A, b.unsqueeze(-1)).squeeze(-1)


def _in_dims(in_dims, args) -> tuple:
    return (None,) * len(args) if in_dims is None else tuple(in_dims)


def make_newton_solve(
        residual: Callable[..., Tensor],
        max_iters: int = 10,
        abs_tol: float | None = None,
        rel_tol: float | None = None,
        print_local_convergence: bool = False,
        line_search_settings: dict[str, Any] | None = None,
        in_dims: tuple | None = None,
        cuda_graphs: bool = False,
) -> Callable[..., Tensor]:
    """Newton solve of ``residual(x, *args) = 0`` from guess ``x0``.

    Returns ``solve(x0, *args) -> x*``, differentiable in ``args`` by
    the implicit-function rules (``backward`` and ``jvp``; zero
    derivative with respect to the guess). ``residual`` is written for
    one point with a flat state ``x``. With ``in_dims=None`` the call
    solves one point (``x0: (n,)``); with a tuple, ``x0`` is ``(B, n)``
    and ``in_dims`` gives each argument's batch axis (None = shared),
    as ``jax.vmap(solve, in_axes=(0, *in_dims))`` did in the JAX
    package. Default tolerances come from ``config.newton_tols`` for the
    dtype of ``x0``. With ``cuda_graphs``, a solve on the card replays
    CUDA graphs of the residual and its Jacobian, captured once per
    structure of the inputs and kept by this solver
    (:meth:`_Newton.evaluators`); the material-point commands use it.
    """
    graphs: dict | None = {} if cuda_graphs else None

    def solve(x0: Tensor, *args) -> Tensor:
        single = in_dims is None
        newton = _Newton(residual, _in_dims(in_dims, args), max_iters,
                         abs_tol, rel_tol, line_search_settings,
                         print_local_convergence, graphs)
        spec = _Args(args)
        x = _ImplicitSolve.apply(x0[None] if single else x0, newton, spec,
                                 *spec.tensors)
        return x[0] if single else x

    return solve


class LocalSolve:
    """A material point's local problem with its driving input as an
    explicit input, solved over a batch of points, and the tangent of
    its solution in that input.

    ``residual(x, x_prev, params, g, *aux)`` is one point's residual in
    its unknowns ``x`` (n,). ``g`` is the input the tangent is taken in:
    the symmetric strain rows [xx, xy, xz, yy, yz, zz] the small-strain
    models read (the increment in the rate form, the total strain in the
    total form), for the point-batch block; the element's displacement
    coefficients (nd, 3), for the generic per-point block. ``aux`` are
    ``n_aux`` further per-point inputs the tangent is not taken in (the
    previous coefficients and the shape functions). ``reduce(xi_prev)``
    picks what the residual reads of one point's previous state as
    ``x_prev``: the unknowns' previous values, which also seed the Newton,
    or, with ``seed``, anything (the reduced principal and Hill solves
    take the whole state, since their trial state depends on all of it),
    and ``seed(x_prev, params, g, *aux)`` then gives the Newton's start.
    ``expand(x, xi_prev, params, g, *aux)`` rebuilds the state. A trial
    state the residual needs is computed inside it from ``x_prev``,
    ``params`` and ``g``: :meth:`tangent` differentiates the residual in
    ``g`` alone, so a trial passed in as ``aux`` would lose its part of
    ``dx/dg``. Calls are batched: ``xi_prev`` (B, nxi), ``g``
    (B, ...), each ``aux`` (B, ...) and ``params`` shared by every
    point. The parameters, the previous state, ``g`` and ``aux`` are each
    inputs of the implicit solve (:class:`_ImplicitSolve`), never
    captured, so gradients reach all of them. ``newton.log``, when set to
    a list, records each solve's iterations (:class:`_Newton`); with
    ``print_local_convergence`` each iteration prints its largest
    residual norms.
    """

    def __init__(self, residual, reduce, expand, max_iters: int = 10,
                 abs_tol: float | None = None, rel_tol: float | None = None,
                 line_search_settings: dict[str, Any] | None = None,
                 print_local_convergence: bool = False, n_aux: int = 0,
                 seed=None):
        self.residual, self.reduce, self.expand = residual, reduce, expand
        dims = (0, None, 0, *(0,) * n_aux)
        self.newton = _Newton(residual, dims, max_iters, abs_tol,
                              rel_tol, line_search_settings,
                              print_local_convergence)
        self._reduce_b = vmap(reduce)
        self._seed_b = None if seed is None else vmap(seed, in_dims=dims)
        self._expand_b = vmap(expand, in_dims=(0, *dims))
        self._dr_dg_b = vmap(jacfwd(residual, argnums=3),
                             in_dims=(0, *dims))

    def unknowns(self, xi_prev: Tensor, params, g: Tensor, *aux
                 ) -> tuple[Tensor, Tensor]:
        """``(x*, x_prev)``: the converged unknowns (B, n) and what
        ``reduce`` read of the previous state (their previous values, or
        the whole state when the solve has a ``seed``)."""
        x_prev = self._reduce_b(xi_prev)
        spec = _Args((x_prev, params, g, *aux))
        return _ImplicitSolve.apply(self._start(x_prev, params, g, *aux),
                                    self.newton, spec, *spec.tensors), x_prev

    def _start(self, x_prev: Tensor, params, g: Tensor, *aux) -> Tensor:
        if self._seed_b is None:
            return x_prev
        with torch.no_grad():
            return self._seed_b(x_prev, params, g, *aux)

    def state(self, x: Tensor, xi_prev: Tensor, params, g: Tensor, *aux
              ) -> Tensor:
        """The states (B, nxi) of the unknowns ``x``."""
        return self._expand_b(x, xi_prev, params, g, *aux)

    def __call__(self, xi_prev: Tensor, params, g: Tensor, *aux) -> Tensor:
        x, _x_prev = self.unknowns(xi_prev, params, g, *aux)
        return self.state(x, xi_prev, params, g, *aux)

    def iterations(self, xi_prev: Tensor, params, g: Tensor, *aux
                   ) -> Tensor:
        """Each point's Newton iterations (B,), for diagnostics: the same
        solve, primal only."""
        x_prev = self._reduce_b(xi_prev)
        with torch.no_grad():
            return self.newton(self._start(x_prev, params, g, *aux),
                               (x_prev, params, g, *aux))[1]

    def tangent(self, x: Tensor, x_prev: Tensor, params, g: Tensor,
                *aux) -> Tensor:
        """``dx*/dg`` (B, n, *g.shape[1:]) at converged unknowns by the
        implicit-function rule, ``-(dr/dx)^-1 dr/dg``: one batched solve
        with a right-hand side per entry of ``g``, in differentiable
        ops."""
        A = self.newton.j_b(x, x_prev, params, g, *aux)
        b = self._dr_dg_b(x, x_prev, params, g, *aux)
        B, n = b.shape[0], b.shape[1]
        return -torch.linalg.solve(A, b.reshape(B, n, -1)).reshape(b.shape)


def make_newton_solve_with_stats(
        residual: Callable[..., Tensor],
        max_iters: int = 10,
        abs_tol: float | None = None,
        rel_tol: float | None = None,
        line_search_settings: dict[str, Any] | None = None,
        in_dims: tuple | None = None,
        cuda_graphs: bool = False,
) -> Callable[..., tuple[Tensor, Tensor, Tensor]]:
    """Newton returning ``(x*, iters, final_norm)``, per point when
    batched (``in_dims`` and ``cuda_graphs`` as in
    :func:`make_newton_solve`).

    Primal only, for solver diagnostics: it runs under ``no_grad`` and
    its results carry no gradient. Use :func:`make_newton_solve` for AD.
    """
    graphs: dict | None = {} if cuda_graphs else None

    def solve(x0: Tensor, *args):
        single = in_dims is None
        newton = _Newton(residual, _in_dims(in_dims, args), max_iters,
                         abs_tol, rel_tol, line_search_settings,
                         graphs=graphs)
        with torch.no_grad():
            x, iters, norm = newton(x0[None] if single else x0, args)
        if single:
            return x[0], iters[0], norm[0]
        return x, iters, norm

    return solve


def batched_newton_solve(
        residual: Callable[..., Tensor],
        x0_batch: Tensor,
        *args_batch,
        in_axes=0,
        **newton_kwargs,
) -> Tensor:
    """Structure-of-arrays Newton over a point batch.

    ``residual`` is the per-point residual; ``x0_batch`` is ``(B, n)``;
    ``in_axes`` is one batch axis for every argument or a tuple, one per
    argument (None = shared). Each point converges on its own.
    """
    if isinstance(in_axes, tuple):
        dims = in_axes
    else:
        dims = (in_axes,) * len(args_batch)
    solver = make_newton_solve(residual, in_dims=dims, **newton_kwargs)
    return solver(x0_batch, *args_batch)


def newton_solve(
        model, xi: Tensor, xi_prev: Tensor, params, U, U_prev,
        max_iters: int = 10,
        abs_tol: float | None = None,
        rel_tol: float | None = None,
        max_ls_evals: int = 0,
) -> tuple[Tensor, int, float]:
    """Imperative host-side Newton on one point's flat state.

    Functional replacement for the reference's mutable seed/evaluate Newton
    (``cmad/models/nonlinear_solver.py:14-85``): takes explicit state,
    returns ``(xi_solved, iters, ||C||)`` for solver logging.
    """
    d_abs, d_rel = config.newton_tols("mp_local", xi.dtype)
    abs_tol = d_abs if abs_tol is None else abs_tol
    rel_tol = d_rel if rel_tol is None else rel_tol

    def host(t: Tensor) -> np.ndarray:
        return t.detach().cpu().numpy()

    def step(d: np.ndarray) -> Tensor:
        return torch.as_tensor(d, dtype=xi.dtype, device=xi.device)

    beta, eta = 1e-4, 0.5
    norm0 = 1.0
    norm = 0.0
    it = 0

    while it < max_iters:
        C = host(model.C(xi, xi_prev, params, U, U_prev))
        norm = float(np.linalg.norm(C))
        if it == 0:
            norm0 = norm if norm > 0.0 else 1.0
        if norm / norm0 < rel_tol or norm < abs_tol:
            break

        J = host(model.jac_xi(xi, xi_prev, params, U, U_prev))
        dxi = np.linalg.solve(J, -C)
        xi = xi + step(dxi)

        if max_ls_evals > 0:
            psi_0 = 0.5 * norm**2
            psi_deriv = -2.0 * psi_0
            alpha = 1.0
            C_j = host(model.C(xi, xi_prev, params, U, U_prev))
            psi_j = 0.5 * float(np.linalg.norm(C_j)) ** 2
            evals = 1
            while psi_j >= (1.0 - 2.0 * beta * alpha) * psi_0 \
                    and evals < max_ls_evals:
                alpha_prev = alpha
                denom = 2.0 * (psi_j - psi_0 - alpha * psi_deriv)
                alpha = max(eta * alpha, -(alpha**2 * psi_deriv) / denom)
                xi = xi + step((alpha - alpha_prev) * dxi)
                C_j = host(model.C(xi, xi_prev, params, U, U_prev))
                psi_j = 0.5 * float(np.linalg.norm(C_j)) ** 2
                evals += 1
        it += 1

    return xi, it, norm
