"""Sparse linear solvers + embedded-BC enforcement.

Port of the CG arms of ``cmad_tpu/fem/sparse_solve.py`` (parity:
reference ``cmad/fem/sparse_solve.py``):

- :func:`lu_unique`: host SuperLU, the f64 truth arm (the K data and
  the right-hand side go to the host and the solution comes back), the
  JAX package's ``scipy_lu``;
- :func:`cg_unique`: Jacobi-preconditioned CG (``jax_cg``), or CG with
  the aggregation two-level preconditioner (``fem/two_level.py``,
  ``jax_cg_two_level``), both with the JAX package's periodic
  true-residual replacement. Both arms take the deduplicated CSR data;
  ``fem/nonlinear_solver.linear_solver`` picks one from the deck's
  settings;
- :func:`linear_solve` (:class:`LinearSolve`): ``x = K^-1 b`` through an
  arm, differentiable in K's data and in ``b`` to any order: the backward
  is the transpose solve through the same arm and the data's cotangent
  ``-lambda[row] x[col]`` on the pattern (the JAX package's
  ``custom_linear_solve`` transpose rule).

Embedded-BC form: prescribed rows AND columns zeroed with the assembled
diagonal kept at prescribed rows (block-diagonal ``K_ff | diag(K_ii)``);
the matching residual puts the dropped (free, prescribed) coupling back
on the RHS. Static structure lives in :class:`EmbeddedSparsity`, built
once per problem.

Every sum over a fixed pattern here is reproducible
(``ops/segment_sum.py``): the CSR dedup of the embedded-BC data and the
assembled diagonal are segment sums over plans built once per problem,
and the CG's sparse matrix-vector product is ``csr_matvec`` over the
pattern's :class:`~cmad_tpu_torch.ops.segment_sum.CsrPlan`, each row summed
in column order (the segment sum's tile path on the card, its plain
version on the CPU: the same bits). The JAX package computes these outside
any Pallas kernel; its node-block ELL form (``_node_block_ell``, a TPU
gather workaround) is not ported.

The CG loop is a Python loop: each iteration reads ``||r||^2`` on the
host to decide whether to stop (one device synchronization per
iteration), which keeps JAX's ``jax.scipy.sparse.linalg.cg`` semantics
exactly: stop once ``||r|| <= tol ||b||`` or after ``maxiter``
iterations, ``x0 = 0``. The GMRES and block arms, Chebyshev CG,
equilibration and the mixed-precision solves are not ported yet
(ROADMAP queue 1, items 13 and 22).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING

import numpy as np
import scipy.sparse
import scipy.sparse.linalg
import torch

from cmad_tpu_torch.ops.segment_sum import (
    CsrPlan,
    SegmentPlan,
    csr_plan,
    make_csr_matvec,
    plan_from_sorted,
    plan_from_target,
    segment_gather,
    segment_sum,
)
from cmad_tpu_torch.typing import Tensor

if TYPE_CHECKING:
    from cmad_tpu_torch.fem.fe_problem import FEProblem

_RR_CYCLES = 4  # residual-replacement cycles per CG solve


@dataclass(frozen=True)
class CooMatrix:
    """The assembled (deduplicated) global tangent: ``data`` on the
    fixed pattern ``(rows, cols)``, sorted by row then column, with
    ``row_plan`` the segment plan of its rows (its CSR row pointer)."""

    data: Tensor
    rows: Tensor
    cols: Tensor
    row_plan: SegmentPlan
    col_plan: SegmentPlan
    n: int

    def __matmul__(self, x: Tensor) -> Tensor:
        """``K x``, each row summed in column order; differentiable in
        ``data`` and ``x`` (the gather of ``x`` transposes to a segment
        sum over ``col_plan``, the pattern's columns)."""
        return segment_sum(self.data * segment_gather(x, self.col_plan),
                           self.row_plan)


# ----------------------------------------------------------------------
# sparsity caches
# ----------------------------------------------------------------------
@dataclass(frozen=True)
class EmbeddedSparsity:
    """Static CSR structure of the BC-enforced tangent.

    ``perm`` selects the kept positions of the runtime embedded-BC data
    buffer (assembled free-free entries + appended prescribed-diagonal
    entries) in lex (row, col) order; ``segment_ids`` dedups them, and
    ``dedup_plan`` is that sum's segment plan;
    ``csr`` is the unique CSR pattern (its row pointer and columns, the
    plan ``csr_matvec`` reads), ``col_indices`` and ``rows`` the column
    and row of each unique entry; ``diag_idx`` maps each row to its
    diagonal slot in the unique data; ``col_plan`` is the segment plan of
    the unique entries' columns (the gather ``x[col_indices]`` and its
    transpose); ``transpose`` maps each unique entry (r, c) to the slot of
    (c, r), so ``unique[transpose]`` is the data of the transposed matrix
    on the same (structurally symmetric) pattern. Tensors on the
    problem's device; ``indptr_np``/``col_indices_np`` are host copies for
    the host solve and the two-level setup.
    """

    perm: Tensor
    segment_ids: Tensor
    dedup_plan: SegmentPlan
    col_indices: Tensor
    rows: Tensor
    diag_idx: Tensor
    csr: CsrPlan
    col_plan: SegmentPlan
    transpose: Tensor
    indptr_np: np.ndarray
    col_indices_np: np.ndarray

    @property
    def num_unique(self) -> int:
        return int(self.col_indices.shape[0])

    @property
    def n(self) -> int:
        return self.csr.n


def build_embedded_sparsity(fe_problem: "FEProblem", rows: np.ndarray,
                            cols: np.ndarray) -> EmbeddedSparsity:
    """The embedded-BC CSR structure of the assembled pattern
    ``(rows, cols)`` (``assembly.assembled_coo_pattern``)."""
    presc = np.asarray(fe_problem.dof_map.prescribed_indices,
                       dtype=np.intp)
    n = fe_problem.dof_map.num_total_dofs
    n_assembled, n_presc = rows.shape[0], presc.shape[0]

    is_presc = np.zeros(n, dtype=bool)
    is_presc[presc] = True
    ff = np.flatnonzero(~is_presc[rows] & ~is_presc[cols]).astype(np.intp)
    appended = np.arange(n_assembled, n_assembled + n_presc, dtype=np.intp)
    kept = np.concatenate([ff, appended])

    full_rows = np.concatenate([rows, presc])
    full_cols = np.concatenate([cols, presc])
    kr, kc = full_rows[kept], full_cols[kept]
    order = np.lexsort((kc, kr))
    perm = kept[order]
    sr, sc = kr[order], kc[order]

    new = np.empty(sr.shape[0], dtype=bool)
    new[0] = True
    new[1:] = (sr[1:] != sr[:-1]) | (sc[1:] != sc[:-1])
    segment_ids = (np.cumsum(new) - 1).astype(np.intp)
    urows = sr[new]
    ucols = sc[new].astype(np.intp)
    indptr = np.searchsorted(urows, np.arange(n + 1),
                             side="left").astype(np.intp)

    diag_idx = np.full(n, -1, dtype=np.intp)
    dpos = np.flatnonzero(urows == ucols)
    diag_idx[urows[dpos]] = dpos
    if (diag_idx < 0).any():
        raise ValueError(
            f"row {int(np.flatnonzero(diag_idx < 0)[0])} lacks a diagonal "
            "entry in the BC-enforced sparsity; assembly must emit a "
            "(row, row) entry per dof")
    # (r, c) -> the slot of (c, r): sorting the entries by (col, row)
    # lists their transposes in (row, col) order
    transpose = np.empty(urows.shape[0], dtype=np.intp)
    transpose[np.lexsort((urows, ucols))] = np.arange(urows.shape[0])
    if not (np.array_equal(urows[transpose], ucols)
            and np.array_equal(ucols[transpose], urows)):
        raise ValueError("the BC-enforced sparsity is not structurally "
                         "symmetric")

    dev = fe_problem.device

    def on(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    return EmbeddedSparsity(
        perm=on(perm), segment_ids=on(segment_ids),
        dedup_plan=plan_from_sorted(perm, segment_ids, ucols.shape[0],
                                    n_assembled + n_presc, dev),
        col_indices=on(ucols), rows=on(urows), diag_idx=on(diag_idx),
        csr=csr_plan(indptr, ucols, dev),
        col_plan=plan_from_target(ucols, n, dev), transpose=on(transpose),
        indptr_np=indptr, col_indices_np=ucols)


# ----------------------------------------------------------------------
# operator construction + embedded BC
# ----------------------------------------------------------------------
def _csr_operator(K_data: Tensor, sparsity: EmbeddedSparsity):
    """(unique_data, matvec): dedup the embedded-BC data buffer into the
    cached CSR pattern and wrap the sparse product."""
    unique = segment_sum(K_data, sparsity.dedup_plan)
    return unique, make_csr_matvec(sparsity.csr, unique)


def _embedded_bc_enforce(K: CooMatrix, presc_idx: Tensor):
    """(K_data, K_ii_presc): zero prescribed rows+cols, append the
    assembled diagonal at prescribed positions (implicit indices are
    concatenate([assembled, (presc, presc)]))."""
    rows, cols = K.rows, K.cols
    p = torch.zeros(K.n, dtype=torch.bool, device=K.data.device)
    p[presc_idx] = True
    keep = ~(p[rows] | p[cols])
    K_ii = segment_sum(K.data * (rows == cols), K.row_plan)
    K_ii_presc = K_ii[presc_idx]
    return torch.cat([K.data * keep, K_ii_presc]), K_ii_presc


def _embedded_residual(R_assembled: Tensor, K: CooMatrix, U: Tensor,
                       presc_idx: Tensor, presc_vals: Tensor,
                       K_ii_presc: Tensor) -> Tensor:
    """Residual paired with the symmetric embedded form: free rows carry
    R + K[:, presc] (presc_vals - U[presc]); prescribed rows carry
    K_ii (U[presc] - presc_vals)."""
    bc_inc = torch.zeros_like(U)
    bc_inc[presc_idx] = presc_vals - U[presc_idx]
    r = R_assembled + K @ bc_inc
    r[presc_idx] = K_ii_presc * (U[presc_idx] - presc_vals)
    return r


# ----------------------------------------------------------------------
# direct solve (host)
# ----------------------------------------------------------------------
def lu_unique(unique: Tensor, sparsity: EmbeddedSparsity,
              b: Tensor) -> Tensor:
    """Host sparse-direct solve (SuperLU through ``spsolve``) of the
    matrix with deduplicated CSR data ``unique``, on the device of ``b``.
    Outside autograd; the differentiable solve is :func:`linear_solve`."""
    K = scipy.sparse.csr_matrix(
        (unique.detach().cpu().numpy(), sparsity.col_indices_np,
         sparsity.indptr_np), shape=(sparsity.n, sparsity.n))
    x = scipy.sparse.linalg.spsolve(K, b.detach().cpu().numpy())
    return torch.as_tensor(np.asarray(x), dtype=b.dtype, device=b.device)


# ----------------------------------------------------------------------
# CG
# ----------------------------------------------------------------------
def _cg(matvec, precon, b: Tensor, tol, maxiter: int):
    """Preconditioned CG from ``x0 = 0`` with the semantics of
    ``jax.scipy.sparse.linalg.cg`` (the "non-legacy" scipy tolerance):
    iterate while ``r.r > tol^2 b.b`` and fewer than ``maxiter``
    iterations ran. Returns ``(x, iterations)``."""
    atol2 = tol * tol * (b @ b)
    x = torch.zeros_like(b)
    r = b
    z = precon(r)
    p = z
    gamma = r @ z
    k = 0
    while k < maxiter and bool(r @ r > atol2):  # one host sync
        Ap = matvec(p)
        alpha = gamma / (p @ Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = precon(r)
        gamma_new = r @ z
        p = z + (gamma_new / gamma) * p
        gamma = gamma_new
        k += 1
    return x, k


def _cg_residual_replacement(matvec, precon, rhs: Tensor, rtol,
                             max_iters: int | None,
                             stats: dict | None = None) -> Tensor:
    """CG with periodic TRUE-residual replacement: up to ``_RR_CYCLES``
    cycles, each a CG solve of ``rhs - A x`` with ``max_iters //
    _RR_CYCLES`` iterations (``max_iters`` None: ``10 n``), until the
    true relative residual meets ``rtol``. Appends the solve's total CG
    iterations to ``stats["cg_iters"]`` when given."""
    if max_iters is None:
        max_iters = 10 * rhs.shape[0]
    m = max(1, int(max_iters) // _RR_CYCLES)
    rhs_norm = torch.linalg.norm(rhs)
    x = torch.zeros_like(rhs)
    rel = float("inf")
    cycles = iters = 0
    while cycles < _RR_CYCLES and rel > float(rtol):
        dx, k = _cg(matvec, precon, rhs - matvec(x), rtol, m)
        x = x + dx
        rel = float(torch.linalg.norm(rhs - matvec(x)) / rhs_norm)
        cycles += 1
        iters += k
    if stats is not None:
        stats.setdefault("cg_iters", []).append(iters)
    return x


def cg_unique(unique: Tensor, sparsity: EmbeddedSparsity, b: Tensor,
              rtol: float, max_iters: int | None, stats: dict | None,
              pattern=None) -> Tensor:
    """CG on the deduplicated CSR data ``unique``: Jacobi-preconditioned,
    or two-level when ``pattern`` (``fem/two_level.py``) is given. SPD K;
    outside autograd."""
    unique = unique.detach()
    matvec = make_csr_matvec(sparsity.csr, unique)
    diag = unique[sparsity.diag_idx]
    if pattern is None:
        def precon(x):
            return x / diag
    else:
        from cmad_tpu_torch.fem.two_level import (
            make_two_level_preconditioner,
        )

        precon = make_two_level_preconditioner(
            pattern, unique, sparsity.rows, sparsity.col_indices, diag)
    return _cg_residual_replacement(matvec, precon, b, rtol, max_iters,
                                    stats)


# ----------------------------------------------------------------------
# the differentiable solve
# ----------------------------------------------------------------------
class LinearSolve(torch.autograd.Function):
    """``x = LinearSolve.apply(unique, b, sparsity, solve)``: ``x = K^-1
    b`` for the matrix with deduplicated CSR data ``unique`` on the fixed
    pattern of ``sparsity``; ``solve(unique, b)`` is the arm (direct, CG,
    two-level CG) and runs outside autograd.

    The backward is the transpose solve through the same arm, ``K^T
    lambda = x_bar``, and the data's cotangent ``-lambda[row] x[col]`` on
    the pattern, both written with differentiable operations (this
    Function again, and the plans' gathers), so the solve has second
    derivatives: the implicit-function rule's transpose solve is
    differentiable, and a Hessian flows through it."""

    @staticmethod
    def forward(ctx, unique: Tensor, b: Tensor, sparsity: EmbeddedSparsity,
                solve) -> Tensor:
        x = solve(unique, b)
        ctx.sparsity, ctx.solve = sparsity, solve
        ctx.save_for_backward(unique, x)
        return x

    @staticmethod
    def backward(ctx, x_bar: Tensor):
        unique, x = ctx.saved_tensors
        sp = ctx.sparsity
        lam = linear_solve(unique[sp.transpose], x_bar, sp, ctx.solve)
        unique_bar = -(segment_gather(lam, sp.csr.rows)
                       * segment_gather(x, sp.col_plan))
        return unique_bar, lam, None, None


def linear_solve(unique: Tensor, b: Tensor, sparsity: EmbeddedSparsity,
                 solve) -> Tensor:
    """``K^-1 b`` through ``solve(unique, b)``, differentiable in the CSR
    data ``unique`` and in ``b`` to any order (:class:`LinearSolve`)."""
    if torch.is_grad_enabled() and (unique.requires_grad
                                    or b.requires_grad):
        return LinearSolve.apply(unique, b, sparsity, solve)
    return solve(unique, b)
