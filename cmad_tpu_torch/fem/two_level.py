"""Two-level (aggregation + rigid-body coarse space) preconditioner.

Port of the single-field CG arm of ``cmad_tpu/fem/two_level.py``, the
device-native replacement for the reference's pyamg smoothed-aggregation
arm:

- **Setup (host, numpy, once per problem):** nodes are binned into
  coordinate aggregates; each aggregate carries the 6 rigid-body modes
  centered at its centroid (the near-null space of 3D elasticity — the
  low-energy modes one-level smoothers cannot damp). Prescribed
  Dirichlet rows are zeroed. The result is the tentative prolongator P
  with a fixed 6-wide block per dof row, stored as
  ``(P_vals (n_dofs, 6), agg_of_dof (n_dofs,))``, with the sorted plan of
  the coarse contraction for the fine CSR pattern
  (:func:`attach_coarse_scatter`).
- **Per solve (device):** the coarse operator A_c = P^T K P is contracted
  from K's deduped COO (one w*w outer product per nonzero, reduced by
  coarse pair), diagonally equilibrated with near-null columns deflated,
  a ridge of 10 eps added, and factored once by Cholesky; up to
  ``_EXPLICIT_INVERSE_CEILING`` coarse dofs the inverse is materialized.
  Each application is ``z = D^-1 r + P A_c^-1 P^T r`` (additive
  smoother + coarse correction).

The restriction ``P^T r`` (every CG iteration) and the coarse matrix's
per-pair sums are segment sums over plans of the fixed aggregation
(``ops/segment_sum.py``: the block path's ``segment_sum_block`` and the
fused ``coarse_pair_sum`` on the card), reproducible from run to run; the
coarse pairs are distinct, so their blocks are placed into the dense
matrix by a plain write. The dense Cholesky is ``torch.linalg.cholesky``
(cuSOLVER on the card); the JAX package computes it outside any Pallas
kernel too. The mixed
u-p pattern, the node-block smoother and the LU (GMRES) arm are not
ported yet (ROADMAP queue 1, item 22).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from cmad_tpu_torch.ops.segment_sum import (
    coarse_pair_sum,
    plan_from_sorted,
    plan_from_target,
    segment_sum,
)
from cmad_tpu_torch.typing import Tensor

# the coarse operator is materialized dense (m, m); past this ceiling
# the setup cost/footprint stops being "free" next to the fine-level
# work. Pattern builders auto-coarsen the aggregation to stay under it;
# coarse_matrix raises as the backstop for hand-built patterns.
DENSE_COARSE_CEILING = 24000

# materialize the coarse inverse (apply = one matmul instead of two
# triangular solves) up to this coarse dimension
_EXPLICIT_INVERSE_CEILING = 4096

_NULL_COL_REL = 1e-8   # relative diagonal floor below which a coarse
                       # column is deflated (dropped) instead of scaled


@dataclass
class TwoLevelPattern:
    """Host (numpy) carrier for the tentative prolongator and the sorted
    plan of its coarse contraction (:func:`attach_coarse_scatter`), with
    a cache of their device copies (:meth:`on`)."""

    P_vals: np.ndarray       # (n_dofs, w)
    agg_of_dof: np.ndarray   # (n_dofs,) int32
    num_aggregates: int
    coarse_order: np.ndarray   # (nnz,) int32
    coarse_seg: np.ndarray     # (nnz,) int32, sorted
    coarse_pI: np.ndarray      # (n_pairs,) int32
    coarse_pJ: np.ndarray      # (n_pairs,) int32
    _device_copies: dict = field(default_factory=dict, init=False,
                                 repr=False, compare=False)

    @property
    def width(self) -> int:
        return int(self.P_vals.shape[1])

    @property
    def coarse_dim(self) -> int:
        return self.width * self.num_aggregates

    def on(self, device: torch.device, dtype: torch.dtype) -> dict:
        """The pattern's arrays as tensors on ``device`` (cached), with the
        segment plans of the restriction (``agg_plan``: dofs into
        aggregates) and of the coarse contraction (``pair_plan``: the
        sorted fine nonzeros into coarse pairs)."""
        key = (str(device), dtype)
        if key not in self._device_copies:
            def idx(a):
                return torch.as_tensor(np.asarray(a, dtype=np.int64),
                                       device=device)
            self._device_copies[key] = {
                "P_vals": torch.as_tensor(self.P_vals, dtype=dtype,
                                          device=device),
                "agg_of_dof": idx(self.agg_of_dof),
                "order": idx(self.coarse_order),
                "pI": idx(self.coarse_pI), "pJ": idx(self.coarse_pJ),
                "agg_plan": plan_from_target(self.agg_of_dof,
                                             self.num_aggregates, device),
                "pair_plan": plan_from_sorted(
                    None, self.coarse_seg, self.coarse_pI.shape[0],
                    self.coarse_seg.shape[0], device)}
        return self._device_copies[key]


def build_two_level_pattern(coords: np.ndarray,
                            prescribed_indices: np.ndarray,
                            n_dofs: int,
                            indptr: np.ndarray,
                            col_indices: np.ndarray,
                            target_nodes_per_aggregate: int = 48,
                            dtype=np.float64) -> TwoLevelPattern:
    """Aggregate nodes by coordinate binning, attach centered rigid-body
    blocks, and plan the coarse contraction for the fine CSR pattern
    ``(indptr, col_indices)``.

    Supports the interleaved single-displacement-field layout
    (``dof = 3 * node + component``); callers must check
    ``n_dofs == 3 * coords.shape[0]``.
    """
    n_nodes = coords.shape[0]
    if n_dofs != 3 * n_nodes:
        raise ValueError(
            "two-level preconditioner supports the single displacement "
            f"field layout (3 dofs/node); got n_dofs={n_dofs} for "
            f"{n_nodes} nodes")

    agg_of_node, n_aggs = _aggregate_nodes_capped(
        coords, target_nodes_per_aggregate, width=6)
    B = _centered_rbm_blocks(coords, agg_of_node, n_aggs, dtype)

    P_vals = B.reshape(n_nodes * 3, 6)
    agg_of_dof = np.repeat(agg_of_node, 3).astype(np.int32)
    _normalize_and_mask(P_vals, agg_of_dof, n_aggs, prescribed_indices)
    return TwoLevelPattern(
        P_vals, agg_of_dof, n_aggs,
        *attach_coarse_scatter(agg_of_dof, n_aggs, indptr, col_indices))



def _aggregate_nodes_capped(coords: np.ndarray, target: int, width: int):
    """Aggregate, auto-coarsening so the dense coarse space fits
    :data:`DENSE_COARSE_CEILING`: a 1M-node mesh at the default 48
    nodes/aggregate would ask for a 125k-dof dense coarse factorization
    (60+ GB). Bumping nodes/aggregate keeps the preconditioner working
    (iteration counts degrade gracefully with aggregate size) instead of
    failing; a warning records the effective value. The retry loop is
    needed because the box binning only lands near its requested count
    (axis rounding can overshoot by ~25%)."""
    import warnings

    max_aggs = max(1, DENSE_COARSE_CEILING // width)
    agg_of_node, n_aggs = _aggregate_nodes(coords, target)
    if n_aggs <= max_aggs:
        return agg_of_node, n_aggs
    fitted = target
    while n_aggs > max_aggs:
        fitted = max(fitted + 1, int(fitted * n_aggs / max_aggs * 1.1))
        agg_of_node, n_aggs = _aggregate_nodes(coords, fitted)
    warnings.warn(
        f"two-level: {coords.shape[0]} nodes at {target} "
        f"nodes/aggregate would overflow the {DENSE_COARSE_CEILING}-dof "
        f"dense coarse ceiling; using {fitted} nodes/aggregate "
        f"({n_aggs * width} coarse dofs) — set 'aggregate nodes' "
        "explicitly to tune", stacklevel=3)
    return agg_of_node, n_aggs


def _aggregate_nodes(coords: np.ndarray, target: int):
    """Regular bounding-box binning -> (agg_of_node, n_aggs).

    Axes whose span is negligible relative to the largest (near-planar /
    near-linear meshes) get a single bin: normalizing by a ~0 span would
    blow the per-axis division counts up by ~1e10, overflow the flat bin
    id, and silently merge far-apart nodes into one aggregate.
    """
    n_nodes = coords.shape[0]
    n_aggs_target = max(1, n_nodes // target)
    lo, hi = coords.min(axis=0), coords.max(axis=0)
    span = hi - lo
    max_span = max(span.max(), 1e-30)
    active = span > 1e-9 * max_span
    n_active = int(active.sum())
    divs = np.ones(3, dtype=int)
    if n_active:
        rel = np.where(active, span / max_span, 0.0)
        geo = rel[active].prod() ** (1.0 / n_active)
        base = (n_aggs_target ** (1.0 / n_active)) / geo
        divs[active] = np.maximum(1, np.round(rel[active] * base))
        # cap the product near the target so degenerate aspect ratios
        # cannot explode the bin count
        while divs.prod() > 8 * n_aggs_target:
            divs[np.argmax(divs)] = max(1, divs.max() // 2)
    safe_span = np.where(active, span, 1.0)
    bins = [np.clip(((coords[:, k] - lo[k]) / safe_span[k]
                     * divs[k]).astype(np.int64), 0, divs[k] - 1)
            for k in range(3)]
    raw_id = (bins[0] * divs[1] + bins[1]) * divs[2] + bins[2]
    _, agg_of_node = np.unique(raw_id, return_inverse=True)
    return agg_of_node, int(agg_of_node.max()) + 1


def _centered_rbm_blocks(coords, agg_of_node, n_aggs, dtype):
    """B[node, comp, mode]: translations + rotations e_k x r about the
    aggregate centroid."""
    n_nodes = coords.shape[0]
    centroids = np.zeros((n_aggs, 3))
    counts = np.bincount(agg_of_node, minlength=n_aggs).astype(float)
    for k in range(3):
        centroids[:, k] = (np.bincount(agg_of_node, coords[:, k],
                                       minlength=n_aggs) / counts)
    r = coords - centroids[agg_of_node]

    B = np.zeros((n_nodes, 3, 6), dtype=dtype)
    for k in range(3):
        B[:, k, k] = 1.0
    x, y, z = r[:, 0], r[:, 1], r[:, 2]
    B[:, 1, 3], B[:, 2, 3] = -z, y
    B[:, 0, 4], B[:, 2, 4] = z, -x
    B[:, 0, 5], B[:, 1, 5] = -y, x
    return B


def _normalize_and_mask(P_vals, agg_of_dof, n_aggs, prescribed_indices):
    """Per-aggregate column normalization (A_c scaling; rank-deficient
    aggregate slots are handled by the traced null-column deflation in
    make_two_level_preconditioner) + zero prescribed rows so the coarse
    space respects the embedded BCs. In-place; vectorized (one
    np.add.at sweep instead of an O(n_aggs * n_dofs) python loop)."""
    sq = np.zeros((n_aggs, P_vals.shape[1]), dtype=P_vals.dtype)
    np.add.at(sq, agg_of_dof, P_vals**2)
    norms = np.sqrt(sq)
    P_vals /= np.where(norms > 1e-12, norms, 1.0)[agg_of_dof]
    P_vals[np.asarray(prescribed_indices, dtype=np.intp)] = 0.0



def attach_coarse_scatter(agg_of_dof: np.ndarray, n_aggs: int,
                          indptr: np.ndarray, col_indices: np.ndarray):
    """The sorted P^T K P contraction plan for the fine CSR pattern:
    ``(order, seg, pI, pJ)``, the fine nnz ordered by coarse (aggI, aggJ)
    pair, their sorted segment ids, and the coarse pair list.
    Host/numpy only."""
    indptr = np.asarray(indptr)
    cols = np.asarray(col_indices)
    nnz = cols.shape[0]
    rows = np.repeat(np.arange(indptr.shape[0] - 1, dtype=np.int64),
                     np.diff(indptr))
    aggd = np.asarray(agg_of_dof).astype(np.int64)
    key = aggd[rows] * n_aggs + aggd[cols]
    order = np.argsort(key, kind="stable")
    skey = key[order]
    new = np.empty(nnz, dtype=bool)
    new[0] = True
    new[1:] = skey[1:] != skey[:-1]
    seg = (np.cumsum(new) - 1).astype(np.int32)
    pairs = skey[new]
    return (order.astype(np.int32), seg, (pairs // n_aggs).astype(np.int32),
            (pairs % n_aggs).astype(np.int32))


def _apply_P(pattern: TwoLevelPattern, x_c: Tensor, P_vals: Tensor,
             agg_of_dof: Tensor) -> Tensor:
    """(m,) coarse -> (n_dofs,) fine."""
    blocks = x_c.reshape(pattern.num_aggregates, pattern.width)[agg_of_dof]
    return torch.sum(P_vals * blocks, dim=-1)


def _apply_PT(r: Tensor, P_vals: Tensor, agg_plan) -> Tensor:
    """(n_dofs,) fine -> (m,) coarse: each aggregate's rows of P, times
    r, summed in dof order."""
    return segment_sum(P_vals, agg_plan, scale=r).reshape(-1)


def coarse_matrix(pattern: TwoLevelPattern, unique: Tensor, rows: Tensor,
                  cols: Tensor) -> Tensor:
    """A_c = P^T K P from K's deduped COO triplet, dense (m, m): the
    per-nonzero w*w outer products in coarse-pair order (the plan of
    :func:`attach_coarse_scatter`), summed per pair in that order
    (:func:`coarse_pair_sum`: on the card one kernel forms and sums them),
    then placed once (the pairs are distinct)."""
    m, w = pattern.coarse_dim, pattern.width
    if m > DENSE_COARSE_CEILING:
        raise ValueError(
            f"two-level coarse space has {m} dofs — the dense (m, m) "
            "coarse factorization would need "
            f"{m * m * 8 / 1e9:.1f} GB; raise 'aggregate nodes' in the "
            "preconditioner spec to shrink the coarse space")
    t = pattern.on(unique.device, unique.dtype)
    S = coarse_pair_sum(unique, t["order"], rows, cols, t["P_vals"],
                        t["pair_plan"])
    A_c = unique.new_zeros((m, m))
    na = pattern.num_aggregates
    A_c.view(na, w, na, w)[t["pI"], :, t["pJ"], :] = S
    return A_c


def make_two_level_preconditioner(pattern: TwoLevelPattern,
                                  unique: Tensor, rows: Tensor,
                                  cols: Tensor, diag: Tensor,
                                  symmetric: bool = True):
    """M^-1 = D^-1 + P (P^T K P)^-1 P^T (additive coarse correction),
    for CG on an SPD K: a Cholesky coarse solve. ``symmetric=False``
    (the LU coarse solve for GMRES) is not ported yet."""
    if not symmetric:
        raise NotImplementedError(
            "the nonsymmetric (LU, GMRES) two-level arm is not ported "
            "yet: ROADMAP queue 1, item 22")
    t = pattern.on(unique.device, unique.dtype)
    P_vals, agg, agg_plan = t["P_vals"], t["agg_of_dof"], t["agg_plan"]
    A_c = coarse_matrix(pattern, unique, rows, cols)
    # Symmetric diagonal equilibration + null-column deflation:
    # rank-deficient aggregate slots (single-node aggregates, prescribed
    # rows) leave near-null columns; scale to O(1) where the column has
    # energy, zero it where it does not (the identity on dropped slots
    # keeps the factorization nonsingular and the outer s-products
    # exactly zero their contribution).
    d_c = torch.abs(torch.diagonal(A_c))
    keep = d_c > (_NULL_COL_REL * torch.max(d_c))
    s = torch.where(keep, 1.0 / torch.sqrt(torch.where(keep, d_c, 1.0)),
                    0.0)
    A_s = (s[:, None] * A_c) * s[None, :]
    ridge = 10.0 * torch.finfo(A_s.dtype).eps
    A_s = A_s + torch.diag(torch.where(keep, ridge, 1.0).to(A_s.dtype))
    L = torch.linalg.cholesky(A_s)

    if A_s.shape[0] <= _EXPLICIT_INVERSE_CEILING:
        A_inv = torch.cholesky_solve(
            torch.eye(A_s.shape[0], dtype=A_s.dtype, device=A_s.device), L)
        A_inv = 0.5 * (A_inv + A_inv.T)  # keep M exactly SPD

        def apply(r: Tensor) -> Tensor:
            rhs = s * _apply_PT(r, P_vals, agg_plan)
            return r / diag + _apply_P(pattern, s * (A_inv @ rhs), P_vals,
                                       agg)

        return apply

    def apply(r: Tensor) -> Tensor:
        rhs = s * _apply_PT(r, P_vals, agg_plan)
        z_c = s * torch.cholesky_solve(rhs[:, None], L)[:, 0]
        return r / diag + _apply_P(pattern, z_c, P_vals, agg)

    return apply
