"""Reproducible sums over fixed patterns: the segment sum and the CSR
product, with their plans, plain versions and CUDA wrappers.

The FE path sums many values into fewer slots over patterns that never
change within a problem: element residuals into the global vector, the
assembly's COO entries into the deduplicated pattern, fine dofs into
two-level aggregates. ``index_add_`` does it on the CPU in ascending entry
order, one thread; on the card it adds float64 with atomics in an order
that changes from run to run, so two runs of the same FE drive rounded
differently and took different Newton paths. A :class:`SegmentPlan`,
built once per pattern, sorts the entries by target (stably) and records
where each target's segment starts (CSR-like offsets); the CUDA kernel
``segment_sum`` (``csrc/segment_sum.cu``) then sums each segment in
ascending entry order, starting from 0: the CPU's order, so the card's sum
equals the CPU's bit for bit, and run after run. The plan also cuts its
segments into tiles of consecutive segments (:func:`tile_plan`); the
arrays the kernels read are int32.

- :func:`segment_sum` — ``out[s] = sum of vals[e] (* scale[e]) over the
  entries e of segment s``; the plain version is ``index_add_``. It is
  differentiable in ``vals``: the backward is the gather
  ``grad_out[segment of entry]``. The plan picks one of two kernels
  (:func:`segment_path`): one block per segment, longest first, where some
  segment is long (``segment_sum_block``), else one block per tile of
  consecutive segments (``segment_sum_tile``: the tile's values staged in
  shared memory, then a thread per output adds its segment); both add each
  output's entries in the same order, so they give the same bits.
- :func:`coarse_pair_sum` — the two-level coarse matrix's sums per coarse
  pair, ``sum of (unique[e] * P[rows[e], a]) * P[cols[e], b]``, with the
  products formed inside the kernel (``coarse_pair_sum``) rather than
  materialized; the plain version is that product and :func:`segment_sum`.
- :func:`segment_gather` — ``x[segment of entry]``, whose backward is the
  segment sum (so the FE gathers of U transpose reproducibly too). Each
  of the two backwards calls the other's differentiable entry, so second
  derivatives stay on the plans' kernels.
- :func:`csr_matvec` — ``y = A x`` for a CSR matrix over a
  :class:`CsrPlan`, each row summed in column order: the segment sum of
  ``data[j] * x[cols[j]]`` over the row pointer, on the tile path (CUDA
  entry ``csr_matvec``); the plain version, :func:`csr_matvec_plain`, is
  that product and ``index_add_``.

The wrappers take the plain version only for a CPU tensor; a CUDA tensor
launches the kernel or raises. Each adds one to its launch count where it
launches its kernel, and nowhere else.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from cmad_tpu_torch.typing import Tensor

segment_sum_tile_launches = 0
segment_sum_block_launches = 0
coarse_pair_sum_launches = 0
csr_matvec_launches = 0
# segment_sum_tile and segment_sum_block launches by plan shape and path:
# (n_entries, n_segments, width, "tile" or "block") -> launches
plan_launches: dict[tuple[int, int, int, str], int] = {}

_DTYPES = (torch.float32, torch.float64)

# The block path runs where the plan's longest segment has at least
# LONG_SEGMENT entries and the plan sums at most BLOCK_MAX_SPREAD times
# that many entries in all (and the width fits the block's adders): its
# time is the longest segment's chain of adds as long as the other
# segments fit beside it in about one wave of its blocks (132 SMs x 4).
# Measured on an NVIDIA H100 80GB HBM3 at a 700 W power limit
# (tools/torch_kernel_probe.py --segsum, uniform plans, PERF.md) against a
# thread per output (the kernel that summed short plans before the tile
# kernel): 166 segments of 6 columns are faster on the block path from 32
# entries on (16: 2.55 us against 2.34); 256-entry segments of 6 columns
# up to 528 of them (7.23 us against 9.68), not at 1,056 (12.79 against
# 9.84). The FE path's short plans (at
# most 45 entries, thousands of segments) take the tile path, the
# restriction (504 entries, 58 times that in all) and the coarse pairs
# (13,538; 78 times) the block path.
LONG_SEGMENT = 32
BLOCK_MAX_SPREAD = 512
BLOCK_MAX_WIDTH = 64      # adder threads per block (csrc: kBlockMaxWidth)
COARSE_PAIR_WIDTH = 6     # the coarse pairs' P width (csrc: W)
# The tile path's tiles: at most TILE_ENTRIES entries and as many segments
# (a longer segment is a tile of its own); a tile's offsets, index and
# values are a block's shared memory (33 KB in f64, five blocks an SM).
# The tile path sums every plan the block path does not take. The FE
# path's are of one column; a row of several columns is staged by plain
# loads, chunk by chunk, at the same bits but slower (166 segments of 16
# entries x 6 columns: 0.0178 ms against 0.0024 for a thread per output;
# the same card and probe, PERF.md).
TILE_ENTRIES = 2048
_INT32_MAX = 2**31 - 1


def reset_launch_counts() -> None:
    global segment_sum_tile_launches, segment_sum_block_launches
    global coarse_pair_sum_launches, csr_matvec_launches
    segment_sum_tile_launches = 0
    segment_sum_block_launches = 0
    coarse_pair_sum_launches = 0
    csr_matvec_launches = 0
    plan_launches.clear()


def launch_counts() -> dict[str, int]:
    return {"segment_sum_tile": segment_sum_tile_launches,
            "segment_sum_block": segment_sum_block_launches,
            "coarse_pair_sum": coarse_pair_sum_launches,
            "csr_matvec": csr_matvec_launches}


@dataclass(frozen=True)
class SegmentPlan:
    """A fixed sum of ``n_entries`` values into ``n_segments`` slots.

    ``perm`` lists the entries in segment order (None: already in it),
    ``offsets`` (n_segments + 1,) where each segment starts in that order,
    ``sorted_target`` the segment of each position of that order, and
    ``target`` (n_entries,) the segment of each entry, or None when some
    entries belong to no segment (the plan sums only those ``perm``
    lists). ``max_length`` is the longest segment's entry count and
    ``schedule`` (n_segments,) the segment ids longest first (ties in
    ascending id): the order in which the block path's blocks take
    them. ``tiles`` is :func:`tile_plan` at ``tile_entries``, which the
    tile path reads. The kernels read ``perm``, ``offsets``, ``schedule``
    and ``tiles``, all int32; ``sorted_target`` and ``target`` (int64) are
    the plain version's ``index_add_`` index and the gather's."""

    offsets: Tensor
    perm: Tensor | None
    sorted_target: Tensor
    target: Tensor | None
    n_segments: int
    n_entries: int
    max_length: int
    schedule: Tensor
    tiles: Tensor
    tile_entries: int


def _index(a, device) -> Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.int64), device=device)


def _index32(a, device) -> Tensor:
    a = np.asarray(a, dtype=np.int64)
    if a.size and (a.min() < 0 or a.max() > _INT32_MAX):
        raise ValueError("a plan's positions and segments must fit int32")
    return torch.as_tensor(a.astype(np.int32), device=device)


def _host(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def tile_plan(offsets, tile_entries: int = TILE_ENTRIES) -> np.ndarray:
    """``(n_tiles + 1, 2)``: the first segment and first position of each
    tile of the segments ``[offsets[s], offsets[s + 1])``, then the end.
    Tiles cover the segments in order, each with at most ``tile_entries``
    entries and as many segments; a segment longer than ``tile_entries``
    is a tile of its own."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    starts = []
    s = 0
    while s < n:
        starts.append(s)
        fits = int(np.searchsorted(offsets, offsets[s] + tile_entries,
                                   side="right")) - 1
        s = max(s + 1, min(fits, s + tile_entries, n))
    starts.append(n)
    starts = np.asarray(starts, dtype=np.int64)
    return np.stack([starts, offsets[starts]], axis=1)


def plan_from_target(target, n_segments: int, device) -> SegmentPlan:
    """The plan that sums entry ``e`` into segment ``target[e]``."""
    target = np.asarray(target, dtype=np.int64).ravel()
    order = np.argsort(target, kind="stable")
    sorted_target = target[order]
    in_order = bool(np.all(order == np.arange(target.shape[0])))
    return plan_from_sorted(None if in_order else order, sorted_target,
                            n_segments, target.shape[0], device,
                            target=target)


def plan_from_sorted(perm, sorted_target, n_segments: int, n_entries: int,
                     device, target=None) -> SegmentPlan:
    """The plan that sums entry ``perm[i]`` (``i`` if ``perm`` is None)
    into segment ``sorted_target[i]``, with ``sorted_target``
    nondecreasing; entries that ``perm`` leaves out belong to no
    segment."""
    sorted_target = np.asarray(sorted_target, dtype=np.int64).ravel()
    if sorted_target.size and (np.any(np.diff(sorted_target) < 0)
                               or sorted_target[0] < 0
                               or sorted_target[-1] >= n_segments):
        raise ValueError("sorted_target must be nondecreasing in "
                         f"[0, {n_segments})")
    offsets = np.searchsorted(sorted_target, np.arange(n_segments + 1),
                              side="left")
    if target is None and perm is None \
            and sorted_target.shape[0] == n_entries:
        target = sorted_target
    lengths = np.diff(offsets)
    return SegmentPlan(
        offsets=_index32(offsets, device),
        perm=None if perm is None else _index32(perm, device),
        sorted_target=_index(sorted_target, device),
        target=None if target is None else _index(target, device),
        n_segments=int(n_segments), n_entries=int(n_entries),
        max_length=int(lengths.max(initial=0)),
        schedule=_index32(np.argsort(-lengths, kind="stable"), device),
        tiles=_index32(tile_plan(offsets), device),
        tile_entries=TILE_ENTRIES)


def plan_from_offsets(offsets, device) -> SegmentPlan:
    """The plan of entries already in segment order, segment ``s`` being
    ``[offsets[s], offsets[s + 1])`` (a CSR row pointer)."""
    offsets = np.asarray(offsets, dtype=np.int64)
    n = offsets.shape[0] - 1
    sorted_target = np.repeat(np.arange(n, dtype=np.int64),
                              np.diff(offsets))
    return plan_from_sorted(None, sorted_target, n, int(offsets[-1]),
                            device)


def _check(name: str, t: Tensor, like: Tensor) -> None:
    if t.device != like.device:
        raise ValueError(f"{name}: on {t.device}, expected {like.device}")
    if t.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype must be float32 or float64; got "
                        f"{t.dtype}")
    if t.dtype != like.dtype:
        raise TypeError(f"{name}: {t.dtype} does not match {like.dtype}")


def _segment_sum_plain(vals: Tensor, plan: SegmentPlan,
                       scale: Tensor | None) -> Tensor:
    """``index_add_`` of the plan's entries, in ascending entry order."""
    out = vals.new_zeros((plan.n_segments, *vals.shape[1:]))
    if plan.target is not None:
        src = vals if scale is None else vals * _column(scale, vals)
        return out.index_add_(0, plan.target, src)
    src = vals[plan.perm]
    if scale is not None:
        src = src * _column(scale[plan.perm], src)
    return out.index_add_(0, plan.sorted_target, src)


def segment_sum_in_plan_order(vals: Tensor, plan: SegmentPlan,
                              scale: Tensor | None = None) -> Tensor:
    """The kernel's order in plain PyTorch: position k of every segment
    at once, k = 0, 1, ..., each added to its segment's sum from 0 (on
    the CPU, where the tests hold it to ``index_add_`` bit for bit)."""
    lengths = plan.offsets[1:] - plan.offsets[:-1]
    starts = plan.offsets[:-1]
    out = vals.new_zeros((plan.n_segments, *vals.shape[1:]))
    for k in range(int(lengths.max()) if plan.n_segments else 0):
        live = lengths > k
        pos = starts[live] + k
        e = pos if plan.perm is None else plan.perm[pos]
        v = vals[e]
        if scale is not None:
            v = v * _column(scale[e], v)
        out[live] = out[live] + v
    return out


def _column(scale: Tensor, like: Tensor) -> Tensor:
    return scale.reshape(-1, *([1] * (like.dim() - 1)))


def segment_path(plan: SegmentPlan, width: int) -> str:
    """The kernel that sums ``plan`` at ``width`` values per entry:
    ``"block"`` where its longest segment has at least
    :data:`LONG_SEGMENT` entries, it sums at most :data:`BLOCK_MAX_SPREAD`
    times that many entries, and ``width`` fits the block's adders; else
    ``"tile"``. A property of the plan's shape alone."""
    summed = int(plan.sorted_target.shape[0])
    if (plan.max_length >= LONG_SEGMENT
            and summed <= BLOCK_MAX_SPREAD * plan.max_length
            and 0 < width <= BLOCK_MAX_WIDTH):
        return "block"
    return "tile"


def _check_index(kernel: str, name: str, idx: Tensor | None,
                 like: Tensor, dtype: torch.dtype = torch.int32) -> None:
    if idx is not None and (idx.device != like.device
                            or idx.dtype != dtype
                            or not idx.is_contiguous()):
        raise ValueError(f"{kernel}: {name} must be contiguous "
                         f"{str(dtype).removeprefix('torch.')} on "
                         f"{like.device}")


def _launched(kernel: str, lib, rc: int) -> None:
    if rc != 0:
        raise RuntimeError(f"{kernel} launch failed: CUDA error {rc} "
                           f"({lib.j2_error_string(rc).decode()})")


def segment_sum_cuda(vals: Tensor, plan: SegmentPlan,
                     scale: Tensor | None = None,
                     path: str | None = None) -> Tensor:
    """The segment sum on the card: ``segment_sum_tile`` (one block per
    tile of segments) or ``segment_sum_block`` (one block per segment), as
    :func:`segment_path` picks for the plan, or as ``path`` says (the
    card's checks run each plan through both paths). The same bits either
    way."""
    from cmad_tpu_torch.ops._build import load_library

    global segment_sum_tile_launches, segment_sum_block_launches
    width = int(np.prod(vals.shape[1:], dtype=np.int64))
    path = segment_path(plan, width) if path is None else path
    if path not in ("tile", "block") or (
            path == "block" and not 0 < width <= BLOCK_MAX_WIDTH):
        raise ValueError(f"segment_sum: no {path!r} path at width {width}")
    # the plan's index arrays that the path reads
    for name in ("offsets", "perm",
                 "tiles" if path == "tile" else "schedule"):
        _check_index("segment_sum", f"plan.{name}", getattr(plan, name),
                     vals)
    if vals.device.type != "cuda":
        raise ValueError(f"segment_sum: the CUDA kernel takes CUDA tensors; "
                         f"got device {vals.device}")
    _check("vals", vals, vals)
    if not vals.is_contiguous():
        raise ValueError("segment_sum: vals must be contiguous")
    if scale is not None:
        _check("scale", scale, vals)
        if tuple(scale.shape) != (plan.n_entries,) \
                or not scale.is_contiguous():
            raise ValueError(f"segment_sum: scale must be a contiguous "
                             f"({plan.n_entries},) vector")
    out = vals.new_empty((plan.n_segments, *vals.shape[1:]))
    lib = load_library()
    sfx = "f64" if vals.dtype == torch.float64 else "f32"
    sc = None if scale is None else scale.data_ptr()
    with torch.cuda.device(vals.device):
        stream = torch.cuda.current_stream(vals.device).cuda_stream
        if path == "block":
            rc = getattr(lib, f"segment_sum_block_{sfx}")(
                vals.data_ptr(), _ptr(plan.perm), plan.offsets.data_ptr(),
                sc, plan.schedule.data_ptr(), out.data_ptr(),
                plan.n_segments, width, stream)
        else:
            rc = getattr(lib, f"segment_sum_tile_{sfx}")(
                vals.data_ptr(), _ptr(plan.perm), plan.offsets.data_ptr(),
                sc, plan.tiles.data_ptr(), out.data_ptr(), _n_tiles(plan),
                width, plan.tile_entries, stream)
    _launched(f"segment_sum ({path} path)", lib, rc)
    if path == "block":
        segment_sum_block_launches += 1
    else:
        segment_sum_tile_launches += 1
    key = (plan.n_entries, plan.n_segments, width, path)
    plan_launches[key] = plan_launches.get(key, 0) + 1
    return out


def _ptr(t: Tensor | None) -> int | None:
    return None if t is None else t.data_ptr()


def _n_tiles(plan: SegmentPlan) -> int:
    return int(plan.tiles.shape[0]) - 1


def _segment_sum_raw(vals: Tensor, plan: SegmentPlan,
                     scale: Tensor | None) -> Tensor:
    if vals.shape[0] != plan.n_entries:
        raise ValueError(f"segment_sum: {vals.shape[0]} entries, the plan "
                         f"has {plan.n_entries}")
    if vals.device.type == "cuda":
        return segment_sum_cuda(vals, plan, scale)
    if vals.device.type == "cpu":
        return _segment_sum_plain(vals, plan, scale)
    raise ValueError(f"segment_sum: no kernel for device {vals.device}")


# The two Functions are each other's transpose, and each backward calls
# the other's differentiable entry: a double backward (a Hessian-vector
# product) then sums and gathers over the same plans, through the kernels
# on the card, which autograd cannot see inside.
class _SegmentSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, vals: Tensor, plan: SegmentPlan) -> Tensor:
        ctx.plan = plan
        return _segment_sum_raw(vals, plan, None)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        return segment_gather(grad_out, ctx.plan), None


def _gather(x: Tensor, plan: SegmentPlan) -> Tensor:
    """``x[segment of entry]`` over every entry (zero where an entry
    belongs to no segment)."""
    if plan.target is not None:
        return x[plan.target]
    out = x.new_zeros((plan.n_entries, *x.shape[1:]))
    out[plan.perm] = x[plan.sorted_target]
    return out


class _SegmentGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x: Tensor, plan: SegmentPlan) -> Tensor:
        ctx.plan = plan
        return _gather(x, plan)

    @staticmethod
    def backward(ctx, grad_out: Tensor):
        return segment_sum(grad_out.contiguous(), ctx.plan), None


def segment_sum(vals: Tensor, plan: SegmentPlan,
                scale: Tensor | None = None) -> Tensor:
    """``(n_segments, ...)`` sums of ``vals`` (``(n_entries, ...)``) over
    ``plan``, each entry times ``scale[e]`` when given; every segment
    summed in ascending entry order from 0. Differentiable in ``vals``
    (not in ``scale``)."""
    if scale is not None and scale.requires_grad:
        raise RuntimeError("segment_sum is not differentiable in scale")
    if vals.device.type == "cuda":
        vals = vals.contiguous()
    if scale is None and vals.requires_grad and torch.is_grad_enabled():
        return _SegmentSum.apply(vals, plan)
    return _segment_sum_raw(vals, plan, scale)


def segment_gather(x: Tensor, plan: SegmentPlan) -> Tensor:
    """``x[target]``: the value of each entry's segment; the backward is
    :func:`segment_sum` over ``plan``."""
    if x.requires_grad and torch.is_grad_enabled():
        return _SegmentGather.apply(x, plan)
    return _gather(x, plan)


def coarse_pair_sum_plain(unique: Tensor, order: Tensor, rows: Tensor,
                          cols: Tensor, P_vals: Tensor,
                          plan: SegmentPlan) -> Tensor:
    """The plain version of :func:`coarse_pair_sum`: the ``(nnz, w, w)``
    products materialized in pair order, then :func:`segment_sum`."""
    r_o, c_o = rows[order], cols[order]
    block = (unique[order][:, None, None] * P_vals[r_o][:, :, None]
             * P_vals[c_o][:, None, :])
    return segment_sum(block, plan)


def coarse_pair_sum_cuda(unique: Tensor, order: Tensor, rows: Tensor,
                         cols: Tensor, P_vals: Tensor,
                         plan: SegmentPlan) -> Tensor:
    """:func:`coarse_pair_sum` on the card (``coarse_pair_sum``), each
    entry's products formed in the kernel. Forward only."""
    from cmad_tpu_torch.ops._build import load_library

    global coarse_pair_sum_launches
    for name, idx in (("order", order), ("rows", rows), ("cols", cols)):
        _check_index("coarse_pair_sum", name, idx, unique, torch.int64)
    for name, idx in (("plan.offsets", plan.offsets),
                      ("plan.schedule", plan.schedule)):
        _check_index("coarse_pair_sum", name, idx, unique)
    if unique.device.type != "cuda":
        raise ValueError(f"coarse_pair_sum: the CUDA kernel takes CUDA "
                         f"tensors; got device {unique.device}")
    _check("unique", unique, unique)
    _check("P_vals", P_vals, unique)
    if torch.is_grad_enabled() and (unique.requires_grad
                                    or P_vals.requires_grad):
        raise RuntimeError("coarse_pair_sum: the CUDA kernel is forward "
                           "only; its inputs must not require grad")
    w = COARSE_PAIR_WIDTH
    n = int(rows.shape[0])
    if tuple(unique.shape) != (n,) or P_vals.dim() != 2 \
            or P_vals.shape[1] != w or tuple(order.shape) != (n,) \
            or tuple(cols.shape) != (n,) or plan.n_entries != n \
            or not (unique.is_contiguous() and P_vals.is_contiguous()):
        raise ValueError(f"coarse_pair_sum: unique, order, rows, cols must "
                         f"be ({n},) over the plan's entries and P_vals a "
                         f"contiguous (n_dofs, {w}) matrix")
    out = unique.new_empty((plan.n_segments, w, w))
    lib = load_library()
    fn = lib.coarse_pair_sum_f64 if unique.dtype == torch.float64 \
        else lib.coarse_pair_sum_f32
    with torch.cuda.device(unique.device):
        stream = torch.cuda.current_stream(unique.device).cuda_stream
        rc = fn(unique.data_ptr(), order.data_ptr(), rows.data_ptr(),
                cols.data_ptr(), P_vals.data_ptr(), plan.offsets.data_ptr(),
                plan.schedule.data_ptr(), out.data_ptr(), plan.n_segments, w,
                stream)
    _launched("coarse_pair_sum", lib, rc)
    coarse_pair_sum_launches += 1
    return out


def coarse_pair_sum(unique: Tensor, order: Tensor, rows: Tensor,
                    cols: Tensor, P_vals: Tensor,
                    plan: SegmentPlan) -> Tensor:
    """``(n_pairs, w, w)``: per coarse pair ``p`` of ``plan`` (positions
    ``i`` in pair order, entry ``e = order[i]`` of the fine COO triplet
    ``(unique, rows, cols)``), the sum over its entries of
    ``(unique[e] * P_vals[rows[e], a]) * P_vals[cols[e], b]``, added in
    ascending ``i`` from 0. The kernel on the card, the plain version on
    the CPU; the same bits."""
    if unique.device.type == "cuda":
        return coarse_pair_sum_cuda(unique, order, rows, cols, P_vals, plan)
    if unique.device.type == "cpu":
        return coarse_pair_sum_plain(unique, order, rows, cols, P_vals, plan)
    raise ValueError(f"coarse_pair_sum: no kernel for device "
                     f"{unique.device}")


@dataclass(frozen=True)
class CsrPlan:
    """The fixed pattern of an ``(n, n)`` CSR matrix: ``rows``, the
    segment plan of its row pointer (its offsets are the row pointer, as
    int32, and its tiles the kernel's), and ``cols``, each entry's column
    as int32."""

    rows: SegmentPlan
    cols: Tensor
    n: int


def csr_plan(indptr, cols, device) -> CsrPlan:
    """The :class:`CsrPlan` of the row pointer ``indptr`` and columns
    ``cols`` (arrays or tensors), built once per pattern on the host."""
    indptr = _host(indptr)
    return CsrPlan(rows=plan_from_offsets(indptr, device),
                   cols=_index32(_host(cols), device),
                   n=int(indptr.shape[0]) - 1)


def csr_matvec_plain(plan: CsrPlan, data: Tensor, x: Tensor) -> Tensor:
    """The plain version of :func:`csr_matvec_cuda`: the products
    ``data[j] * x[cols[j]]``, then ``index_add_`` over the rows; on the
    CPU each row summed in ascending position from 0, the kernel's order,
    so the same bits."""
    return _segment_sum_plain(data * x[plan.cols], plan.rows, None)


def csr_matvec_cuda(plan: CsrPlan, data: Tensor, x: Tensor) -> Tensor:
    """``y = A x`` on the card for the matrix of ``plan`` with values
    ``data``: the tile path (``csr_matvec``), each row summed in ascending
    column position from 0."""
    from cmad_tpu_torch.ops._build import load_library

    global csr_matvec_launches
    for name, idx in (("plan.rows.offsets", plan.rows.offsets),
                      ("plan.rows.tiles", plan.rows.tiles),
                      ("plan.cols", plan.cols)):
        _check_index("csr_matvec", name, idx, x)
    if x.device.type != "cuda":
        raise ValueError(f"csr_matvec: the CUDA kernel takes CUDA tensors; "
                         f"got device {x.device}")
    _check("data", data, x)
    n = plan.n
    if tuple(x.shape) != (n,) or tuple(data.shape) != tuple(
            plan.cols.shape) or not (x.is_contiguous()
                                     and data.is_contiguous()):
        raise ValueError(f"csr_matvec: x must be a contiguous ({n},) "
                         f"vector and data contiguous, one per column")
    y = torch.empty_like(x)
    lib = load_library()
    fn = lib.csr_matvec_f64 if x.dtype == torch.float64 \
        else lib.csr_matvec_f32
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(plan.rows.tiles.data_ptr(), plan.rows.offsets.data_ptr(),
                plan.cols.data_ptr(), data.data_ptr(), x.data_ptr(),
                y.data_ptr(), _n_tiles(plan.rows), plan.rows.tile_entries,
                stream)
    _launched("csr_matvec", lib, rc)
    csr_matvec_launches += 1
    return y


def make_csr_matvec(plan: CsrPlan, data: Tensor):
    """``matvec(x) = A x`` for the fixed CSR matrix of ``plan`` with
    values ``data``: the kernel on the card, :func:`csr_matvec_plain` on
    the CPU; the same bits. Not differentiable."""
    data = data.detach()
    if data.device.type == "cuda":
        data = data.contiguous()
        return lambda x: csr_matvec_cuda(plan, data, x)
    if data.device.type != "cpu":
        raise ValueError(f"csr_matvec: no kernel for device {data.device}")
    return lambda x: csr_matvec_plain(plan, data, x)
