// Reproducible sums on Hopper (sm_90a): a segment sum over a fixed plan,
// the two-level coarse-pair contraction, and the CSR matrix-vector
// product, each adding in one fixed order. Plain C interface, loaded with
// ctypes by cmad_tpu_torch/ops/_build.py.
//
// These replace no TPU kernel: they replace torch's index_add_ and the
// cuSPARSE product on the FE path (the residual scatter and COO dedup of
// assembly, the CSR dedup, the embedded-BC diagonal, the two-level
// restriction and coarse matrix, and CG's product). On the card
// index_add_ adds float64 with atomics, in an order that changes from run
// to run, so the last bits of R and K did, and with them the Newton's
// path. Here every output is one sequential sum:
//
//   segment_sum: out[s, c] = sum over i in [offsets[s], offsets[s + 1]) of
//                vals[e, c] (times scale[e]), e = perm[i] (or i),
//                added in ascending i, starting from 0.
//
// With perm the stable sort of the entries by segment (ops/segment_sum.py
// builds it once per fixed pattern), ascending i is ascending entry
// order: the order in which the CPU's single-threaded index_add_ adds
// them, so the card's sum equals the plain CPU sum bit for bit. The
// products and sums are the _rn intrinsics: nvcc may not contract them
// into FMAs, which would round differently from the CPU. A segment is
// never split across threads and never summed as a tree: either would
// change the order, and with it the bits.
//
// Two paths compute the same bits; the plan's longest segment picks one
// (ops/segment_sum.py segment_path):
//
// - the thread path (segment_sum_kernel), for plans of short segments
//   (the assembly's scatter and dedups, at most 45 entries): one thread
//   per output, consecutive threads on consecutive columns of one segment
//   (or consecutive rows), the inner loop unrolled so that later entries'
//   loads are in flight while the adds wait;
// - the block path (segment_sum_block_kernel), for plans of long
//   segments (the two-level restriction: up to 504 entries into each of
//   996 outputs). There one thread per output would leave the card idle
//   (996 threads on 4 of 132 SMs) and walk a chain of dependent loads
//   (perm[i], then the value and scale behind it) per entry. Instead one
//   block takes one segment: its stager threads load the entries of a
//   chunk in parallel, perm and scale once per entry, form the scaled
//   values and stage them in shared memory, double-buffered, while
//   `width` adder threads add the chunk before in ascending order from
//   shared memory. What is left is the one dependent add chain per output
//   column, at the add's latency: the longest segment times the DADD
//   latency is this path's floor. Blocks take segments longest first
//   (the plan's schedule), so the longest starts in the first wave.
//
//   coarse_pair_sum: S[p, a, b] = sum over i in [offsets[p], offsets[p + 1])
//                of (unique[e] * P[rows[e], a]) * P[cols[e], b], e = order[i],
//                added in ascending i from 0,
//
// the coarse matrix P^T K P of the two-level preconditioner per coarse
// pair (fem/two_level.py coarse_matrix). The plain version materializes the
// (nnz, W, W) products (305 MB at the 47,628-tet notch) and sums them; here
// the stagers form the W * W products of each entry, in that order of
// association, straight into shared memory, and W * W adders sum them as
// the block path does: about 34 MB read instead of 305 MB written and
// read again.
//
//   csr_matvec:  y[r] = sum over j in [indptr[r], indptr[r + 1]) of
//                data[j] * x[cols[j]], added in ascending j from 0.
//
// What bounds them on an H100 (3.35 TB/s HBM3 at 700 W): bytes, each
// value and index read once and each output written once; at the FE
// path's shapes (a few thousand to a few million outputs) the latency of
// each output's dependent adds over its segment.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ double add_rn(double a, double b) {
  return __dadd_rn(a, b);
}
__device__ __forceinline__ float add_rn(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ double mul_rn(double a, double b) {
  return __dmul_rn(a, b);
}
__device__ __forceinline__ float mul_rn(float a, float b) {
  return __fmul_rn(a, b);
}

template <typename T, bool kPerm, bool kScale>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const T* __restrict__ vals, const int64_t* __restrict__ perm,
                   const int64_t* __restrict__ offsets,
                   const T* __restrict__ scale, T* __restrict__ out,
                   int64_t n_segments, int64_t width) {
  const int64_t total = n_segments * width;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       k < total; k += stride) {
    const int64_t s = k / width;
    const int64_t c = k - s * width;
    const int64_t lo = offsets[s], hi = offsets[s + 1];
    T acc = T(0);
#pragma unroll 8
    for (int64_t i = lo; i < hi; ++i) {
      const int64_t e = kPerm ? perm[i] : i;
      T v = vals[e * width + c];
      if (kScale) v = mul_rn(v, scale[e]);
      acc = add_rn(acc, v);
    }
    out[k] = acc;
  }
}

// The block path and the coarse-pair contraction share one shape: a block
// per segment, taken from the plan's longest-first schedule; kStagers
// stager threads after 32 * ceil(width / 32) adder threads (adder c owns
// output column c); a chunk of at most kStagers entries, one per stager,
// staged double-buffered in dynamic shared memory. A chunk is stored by
// column: column c holds the chunk's entries in order, `ld` apart from
// column c + 1, so that a stager's writes (consecutive entries, one
// column, across a warp) fall on consecutive banks and an adder reads its
// column two values at a time with one 16-byte load. While the adders add
// chunk k in ascending order, the stagers stage chunk k + 1; one
// __syncthreads per chunk hands the buffers over.
constexpr int kStagers = 256;
constexpr int kBlockMaxWidth = 64;
// the staging ring's shared memory: at width 36 in f64 a full chunk of
// kStagers entries (148,608 bytes, one block per SM); at width 6, 24,768
constexpr int kStagingBudget = 160 * 1024;

// a column's length: the chunk rounded up to even, plus 2, so that every
// column starts on 16 bytes and pairs of values load as one
__host__ __device__ constexpr int staged_ld(int chunk) {
  return (chunk + 1) / 2 * 2 + 2;
}

template <typename T>
__device__ __forceinline__ T* staged_buffer(int64_t k, int width, int ld) {
  extern __shared__ __align__(16) unsigned char staged_raw[];
  return reinterpret_cast<T*>(staged_raw) + (k & 1) * width * ld;
}

template <typename T> struct PairOf;
template <> struct PairOf<double> { using type = double2; };
template <> struct PairOf<float> { using type = float2; };

// adder c's part of one chunk: the m values of its column, in ascending
// entry order, loaded two at a time. Two groups of 2 * kPairs values are
// in registers: one is reloaded from shared memory right after it is
// added, 2 * kPairs adds before it is needed, so the adds wait only on
// each other. The groups' registers count against every thread of the
// block, stagers too: the block path keeps 8 values a group, so that four
// of its blocks fit an SM; the coarse pairs, one block per SM by their
// shared memory, keep 16.
template <int kPairs, typename T>
__device__ __forceinline__ T add_chunk(T acc, const T* col, int m) {
  using Pair = typename PairOf<T>::type;
  constexpr int kGroup = 2 * kPairs;
  const Pair* pairs = reinterpret_cast<const Pair*>(col);
  int q = 0;
  if (m >= 2 * kGroup) {
    Pair a[kPairs], b[kPairs];
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      a[u] = pairs[u];
      b[u] = pairs[kPairs + u];
    }
    for (; q + 4 * kGroup <= m; q += 2 * kGroup) {
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        acc = add_rn(acc, a[u].x);
        acc = add_rn(acc, a[u].y);
      }
#pragma unroll
      for (int u = 0; u < kPairs; ++u) a[u] = pairs[q / 2 + 2 * kPairs + u];
#pragma unroll
      for (int u = 0; u < kPairs; ++u) {
        acc = add_rn(acc, b[u].x);
        acc = add_rn(acc, b[u].y);
      }
#pragma unroll
      for (int u = 0; u < kPairs; ++u) b[u] = pairs[q / 2 + 3 * kPairs + u];
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      acc = add_rn(acc, a[u].x);
      acc = add_rn(acc, a[u].y);
    }
#pragma unroll
    for (int u = 0; u < kPairs; ++u) {
      acc = add_rn(acc, b[u].x);
      acc = add_rn(acc, b[u].y);
    }
    q += 2 * kGroup;
  }
#pragma unroll 4
  for (; q + 2 <= m; q += 2) {
    const Pair v = pairs[q / 2];
    acc = add_rn(acc, v.x);
    acc = add_rn(acc, v.y);
  }
  if (q < m) acc = add_rn(acc, col[q]);
  return acc;
}

template <typename T, bool kPerm, bool kScale>
__global__ void __launch_bounds__(kStagers + kBlockMaxWidth)
segment_sum_block_kernel(const T* __restrict__ vals,
                         const int64_t* __restrict__ perm,
                         const int64_t* __restrict__ offsets,
                         const T* __restrict__ scale,
                         const int64_t* __restrict__ schedule,
                         T* __restrict__ out, int width, int chunk) {
  const int ld = staged_ld(chunk);
  const int adders = static_cast<int>(blockDim.x) - kStagers;
  const int64_t s = schedule[blockIdx.x];
  const int64_t lo = offsets[s];
  const int64_t n = offsets[s + 1] - lo;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const int tid = threadIdx.x;
  const int j = tid - adders;  // a stager's entry in each chunk (< 0: adder)
  auto live = [&](int64_t k) { return j < chunk && k * chunk + j < n; };
  // entry j's index level, loaded ahead of its values: perm two chunks
  // ahead (e_after), and scale behind it one chunk ahead (e_next, f_next),
  // so that no load waits on another within a chunk; perm and scale are
  // loaded once per entry
  int64_t e_after = 0, e_next = 0;
  T f_next = T(1);
  auto fetch_perm = [&](int64_t k) {
    if (live(k))
      e_after = kPerm ? perm[lo + k * chunk + j] : lo + k * chunk + j;
  };
  auto fetch_scale = [&](int64_t k) {
    if (!live(k)) return;
    e_next = e_after;
    if (kScale) f_next = scale[e_next];
  };
  // entry j of chunk k: the row's values eight at a time (loads first,
  // then the products and stores); then the index levels of chunks k + 1
  // and k + 2 are requested, to land while the adders add chunk k
  auto stage = [&](int64_t k) {
    if (live(k)) {
      const T* __restrict__ row = vals + e_next * width;
      T* dst = staged_buffer<T>(k, width, ld) + j;
      for (int c0 = 0; c0 < width; c0 += 8) {
        T v[8];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + u < width) v[u] = row[c0 + u];
#pragma unroll
        for (int u = 0; u < 8; ++u)
          if (c0 + u < width)
            dst[(c0 + u) * ld] = kScale ? mul_rn(v[u], f_next) : v[u];
      }
    }
    fetch_scale(k + 1);
    fetch_perm(k + 2);
  };
  if (j >= 0 && n_chunks > 0) {
    fetch_perm(0);
    fetch_scale(0);
    fetch_perm(1);
    stage(0);
  }
  __syncthreads();
  T acc = T(0);
  for (int64_t k = 0; k < n_chunks; ++k) {
    if (j < 0) {
      if (tid < width) {
        const int m = static_cast<int>(
            n - k * chunk < chunk ? n - k * chunk : chunk);
        acc = add_chunk<4>(acc, staged_buffer<T>(k, width, ld) + tid * ld, m);
      }
    } else if (k + 1 < n_chunks) {
      stage(k + 1);
    }
    __syncthreads();
  }
  if (tid < width) out[s * width + tid] = acc;
}

// The coarse pairs: a stager forms entry e's W * W products
// (unique[e] * P[rows[e], a]) * P[cols[e], b], in the association of the
// plain version's expression, from unique, the two rows of P (1.4 MB at
// the 47,628-tet notch: L2-resident) and the indices; W * W adders sum
// them per pair.
template <typename T, int W>
__global__ void __launch_bounds__(kStagers + kBlockMaxWidth)
coarse_pair_sum_kernel(const T* __restrict__ unique,
                       const int64_t* __restrict__ order,
                       const int64_t* __restrict__ rows,
                       const int64_t* __restrict__ cols,
                       const T* __restrict__ P,
                       const int64_t* __restrict__ offsets,
                       const int64_t* __restrict__ schedule,
                       T* __restrict__ out, int chunk) {
  constexpr int kW2 = W * W;
  constexpr int kAdders = (kW2 + 31) / 32 * 32;
  static_assert(kW2 <= kBlockMaxWidth, "W * W adders per block");
  const int64_t p = schedule[blockIdx.x];
  const int64_t lo = offsets[p];
  const int64_t n = offsets[p + 1] - lo;
  const int64_t n_chunks = (n + chunk - 1) / chunk;
  const int tid = threadIdx.x;
  const int j = tid - kAdders;
  const int ld = staged_ld(chunk);
  auto live = [&](int64_t k) { return j < chunk && k * chunk + j < n; };
  // entry j's index level, loaded ahead of its rows of P: order two chunks
  // ahead (e_after), and unique, rows and cols behind it one chunk ahead,
  // so that no load waits on another within a chunk
  int64_t e_after = 0, r_next = 0, c_next = 0;
  T u_next = T(0);
  auto fetch_order = [&](int64_t k) {
    if (live(k)) e_after = order[lo + k * chunk + j];
  };
  auto fetch_index = [&](int64_t k) {
    if (!live(k)) return;
    u_next = unique[e_after];
    r_next = rows[e_after];
    c_next = cols[e_after];
  };
  // entry j of chunk k: its rows of P requested first, then the index
  // levels of chunks k + 1 and k + 2, then the products in the plain
  // version's association
  auto stage = [&](int64_t k) {
    const bool here = live(k);
    const T u = u_next;
    const T* __restrict__ pr = P + r_next * W;
    const T* __restrict__ pc = P + c_next * W;
    T a_row[W], b_row[W];
#pragma unroll
    for (int a = 0; a < W; ++a) {
      a_row[a] = here ? pr[a] : T(0);
      b_row[a] = here ? pc[a] : T(0);
    }
    fetch_index(k + 1);
    fetch_order(k + 2);
    if (!here) return;
    T* dst = staged_buffer<T>(k, kW2, ld) + j;
#pragma unroll
    for (int a = 0; a < W; ++a) {
      const T ua = mul_rn(u, a_row[a]);
#pragma unroll
      for (int b = 0; b < W; ++b)
        dst[(a * W + b) * ld] = mul_rn(ua, b_row[b]);
    }
  };
  if (j >= 0 && n_chunks > 0) {
    fetch_order(0);
    fetch_index(0);
    fetch_order(1);
    stage(0);
  }
  __syncthreads();
  T acc = T(0);
  for (int64_t k = 0; k < n_chunks; ++k) {
    if (j < 0) {
      if (tid < kW2) {
        const int m = static_cast<int>(
            n - k * chunk < chunk ? n - k * chunk : chunk);
        acc = add_chunk<8>(acc, staged_buffer<T>(k, kW2, ld) + tid * ld, m);
      }
    } else if (k + 1 < n_chunks) {
      stage(k + 1);
    }
    __syncthreads();
  }
  if (tid < kW2) out[p * kW2 + tid] = acc;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
csr_matvec_kernel(const int64_t* __restrict__ indptr,
                  const int64_t* __restrict__ cols, const T* __restrict__ data,
                  const T* __restrict__ x, T* __restrict__ y, int64_t n_rows) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t r = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       r < n_rows; r += stride) {
    const int64_t lo = indptr[r], hi = indptr[r + 1];
    T acc = T(0);
#pragma unroll 8
    for (int64_t j = lo; j < hi; ++j) acc = add_rn(acc, mul_rn(data[j], x[cols[j]]));
    y[r] = acc;
  }
}

// Enough blocks to fill every SM at the kernel's occupancy, and no more
// than `needed`; the stride loops cover the rest.
template <typename Kernel>
int grid_for(Kernel kernel, int64_t needed) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t full = static_cast<int64_t>(sms > 0 ? sms : 1) *
                       (per_sm > 0 ? per_sm : 1);
  return static_cast<int>(needed < full ? needed : full);
}

template <typename T, bool kPerm, bool kScale>
int launch_segment_sum(const void* vals, const void* perm, const void* offsets,
                       const void* scale, void* out, long long n_segments,
                       long long width, void* stream) {
  const int64_t total = static_cast<int64_t>(n_segments) * width;
  if (total <= 0) return 0;
  auto kernel = segment_sum_kernel<T, kPerm, kScale>;
  const int grid = grid_for(kernel, (total + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets), static_cast<const T*>(scale),
      static_cast<T*>(out), n_segments, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_segment_sum(const void* vals, const void* perm,
                         const void* offsets, const void* scale, void* out,
                         long long n_segments, long long width, void* stream) {
  if (perm && scale)
    return launch_segment_sum<T, true, true>(vals, perm, offsets, scale, out,
                                             n_segments, width, stream);
  if (perm)
    return launch_segment_sum<T, true, false>(vals, perm, offsets, scale, out,
                                              n_segments, width, stream);
  if (scale)
    return launch_segment_sum<T, false, true>(vals, perm, offsets, scale, out,
                                              n_segments, width, stream);
  return launch_segment_sum<T, false, false>(vals, perm, offsets, scale, out,
                                             n_segments, width, stream);
}

// Shared memory above 48 KB must be allowed per kernel. Each launcher
// instance keeps what it allowed (`allowed`), so the attribute is set once
// per size, by the first launch: a launch inside a CUDA graph's capture
// finds it set by the warm-up launch before it.
template <typename Kernel>
cudaError_t allow_staging(Kernel kernel, size_t bytes, size_t& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (rc == cudaSuccess) allowed = bytes;
  return rc;
}

// entries per chunk at this width: kStagers, or fewer (an even number)
// where a double buffer of kStagers entries would not fit kStagingBudget
template <typename T>
int staging_chunk(int width) {
  int chunk = kStagers;
  while (2 * width * staged_ld(chunk) * static_cast<int>(sizeof(T)) >
         kStagingBudget)
    chunk -= 2;
  return chunk;
}

template <typename T>
size_t staging_bytes(int width, int chunk) {
  return 2ull * width * staged_ld(chunk) * sizeof(T);
}

template <typename T, bool kPerm, bool kScale>
int launch_segment_sum_block(const void* vals, const void* perm,
                             const void* offsets, const void* scale,
                             const void* schedule, void* out,
                             long long n_segments, long long width,
                             void* stream) {
  if (n_segments <= 0 || width <= 0) return 0;
  if (width > kBlockMaxWidth || n_segments > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int w = static_cast<int>(width);
  const int chunk = staging_chunk<T>(w);
  const size_t smem = staging_bytes<T>(w, chunk);
  auto kernel = segment_sum_block_kernel<T, kPerm, kScale>;
  static size_t allowed = 48 * 1024;
  const cudaError_t rc = allow_staging(kernel, smem, allowed);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const int threads = kStagers + 32 * ((w + 31) / 32);
  kernel<<<static_cast<unsigned>(n_segments), threads, smem,
           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(vals), static_cast<const int64_t*>(perm),
      static_cast<const int64_t*>(offsets), static_cast<const T*>(scale),
      static_cast<const int64_t*>(schedule), static_cast<T*>(out), w, chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_segment_sum_block(const void* vals, const void* perm,
                               const void* offsets, const void* scale,
                               const void* schedule, void* out,
                               long long n_segments, long long width,
                               void* stream) {
  if (perm && scale)
    return launch_segment_sum_block<T, true, true>(
        vals, perm, offsets, scale, schedule, out, n_segments, width, stream);
  if (perm)
    return launch_segment_sum_block<T, true, false>(
        vals, perm, offsets, scale, schedule, out, n_segments, width, stream);
  if (scale)
    return launch_segment_sum_block<T, false, true>(
        vals, perm, offsets, scale, schedule, out, n_segments, width, stream);
  return launch_segment_sum_block<T, false, false>(
      vals, perm, offsets, scale, schedule, out, n_segments, width, stream);
}

template <typename T>
int launch_coarse_pair_sum(const void* unique, const void* order,
                           const void* rows, const void* cols, const void* P,
                           const void* offsets, const void* schedule,
                           void* out, long long n_pairs, long long width,
                           void* stream) {
  constexpr int W = 6;  // the rigid-body modes of 3D elasticity
  if (n_pairs <= 0) return 0;
  if (width != W || n_pairs > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunk = staging_chunk<T>(W * W);
  const size_t smem = staging_bytes<T>(W * W, chunk);
  auto kernel = coarse_pair_sum_kernel<T, W>;
  static size_t allowed = 48 * 1024;
  const cudaError_t rc = allow_staging(kernel, smem, allowed);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<static_cast<unsigned>(n_pairs), kStagers + (W * W + 31) / 32 * 32,
           smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(unique), static_cast<const int64_t*>(order),
      static_cast<const int64_t*>(rows), static_cast<const int64_t*>(cols),
      static_cast<const T*>(P), static_cast<const int64_t*>(offsets),
      static_cast<const int64_t*>(schedule), static_cast<T*>(out), chunk);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_csr_matvec(const void* indptr, const void* cols, const void* data,
                      const void* x, void* y, long long n_rows, void* stream) {
  if (n_rows <= 0) return 0;
  auto kernel = csr_matvec_kernel<T>;
  const int grid = grid_for(kernel, (n_rows + kThreads - 1) / kThreads);
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(indptr), static_cast<const int64_t*>(cols),
      static_cast<const T*>(data), static_cast<const T*>(x),
      static_cast<T*>(y), n_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 = success).
// perm and scale may be null: the identity order, and no scale.
int segment_sum_f32(const void* vals, const void* perm, const void* offsets,
                    const void* scale, void* out, long long n_segments,
                    long long width, void* stream) {
  return dispatch_segment_sum<float>(vals, perm, offsets, scale, out,
                                     n_segments, width, stream);
}

int segment_sum_f64(const void* vals, const void* perm, const void* offsets,
                    const void* scale, void* out, long long n_segments,
                    long long width, void* stream) {
  return dispatch_segment_sum<double>(vals, perm, offsets, scale, out,
                                      n_segments, width, stream);
}

// The block path: the same sums as segment_sum_*, one block per segment in
// the order `schedule` lists them (the plan's longest first); width at
// most 64.
int segment_sum_block_f32(const void* vals, const void* perm,
                          const void* offsets, const void* scale,
                          const void* schedule, void* out,
                          long long n_segments, long long width,
                          void* stream) {
  return dispatch_segment_sum_block<float>(vals, perm, offsets, scale,
                                           schedule, out, n_segments, width,
                                           stream);
}

int segment_sum_block_f64(const void* vals, const void* perm,
                          const void* offsets, const void* scale,
                          const void* schedule, void* out,
                          long long n_segments, long long width,
                          void* stream) {
  return dispatch_segment_sum_block<double>(vals, perm, offsets, scale,
                                            schedule, out, n_segments, width,
                                            stream);
}

// out (n_pairs, width, width): the coarse pairs' sums; P is (n_dofs,
// width) with width 6; unique, rows and cols the fine COO triplet, order
// its entries in pair order, offsets and schedule the pair plan's.
int coarse_pair_sum_f32(const void* unique, const void* order,
                        const void* rows, const void* cols, const void* P,
                        const void* offsets, const void* schedule, void* out,
                        long long n_pairs, long long width, void* stream) {
  return launch_coarse_pair_sum<float>(unique, order, rows, cols, P, offsets,
                                       schedule, out, n_pairs, width, stream);
}

int coarse_pair_sum_f64(const void* unique, const void* order,
                        const void* rows, const void* cols, const void* P,
                        const void* offsets, const void* schedule, void* out,
                        long long n_pairs, long long width, void* stream) {
  return launch_coarse_pair_sum<double>(unique, order, rows, cols, P,
                                        offsets, schedule, out, n_pairs,
                                        width, stream);
}

int csr_matvec_f32(const void* indptr, const void* cols, const void* data,
                   const void* x, void* y, long long n_rows, void* stream) {
  return launch_csr_matvec<float>(indptr, cols, data, x, y, n_rows, stream);
}

int csr_matvec_f64(const void* indptr, const void* cols, const void* data,
                   const void* x, void* y, long long n_rows, void* stream) {
  return launch_csr_matvec<double>(indptr, cols, data, x, y, n_rows, stream);
}

}  // extern "C"
