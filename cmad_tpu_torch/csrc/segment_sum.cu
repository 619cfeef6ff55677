// Reproducible sums on Hopper (sm_90a): a segment sum over a fixed plan,
// and the CSR matrix-vector product, each adding in one fixed order. Plain
// C interface, loaded with ctypes by cmad_tpu_torch/ops/_build.py.
//
// These replace no TPU kernel: they replace torch's index_add_ and the
// cuSPARSE product on the FE path (the residual scatter and COO dedup of
// assembly, the CSR dedup, the embedded-BC diagonal, the two-level
// restriction and coarse matrix, and CG's product). On the card
// index_add_ adds float64 with atomics, in an order that changes from run
// to run, so the last bits of R and K did, and with them the Newton's
// path. Here every output is one thread's sequential sum:
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
// into FMAs, which would round differently from the CPU.
//
//   csr_matvec:  y[r] = sum over j in [indptr[r], indptr[r + 1]) of
//                data[j] * x[cols[j]], added in ascending j from 0.
//
// What bounds them on an H100 (3.35 TB/s HBM3 at 700 W): bytes, each
// value and index read once and each output written once; at the FE
// path's shapes (a few thousand to a few million outputs) the latency of
// one thread's dependent adds over its segment, since a segment is never
// split across threads (that would change the order). The inner loop is
// unrolled so that the loads of later entries are in flight while the
// adds wait; consecutive threads take consecutive columns of one segment
// (or consecutive rows), so a warp's loads of a column group are
// coalesced.

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

int csr_matvec_f32(const void* indptr, const void* cols, const void* data,
                   const void* x, void* y, long long n_rows, void* stream) {
  return launch_csr_matvec<float>(indptr, cols, data, x, y, n_rows, stream);
}

int csr_matvec_f64(const void* indptr, const void* cols, const void* data,
                   const void* x, void* y, long long n_rows, void* stream) {
  return launch_csr_matvec<double>(indptr, cols, data, x, y, n_rows, stream);
}

}  // extern "C"
