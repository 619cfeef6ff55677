// J2+Voce rate-form radial return on Hopper (sm_90a): two kernels with a
// plain C interface, loaded with ctypes by cmad_tpu_torch/ops/_build.py.
//
// Replaces the Pallas kernels of cmad_tpu/ops/pallas_radial_return.py:
//   j2_soa_step    <- _kernel_soa (K1) and its shared body _radial_rows;
//                     the wide twin _kernel_soa_wide (K6) is a reshape view
//                     of the same bytes and calls this kernel too.
//   j2_soa_history <- _kernel_soa_hist_full (K2) and _kernel_soa_hist (K3);
//                     the wide twins K7 and K8 are views onto it.
//
// Layout (component-major, contract in ops/j2_radial_return.py): row r of
// point j sits at r*N + j. One thread owns one point (grid-stride loop),
// so each row load and store of a warp is one coalesced 32-point segment.
// The TPU's tiling is not carried over: no padding, the loop bound masks
// the ragged edge, and offsets are 64-bit (T*8*N passes 2^31 at 4M
// points x 64 steps).
//
// The five material scalars [mu, lam, Y, S, D] come in as a device
// pointer and are loaded by every thread (broadcast through the read-only
// cache), so no host sync is needed to launch a step.
//
// What bounds it on an H100 (3.35 TB/s HBM3 at 700 W): both kernels are
// memory-bound. j2_soa_step moves 6 + 7 reads and 8 writes per update
// (168 B in f64, 84 B in f32). j2_soa_history keeps the 7 state values
// in registers across a runtime loop over T and reads only strain rows
// 0-5 of each step: 48 B of strain per update plus 120/T B of state in
// f64 (24 + 60/T B in f32). The Newton corrector costs 8 exp and 8
// divides per plastic point; in f64 that is the part that may become the
// limit (the H100 issues f64 at half its f32 rate). The next step's
// strain is loaded before the current step is computed, so one step's
// loads are in flight under the arithmetic of the previous one.
//
// The arithmetic follows _radial_rows (pallas_radial_return.py:123-170)
// op for op. nvcc contracts a*b+c into FMAs (no --use_fast_math: expf
// stays the accurate one), so results differ from the plain PyTorch
// version by rounding only.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNewtonIters = 8;  // _SCALAR_NEWTON_ITERS
constexpr int kRows = 8;
constexpr int kThreads = 256;

__device__ __forceinline__ float exp_(float x) { return expf(x); }
__device__ __forceinline__ double exp_(double x) { return exp(x); }
__device__ __forceinline__ float sqrt_(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_(double x) { return sqrt(x); }
__device__ __forceinline__ float fmax_(float a, float b) { return fmaxf(a, b); }
__device__ __forceinline__ double fmax_(double a, double b) { return fmax(a, b); }

template <typename T>
struct Material {
  T mu, lam, Y, S, D;
};

template <typename T>
__device__ __forceinline__ Material<T> load_material(const T* __restrict__ s) {
  return Material<T>{__ldg(s + 0), __ldg(s + 1), __ldg(s + 2), __ldg(s + 3),
                     __ldg(s + 4)};
}

// One rate-form radial return on seven state values x (6 stress + alpha)
// and six strain increments e; x is updated in place.
template <typename T>
__device__ __forceinline__ void radial_rows(T x[7], const T e[6],
                                            const Material<T>& m) {
  const T tr = e[0] + e[3] + e[5];
  const T two_mu = T(2) * m.mu;
  const T diag = m.lam * tr;
  const T s0 = x[0] + diag + two_mu * e[0];
  const T s1 = x[1] + two_mu * e[1];
  const T s2 = x[2] + two_mu * e[2];
  const T s3 = x[3] + diag + two_mu * e[3];
  const T s4 = x[4] + two_mu * e[4];
  const T s5 = x[5] + diag + two_mu * e[5];

  const T p = (s0 + s3 + s5) / T(3);
  const T d0 = s0 - p;
  const T d3 = s3 - p;
  const T d5 = s5 - p;
  const T phi_sq = d0 * d0 + d3 * d3 + d5 * d5 +
                   T(2) * (s1 * s1 + s2 * s2 + s4 * s4);
  const T phi_tr = sqrt_(T(1.5) * phi_sq);

  const T alpha_prev = x[6];
  const T f_trial = phi_tr - m.Y - m.S * (T(1) - exp_(-m.D * alpha_prev));
  const bool plastic = f_trial > T(0);

  // Elastic points keep dg = 0, which is what the TPU kernel's select
  // after the maximum gives them; they never evaluate g / dgd.
  T dg = T(0);
  if (plastic) {
#pragma unroll
    for (int k = 0; k < kNewtonIters; ++k) {
      const T ex = exp_(-m.D * (alpha_prev + dg));
      const T g = phi_tr - T(3) * m.mu * dg - m.Y - m.S * (T(1) - ex);
      const T dgd = -T(3) * m.mu - m.S * m.D * ex;
      dg = fmax_(dg - g / dgd, T(0));
    }
  }

  const T safe_phi = phi_tr > T(0) ? phi_tr : T(1);
  const T scale = plastic ? T(3) * m.mu * dg / safe_phi : T(0);

  x[0] = s0 - scale * d0;
  x[1] = s1 * (T(1) - scale);
  x[2] = s2 * (T(1) - scale);
  x[3] = s3 - scale * d3;
  x[4] = s4 * (T(1) - scale);
  x[5] = s5 - scale * d5;
  x[6] = alpha_prev + dg;
}

template <typename T>
__device__ __forceinline__ void store_state(T* __restrict__ out, const T x[7],
                                            int64_t j, int64_t n) {
#pragma unroll
  for (int r = 0; r < 7; ++r) out[r * n + j] = x[r];
  out[7 * n + j] = T(0);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
j2_soa_step_kernel(const T* __restrict__ xi, const T* __restrict__ de,
                   const T* __restrict__ scalars, T* __restrict__ out,
                   int64_t n) {
  const Material<T> m = load_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    T x[7];
    T e[6];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = xi[r * n + j];
#pragma unroll
    for (int r = 0; r < 6; ++r) e[r] = de[r * n + j];
    radial_rows(x, e, m);
    store_state(out, x, j, n);
  }
}

// The whole strain history for one point in one thread: the TPU kernel
// carried the state across its sequential grid axis in VMEM; here blocks
// run in no order, so the loop over T lives inside the thread and the
// state stays in registers. Row 7 of the output is written as zero (K2
// passed the input's pad row through; every caller's pad row is zero).
template <typename T>
__global__ void __launch_bounds__(kThreads)
j2_soa_history_kernel(const T* __restrict__ xi, const T* __restrict__ de_hist,
                      const T* __restrict__ scalars, T* __restrict__ out,
                      int64_t n, int64_t t_steps) {
  const Material<T> m = load_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t step_stride = kRows * n;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    T x[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = xi[r * n + j];
    T e_next[6];
    if (t_steps > 0) {
#pragma unroll
      for (int r = 0; r < 6; ++r) e_next[r] = de_hist[r * n + j];
    }
    for (int64_t t = 0; t < t_steps; ++t) {
      T e[6];
#pragma unroll
      for (int r = 0; r < 6; ++r) e[r] = e_next[r];
      if (t + 1 < t_steps) {
        const T* __restrict__ nxt = de_hist + (t + 1) * step_stride;
#pragma unroll
        for (int r = 0; r < 6; ++r) e_next[r] = nxt[r * n + j];
      }
      radial_rows(x, e, m);
    }
    store_state(out, x, j, n);
  }
}

// Enough blocks to fill every SM at the kernel's occupancy, and no more
// than the points need; the grid-stride loop covers the rest.
template <typename Kernel>
int grid_for(Kernel kernel, int64_t n) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t full = static_cast<int64_t>(sms > 0 ? sms : 1) *
                       (per_sm > 0 ? per_sm : 1);
  const int64_t needed = (n + kThreads - 1) / kThreads;
  return static_cast<int>(needed < full ? needed : full);
}

template <typename T>
int launch_step(const void* xi, const void* de, const void* scalars, void* out,
                long long n, void* stream) {
  if (n <= 0) return 0;
  const int grid = grid_for(j2_soa_step_kernel<T>, n);
  j2_soa_step_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xi), static_cast<const T*>(de),
      static_cast<const T*>(scalars), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_history(const void* xi, const void* de_hist, const void* scalars,
                   void* out, long long n, long long t_steps, void* stream) {
  if (n <= 0) return 0;
  const int grid = grid_for(j2_soa_history_kernel<T>, n);
  j2_soa_history_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xi), static_cast<const T*>(de_hist),
      static_cast<const T*>(scalars), static_cast<T*>(out), n, t_steps);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Each entry returns cudaGetLastError() after its launch (0 = success).
int j2_soa_step_f32(const void* xi, const void* de, const void* scalars,
                    void* out, long long n, void* stream) {
  return launch_step<float>(xi, de, scalars, out, n, stream);
}

int j2_soa_step_f64(const void* xi, const void* de, const void* scalars,
                    void* out, long long n, void* stream) {
  return launch_step<double>(xi, de, scalars, out, n, stream);
}

int j2_soa_history_f32(const void* xi, const void* de_hist,
                       const void* scalars, void* out, long long n,
                       long long t_steps, void* stream) {
  return launch_history<float>(xi, de_hist, scalars, out, n, t_steps, stream);
}

int j2_soa_history_f64(const void* xi, const void* de_hist,
                       const void* scalars, void* out, long long n,
                       long long t_steps, void* stream) {
  return launch_history<double>(xi, de_hist, scalars, out, n, t_steps, stream);
}

const char* j2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
