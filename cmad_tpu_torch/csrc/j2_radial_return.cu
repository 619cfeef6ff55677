// J2+Voce radial returns on Hopper (sm_90a): four kernels with a plain C
// interface, loaded with ctypes by cmad_tpu_torch/ops/_build.py.
//
// Replaces the Pallas kernels of cmad_tpu/ops/pallas_radial_return.py:
//   j2_soa_step    <- _kernel_soa (K1) and its shared body _radial_rows;
//                     the wide twin _kernel_soa_wide (K6) is a reshape view
//                     of the same bytes and calls this kernel too.
//   j2_soa_history <- _kernel_soa_hist_full (K2) and _kernel_soa_hist (K3);
//                     the wide twins K7 and K8 are views onto it.
//   j2_aos_step    <- _kernel (K4), the rate-form step on the AoS state.
//   j2_total_step  <- _kernel_total (K5), the total-form step.
//
// The first two read the component-major (SoA) layout described below;
// the AoS kernels are described where they are defined.
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

// Deviator, Mises norm and plastic multiplier of one trial stress
// s[0..5] (order xx, xy, xz, yy, yz, zz) at hardening variable alpha_prev:
// the part every TPU kernel shares (pallas_radial_return.py:63-85).
template <typename T>
struct Corrector {
  T d0, d3, d5;  // diagonal of the trial deviator
  T safe_phi;    // phi_tr, or 1 where phi_tr == 0
  T dg;          // plastic multiplier (0 on elastic points)
  bool plastic;
};

template <typename T>
__device__ __forceinline__ Corrector<T> j2_corrector(const T s[6],
                                                     T alpha_prev,
                                                     const Material<T>& m) {
  Corrector<T> c;
  const T p = (s[0] + s[3] + s[5]) / T(3);
  c.d0 = s[0] - p;
  c.d3 = s[3] - p;
  c.d5 = s[5] - p;
  const T phi_sq = c.d0 * c.d0 + c.d3 * c.d3 + c.d5 * c.d5 +
                   T(2) * (s[1] * s[1] + s[2] * s[2] + s[4] * s[4]);
  const T phi_tr = sqrt_(T(1.5) * phi_sq);

  const T f_trial = phi_tr - m.Y - m.S * (T(1) - exp_(-m.D * alpha_prev));
  c.plastic = f_trial > T(0);

  // Elastic points keep dg = 0, which is what the TPU kernel's select
  // after the maximum gives them; they never evaluate g / dgd.
  T dg = T(0);
  if (c.plastic) {
#pragma unroll
    for (int k = 0; k < kNewtonIters; ++k) {
      const T ex = exp_(-m.D * (alpha_prev + dg));
      const T g = phi_tr - T(3) * m.mu * dg - m.Y - m.S * (T(1) - ex);
      const T dgd = -T(3) * m.mu - m.S * m.D * ex;
      dg = fmax_(dg - g / dgd, T(0));
    }
  }
  c.dg = dg;
  c.safe_phi = phi_tr > T(0) ? phi_tr : T(1);
  return c;
}

// One rate-form radial return on seven state values x (6 stress + alpha)
// and six strain increments e; x is updated in place.
template <typename T>
__device__ __forceinline__ void radial_rows(T x[7], const T e[6],
                                            const Material<T>& m) {
  const T tr = e[0] + e[3] + e[5];
  const T two_mu = T(2) * m.mu;
  const T diag = m.lam * tr;
  const T s[6] = {x[0] + diag + two_mu * e[0], x[1] + two_mu * e[1],
                  x[2] + two_mu * e[2],        x[3] + diag + two_mu * e[3],
                  x[4] + two_mu * e[4],        x[5] + diag + two_mu * e[5]};
  const T alpha_prev = x[6];
  const Corrector<T> c = j2_corrector(s, alpha_prev, m);
  const T scale = c.plastic ? T(3) * m.mu * c.dg / c.safe_phi : T(0);

  x[0] = s[0] - scale * c.d0;
  x[1] = s[1] * (T(1) - scale);
  x[2] = s[2] * (T(1) - scale);
  x[3] = s[3] - scale * c.d3;
  x[4] = s[4] * (T(1) - scale);
  x[5] = s[5] - scale * c.d5;
  x[6] = alpha_prev + c.dg;
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

// ---------------------------------------------------------------------------
// AoS kernels (K4, K5). Point j's state is the row xi[7j .. 7j+6] of an
// (N, 7) array and its displacement gradients the rows g[9j .. 9j+8] of
// (N, 3, 3) arrays, row-major; the outputs are xi' (N, 7) and the full
// symmetric sigma (N, 3, 3), both entries of each off-diagonal pair
// written. The TPU wrappers packed these into a (16, B) block with B
// padded to the 2048-lane tile (a transpose and a pad each way,
// pallas_radial_return.py:775-810, :724-759); here each thread reads its
// point's rows in place and writes its outputs in place, no pack, no pad.
//
// What bounds them on an H100 (3.35 TB/s HBM3 at 700 W): memory.
// j2_aos_step reads 7 + 9 + 9 and writes 7 + 9 values per point (328 B in
// f64, 164 B in f32); j2_total_step reads 7 + 9 and writes 7 + 9 (256 B
// in f64, 128 B in f32). The Newton corrector is as in the SoA kernels.
// Rows of 56 B and 72 B make a warp's loads strided: each load
// instruction touches 32 rows, and the L1 serves the other values of the
// same rows to the following loads. Coalescing through shared memory is
// later work.
// ---------------------------------------------------------------------------

template <typename T>
__device__ __forceinline__ void store_sigma(T* __restrict__ out,
                                            const T s[6]) {
  out[0] = s[0];
  out[1] = s[1];
  out[2] = s[2];
  out[3] = s[1];
  out[4] = s[3];
  out[5] = s[4];
  out[6] = s[2];
  out[7] = s[4];
  out[8] = s[5];
}

// One rate-form step from AoS rows (K4, _kernel at
// pallas_radial_return.py:40-95): the strain increment
// sym(grad_u - grad_u_prev), the trial stress, the corrector, and the
// stress written as the new state and as sigma. The body is radial_rows,
// whose shear update s * (1 - scale) is _radial_rows' and the plain
// version's; _kernel wrote s - scale * s, equal up to rounding.
template <typename T>
__global__ void __launch_bounds__(kThreads)
j2_aos_step_kernel(const T* __restrict__ xi, const T* __restrict__ grad_u,
                   const T* __restrict__ grad_u_prev,
                   const T* __restrict__ scalars, T* __restrict__ xi_out,
                   T* __restrict__ sigma_out, int64_t n) {
  const Material<T> m = load_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const T* __restrict__ x_in = xi + 7 * j;
    const T* __restrict__ g = grad_u + 9 * j;
    const T* __restrict__ g0 = grad_u_prev + 9 * j;
    T x[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = x_in[r];
    // the order of make_j2_radial_return's increment
    const T e[6] = {g[0] - g0[0],
                    T(0.5) * (g[1] + g[3] - g0[1] - g0[3]),
                    T(0.5) * (g[2] + g[6] - g0[2] - g0[6]),
                    g[4] - g0[4],
                    T(0.5) * (g[5] + g[7] - g0[5] - g0[7]),
                    g[8] - g0[8]};
    radial_rows(x, e, m);
    T* __restrict__ x_out = xi_out + 7 * j;
#pragma unroll
    for (int r = 0; r < 7; ++r) x_out[r] = x[r];
    store_sigma(sigma_out + 9 * j, x);
  }
}

// One total-form step (K5, _kernel_total at pallas_radial_return.py:
// 624-693): state [plastic strain pe (6), alpha]; the trial stress comes
// from the elastic strain sym(grad_u) - pe, the plastic strain moves by
// dp = coef * dev(s_tr), and sigma = s_tr - 2 mu dp. grad_u_prev plays no
// part (the total form is parametrized by the current strain).
template <typename T>
__global__ void __launch_bounds__(kThreads)
j2_total_step_kernel(const T* __restrict__ xi, const T* __restrict__ grad_u,
                     const T* __restrict__ scalars, T* __restrict__ xi_out,
                     T* __restrict__ sigma_out, int64_t n) {
  const Material<T> m = load_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    const T* __restrict__ x_in = xi + 7 * j;
    const T* __restrict__ g = grad_u + 9 * j;
    T pe[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) pe[r] = x_in[r];
    const T alpha_prev = x_in[6];
    const T e[6] = {g[0] - pe[0],
                    T(0.5) * (g[1] + g[3]) - pe[1],
                    T(0.5) * (g[2] + g[6]) - pe[2],
                    g[4] - pe[3],
                    T(0.5) * (g[5] + g[7]) - pe[4],
                    g[8] - pe[5]};
    const T tr = e[0] + e[3] + e[5];
    const T two_mu = T(2) * m.mu;
    const T diag = m.lam * tr;
    const T s[6] = {diag + two_mu * e[0], two_mu * e[1], two_mu * e[2],
                    diag + two_mu * e[3], two_mu * e[4],
                    diag + two_mu * e[5]};
    const Corrector<T> c = j2_corrector(s, alpha_prev, m);
    const T coef = c.plastic ? T(1.5) * c.dg / c.safe_phi : T(0);
    // deviator of the trial stress in sym-vec order
    const T dev[6] = {c.d0, s[1], s[2], c.d3, s[4], c.d5};

    T* __restrict__ x_out = xi_out + 7 * j;
#pragma unroll
    for (int r = 0; r < 6; ++r) x_out[r] = pe[r] + coef * dev[r];
    x_out[6] = alpha_prev + c.dg;
    T sig[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) sig[r] = s[r] - two_mu * coef * dev[r];
    store_sigma(sigma_out + 9 * j, sig);
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

template <typename T>
int launch_aos(const void* xi, const void* grad_u, const void* grad_u_prev,
               const void* scalars, void* xi_out, void* sigma_out,
               long long n, void* stream) {
  if (n <= 0) return 0;
  const int grid = grid_for(j2_aos_step_kernel<T>, n);
  j2_aos_step_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xi), static_cast<const T*>(grad_u),
      static_cast<const T*>(grad_u_prev), static_cast<const T*>(scalars),
      static_cast<T*>(xi_out), static_cast<T*>(sigma_out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_total(const void* xi, const void* grad_u, const void* scalars,
                 void* xi_out, void* sigma_out, long long n, void* stream) {
  if (n <= 0) return 0;
  const int grid = grid_for(j2_total_step_kernel<T>, n);
  j2_total_step_kernel<T><<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xi), static_cast<const T*>(grad_u),
      static_cast<const T*>(scalars), static_cast<T*>(xi_out),
      static_cast<T*>(sigma_out), n);
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

int j2_aos_step_f32(const void* xi, const void* grad_u,
                    const void* grad_u_prev, const void* scalars,
                    void* xi_out, void* sigma_out, long long n,
                    void* stream) {
  return launch_aos<float>(xi, grad_u, grad_u_prev, scalars, xi_out,
                           sigma_out, n, stream);
}

int j2_aos_step_f64(const void* xi, const void* grad_u,
                    const void* grad_u_prev, const void* scalars,
                    void* xi_out, void* sigma_out, long long n,
                    void* stream) {
  return launch_aos<double>(xi, grad_u, grad_u_prev, scalars, xi_out,
                            sigma_out, n, stream);
}

int j2_total_step_f32(const void* xi, const void* grad_u,
                      const void* scalars, void* xi_out, void* sigma_out,
                      long long n, void* stream) {
  return launch_total<float>(xi, grad_u, scalars, xi_out, sigma_out, n,
                             stream);
}

int j2_total_step_f64(const void* xi, const void* grad_u,
                      const void* scalars, void* xi_out, void* sigma_out,
                      long long n, void* stream) {
  return launch_total<double>(xi, grad_u, scalars, xi_out, sigma_out, n,
                              stream);
}

const char* j2_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
