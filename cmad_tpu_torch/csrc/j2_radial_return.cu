// J2+Voce radial returns on Hopper (sm_90a): four kernels with a plain C
// interface, loaded with ctypes by cmad_tpu_torch/ops/_build.py.
//
// Replaces the Pallas kernels of cmad_tpu/ops/pallas_radial_return.py:
//   j2_soa_step    <- _kernel_soa (K1) and its shared body _radial_rows;
//                     the wide twin _kernel_soa_wide (K6) is a reshape view
//                     of the same bytes and calls this kernel too.
//   j2_soa_history <- _kernel_soa_hist_full (K2) and _kernel_soa_hist (K3);
//                     the wide twins K7 and K8 are views onto it. In f32
//                     its Newton's iteration count is a template
//                     parameter, and j2_soa_history_f32_iters launches it
//                     with 1, 2, 4, 8 or 12 iterations: the roofline
//                     experiment's kernel (R, `kernel` in _make_hist_call,
//                     benchmarks/local_kernels/roofline_experiment.py:40),
//                     K3 with t_steps and the iteration count as
//                     parameters. Its 8-iteration instance is the kernel
//                     of j2_soa_history_f32.
//   j2_aos_step    <- _kernel (K4), the rate-form step on the AoS state.
//   j2_total_step  <- _kernel_total (K5), the total-form step.
//
// The first two read the component-major (SoA) layout described below and
// share one update, soa_rows; the AoS kernels, which share one staged tile
// loop, are described where they are defined.
//
// Layout (component-major, contract in ops/j2_radial_return.py): row r of
// point j sits at r*N + j. Consecutive threads own consecutive points, so
// each row load and store of a warp is one coalesced 32-point segment.
// The TPU's tiling is not carried over: no padding, the loop bound masks
// the ragged edge, and offsets are 64-bit (T*8*N passes 2^31 at 4M
// points x 64 steps).
//
// The five material scalars [mu, lam, Y, S, D] come in as a device
// pointer and are loaded by every thread (broadcast through the read-only
// cache), so no host sync is needed to launch a step.
//
// The AoS kernels' arithmetic follows _radial_rows
// (pallas_radial_return.py:123-170) op for op; the SoA kernels' reaches
// the same Newton fixed point by a shorter path (soa_newton). nvcc
// contracts a*b+c into FMAs (no --use_fast_math: expf stays the accurate
// one), so results differ from the plain PyTorch version by rounding only.

#include <cuda_runtime.h>

#include <cstdint>

#include "launch_grid.cuh"

namespace {

constexpr int kNewtonIters = 8;  // _SCALAR_NEWTON_ITERS
constexpr int kRows = 8;

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

// Asynchronous 4 B / 8 B copy from global to shared memory (cp.async,
// sm_80+): no register holds the value on the way, and the issuing
// thread sees it after cp_async_wait.
template <typename T>
__device__ __forceinline__ void cp_async(T* smem, const T* gmem) {
  static_assert(sizeof(T) == 4 || sizeof(T) == 8, "4 B or 8 B words");
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(dst),
               "l"(gmem), "n"(sizeof(T))
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `Pending` of this thread's committed groups are
// still in flight.
template <int Pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(Pending) : "memory");
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

// The plastic multiplier of a yielding point: kNewtonIters Newton
// iterations from dg = 0 on g = phi_tr - 3 mu dg - Y - S (1 - ex).
template <typename T>
__device__ __forceinline__ T voce_newton(T phi_tr, T alpha_prev,
                                        const Material<T>& m) {
  T dg = T(0);
#pragma unroll
  for (int k = 0; k < kNewtonIters; ++k) {
    const T ex = exp_(-m.D * (alpha_prev + dg));
    const T g = phi_tr - T(3) * m.mu * dg - m.Y - m.S * (T(1) - ex);
    const T dgd = -T(3) * m.mu - m.S * m.D * ex;
    dg = fmax_(dg - g / dgd, T(0));
  }
  return dg;
}

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
  if (c.plastic) dg = voce_newton(phi_tr, alpha_prev, m);
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

// ---------------------------------------------------------------------------
// soa_rows: the update of the SoA kernels (j2_soa_step, j2_soa_history):
// radial_rows' trial stress, yield check and radial corrector, with a
// shorter path to the Newton's fixed point.
//
// What it is up against: with j2_corrector's Newton a plastic update adds
// 8 iterations, each an exp (in f64 a 14-FMA polynomial, its constants
// rematerialised, about 35 instructions) and an IEEE divide (MUFU.RCP64H,
// 7 FP64 instructions and a range check): 480 f64 operations and about
// 1,000 instructions in the SASS, against 118 for an elastic update. The
// schedulers' one instruction a cycle and the FP64 pipe (2 cycles a warp
// instruction) then set the pace: the f64 history on plastic data took
// 2.7x its all-elastic time, and one step at the FE notch's 47,628 points
// spent longer issuing its Newton than moving its bytes.
//
// What soa_newton does about it: fewer instructions for the same fixed
// point, the 8 iterations kept.
// - Iteration 0 reuses exp(-D alpha_prev) from the yield check (dg = 0
//   there, and alpha_prev + 0 only flips the sign of a zero).
// - 3 mu, S D and Y + S are hoisted: g = (phi - (Y + S)) - 3 mu dg +
//   S ex, two FMAs.
// - In f64 the first kF32Iters iterations run in f32 (MUFU.EX2 and a fast
//   reciprocal, on the FP32 pipe); they bring dg to f32 precision, and
//   the last two run in f64 from there: Newton's quadratic convergence
//   takes an f32-accurate dg to the f64 fixed point in one iteration.
//   Only where f32 can hold the iteration: phi - (Y + S), 3 mu, Y + S, S
//   and S D within kF32Range (below). A point outside it (a trial stress
//   beyond f32's range, or S D above it) would leave the f32 phase with a
//   meaningless dg, and silently so: fmaxf(NaN, 0) is 0. It takes the
//   slow path soa_newton_exact instead, j2_corrector's Newton in f64.
// - Every iteration but the last divides with a fast reciprocal (f64:
//   MUFU.RCP64H and one cubic refinement; f32: __fdividef); the last one
//   is the exact IEEE divide, as j2_corrector's.
// A plastic f64 update adds about 122 f64 operations instead of 480. The
// yield check, trial stress and radial scale are radial_rows' in its
// order of operations, so a point is classified exactly as there.
// ---------------------------------------------------------------------------

constexpr int kF32Iters = 6;  // f64: Newton iterations run in f32

// The corrector's constants, hoisted out of the loops.
template <typename T>
struct Voce {
  T mu3, ys, s, d, sd;  // 3 mu, Y + S, S, D, S D
};

template <typename T, typename M>
__device__ __forceinline__ Voce<T> voce(const Material<M>& m) {
  const T mu = static_cast<T>(m.mu), s = static_cast<T>(m.S),
          d = static_cast<T>(m.D);
  return Voce<T>{T(3) * mu, static_cast<T>(m.Y) + s, s, d, s * d};
}

// 1 / x to about 1 ulp: MUFU.RCP64H, then one cubic refinement.
__device__ __forceinline__ double rcp_fast(double x) {
  double r;
  asm("rcp.approx.ftz.f64 %0, %1;" : "=d"(r) : "d"(x));
  const double e = fma(-x, r, 1.0);
  return fma(r, fma(e, e, e), r);
}

// One Newton iteration on dg: g = phi - 3 mu dg - Y - S (1 - ex) with c =
// phi - (Y + S), dgd = dg/d(dg); `exact` takes the IEEE divide.
__device__ __forceinline__ float newton_step(float dg, float c, float ex,
                                             const Voce<float>& v,
                                             bool exact) {
  const float g = c - v.mu3 * dg + v.s * ex;
  const float dgd = -v.mu3 - v.sd * ex;
  return fmaxf(dg - (exact ? g / dgd : __fdividef(g, dgd)), 0.f);
}

__device__ __forceinline__ double newton_step(double dg, double c, double ex,
                                              const Voce<double>& v,
                                              bool exact) {
  const double g = c - v.mu3 * dg + v.s * ex;
  const double dgd = -v.mu3 - v.sd * ex;
  return fmax(dg - (exact ? g / dgd : g * rcp_fast(dgd)), 0.0);
}

// The f32 phase of the f64 Newton holds only for values within kF32Range
// (and 3 mu at least 1 / kF32Range): far enough inside f32's 3.4e38 that
// the sums of an iteration stay finite and the fast divide's divisor stays
// below 2^126, beyond which __fdividef returns 0. NaN fails every test.
constexpr float kF32Range = 0x1p100f;

// The largest |phi - (Y + S)| the f32 phase takes: kF32Range when the
// material's constants are in range, else -1 (no point).
__device__ __forceinline__ float f32_phase_limit(const Voce<float>& v) {
  const bool ok = v.mu3 >= 1.f / kF32Range && v.mu3 <= kF32Range &&
                  fabsf(v.ys) <= kF32Range && fabsf(v.s) <= kF32Range &&
                  fabsf(v.sd) <= kF32Range;
  return ok ? kF32Range : -1.f;
}

// The material's constants as the SoA update takes them, computed once
// per thread: the material, its hoisted constants in T and in f32, and
// f32_phase_limit of the latter.
template <typename T>
struct SoaMaterial {
  Material<T> m;
  Voce<T> v;
  Voce<float> vf;
  float f32_limit;
};

template <typename T>
__device__ __forceinline__ SoaMaterial<T> soa_material(
    const T* __restrict__ scalars) {
  const Material<T> m = load_material(scalars);
  const Voce<float> vf = voce<float>(m);
  return SoaMaterial<T>{m, voce<T>(m), vf, f32_phase_limit(vf)};
}

// The plastic multiplier of a yielding point: Iters Newton iterations
// from dg = 0, ex0 = exp(-D alpha), the last one with the exact divide
// (kNewtonIters = 8 everywhere but the roofline sweep).
template <int Iters>
__device__ __forceinline__ float soa_newton(float phi, float alpha,
                                            float ex0,
                                            const SoaMaterial<float>& sm) {
  static_assert(Iters >= 1, "at least one Newton iteration");
  const Voce<float>& v = sm.v;
  const float c = phi - v.ys;
  float dg = 0.f;
#pragma unroll
  for (int it = 0; it < Iters; ++it) {
    const float ex = it == 0 ? ex0 : expf(-v.d * (alpha + dg));
    dg = newton_step(dg, c, ex, v, it + 1 == Iters);
  }
  return dg;
}

// The slow path of the f64 Newton, for a point outside the f32 phase's
// range: j2_corrector's Newton, all in f64. Not inlined, like the IEEE
// divide's slow path: it stays out of the hot loop's code, and out of the
// operations that ops/_sass.py counts per update.
__device__ __noinline__ double soa_newton_exact(double phi, double alpha,
                                                double mu, double Y,
                                                double S, double D) {
  return voce_newton(phi, alpha, Material<double>{mu, 0.0, Y, S, D});
}

// The f64 Newton runs kNewtonIters iterations only.
template <int Iters>
__device__ __forceinline__ double soa_newton(double phi, double alpha,
                                             double ex0,
                                             const SoaMaterial<double>& sm) {
  static_assert(Iters == kNewtonIters, "the f64 Newton runs 8 iterations");
  const Voce<double>& v = sm.v;
  const Voce<float>& vf = sm.vf;
  const double c = phi - v.ys;
  const float cf = static_cast<float>(c), af = static_cast<float>(alpha);
  float dgf = 0.f;
#pragma unroll
  for (int it = 0; it < kF32Iters; ++it) {
    const float ex = it == 0 ? static_cast<float>(ex0)
                             : expf(-vf.d * (af + dgf));
    dgf = newton_step(dgf, cf, ex, vf, false);
  }
  double dg = dgf;
#pragma unroll
  for (int it = kF32Iters; it < kNewtonIters; ++it) {
    const double ex = it == 0 ? ex0 : exp(-v.d * (alpha + dg));
    dg = newton_step(dg, c, ex, v, it + 1 == kNewtonIters);
  }
  // Outside the f32 phase's range this dg is meaningless: replace it.
  // Tested here, on the phase's inputs, and not before the phase, so that
  // the points in range run the phase with no branch around it.
  if (!(fabsf(cf) <= sm.f32_limit)) {
    const Material<double>& m = sm.m;
    dg = soa_newton_exact(phi, alpha, m.mu, m.Y, m.S, m.D);
  }
  return dg;
}

// radial_rows with the Newton of soa_newton: the same trial stress, yield
// check and corrector, in the same order of operations.
template <typename T, int Iters>
__device__ __forceinline__ void soa_rows(T x[7], const T e[6],
                                         const SoaMaterial<T>& sm) {
  const Material<T>& m = sm.m;
  const T tr = e[0] + e[3] + e[5];
  const T two_mu = T(2) * m.mu;
  const T diag = m.lam * tr;
  const T s[6] = {x[0] + diag + two_mu * e[0], x[1] + two_mu * e[1],
                  x[2] + two_mu * e[2],        x[3] + diag + two_mu * e[3],
                  x[4] + two_mu * e[4],        x[5] + diag + two_mu * e[5]};
  const T alpha_prev = x[6];
  const T p = (s[0] + s[3] + s[5]) / T(3);
  const T d0 = s[0] - p, d3 = s[3] - p, d5 = s[5] - p;
  const T phi_sq = d0 * d0 + d3 * d3 + d5 * d5 +
                   T(2) * (s[1] * s[1] + s[2] * s[2] + s[4] * s[4]);
  const T phi_tr = sqrt_(T(1.5) * phi_sq);
  const T ex0 = exp_(-m.D * alpha_prev);
  const bool plastic = phi_tr - m.Y - m.S * (T(1) - ex0) > T(0);
  T dg = T(0);
  T scale = T(0);
  if (plastic) {
    dg = soa_newton<Iters>(phi_tr, alpha_prev, ex0, sm);
    const T safe_phi = phi_tr > T(0) ? phi_tr : T(1);
    scale = T(3) * m.mu * dg / safe_phi;
  }
  x[0] = s[0] - scale * d0;
  x[1] = s[1] * (T(1) - scale);
  x[2] = s[2] * (T(1) - scale);
  x[3] = s[3] - scale * d3;
  x[4] = s[4] * (T(1) - scale);
  x[5] = s[5] - scale * d5;
  x[6] = alpha_prev + dg;
}

// ---------------------------------------------------------------------------
// j2_soa_step (K1; K6 as a view): one step of every point, one thread per
// point, soa_rows in a stride loop.
//
// What bounds it on an H100 (3.35 TB/s HBM3 at 700 W): it reads rows 0-6
// of xi and 0-5 of de and writes 8 rows, 168 B per update in f64 (84 B in
// f32). At 4,194,304 points that is 0.21 ms of memory, and the memory
// bounds it. At the FE notch's 47,628 points (every assembly launches it
// once) the byte bound is 2.4 us, and an empty kernel on the same grid
// takes 1.4-1.6 us a launch in a CUDA graph: there the time is the
// launch, the loads' latency and the dependent chain of one plastic
// update on the busiest SM (f64: 3,367 cycles with j2_corrector's Newton,
// 1,803 with soa_newton), which tools/torch_kernel_probe.py --cases
// j2_soa_step measures beside the kernel.
//
// What the design does about it:
// - soa_rows: a plastic f64 update's Newton in about a quarter of the
//   f64 operations of j2_corrector's and half its latency, so that at
//   the FE shape the busiest SM's issue time stays below the chain's
//   latency, and at large N the arithmetic hides under the memory;
// - blocks of kStepThreads = 128 on a balanced grid: at the FE shape 373
//   blocks, no SM with more than 3 (12 warps, the least any split of
//   1,489 warps over 132 SMs allows), where 256-thread blocks put 16
//   warps on 55 SMs and 8 on the rest; at large N every block takes the
//   same number of rounds of the stride loop;
// - no launch bound below the registers soa_rows takes (kStepMinBlocks):
//   86 in f64, 5 blocks an SM; caps at 80 and 64 spilled and were slower
//   at 4,194,304 points, and so was a second point's rows in flight
//   (128 registers, 4 blocks).
// ---------------------------------------------------------------------------

constexpr int kStepThreads = 128;
// per SM: caps registers at 128 in f64, 64 in f32
template <typename T>
constexpr int kStepMinBlocks = sizeof(T) == 8 ? 4 : 8;

template <typename T>
__global__ void __launch_bounds__(kStepThreads, kStepMinBlocks<T>)
j2_soa_step_kernel(const T* __restrict__ xi, const T* __restrict__ de,
                   const T* __restrict__ scalars, T* __restrict__ out,
                   int64_t n) {
  const SoaMaterial<T> sm = soa_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    T x[7];
    T e[6];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = xi[r * n + j];
#pragma unroll
    for (int r = 0; r < 6; ++r) e[r] = de[r * n + j];
    soa_rows<T, kNewtonIters>(x, e, sm);
    store_state(out, x, j, n);
  }
}

// ---------------------------------------------------------------------------
// j2_soa_history (K2, K3; K7, K8 as views): the whole strain history of a
// point in one thread. The TPU kernel carried the state across its
// sequential grid axis in VMEM; here blocks run in no order, so the loop
// over T lives inside the thread and the state stays in registers, and
// the strain of the next steps is loaded before the current step is
// computed. Row 7 of the output is written as zero (K2 passed the
// input's pad row through; every caller's pad row is zero).
//
// What bounds it on an H100: on plastic data, instructions, not bytes.
// It reads strain rows 0-5 of each step and the state once, 48 + 120/T B
// per update in f64 (24 + 60/T in f32), 2.00 ms at 2,097,152 points x 64
// steps; with j2_corrector's Newton a drive in which no point yields ran
// at 89% of that and an all-plastic one took 2.7x as long. Two points per
// thread with their Newton iterations interleaved, or 50% occupancy, did
// not shorten it.
//
// What the design does about it: soa_rows (above), and
// - no launch bound below the registers this takes (116 in f64): a
//   smaller cap spilled inside the Newton and doubled the time. The 16
//   warps per SM that 116 registers leave keep two steps of strain in
//   flight each (the loop is unrolled by two, so no register copy waits
//   on a load), and the grid is balanced so that no last round runs with
//   a few blocks alone: an all-elastic drive keeps its bytes' time.
// The update is j2_soa_step's, so the result equals T chained j2_soa_step
// launches (bit for bit on an H100, f64 and f32: chip_smoke.py's
// parity-history).
// ---------------------------------------------------------------------------

constexpr int kHistThreads = 256;
constexpr int kHistMinBlocks = 2;  // per SM: caps registers at 128
// strain steps in flight: two in f64, one in f32 (whose 48 registers
// leave 40 warps per SM; a second buffer made its all-elastic drive 5%
// slower)
template <typename T>
constexpr int kHistAhead = sizeof(T) == 8 ? 2 : 1;

template <typename T, int Iters>
__global__ void __launch_bounds__(kHistThreads, kHistMinBlocks)
j2_soa_history_kernel(const T* __restrict__ xi, const T* __restrict__ de_hist,
                      const T* __restrict__ scalars, T* __restrict__ out,
                      int64_t n, int64_t t_steps) {
  const SoaMaterial<T> sm = soa_material(scalars);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int64_t step_stride = kRows * n;
  for (int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       j < n; j += stride) {
    T x[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = xi[r * n + j];
    const T* __restrict__ col = de_hist + j;
    auto load = [&](T (&dst)[6], int64_t step) {
#pragma unroll
      for (int r = 0; r < 6; ++r) dst[r] = col[step * step_stride + r * n];
    };
    if constexpr (kHistAhead<T> == 1) {
      T next[6];
      if (t_steps > 0) load(next, 0);
      for (int64_t t = 0; t < t_steps; ++t) {
        T e[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) e[r] = next[r];
        if (t + 1 < t_steps) load(next, t + 1);
        soa_rows<T, Iters>(x, e, sm);
      }
    } else {
      // steps t + 1 and t + 2 in flight while step t is computed: the
      // loop is unrolled by two so that each buffer is refilled right
      // after it is read, with no register copy waiting on a load
      T even[6], odd[6];
      if (t_steps > 0) load(even, 0);
      if (t_steps > 1) load(odd, 1);
      for (int64_t t = 0; t < t_steps; t += 2) {
        T e[6];
#pragma unroll
        for (int r = 0; r < 6; ++r) e[r] = even[r];
        if (t + 2 < t_steps) load(even, t + 2);
        soa_rows<T, Iters>(x, e, sm);
        if (t + 1 < t_steps) {
#pragma unroll
          for (int r = 0; r < 6; ++r) e[r] = odd[r];
          if (t + 3 < t_steps) load(odd, t + 3);
          soa_rows<T, Iters>(x, e, sm);
        }
      }
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
// pallas_radial_return.py:775-810, :724-759); here no pack, no pad.
//
// What bounds them on an H100 (3.35 TB/s HBM3 at 700 W): memory.
// j2_aos_step reads 7 + 9 + 9 and writes 7 + 9 values per point (328 B in
// f64, 164 B in f32); j2_total_step reads 7 + 9 and writes 7 + 9 (256 B
// in f64, 128 B in f32). The Newton corrector is j2_corrector's.
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

// The staged tile loop that both AoS kernels run. Read in place, one
// thread per point, the 56 B and 72 B rows made every warp load
// instruction span 32 rows (32 sectors for 256 useful bytes), and the
// time followed the access pattern, not the bytes (j2_aos_step at 46% of
// its byte bound, j2_total_step at 37%). So each block stages a tile of
// Tile points through shared memory: the tile's rows are contiguous slabs
// (7 P values of xi, 9 P of each displacement gradient the form reads),
// copied with cp.async, consecutive threads on consecutive words. Each
// thread then reads its own rows from shared memory: strides of 7 and 9
// words, both odd, hit distinct banks for 4 B and 8 B words. It writes
// xi' over its xi row and sigma (all 9 entries) over its grad_u row, and
// the block stores both slabs coalesced. Any N and any base address a
// contiguous view can have (a slab is copied word by word, so 8 B
// alignment is all it needs); the last tile is ragged.
//
// With Stages = 2 the copy of the block's next tile is in flight while
// this one is computed and stored (two slab sets; the wait at the top of
// a tile finds only that tile's copy outstanding). With Stages = 1 the
// copy, compute and store of a tile follow each other, and the other
// blocks on the SM hide the wait.
//
// A form says which gradient slabs come in (kGradSlabs: grad_u, then
// grad_u_prev) and what each point computes (point(xr, g, g0, m)).
// ---------------------------------------------------------------------------

template <int Tile, typename T>
__device__ __forceinline__ void copy_in(T* __restrict__ dst,
                                        const T* __restrict__ src, int count) {
  for (int i = threadIdx.x; i < count; i += Tile) cp_async(dst + i, src + i);
}

template <int Tile, typename T>
__device__ __forceinline__ void copy_out(T* __restrict__ dst,
                                         const T* __restrict__ src,
                                         int count) {
  for (int i = threadIdx.x; i < count; i += Tile) dst[i] = src[i];
}

template <typename Form, int Tile, int Stages, typename T>
__device__ __forceinline__ void aos_tile_loop(
    const T* __restrict__ xi, const T* __restrict__ grad_u,
    const T* __restrict__ grad_u_prev, const Material<T>& m,
    T* __restrict__ xi_out, T* __restrict__ sigma_out, int64_t n) {
  static_assert(Stages == 1 || Stages == 2, "one or two slab sets");
  constexpr int kWords = 7 + 9 * Form::kGradSlabs;  // per point
  // per stage: xi rows (then xi' rows), grad_u rows (then sigma rows),
  // grad_u_prev rows
  __shared__ T slabs[Stages][kWords * Tile];
  const int tid = threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * Tile;
  auto count_at = [n](int64_t base) {
    return static_cast<int>(n - base < Tile ? n - base : Tile);
  };
  auto fetch = [&](T* s, int64_t base) {
    const int count = count_at(base);
    copy_in<Tile>(s, xi + 7 * base, 7 * count);
    copy_in<Tile>(s + 7 * Tile, grad_u + 9 * base, 9 * count);
    if constexpr (Form::kGradSlabs == 2) {
      copy_in<Tile>(s + 16 * Tile, grad_u_prev + 9 * base, 9 * count);
    }
    cp_async_commit();
  };
  int64_t base = static_cast<int64_t>(blockIdx.x) * Tile;
  if constexpr (Stages == 2) {
    if (base < n) fetch(slabs[0], base);
  }
  for (int k = 0; base < n; ++k, base += stride) {
    T* s = slabs[k % Stages];
    if constexpr (Stages == 1) fetch(s, base);
    cp_async_wait<0>();
    // the tile has landed, and every thread has stored the last one
    __syncthreads();
    if constexpr (Stages == 2) {
      if (base + stride < n) fetch(slabs[(k + 1) % 2], base + stride);
    }
    const int count = count_at(base);
    if (tid < count) {
      Form::point(s + 7 * tid, s + 7 * Tile + 9 * tid,
                  Form::kGradSlabs == 2 ? s + 16 * Tile + 9 * tid : nullptr,
                  m);
    }
    __syncthreads();
    copy_out<Tile>(xi_out + 7 * base, s, 7 * count);
    copy_out<Tile>(sigma_out + 9 * base, s + 7 * Tile, 9 * count);
    // one slab set: the next tile's copies overwrite it
    if constexpr (Stages == 1) __syncthreads();
  }
}

// One rate-form step from AoS rows (K4, _kernel at
// pallas_radial_return.py:40-95): the strain increment
// sym(grad_u - grad_u_prev), the trial stress, the corrector, and the
// stress written as the new state and as sigma. The body is radial_rows,
// whose shear update s * (1 - scale) is _radial_rows' and the plain
// version's; _kernel wrote s - scale * s, equal up to rounding.
struct RateForm {
  static constexpr int kGradSlabs = 2;

  template <typename T>
  __device__ __forceinline__ static void point(T* __restrict__ xr,
                                               T* __restrict__ g,
                                               const T* __restrict__ g0,
                                               const Material<T>& m) {
    T x[7];
#pragma unroll
    for (int r = 0; r < 7; ++r) x[r] = xr[r];
    // the order of make_j2_radial_return's increment
    const T e[6] = {g[0] - g0[0],
                    T(0.5) * (g[1] + g[3] - g0[1] - g0[3]),
                    T(0.5) * (g[2] + g[6] - g0[2] - g0[6]),
                    g[4] - g0[4],
                    T(0.5) * (g[5] + g[7] - g0[5] - g0[7]),
                    g[8] - g0[8]};
    radial_rows(x, e, m);
#pragma unroll
    for (int r = 0; r < 7; ++r) xr[r] = x[r];
    store_sigma(g, x);
  }
};

// One total-form step (K5, _kernel_total at pallas_radial_return.py:
// 624-693): state [plastic strain pe (6), alpha]; the trial stress comes
// from the elastic strain sym(grad_u) - pe, the plastic strain moves by
// dp = coef * dev(s_tr), and sigma = s_tr - 2 mu dp. grad_u_prev plays no
// part (the total form is parametrized by the current strain), so it is
// not staged: 16 words per point against the rate form's 25.
struct TotalForm {
  static constexpr int kGradSlabs = 1;

  template <typename T>
  __device__ __forceinline__ static void point(T* __restrict__ xr,
                                               T* __restrict__ g,
                                               const T* __restrict__,
                                               const Material<T>& m) {
    T pe[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) pe[r] = xr[r];
    const T alpha_prev = xr[6];
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
#pragma unroll
    for (int r = 0; r < 6; ++r) xr[r] = pe[r] + coef * dev[r];
    xr[6] = alpha_prev + c.dg;
    T sig[6];
#pragma unroll
    for (int r = 0; r < 6; ++r) sig[r] = s[r] - two_mu * coef * dev[r];
    store_sigma(g, sig);
  }
};

// j2_aos_step: 25 words per point, 25.6 KB of shared memory per block in
// f64; 8 blocks per SM hide the load (83% of the byte bound).
constexpr int kAosTile = 128;     // points (and threads) per block
constexpr int kAosMinBlocks = 8;  // per SM: caps registers at 64

// j2_total_step: 16 words per point, so two slab sets of a 128-point tile
// (32 KB in f64) fit in less shared memory than j2_aos_step's one. In f64
// two stages, and no register cap below what the Newton takes (about 100
// registers, 4 blocks per SM): 9-10% faster than one stage at 8 blocks,
// whose cap at 64 registers spilled (a cap at 80 reloaded the material
// inside the Newton). In f32 (56 registers) one stage at 8 blocks or more
// was 4-5% faster than two (PERF.md).
constexpr int kTotalTile = 128;
template <typename T>
constexpr int kTotalStages = sizeof(T) == 8 ? 2 : 1;
template <typename T>
constexpr int kTotalMinBlocks = sizeof(T) == 8 ? 4 : 8;

template <typename T>
__global__ void __launch_bounds__(kAosTile, kAosMinBlocks)
j2_aos_step_kernel(const T* __restrict__ xi, const T* __restrict__ grad_u,
                   const T* __restrict__ grad_u_prev,
                   const T* __restrict__ scalars, T* __restrict__ xi_out,
                   T* __restrict__ sigma_out, int64_t n) {
  aos_tile_loop<RateForm, kAosTile, 1>(xi, grad_u, grad_u_prev,
                                       load_material(scalars), xi_out,
                                       sigma_out, n);
}

template <typename T>
__global__ void __launch_bounds__(kTotalTile, kTotalMinBlocks<T>)
j2_total_step_kernel(const T* __restrict__ xi, const T* __restrict__ grad_u,
                     const T* __restrict__ scalars, T* __restrict__ xi_out,
                     T* __restrict__ sigma_out, int64_t n) {
  aos_tile_loop<TotalForm, kTotalTile, kTotalStages<T>>(
      xi, grad_u, static_cast<const T*>(nullptr), load_material(scalars),
      xi_out, sigma_out, n);
}

template <typename T>
int launch_step(const void* xi, const void* de, const void* scalars, void* out,
                long long n, void* stream) {
  if (n <= 0) return 0;
  static FullGrid full;
  const int grid = balanced_grid(
      full.blocks(j2_soa_step_kernel<T>, kStepThreads),
      (n + kStepThreads - 1) / kStepThreads);
  j2_soa_step_kernel<T>
      <<<grid, kStepThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xi), static_cast<const T*>(de),
          static_cast<const T*>(scalars), static_cast<T*>(out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int Iters = kNewtonIters>
int launch_history(const void* xi, const void* de_hist, const void* scalars,
                   void* out, long long n, long long t_steps, void* stream) {
  if (n <= 0) return 0;
  static FullGrid full;
  const int grid = balanced_grid(
      full.blocks(j2_soa_history_kernel<T, Iters>, kHistThreads),
      (n + kHistThreads - 1) / kHistThreads);
  j2_soa_history_kernel<T, Iters>
      <<<grid, kHistThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          static_cast<const T*>(xi), static_cast<const T*>(de_hist),
          static_cast<const T*>(scalars), static_cast<T*>(out), n, t_steps);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_aos(const void* xi, const void* grad_u, const void* grad_u_prev,
               const void* scalars, void* xi_out, void* sigma_out,
               long long n, void* stream) {
  if (n <= 0) return 0;
  static FullGrid full;
  const int grid = grid_for(full.blocks(j2_aos_step_kernel<T>, kAosTile, true),
                            (n + kAosTile - 1) / kAosTile);
  j2_aos_step_kernel<T><<<grid, kAosTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(xi), static_cast<const T*>(grad_u),
      static_cast<const T*>(grad_u_prev), static_cast<const T*>(scalars),
      static_cast<T*>(xi_out), static_cast<T*>(sigma_out), n);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_total(const void* xi, const void* grad_u, const void* scalars,
                 void* xi_out, void* sigma_out, long long n, void* stream) {
  if (n <= 0) return 0;
  static FullGrid full;
  const int grid = balanced_grid(
      full.blocks(j2_total_step_kernel<T>, kTotalTile, true),
      (n + kTotalTile - 1) / kTotalTile);
  j2_total_step_kernel<T>
      <<<grid, kTotalTile, 0, static_cast<cudaStream_t>(stream)>>>(
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

// The roofline sweep (R): the f32 history with `iters` Newton iterations,
// iters in {1, 2, 4, 8, 12}; 8 launches j2_soa_history_f32's kernel.
int j2_soa_history_f32_iters(const void* xi, const void* de_hist,
                             const void* scalars, void* out, long long n,
                             long long t_steps, int iters, void* stream) {
  switch (iters) {
    case 1:
      return launch_history<float, 1>(xi, de_hist, scalars, out, n, t_steps,
                                      stream);
    case 2:
      return launch_history<float, 2>(xi, de_hist, scalars, out, n, t_steps,
                                      stream);
    case 4:
      return launch_history<float, 4>(xi, de_hist, scalars, out, n, t_steps,
                                      stream);
    case 8:
      return launch_history<float, 8>(xi, de_hist, scalars, out, n, t_steps,
                                      stream);
    case 12:
      return launch_history<float, 12>(xi, de_hist, scalars, out, n, t_steps,
                                       stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
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
