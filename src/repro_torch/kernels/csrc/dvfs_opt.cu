// Batched single-task DVFS optimum (paper §4.1, Algorithm 1) for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/dvfs_opt.py::_kernel (with its _hier_argmin), launched
// there by dvfs_solve_kernel.  The plain torch version of the same function
// is repro_torch/kernels/dvfs_opt.py::dvfs_solve_plain; the Python wrapper is
// dvfs_solve_cuda in the same module.
//
// Input:  [n, 16] f32 rows (P0, GAMMA, C_COEF, BIG_D, DELTA, T0, ALLOWED,
//         READJUST, V_MIN, V_MAX, FC_MIN, FM_MIN, FM_MAX, pad x3), the
//         columns of repro_torch/kernels/layout.py.
// Output: [n, 8] f32 rows (v, fc, fm, t, p, e, deadline_prior, feasible).
//
// The kernel is bit-equal to the plain version: every division and square
// root is IEEE round-to-nearest (div.rn / sqrt.rn, no fast math), and the
// build passes -fmad=false, so a*b+c is never contracted.
//
// What bounds it on an H100: the rate at which the SMs run instructions,
// most of them IEEE division and square-root sequences.  A row moves 96
// bytes but evaluates the energy surface 2 x (G0 + G1) = 256 times, with 8
// divisions and 1 square root per pair of evaluations (one unconstrained,
// one on the deadline boundary).  Without fast math each is a sequence of
// about ten instructions around one reciprocal (or reciprocal square root)
// on the special-function unit, a range check and a branch past a slow
// path, and these sequences are most of what a pair issues.  Neither the
// special-function unit (16 lanes a cycle an SM, against 128 for other
// instructions) nor memory (tens of microseconds for 300k rows) is the
// limit; PERF.md gives the ceiling the sequences leave, which
// dvfs_opt_probe.py reads off the compiler's SASS.
//
// What the design does about it:
// * The sweep fractions i / (G0 - 1) and j / (G1 - 1) are the same for
//   every row: each block computes them once into shared memory (the same
//   IEEE division), which takes 2 of the 11 divisions off every point.
// * Row invariants (the box widths, D delta, D (1 - delta), 1 - delta,
//   allowed - t0) are computed once a row; each is the same rounded value
//   the plain version computes at every point.
// * kLanes lanes of a warp share one row.  Each sweeps the points
//   i = lane (mod kLanes) in ascending order with a running argmin, and a
//   shuffle reduction combines (energy, index) into what jnp.argmin
//   returns.  The unconstrained and boundary sweeps share each loop, so a
//   lane carries two independent dependency chains for the scheduler to
//   interleave.  Most of the main path's launches are readjust batches of
//   8 to 5,120 rows, which the host waits for: there the kernel takes one
//   row's latency, and kLanes lanes cut it nearly kLanes-fold.  The price
//   is the work every lane repeats (the row's set-up, the reductions, the
//   winners' re-evaluation, the decision rule), which makes one or two
//   lanes faster from 300k rows up.
//
// min/max follow jnp.minimum/jnp.maximum (and torch's): a NaN operand gives
// NaN (PTX min.NaN / max.NaN), unlike IEEE minNum/maxNum, which drop it.
// Argmin follows jnp.argmin: the lowest index of the least value, or the
// lowest index of any NaN.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNcol = 16;
constexpr int kSolCols = 8;
constexpr int kBlock = 128;
// Lanes that share a row: a power of two that divides the warp.  8 gave
// the least device time summed over the main path's launches on an H100
// (dvfs_opt_probe.py, PERF.md); 4 is faster at 60k-100k rows, 1 or 2 from
// 300k rows up.
constexpr int kLanes = 8;
constexpr int kRowsPerBlock = kBlock / kLanes;
constexpr float kInf = 1e30f;
static_assert(32 % kLanes == 0, "a row's lanes lie in one warp");

// jnp.minimum / jnp.maximum: NaN in, NaN out.
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return min_nan(max_nan(x, lo), hi);
}

__device__ __forceinline__ float g1_of(float v) {
  return sqrtf(max_nan(v - 0.5f, 0.0f) / 2.0f) + 0.5f;
}

__device__ __forceinline__ float g1_inv(float fc) {
  const float x = max_nan(fc - 0.5f, 0.0f);
  return 2.0f * (x * x) + 0.5f;
}

struct Row {
  float p0, gamma, cc, dd, delta, t0, allowed, readjust;
  float v_min, v_max, fc_min, fm_min, fm_max;
  float fc_max;  // g1_of(v_max)
  // Row invariants, each rounded as the plain version rounds it.
  float fc_span, fm_span;  // fc_max - fc_min, fm_max - fm_min
  float one_m_delta;       // 1 - delta
  float dd_delta, dd_rest;  // dd * delta, dd * (1 - delta)
  float budget;            // allowed - t0
};

__device__ __forceinline__ float power_at(const Row& r, float cvf, float fm) {
  return (r.p0 + r.gamma * fm) + cvf;  // cvf = (cc * v^2) * fc
}

__device__ __forceinline__ float time_at(const Row& r, float fc, float fm) {
  return r.dd * (r.delta / fc + r.one_m_delta / fm) + r.t0;
}

// Sweep 1: the unconstrained optimum on the optimal-V / closed-form-fm
// manifold, parametrized by the fraction of [fc_min, fc_max].
struct Unconstrained {
  float v, fc, fm, t;
  __device__ __forceinline__ float at(const Row& r, float frac) {
    fc = r.fc_min + r.fc_span * frac;
    v = max_nan(r.v_min, g1_inv(fc));
    const float cvf = (r.cc * (v * v)) * fc;
    const float num = ((r.p0 + cvf) * r.dd) * r.one_m_delta;
    const float den = r.gamma * (r.t0 + r.dd_delta / fc);
    fm = sqrtf(num / max_nan(den, 1e-30f));
    if (r.gamma <= 0.0f) fm = r.fm_max;
    fm = clip(fm, r.fm_min, r.fm_max);
    t = time_at(r, fc, fm);
    return power_at(r, cvf, fm) * t;
  }
};

// Sweep 2: the deadline boundary t(fc, fm) = allowed, parametrized by the
// fraction of [fm_min, fm_max]; infeasible points cost kInf.
struct Boundary {
  float v, fc, fm;
  __device__ __forceinline__ float at(const Row& r, float frac) {
    fm = r.fm_min + r.fm_span * frac;
    const float slack = r.budget - r.dd_rest / fm;
    float fc_req = r.dd_delta / max_nan(slack, 1e-30f);
    if (r.delta <= 0.0f) fc_req = r.fc_min;
    const bool bad = (slack <= 0.0f) && (r.delta > 0.0f);
    fc = clip(fc_req, r.fc_min, r.fc_max);
    v = max_nan(r.v_min, g1_inv(fc));
    const float e = power_at(r, (r.cc * (v * v)) * fc, fm) * time_at(r, fc, fm);
    return (bad || fc_req > r.fc_max + 1e-6f) ? kInf : e;
  }
};

// An argmin in jnp.argmin's order: a NaN comes first, then the least value;
// ties go to the lower index.
struct Best {
  float e;
  int i;

  // A lane starts at (+inf, lane), the index of its first point.  That
  // point replaces the entry unless it is +inf too, and then the index is
  // already its own.  A lane with no point keeps an index past every point
  // and so loses every tie when the lanes combine.
  __device__ __forceinline__ static Best start(int lane) {
    return Best{__int_as_float(0x7f800000), lane};
  }
  // The next point of a lane's ascending sweep: it replaces the entry if it
  // is less, or NaN where the entry is not.
  __device__ __forceinline__ void scan(float e2, int i2) {
    if (e2 < e || (isnan(e2) && !isnan(e))) {
      e = e2;
      i = i2;
    }
  }
  // Combines the entries of a row's kLanes lanes, in any order; every lane
  // ends with the row's argmin.  All 32 lanes of the warp call it together.
  __device__ __forceinline__ void reduce_lanes() {
#pragma unroll
    for (int off = 1; off < kLanes; off <<= 1) {
      const float e2 = __shfl_xor_sync(0xffffffffu, e, off);
      const int i2 = __shfl_xor_sync(0xffffffffu, i, off);
      const bool nan2 = isnan(e2), nan1 = isnan(e);
      bool first = i2 < i;  // a tie, or both NaN
      if (nan2 != nan1) {
        first = nan2;
      } else if (!nan2 && e2 != e) {
        first = e2 < e;
      }
      if (first) {
        e = e2;
        i = i2;
      }
    }
  }
};

// Coarse-then-fine argmin of both sweeps over the unit interval: G0 coarse
// points, then G1 fine points in the bracket one coarse step to each side
// of the coarse winner; the fine winner is kept if it is no worse.  Leaves
// each sweep evaluated at its winner.  `frac` holds the G0 coarse fractions
// followed by the G1 fine ones.
__device__ __forceinline__ void hier_argmin(Unconstrained& u, Boundary& b,
                                            const Row& r, const float* frac,
                                            int g0, int g1, float step0,
                                            int lane) {
  Best cu = Best::start(lane), cb = Best::start(lane);
  for (int i = lane; i < g0; i += kLanes) {
    const float f = frac[i];
    cu.scan(u.at(r, f), i);
    cb.scan(b.at(r, f), i);
  }
  cu.reduce_lanes();
  cb.reduce_lanes();

  const float fiu = static_cast<float>(cu.i), fib = static_cast<float>(cb.i);
  const float lo_u = clip((fiu - 1.0f) * step0, 0.0f, 1.0f);
  const float lo_b = clip((fib - 1.0f) * step0, 0.0f, 1.0f);
  const float span_u = clip((fiu + 1.0f) * step0, 0.0f, 1.0f) - lo_u;
  const float span_b = clip((fib + 1.0f) * step0, 0.0f, 1.0f) - lo_b;
  const float* frac1 = frac + g0;
  Best fu = Best::start(lane), fb = Best::start(lane);
  for (int j = lane; j < g1; j += kLanes) {
    const float f = frac1[j];
    fu.scan(u.at(r, lo_u + span_u * f), j);
    fb.scan(b.at(r, lo_b + span_b * f), j);
  }
  fu.reduce_lanes();
  fb.reduce_lanes();

  u.at(r, fu.e <= cu.e ? lo_u + span_u * frac1[fu.i] : frac[cu.i]);
  b.at(r, fb.e <= cb.e ? lo_b + span_b * frac1[fb.i] : frac[cb.i]);
}

__global__ void __launch_bounds__(kBlock)
dvfs_opt_kernel(const float* __restrict__ tasks, float* __restrict__ out,
                int64_t n, int g0, int g1, float step0) {
  extern __shared__ float frac[];  // [g0] coarse, then [g1] fine fractions
  const float den0 = static_cast<float>(g0 - 1);
  const float den1 = static_cast<float>(g1 - 1);
  for (int k = threadIdx.x; k < g0 + g1; k += kBlock) {
    frac[k] = k < g0 ? static_cast<float>(k) / den0
                     : static_cast<float>(k - g0) / den1;
  }
  __syncthreads();

  // Every lane runs to the end, so that the shuffles see whole warps; the
  // lanes past the last row solve the last row again and store nothing.
  const int lane = threadIdx.x % kLanes;
  const int64_t i =
      static_cast<int64_t>(blockIdx.x) * kRowsPerBlock + threadIdx.x / kLanes;
  const bool live = i < n;
  const float4* src =
      reinterpret_cast<const float4*>(tasks + (live ? i : n - 1) * kNcol);
  const float4 a = src[0], bb = src[1], c = src[2], d = src[3];
  Row r;
  r.p0 = a.x; r.gamma = a.y; r.cc = a.z; r.dd = a.w;
  r.delta = bb.x; r.t0 = bb.y; r.allowed = bb.z; r.readjust = bb.w;
  r.v_min = c.x; r.v_max = c.y; r.fc_min = c.z; r.fm_min = c.w;
  r.fm_max = d.x;
  r.fc_max = g1_of(r.v_max);
  r.fc_span = r.fc_max - r.fc_min;
  r.fm_span = r.fm_max - r.fm_min;
  r.one_m_delta = 1.0f - r.delta;
  r.dd_delta = r.dd * r.delta;
  r.dd_rest = r.dd * r.one_m_delta;
  r.budget = r.allowed - r.t0;

  Unconstrained u;
  Boundary bd;
  hier_argmin(u, bd, r, frac, g0, g1, step0, lane);

  // Decision rule (== single_task.solve_with_deadline / solve_on_boundary).
  const bool readjust = r.readjust > 0.5f;
  const bool energy_prior = (u.t <= r.allowed + 1e-6f) && !readjust;
  const float t_min = time_at(r, r.fc_max, r.fm_max);
  const bool feasible = r.allowed >= t_min - 1e-6f;
  float vf, fcf, fmf;
  if (!feasible) {
    vf = r.v_max; fcf = r.fc_max; fmf = r.fm_max;
  } else if (energy_prior) {
    vf = u.v; fcf = u.fc; fmf = u.fm;
  } else {
    vf = bd.v; fcf = bd.fc; fmf = bd.fm;
  }
  const float pw = power_at(r, (r.cc * (vf * vf)) * fcf, fmf);
  float tt = time_at(r, fcf, fmf);
  if (feasible && !energy_prior) tt = min_nan(tt, r.allowed);

  if (!live) return;
  float4* dst = reinterpret_cast<float4*>(out + i * kSolCols);
  if (lane == 0) dst[0] = make_float4(vf, fcf, fmf, tt);
  if (lane == (kLanes > 1 ? 1 : 0)) {
    dst[1] = make_float4(pw, pw * tt, energy_prior ? 0.0f : 1.0f,
                         feasible ? 1.0f : 0.0f);
  }
}

}  // namespace

// Launches the kernel on `stream` over n rows (tasks and out 16-byte
// aligned and contiguous) and returns cudaGetLastError() as an int.
extern "C" int dvfs_opt_launch(const void* tasks, void* out, int64_t n,
                               int g0, int g1, float step0, void* stream) {
  const size_t smem = static_cast<size_t>(g0 + g1) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dvfs_opt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const int64_t blocks = (n + kRowsPerBlock - 1) / kRowsPerBlock;
  dvfs_opt_kernel<<<static_cast<unsigned int>(blocks), kBlock, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tasks), static_cast<float*>(out), n, g0, g1,
      step0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dvfs_opt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
