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
// What bounds it on an H100: arithmetic.  A row moves 96 bytes (64 in, 32
// out) but evaluates the energy surface 2 x (G0 + G1) = 256 times, each
// evaluation with three to four IEEE divisions or square roots (a dozen
// instructions each without fast math) beside some twenty adds, multiplies
// and min/max.  At 96 bytes per row the memory time is tens of microseconds
// for the 300k-row main-path batch; the float32 work is far larger.
//
// What the design does about it: one thread per row, 128 threads a block,
// every sweep a scalar loop in registers (the fine bracket depends on the
// coarse argmin, so there is no tile algebra to hand to tensor cores), no
// shared memory, the row read with four 16-byte loads and written with two.
// The ragged edge is masked here, so no pad rows are launched.  Division and
// square root stay IEEE round-to-nearest, and the build passes -fmad=false,
// so each operation rounds where the plain version's does: a*b+c is never
// contracted.  Making it faster (fewer divisions, a cheaper first sweep) is
// later work.
//
// Argmin semantics follow jnp.argmin: a strict '<' running minimum, so ties
// go to the lowest index, and a NaN wins over any number.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kNcol = 16;
constexpr int kSolCols = 8;
constexpr int kBlock = 128;
constexpr float kInf = 1e30f;

struct Row {
  float p0, gamma, cc, dd, delta, t0, allowed, readjust;
  float v_min, v_max, fc_min, fm_min, fm_max;
  float fc_max;  // g1_of(v_max)
};

__device__ __forceinline__ float g1_of(float v) {
  return sqrtf(fmaxf(v - 0.5f, 0.0f) / 2.0f) + 0.5f;
}

__device__ __forceinline__ float g1_inv(float fc) {
  const float x = fmaxf(fc - 0.5f, 0.0f);
  return 2.0f * (x * x) + 0.5f;
}

// jnp.clip(x, lo, hi) == minimum(maximum(x, lo), hi)
__device__ __forceinline__ float clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ float power_at(const Row& r, float v, float fc,
                                          float fm) {
  return (r.p0 + r.gamma * fm) + (r.cc * (v * v)) * fc;
}

__device__ __forceinline__ float time_at(const Row& r, float fc, float fm) {
  return r.dd * (r.delta / fc + (1.0f - r.delta) / fm) + r.t0;
}

// Sweep 1: the unconstrained optimum on the optimal-V / closed-form-fm
// manifold, parametrized by the fraction of [fc_min, fc_max].
struct Unconstrained {
  float v, fc, fm, t;
  __device__ __forceinline__ float at(const Row& r, float frac) {
    fc = r.fc_min + (r.fc_max - r.fc_min) * frac;
    v = fmaxf(r.v_min, g1_inv(fc));
    const float num = ((r.p0 + (r.cc * (v * v)) * fc) * r.dd) * (1.0f - r.delta);
    const float den = r.gamma * (r.t0 + (r.dd * r.delta) / fc);
    fm = sqrtf(num / fmaxf(den, 1e-30f));
    if (r.gamma <= 0.0f) fm = r.fm_max;
    fm = clip(fm, r.fm_min, r.fm_max);
    t = time_at(r, fc, fm);
    return power_at(r, v, fc, fm) * t;
  }
};

// Sweep 2: the deadline boundary t(fc, fm) = allowed, parametrized by the
// fraction of [fm_min, fm_max]; infeasible points cost kInf.
struct Boundary {
  float v, fc, fm;
  __device__ __forceinline__ float at(const Row& r, float frac) {
    fm = r.fm_min + (r.fm_max - r.fm_min) * frac;
    const float slack = (r.allowed - r.t0) - (r.dd * (1.0f - r.delta)) / fm;
    float fc_req = (r.dd * r.delta) / fmaxf(slack, 1e-30f);
    if (r.delta <= 0.0f) fc_req = r.fc_min;
    const bool bad = (slack <= 0.0f) && (r.delta > 0.0f);
    fc = clip(fc_req, r.fc_min, r.fc_max);
    v = fmaxf(r.v_min, g1_inv(fc));
    const float e = power_at(r, v, fc, fm) * time_at(r, fc, fm);
    return (bad || fc_req > r.fc_max + 1e-6f) ? kInf : e;
  }
};

// True if e replaces best in a jnp.argmin-style scan.
__device__ __forceinline__ bool better(float e, float best) {
  return e < best || (isnan(e) && !isnan(best));
}

// Coarse-then-fine argmin over the unit interval; returns the winning
// fraction and leaves `s` evaluated at it.
template <class Sweep>
__device__ float hier_argmin(Sweep& s, const Row& r, int g0, int g1,
                             float step0) {
  const float den0 = static_cast<float>(g0 - 1);
  float e0_best = s.at(r, 0.0f / den0);
  int i0 = 0;
  for (int i = 1; i < g0; ++i) {
    const float e = s.at(r, static_cast<float>(i) / den0);
    if (better(e, e0_best)) {
      e0_best = e;
      i0 = i;
    }
  }
  const float f0_best = static_cast<float>(i0) / den0;
  const float fi0 = static_cast<float>(i0);
  const float f_lo = clip((fi0 - 1.0f) * step0, 0.0f, 1.0f);
  const float f_hi = clip((fi0 + 1.0f) * step0, 0.0f, 1.0f);
  const float den1 = static_cast<float>(g1 - 1);
  float f1_best = f_lo + (f_hi - f_lo) * (0.0f / den1);
  float e1_best = s.at(r, f1_best);
  for (int j = 1; j < g1; ++j) {
    const float f = f_lo + (f_hi - f_lo) * (static_cast<float>(j) / den1);
    const float e = s.at(r, f);
    if (better(e, e1_best)) {
      e1_best = e;
      f1_best = f;
    }
  }
  const float win = (e1_best <= e0_best) ? f1_best : f0_best;
  s.at(r, win);
  return win;
}

__global__ void __launch_bounds__(kBlock)
dvfs_opt_kernel(const float* __restrict__ tasks, float* __restrict__ out,
                int64_t n, int g0, int g1, float step0) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kBlock + threadIdx.x;
  if (i >= n) return;
  const float4* src = reinterpret_cast<const float4*>(tasks + i * kNcol);
  const float4 a = src[0], b = src[1], c = src[2], d = src[3];
  Row r;
  r.p0 = a.x; r.gamma = a.y; r.cc = a.z; r.dd = a.w;
  r.delta = b.x; r.t0 = b.y; r.allowed = b.z; r.readjust = b.w;
  r.v_min = c.x; r.v_max = c.y; r.fc_min = c.z; r.fm_min = c.w;
  r.fm_max = d.x;
  r.fc_max = g1_of(r.v_max);

  Unconstrained u;
  hier_argmin(u, r, g0, g1, step0);
  Boundary bd;
  hier_argmin(bd, r, g0, g1, step0);

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
  const float pw = power_at(r, vf, fcf, fmf);
  float tt = time_at(r, fcf, fmf);
  if (feasible && !energy_prior) tt = fminf(tt, r.allowed);

  float4* dst = reinterpret_cast<float4*>(out + i * kSolCols);
  dst[0] = make_float4(vf, fcf, fmf, tt);
  dst[1] = make_float4(pw, pw * tt, energy_prior ? 0.0f : 1.0f,
                       feasible ? 1.0f : 0.0f);
}

}  // namespace

// Launches the kernel on `stream` over n rows (tasks and out 16-byte
// aligned and contiguous) and returns cudaGetLastError() as an int.
extern "C" int dvfs_opt_launch(const void* tasks, void* out, int64_t n,
                               int g0, int g1, float step0, void* stream) {
  const int64_t blocks = (n + kBlock - 1) / kBlock;
  dvfs_opt_kernel<<<static_cast<unsigned int>(blocks), kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(tasks), static_cast<float*>(out), n, g0, g1,
      step0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* dvfs_opt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
