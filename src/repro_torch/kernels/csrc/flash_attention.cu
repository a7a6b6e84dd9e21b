// Forward GQA attention (causal and/or sliding window) for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/flash_attention.py::_kernel, launched there by
// flash_attention (and wrapped by ops.py, which pads dh to 128).  The plain
// torch version of the same function is
// repro_torch/kernels/flash_attention.py::flash_attention_plain; the Python
// wrapper is flash_attention_cuda in the same module.
//
// Input:  q [B, Sq, H, dh], k/v [B, Sk, KV, dh] bf16, each with its own
//         (batch, seq, head) element strides and a unit dh stride; query
//         head h reads kv head h / (H / KV).
// Output: o with q's shape and strides, bf16.
// dh is 64, 80 or 128, taken natively: dh / 16 k-steps of mma.sync
// m16n8k16, no padding and no rescaling of q.
//
// What bounds it on an H100: operations.  At the h2o-danube-1.8b prefill
// shape (B 8, S 2048, H 32, KV 8, dh 80, causal) the live score entries
// need 4 * B * H * dh * 2.1M = 172 GFLOP, 0.17 ms at the bf16 tensor-core
// peak, against 210 MB of q/k/v/o, 0.06 ms at the memory rate.
//
// What the design does about it: both products run on the tensor cores
// (mma.sync bf16 -> f32), and a block never touches a key block that the
// causal bound or the window excludes: the kv loop runs from the block
// holding key q_lo - window + 1 to the block holding key q_hi - 1, so a
// skipped block costs nothing.  One block of 4 warps per (64 query rows,
// head, batch); each warp owns 16 query rows, keeps its Q fragments, the
// running max m, the partial sums l and the f32 accumulator in registers
// across the kv loop (the Pallas kernel kept m, l, acc in VMEM scratch
// across its sequential kv grid axis; CUDA blocks run in no order, so the
// loop lives inside the block).  Each kv step stages a 64-row K tile and
// the transposed V tile in shared memory (rows padded by 8 elements, so
// fragment loads hit 32 distinct banks).  The ragged edge is masked here:
// keys past Sk are zero-filled and masked, query rows past Sq not stored.
// Loads are not overlapped with the products and there is no wgmma or TMA:
// that is the redesign's work.
//
// Semantics follow the model's blockwise_attention: scores scaled by the
// real dh^-0.5 in f32, masked entries set to -1e30 (a row masked so far
// keeps m = -1e30 and its weight is wiped by the first real maximum), p
// rounded to bf16 for the PV product while l sums the f32 p, and the
// output divided by max(l, 1e-30).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBq = 64;       // query rows of a block (16 per warp)
constexpr int kBk = 64;       // key rows of a kv tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* q;
  const bf16* k;
  const bf16* v;
  bf16* o;
  int B, H, KV, Sq, Sk;
  int64_t q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss,
      o_sh;
  int causal, window;  // window 0: none
  float scale;
};

// D = A B + D for one 16x8x16 tile: A row-major 16x16 bf16 (4 regs), B
// column-major 16x8 bf16 (2 regs), D 16x8 f32 (4 regs).
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int DH>
__global__ void __launch_bounds__(kThreads) flash_fwd(const Params p) {
  constexpr int kKs = DH / 16;        // k-steps of QK^T
  constexpr int kDt = DH / 8;         // n8 tiles of the output
  constexpr int kNt = kBk / 8;        // n8 tiles of the scores
  constexpr int kKStride = DH + 8;    // K tile row stride (elements)
  constexpr int kVStride = kBk + 8;   // V^T tile row stride
  __shared__ __align__(16) bf16 ks[kBk * kKStride];
  __shared__ __align__(16) bf16 vt[DH * kVStride];

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int q_lo = blockIdx.x * kBq;
  const int q_hi = min(q_lo + kBq, p.Sq);  // exclusive
  const int r0 = q_lo + warp * 16 + g;     // this thread's two query rows
  const int r1 = r0 + 8;

  const bf16* qb = p.q + b * p.q_sb + h * p.q_sh;
  const bf16* kb = p.k + b * p.k_sb + kvh * p.k_sh;
  const bf16* vb = p.v + b * p.v_sb + kvh * p.v_sh;

  // Q fragments for every k-step, zero past Sq.
  uint32_t qf[kKs][4];
#pragma unroll
  for (int kk = 0; kk < kKs; ++kk) {
    const int c = kk * 16 + 2 * t;
    qf[kk][0] = r0 < p.Sq ? ld32(qb + r0 * p.q_ss + c) : 0u;
    qf[kk][1] = r1 < p.Sq ? ld32(qb + r1 * p.q_ss + c) : 0u;
    qf[kk][2] = r0 < p.Sq ? ld32(qb + r0 * p.q_ss + c + 8) : 0u;
    qf[kk][3] = r1 < p.Sq ? ld32(qb + r1 * p.q_ss + c + 8) : 0u;
  }

  float acc[kDt][4];
#pragma unroll
  for (int n = 0; n < kDt; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max (whole row)
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  // Key range this block needs: causal keys <= q_hi - 1, window keys
  // >= q_lo - window + 1; whole tiles outside it are never loaded.
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, q_hi);
  int kv_begin = 0;
  if (p.window > 0) kv_begin = max(0, q_lo - p.window + 1);
  const int kb_begin = kv_begin / kBk;
  const int kb_end = (kv_end + kBk - 1) / kBk;

  for (int kblk = kb_begin; kblk < kb_end; ++kblk) {
    const int k_lo = kblk * kBk;
    __syncthreads();  // the previous tile is consumed
    constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
    for (int i = threadIdx.x; i < kBk * kChunks; i += kThreads) {
      const int row = i / kChunks, ch = i - row * kChunks;
      const int key = k_lo + row;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < p.Sk) {
        kv4 = *reinterpret_cast<const uint4*>(kb + key * p.k_ss + ch * 8);
        vv4 = *reinterpret_cast<const uint4*>(vb + key * p.v_ss + ch * 8);
      }
      *reinterpret_cast<uint4*>(&ks[row * kKStride + ch * 8]) = kv4;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv4);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[(ch * 8 + e) * kVStride + row] = ve[e];
    }
    __syncthreads();

    // S = Q K^T for this warp's 16 rows and the tile's 64 keys.
    float s[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKs; ++kk) {
        const bf16* kr = &ks[(j * 8 + g) * kKStride + kk * 16 + 2 * t];
        const uint32_t bfr[2] = {ld32(kr), ld32(kr + 8)};
        mma_bf16(s[j], qf[kk], bfr);
      }
    }

    // Scale, mask, and the new row maxima.
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = e < 2 ? r0 : r1;
        const int col = k_lo + j * 8 + 2 * t + (e & 1);
        bool ok = col < p.Sk;
        if (p.causal) ok = ok && row >= col;
        if (p.window > 0) ok = ok && row - col < p.window;
        const float x = ok ? s[j][e] * p.scale : kNegInf;
        s[j][e] = x;
        if (e < 2) mx0 = fmaxf(mx0, x); else mx1 = fmaxf(mx1, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - mn0), c1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= c0;
    l1 *= c1;
#pragma unroll
    for (int n = 0; n < kDt; ++n) {
      acc[n][0] *= c0; acc[n][1] *= c0;
      acc[n][2] *= c1; acc[n][3] *= c1;
    }

    // P = exp(S - m): f32 into the row sums, bf16 into A fragments (the
    // accumulator layout of two neighbouring n8 tiles is the A layout of
    // one k16 step).
    uint32_t pf[kBk / 16][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const float e0 = expf(s[j][0] - m0), e1 = expf(s[j][1] - m0);
      const float e2 = expf(s[j][2] - m1), e3 = expf(s[j][3] - m1);
      l0 += e0 + e1;
      l1 += e2 + e3;
      pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(e0, e1);
      pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
    }

    // acc += P V, V^T from shared memory as the column-major B operand.
#pragma unroll
    for (int kk = 0; kk < kBk / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kDt; ++n) {
        const bf16* vr = &vt[(n * 8 + g) * kVStride + kk * 16 + 2 * t];
        const uint32_t bfr[2] = {ld32(vr), ld32(vr + 8)};
        mma_bf16(acc[n], pf[kk], bfr);
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < kDt; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + c) =
          pack_bf16(acc[n][0] / d0, acc[n][1] / d0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + c) =
          pack_bf16(acc[n][2] / d1, acc[n][3] / d1);
  }
}

template <int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.Sq + kBq - 1) / kBq, p.H, p.B);
  flash_fwd<DH><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// shape: B, H, KV, Sq, Sk, dh.  strides: (batch, seq, head) element strides
// of q, k, v, o in that order.  Launches on `stream`; returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for a head dim it was
// not compiled for).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o,
                                      const int64_t* shape,
                                      const int64_t* strides, int causal,
                                      int window, float scale, void* stream) {
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<bf16*>(o);
  p.B = static_cast<int>(shape[0]);
  p.H = static_cast<int>(shape[1]);
  p.KV = static_cast<int>(shape[2]);
  p.Sq = static_cast<int>(shape[3]);
  p.Sk = static_cast<int>(shape[4]);
  p.q_sb = strides[0]; p.q_ss = strides[1]; p.q_sh = strides[2];
  p.k_sb = strides[3]; p.k_ss = strides[4]; p.k_sh = strides[5];
  p.v_sb = strides[6]; p.v_ss = strides[7]; p.v_sh = strides[8];
  p.o_sb = strides[9]; p.o_ss = strides[10]; p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (shape[5]) {
    case 64: return static_cast<int>(launch<64>(p, s));
    case 80: return static_cast<int>(launch<80>(p, s));
    case 128: return static_cast<int>(launch<128>(p, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
