// Backward of the GQA attention of flash_attention.cu (causal and/or sliding
// window, bidirectional prefix) for Hopper: dQ, dK and dV from q, k, v, the
// forward's output o, its row log-sum-exp lse and the output's gradient dO.
//
// No TPU kernel is replaced: the JAX package has no Pallas backward and
// differentiates the jnp blockwise_attention (src/repro/models/
// attention.py:96, the forward kernel's oracle) with jax.grad.  This kernel
// computes the gradient of the function the forward kernel computes.  The
// plain torch version is repro_torch/kernels/flash_attention.py::
// flash_attention_bwd_plain; the Python wrapper is flash_attention_bwd_cuda
// in the same module, and FlashAttention (a torch.autograd.Function) puts it
// on the training path.
//
// Input:  q, o, dO [B, Sq, H, dh] and k/v [B, Sk, KV, dh] bf16, each with its
//         own (batch, seq, head) element strides, a unit dh stride and
//         16-byte aligned rows; lse [B, H, Sq] float32 in natural-log units
//         (the forward's m * scale + log(l); +inf where l = 0).
// Output: dq with q's layout, dk/dv with k's and v's, bf16; delta [B, H, Sq]
//         float32 scratch.
// dh is 64, 80, 128 or 256 (the forward's instantiations); the wrapper
// zero-pads any other dh, as the forward's does.
//
// Three launches:
// 1. delta = rowsum(dO * O) in float32, one warp a row;
// 2. dK and dV: one block of 4 warps per (64 keys, kv head, batch), each
//    warp owning 16 keys.  It loops over the g query heads of its group and
//    over the 32-row query steps that can see its keys, recomputes
//    P^T = exp(S^T scale - lse) from K Q^T, and accumulates dV += P^T dO,
//    dS^T = P^T * (dP^T - delta) with dP^T = V dO^T, and dK += dS^T Q scale
//    in float32 registers; it writes bf16 once at the end.  At dh 256 the
//    accumulators of all columns do not fit a thread's registers, so the
//    block runs two passes of 128 columns, recomputing S and dP in each;
// 3. dQ: one block of 4 warps per (64 query rows, head, batch), each warp
//    owning 16 rows, looping over 32-key steps of the rows' key range:
//    dQ += dS K scale.
// Two passes and no atomics: every gradient element is summed by one thread
// in one fixed order, so a replayed step gives the same bits.
//
// Every product is a warp-level mma.sync m16n8k16 (bf16 in, float32
// accumulate) on fragments read from shared memory with ldmatrix; rows are
// padded by 16 bytes so the eight row addresses of each ldmatrix fall in
// distinct bank groups.  P and dS are rounded to bf16 as product inputs,
// the plain version rounds them at the same places.  The masking predicate
// is the forward's: keys past Sk, the causal diagonal and the window's lower
// edge, and keys below the prefix visible to every row.
//
// What bounds it on an H100: operations.  At the h2o-danube-1.8b training
// shape (B 8, S 2048, H 32, KV 8, dh 80, causal) the live score entries need
// five products of 2 B H dh per entry (S and dP recomputed, dV, dK, dQ):
// 5 * 2 * B * H * dh * 2.1M = 430 GFLOP, 0.43 ms at the bf16 tensor-core
// peak, against 5 x 84 MB of q, k, v, o, dO, lse, dq, dk, dv, 0.13 ms at the
// memory rate.  This first kernel is simple and right (synchronous tile
// loads, no wgmma, S and dP recomputed by both kernels); wgmma and TMA are
// later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kLog2e = 1.4426950408889634f;
constexpr int kThreads = 128;  // 4 warps
constexpr int kKeys = 64;      // keys of a dK/dV block
constexpr int kQStep = 32;     // query rows of one step there
constexpr int kRows = 64;      // query rows of a dQ block
constexpr int kKStep = 32;     // keys of one step there

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16 *q, *k, *v, *o, *dout;
  const float* lse;
  float* delta;
  bf16 *dq, *dk, *dv;
  int B, H, KV, Sq, Sk, dh;
  // (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv
  int64_t st[8][3];
  int causal, window, prefix;  // window 0: none; prefix 0: none
  float scale, scale_log2;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

template <int DH>
struct Cfg {
  static constexpr int kLd = DH + 8;               // shared row, elements
  static constexpr int kCols = DH > 128 ? 128 : DH;  // dK/dV columns a pass
  static constexpr int kPasses = DH / kCols;
};

// ---- helpers --------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d[16 x 8] += a[16 x 16] b[16 x 8], bf16 in, float32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16 and packed, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of rows [r0, r0 + 16) and columns [c0, c0 + 16) of a
// row-major shared tile (row stride ld elements).
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], uint32_t tile, int ld,
                                       int r0, int c0, int lane) {
  const int row = r0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = c0 + (lane >> 4) * 8;
  ldsm_x4(a, tile + (row * ld + col) * 2);
}

// B fragments of two n8 tiles, n in [n0, n0 + 16), over k in [k0, k0 + 16),
// from a shared tile stored [n][k] row-major: b[0..1] the first tile's,
// b[2..3] the second's.
__device__ __forceinline__ void frag_b_nk(uint32_t (&b)[4], uint32_t tile,
                                          int ld, int n0, int k0, int lane) {
  const int row = n0 + (lane & 7) + (lane >> 4) * 8;
  const int col = k0 + ((lane >> 3) & 1) * 8;
  ldsm_x4(b, tile + (row * ld + col) * 2);
}

// The same from a shared tile stored [k][n] row-major (transposed load).
__device__ __forceinline__ void frag_b_kn(uint32_t (&b)[4], uint32_t tile,
                                          int ld, int k0, int n0, int lane) {
  const int row = k0 + (lane & 7) + ((lane >> 3) & 1) * 8;
  const int col = n0 + (lane >> 4) * 8;
  ldsm_x4_t(b, tile + (row * ld + col) * 2);
}

// The A fragment of k-step kk from a float32 accumulator of n8 tiles over
// the same 16 rows (tiles 2 kk and 2 kk + 1), rounded to bf16.
template <int N>
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4],
                                         const float (&c)[N][4], int kk) {
  a[0] = pack_bf16(c[2 * kk][0], c[2 * kk][1]);
  a[1] = pack_bf16(c[2 * kk][2], c[2 * kk][3]);
  a[2] = pack_bf16(c[2 * kk + 1][0], c[2 * kk + 1][1]);
  a[3] = pack_bf16(c[2 * kk + 1][2], c[2 * kk + 1][3]);
}

// Rows [lo, lo + n) of one head of a [B, S, heads, DH] tensor into a shared
// tile of row stride Cfg<DH>::kLd, zeros past `limit`.
template <int DH>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* g,
                                          int64_t ss, int lo, int n,
                                          int limit) {
  constexpr int kChunks = DH / 8;  // 16-byte chunks of a row
  for (int i = threadIdx.x; i < n * kChunks; i += kThreads) {
    const int r = i / kChunks, c = (i % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (lo + r < limit)
      val = *reinterpret_cast<const uint4*>(g + (lo + r) * ss + c);
    *reinterpret_cast<uint4*>(tile + r * Cfg<DH>::kLd + c) = val;
  }
}

// The forward's mask: is key `col` visible to query `row`?
template <bool kPrefix>
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  if (row >= p.Sq || col >= p.Sk) return false;
  if (kPrefix && col < p.prefix) return true;
  if (p.causal && row < col) return false;
  if (p.window > 0 && row - col >= p.window) return false;
  return true;
}

__device__ __forceinline__ const bf16* head_ptr(const Params& p, int t,
                                                const bf16* base, int b,
                                                int h) {
  return base + b * p.st[t][0] + h * p.st[t][2];
}

// ---- 1. delta = rowsum(dO * O) ----------------------------------------------

__global__ void __launch_bounds__(256) flash_bwd_delta(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * 8 + warp;
  if (row >= static_cast<int64_t>(p.B) * p.H * p.Sq) return;
  const int s = static_cast<int>(row % p.Sq);
  const int bh = static_cast<int>(row / p.Sq);
  const int h = bh % p.H, b = bh / p.H;
  const bf16* o = head_ptr(p, kO, p.o, b, h) + s * p.st[kO][1];
  const bf16* d = head_ptr(p, kDO, p.dout, b, h) + s * p.st[kDO][1];
  float acc = 0.f;
  for (int c = lane; c < p.dh; c += 32)
    acc += __bfloat162float(o[c]) * __bfloat162float(d[c]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) p.delta[row] = acc;
}

// ---- 2. dK and dV -----------------------------------------------------------

template <int DH, bool kPrefix>
__global__ void __launch_bounds__(kThreads) flash_bwd_dkdv(const Params p) {
  constexpr int kLd = Cfg<DH>::kLd, kCols = Cfg<DH>::kCols;
  constexpr int kN = kQStep / 8;  // n8 tiles of S^T over the query step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sk = reinterpret_cast<bf16*>(smem_raw);  // [kKeys][kLd]
  bf16* sv = sk + kKeys * kLd;                    // [kKeys][kLd]
  bf16* sq = sv + kKeys * kLd;                    // [kQStep][kLd]
  bf16* sdo = sq + kQStep * kLd;                  // [kQStep][kLd]
  float* slse = reinterpret_cast<float*>(sdo + kQStep * kLd);  // log2 units
  float* sdelta = slse + kQStep;
  const uint32_t a_k = smem_addr(sk), a_v = smem_addr(sv);
  const uint32_t a_q = smem_addr(sq), a_do = smem_addr(sdo);

  const int kvh = blockIdx.y, b = blockIdx.z;
  const int g = p.H / p.KV;
  const int k_lo = blockIdx.x * kKeys;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int wk = k_lo + warp * 16;  // this warp's first key

  load_rows<DH>(sk, head_ptr(p, kK, p.k, b, kvh), p.st[kK][1], k_lo, kKeys,
                p.Sk);
  load_rows<DH>(sv, head_ptr(p, kV, p.v, b, kvh), p.st[kV][1], k_lo, kKeys,
                p.Sk);

  // The query rows that can see a key of the block: all of them for a block
  // holding a prefix key, else from the diagonal (causal) to the window's
  // reach.
  const bool block_prefix = kPrefix && k_lo < p.prefix;
  int q_begin = 0, q_end = p.Sq;
  if (!block_prefix) {
    if (p.causal) q_begin = k_lo;
    if (p.window > 0) q_end = min(q_end, k_lo + kKeys - 1 + p.window);
  }
  q_begin = (q_begin / kQStep) * kQStep;
  const bool warp_prefix = kPrefix && wk < p.prefix;

  for (int pass = 0; pass < Cfg<DH>::kPasses; ++pass) {
    const int c_lo = pass * kCols;
    float dk[kCols / 8][4], dv[kCols / 8][4];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

    for (int j = 0; j < g; ++j) {
      const int h = kvh * g + j;
      for (int q0 = q_begin; q0 < q_end; q0 += kQStep) {
        __syncthreads();  // the last step's tiles are consumed
        load_rows<DH>(sq, head_ptr(p, kQ, p.q, b, h), p.st[kQ][1], q0, kQStep,
                      p.Sq);
        load_rows<DH>(sdo, head_ptr(p, kDO, p.dout, b, h), p.st[kDO][1], q0,
                      kQStep, p.Sq);
        if (threadIdx.x < kQStep) {
          const int r = q0 + threadIdx.x;
          const int64_t i = (static_cast<int64_t>(b) * p.H + h) * p.Sq + r;
          slse[threadIdx.x] = r < p.Sq ? p.lse[i] * kLog2e : __int_as_float(0x7f800000);
          sdelta[threadIdx.x] = r < p.Sq ? p.delta[i] : 0.f;
        }
        __syncthreads();
        // Does any query of the step see a key of this warp?
        const bool live =
            wk < p.Sk &&
            (warp_prefix ||
             ((!p.causal || wk <= q0 + kQStep - 1) &&
              (p.window <= 0 || q0 - (wk + 15) < p.window)));
        if (!live) continue;

        // S^T = K Q^T: 16 keys x kQStep queries.
        float s[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, a_k, kLd, warp * 16, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < kN / 2; ++np) {
            uint32_t bb[4];
            frag_b_nk(bb, a_q, kLd, np * 16, kk * 16, lane);
            mma(s[2 * np], a, bb[0], bb[1]);
            mma(s[2 * np + 1], a, bb[2], bb[3]);
          }
        }
        // P^T = exp(S^T scale - lse), zero where masked.
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = wk + gr + (e >> 1) * 8;
            const int qi = n * 8 + 2 * t + (e & 1);
            s[n][e] = visible<kPrefix>(p, q0 + qi, key)
                          ? ex2(s[n][e] * p.scale_log2 - slse[qi])
                          : 0.f;
          }
        // dV += P^T dO over this pass's columns.
#pragma unroll
        for (int kk = 0; kk < kQStep / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, s, kk);
#pragma unroll
          for (int np = 0; np < kCols / 16; ++np) {
            uint32_t bb[4];
            frag_b_kn(bb, a_do, kLd, kk * 16, c_lo + np * 16, lane);
            mma(dv[2 * np], a, bb[0], bb[1]);
            mma(dv[2 * np + 1], a, bb[2], bb[3]);
          }
        }
        // dP^T = V dO^T, then dS^T = P^T (dP^T - delta).
        float ds[kN][4];
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) ds[n][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < DH / 16; ++kk) {
          uint32_t a[4];
          frag_a(a, a_v, kLd, warp * 16, kk * 16, lane);
#pragma unroll
          for (int np = 0; np < kN / 2; ++np) {
            uint32_t bb[4];
            frag_b_nk(bb, a_do, kLd, np * 16, kk * 16, lane);
            mma(ds[2 * np], a, bb[0], bb[1]);
            mma(ds[2 * np + 1], a, bb[2], bb[3]);
          }
        }
#pragma unroll
        for (int n = 0; n < kN; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            ds[n][e] = s[n][e] * (ds[n][e] - sdelta[n * 8 + 2 * t + (e & 1)]);
        // dK += dS^T Q over this pass's columns (scaled at the end).
#pragma unroll
        for (int kk = 0; kk < kQStep / 16; ++kk) {
          uint32_t a[4];
          acc_to_a(a, ds, kk);
#pragma unroll
          for (int np = 0; np < kCols / 16; ++np) {
            uint32_t bb[4];
            frag_b_kn(bb, a_q, kLd, kk * 16, c_lo + np * 16, lane);
            mma(dk[2 * np], a, bb[0], bb[1]);
            mma(dk[2 * np + 1], a, bb[2], bb[3]);
          }
        }
      }
    }

    bf16* gk = p.dk + b * p.st[kDK][0] + kvh * p.st[kDK][2];
    bf16* gv = p.dv + b * p.st[kDV][0] + kvh * p.st[kDV][2];
#pragma unroll
    for (int n = 0; n < kCols / 8; ++n) {
      const int c = c_lo + n * 8 + 2 * t;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int key = wk + gr + half * 8;
        if (key >= p.Sk) continue;
        *reinterpret_cast<uint32_t*>(gk + key * p.st[kDK][1] + c) =
            pack_bf16(dk[n][2 * half] * p.scale, dk[n][2 * half + 1] * p.scale);
        *reinterpret_cast<uint32_t*>(gv + key * p.st[kDV][1] + c) =
            pack_bf16(dv[n][2 * half], dv[n][2 * half + 1]);
      }
    }
  }
}

// ---- 3. dQ ------------------------------------------------------------------

template <int DH, bool kPrefix>
__global__ void __launch_bounds__(kThreads) flash_bwd_dq(const Params p) {
  constexpr int kLd = Cfg<DH>::kLd;
  constexpr int kN = kKStep / 8;  // n8 tiles of S over the key step
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sq = reinterpret_cast<bf16*>(smem_raw);  // [kRows][kLd]
  bf16* sdo = sq + kRows * kLd;                   // [kRows][kLd]
  bf16* sk = sdo + kRows * kLd;                   // [kKStep][kLd]
  bf16* sv = sk + kKStep * kLd;                   // [kKStep][kLd]
  float* slse = reinterpret_cast<float*>(sv + kKStep * kLd);  // log2 units
  float* sdelta = slse + kRows;
  const uint32_t a_q = smem_addr(sq), a_do = smem_addr(sdo);
  const uint32_t a_k = smem_addr(sk), a_v = smem_addr(sv);

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_lo = blockIdx.x * kRows;
  const int q_hi = min(q_lo + kRows, p.Sq);  // exclusive
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int gr = lane >> 2, t = lane & 3;
  const int wq = q_lo + warp * 16;  // this warp's first row

  load_rows<DH>(sq, head_ptr(p, kQ, p.q, b, h), p.st[kQ][1], q_lo, kRows,
                p.Sq);
  load_rows<DH>(sdo, head_ptr(p, kDO, p.dout, b, h), p.st[kDO][1], q_lo,
                kRows, p.Sq);
  if (threadIdx.x < kRows) {
    const int r = q_lo + threadIdx.x;
    const int64_t i = (static_cast<int64_t>(b) * p.H + h) * p.Sq + r;
    slse[threadIdx.x] = r < p.Sq ? p.lse[i] * kLog2e : __int_as_float(0x7f800000);
    sdelta[threadIdx.x] = r < p.Sq ? p.delta[i] : 0.f;
  }

  // The forward's key range of the block.
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, kPrefix ? max(q_hi, p.prefix) : q_hi);
  int kv_begin = p.window > 0 && !kPrefix ? max(0, q_lo - p.window + 1) : 0;
  kv_begin = (kv_begin / kKStep) * kKStep;

  float dq[DH / 8][4];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  for (int k0 = kv_begin; k0 < kv_end; k0 += kKStep) {
    __syncthreads();  // the last step's tiles are consumed
    load_rows<DH>(sk, head_ptr(p, kK, p.k, b, kvh), p.st[kK][1], k0, kKStep,
                  p.Sk);
    load_rows<DH>(sv, head_ptr(p, kV, p.v, b, kvh), p.st[kV][1], k0, kKStep,
                  p.Sk);
    __syncthreads();
    const bool live =
        wq < p.Sq &&
        ((kPrefix && k0 < p.prefix) ||
         ((!p.causal || k0 <= wq + 15) &&
          (p.window <= 0 || wq - (k0 + kKStep - 1) < p.window)));
    if (!live) continue;

    // S = Q K^T: 16 rows x kKStep keys.
    float s[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, a_q, kLd, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bb[4];
        frag_b_nk(bb, a_k, kLd, np * 16, kk * 16, lane);
        mma(s[2 * np], a, bb[0], bb[1]);
        mma(s[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ri = warp * 16 + gr + (e >> 1) * 8;
        const int key = k0 + n * 8 + 2 * t + (e & 1);
        s[n][e] = visible<kPrefix>(p, q_lo + ri, key)
                      ? ex2(s[n][e] * p.scale_log2 - slse[ri])
                      : 0.f;
      }
    // dP = dO V^T, then dS = P (dP - delta).
    float ds[kN][4];
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[n][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, a_do, kLd, warp * 16, kk * 16, lane);
#pragma unroll
      for (int np = 0; np < kN / 2; ++np) {
        uint32_t bb[4];
        frag_b_nk(bb, a_v, kLd, np * 16, kk * 16, lane);
        mma(ds[2 * np], a, bb[0], bb[1]);
        mma(ds[2 * np + 1], a, bb[2], bb[3]);
      }
    }
#pragma unroll
    for (int n = 0; n < kN; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[n][e] =
            s[n][e] * (ds[n][e] - sdelta[warp * 16 + gr + (e >> 1) * 8]);
    // dQ += dS K (scaled at the end).
#pragma unroll
    for (int kk = 0; kk < kKStep / 16; ++kk) {
      uint32_t a[4];
      acc_to_a(a, ds, kk);
#pragma unroll
      for (int np = 0; np < DH / 16; ++np) {
        uint32_t bb[4];
        frag_b_kn(bb, a_k, kLd, kk * 16, np * 16, lane);
        mma(dq[2 * np], a, bb[0], bb[1]);
        mma(dq[2 * np + 1], a, bb[2], bb[3]);
      }
    }
  }

  bf16* gq = p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][2];
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = wq + gr + half * 8;
      if (row >= p.Sq) continue;
      *reinterpret_cast<uint32_t*>(gq + row * p.st[kDQ][1] + c) =
          pack_bf16(dq[n][2 * half] * p.scale, dq[n][2 * half + 1] * p.scale);
    }
  }
}

// ---- host side ------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int bytes, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

template <int DH, bool kPrefix>
cudaError_t launch_grads(const Params& p, cudaStream_t stream) {
  constexpr int kLd = Cfg<DH>::kLd;
  const int dkdv_bytes = (2 * kKeys + 2 * kQStep) * kLd * 2 + 2 * kQStep * 4;
  const dim3 dkdv_grid((p.Sk + kKeys - 1) / kKeys, p.KV, p.B);
  cudaError_t err = launch_one(flash_bwd_dkdv<DH, kPrefix>, dkdv_grid,
                               dkdv_bytes, p, stream);
  if (err != cudaSuccess) return err;
  const int dq_bytes = (2 * kRows + 2 * kKStep) * kLd * 2 + 2 * kRows * 4;
  const dim3 dq_grid((p.Sq + kRows - 1) / kRows, p.H, p.B);
  return launch_one(flash_bwd_dq<DH, kPrefix>, dq_grid, dq_bytes, p, stream);
}

template <int DH>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int64_t rows = static_cast<int64_t>(p.B) * p.H * p.Sq;
  flash_bwd_delta<<<static_cast<unsigned>((rows + 7) / 8), 256, 0, stream>>>(
      p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  return p.prefix > 0 ? launch_grads<DH, true>(p, stream)
                      : launch_grads<DH, false>(p, stream);
}

}  // namespace

// shape: B, H, KV, Sq, Sk, dh.  strides: (batch, seq, head) element strides
// of q, k, v, o, dO, dq, dk, dv in that order; lse and delta are contiguous
// [B, H, Sq] float32.  window 0: none; prefix 0: none.  Launches the three
// kernels on `stream`; returns the first error as an int
// (cudaErrorInvalidValue for a head dim it was not compiled for).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int64_t* shape, const int64_t* strides, int causal,
    int window, int prefix, float scale, void* stream) {
  const int dh = static_cast<int>(shape[5]);
  if (dh != 64 && dh != 80 && dh != 128 && dh != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.q = static_cast<const bf16*>(q);
  p.k = static_cast<const bf16*>(k);
  p.v = static_cast<const bf16*>(v);
  p.o = static_cast<const bf16*>(o);
  p.dout = static_cast<const bf16*>(dout);
  p.lse = lse;
  p.delta = delta;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = static_cast<int>(shape[0]);
  p.H = static_cast<int>(shape[1]);
  p.KV = static_cast<int>(shape[2]);
  p.Sq = static_cast<int>(shape[3]);
  p.Sk = static_cast<int>(shape[4]);
  p.dh = dh;
  for (int t = 0; t < 8; ++t)
    for (int i = 0; i < 3; ++i) p.st[t][i] = strides[3 * t + i];
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 64: err = launch<64>(p, s); break;
    case 80: err = launch<80>(p, s); break;
    case 128: err = launch<128>(p, s); break;
    default: err = launch<256>(p, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
