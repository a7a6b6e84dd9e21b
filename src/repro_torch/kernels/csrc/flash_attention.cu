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
//         (batch, seq, head) element strides, a unit dh stride and 16-byte
//         aligned rows; query head h reads kv head h / (H / KV).
// Output: o with q's shape and strides, bf16; where asked for, the row
//         log-sum-exp lse [B, H, Sq] float32 in natural-log units
//         (m * scale + log(l), +inf for a row that sees no key), which the
//         backward (flash_attention_bwd.cu) recomputes P from.
// dh is 64, 80, 128 or 256, each its own instantiation, taken natively;
// the Python wrapper zero-pads any other dh up to 256 to the next of them.
//
// What bounds it on an H100: operations.  At the h2o-danube-1.8b prefill
// shape (B 8, S 2048, H 32, KV 8, dh 80, causal) the live score entries
// need 4 * B * H * dh * 2.1M = 172 GFLOP, 0.17 ms at the bf16 tensor-core
// peak, against 210 MB of q/k/v/o, 0.06 ms at the memory rate.  Only
// wgmma reaches that peak; every cycle the tensor cores wait on a load, a
// barrier or the softmax is lost.
//
// What the design does about it:
// - Both products run as wgmma: S = Q K^T with Q and the K tile read from
//   shared memory (both K-major), and O += P V with P from registers (the S
//   accumulator rounded to bf16 is already the A-fragment layout) and the V
//   tile [keys, dh] read as an MN-major B operand, so nothing is transposed.
// - One block per (128 query rows, head, batch): two consumer warpgroups of
//   64 rows each and one producer warp (9 warps: ptxas caps a thread at 168
//   registers, enough for S, O and P at dh 128 without spills).  The
//   producer's one thread loads Q once and keeps 128-key K/V tiles in
//   flight with TMA (cp.async.bulk.tensor, 4-D maps over the strided
//   tensors) into a three-stage ring guarded by full/empty mbarriers, so
//   the next tiles arrive while the current one is multiplied.
// - At dh 256 (Cfg<256>) the O accumulator alone is 128 registers a thread
//   and a 128-key tile 64 KB, so a block is one consumer warpgroup of 64
//   query rows and the producer (5 warps, up to 255 registers a thread),
//   the tiles hold 64 keys, and Q plus a three-stage ring is 224 KB.  P V
//   runs as two n128 products, one for each half of the dh columns.  A tile is
//   stored as dh/16 boxes of [128 rows, 16 columns] with the 32-byte
//   swizzle: every head dim is a whole number of them (dh 80 rows are 160
//   bytes, wider than a 128-byte swizzle box), and wgmma reads them without
//   bank conflicts.  TMA fills rows past Sq or Sk with zeros.  (Blocks of
//   two query heads of one kv group x 64 rows, which share each K/V tile,
//   measured no faster on the card.  The group's K/V stays in L2.)
// - The softmax runs in base 2 (scale * log2(e) folded into one FMA, then
//   ex2.approx), and the mask is applied only on tiles that the causal
//   diagonal, the window's lower edge, the prefix's edge or the ragged end
//   Sk cut, classified per warpgroup in integer arithmetic; a warpgroup
//   skips a tile that holds none of its live keys.  The kv loop runs only
//   over the tiles between the causal and window bounds of the block.
// - A bidirectional prefix (the vlm family's image tokens): a key at column
//   col < prefix is visible to every query row, whatever the causal and
//   window bounds say, so a block's key range runs to at least
//   min(prefix, Sk) and, with a window, starts at key 0.  The prefix is a
//   template flag, so a launch without one runs no prefix test at all
//   (made at run time, the tests slowed the dh 64 and 80 kernels by some
//   8% on an H100; attention_ab.py reads it).
// - The row log-sum-exp for the backward is a template flag too: tested at
//   run time, the dormant store slowed the kernel by 2-5% on an H100
//   (attention_ab.py), so the serving instantiations compile without it.
// - Causal blocks carry from 1 to Sk/128 tiles; the heaviest (last) query
//   blocks are launched first.
//
// The tensor maps come from cuTensorMapEncodeTiled, reached through
// cudaGetDriverEntryPoint, so the library links no more than cudart.  The
// ring's barriers, the TMA loads, the wgmma wrappers and the tensor maps
// live in sm90.cuh, which the backward (flash_attention_bwd.cu) shares.
//
// Semantics follow the model's blockwise_attention: scores scaled by the
// real dh^-0.5 in f32 (the wrapper passes it: a padded dh does not change
// it), masked entries set to -1e30 (a row masked so far
// keeps m = -1e30; what it summed is wiped by the first real maximum), p
// rounded to bf16 for the PV product while l sums the f32 p, and the
// output divided by max(l, 1e-30).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kStages = 3;      // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  bf16* o;
  float* lse;          // [B, H, Sq]; written by flash_fwd<.., .., true>
  int H, KV, Sq, Sk;
  int64_t o_sb, o_ss, o_sh;
  int causal, window;  // window 0: none
  int prefix;          // keys < prefix are visible to every row; 0: none
  float scale_log2;    // dh^-0.5 * log2(e)
};

// Tiles of one head dim: consumer warpgroups (64 query rows each) and the
// key rows of a K/V tile.  dh 256 takes one warpgroup and 64-key tiles (see
// the note at the top).
template <int DH>
struct Cfg {
  static constexpr int kGroups = DH > 128 ? 1 : 2;
  static constexpr int kBq = 64 * kGroups;        // query rows of a block
  static constexpr int kBk = DH > 128 ? 64 : 128;  // key rows of a tile
  static constexpr int kConsumerWarps = 4 * kGroups;
  static constexpr int kThreads = (kConsumerWarps + 1) * 32;  // + producer
};

// Shared-memory layout of one block, in bytes from a 1024-aligned base.
template <int DH>
struct Smem {
  static constexpr int kQ = 0;                            // [DH/16][kBq][16]
  static constexpr int kTile = Cfg<DH>::kBk * DH * 2;     // one K or V tile
  static constexpr int kK = kQ + Cfg<DH>::kBq * DH * 2;   // [kStages] tiles
  static constexpr int kV = kK + kStages * kTile;         // [kStages] tiles
  static constexpr int kBar = kV + kStages * kTile;       // mbarriers
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// ---- the kernel -----------------------------------------------------------

template <int DH, bool kPrefix, bool kLse>
__global__ void __launch_bounds__(Cfg<DH>::kThreads, 1)
    flash_fwd(const __grid_constant__ CUtensorMap tq,
              const __grid_constant__ CUtensorMap tk,
              const __grid_constant__ CUtensorMap tv, const Params p) {
  using L = Smem<DH>;
  constexpr int kBq = Cfg<DH>::kBq, kBk = Cfg<DH>::kBk;
  constexpr int kConsumerWarps = Cfg<DH>::kConsumerWarps;
  constexpr int kChunks = DH / kBox;     // k-steps of S = Q K^T
  constexpr int kBoxBytes = kBk * kBox * 2;  // one [kBk, 16] box
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint32_t sq = base + L::kQ, sk = base + L::kK, sv = base + L::kV;
  const uint32_t q_full = base + L::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * kStages;

  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int q_lo = (gridDim.x - 1 - blockIdx.x) * kBq;  // heaviest first
  const int q_hi = min(q_lo + kBq, p.Sq);               // exclusive
  // Key range of the block: causal keys <= q_hi - 1, window keys >=
  // q_lo - window + 1, and the prefix's keys [0, prefix) for every row;
  // whole tiles outside it are never loaded.
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, kPrefix ? max(q_hi, p.prefix) : q_hi);
  const int kv_begin =
      p.window > 0 && !kPrefix ? max(0, q_lo - p.window + 1) : 0;
  const int kb_begin = kv_begin / kBk;
  const int kb_end = (kv_end + kBk - 1) / kBk;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == kConsumerWarps) {
    // ---- producer: Q once, then the K/V ring.
    if (lane == 0) {
      mbar_expect_tx(q_full, kBq * DH * 2);
      for (int c = 0; c < kChunks; ++c)
        tma_load(sq + c * kBq * kBox * 2, &tq, q_full, c * kBox, q_lo, h, b);
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, 2 * L::kTile);
        const uint32_t kt = sk + stage * L::kTile, vt = sv + stage * L::kTile;
        for (int c = 0; c < kChunks; ++c) {
          tma_load(kt + c * kBoxBytes, &tk, full, c * kBox, kb * kBk, kvh, b);
          tma_load(vt + c * kBoxBytes, &tv, full, c * kBox, kb * kBk, kvh, b);
        }
        if (++stage == kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg owns query rows q_lo + 64 wg ... + 63.
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  const int wq_lo = q_lo + 64 * wg;
  const int wq_hi = min(wq_lo + 64, p.Sq);  // exclusive; may be <= wq_lo
  const int r0 = wq_lo + wl * 16 + g;       // this thread's two query rows
  const int r1 = r0 + 8;

  float o[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf;  // running row max of the raw scores
  float l0 = 0.f, l1 = 0.f;          // this thread's share of the row sums

  // Q, K and V boxes: rows of 32 bytes, 8-row groups 256 bytes apart.
  const uint32_t q_rows = sq + wg * 64 * kBox * 2;
  mbar_wait(q_full, 0);

  int stage = 0;
  uint32_t phase = 0;
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k_lo = kb * kBk;
    mbar_wait(full0 + 8 * stage, phase);
    // Does this warpgroup see any live key of the tile, and must it mask?
    // A tile that holds a prefix key is live for every row; one inside the
    // prefix is cut only by Sk, one across the prefix's edge always masks.
    const bool has_prefix = kPrefix && k_lo < p.prefix;
    const bool in_prefix = kPrefix && k_lo + kBk <= p.prefix;
    const bool live =
        wq_lo < wq_hi &&
        (has_prefix ||
         (!(p.causal && k_lo > wq_hi - 1) &&
          !(p.window > 0 && k_lo + kBk - 1 < wq_lo - p.window + 1)));
    if (live) {
      const bool masked =
          k_lo + kBk > p.Sk ||
          (!in_prefix && (has_prefix || (p.causal && k_lo + kBk - 1 > wq_lo) ||
                          (p.window > 0 && wq_hi - 1 - k_lo >= p.window)));
      const uint32_t kt = sk + stage * L::kTile, vt = sv + stage * L::kTile;

      // S = Q K^T: dh/16 k-steps, each one [64, 16] Q box against one
      // [kBk, 16] K box.
      float s[kBk / 2];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        wgmma_qk<kBk>(s, desc_sw32(q_rows + c * kBq * kBox * 2, 1, 16),
                      desc_sw32(kt + c * kBoxBytes, 1, 16), c > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(s);

      if (masked) {
#pragma unroll
        for (int j = 0; j < kBk / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int row = e < 2 ? r0 : r1;
            const int col = k_lo + j * 8 + 2 * t + (e & 1);
            bool ok = col < p.Sk;
            if (!kPrefix || col >= p.prefix) {
              if (p.causal) ok = ok && row >= col;
              if (p.window > 0) ok = ok && row - col < p.window;
            }
            if (!ok) s[4 * j + e] = kNegInf;
          }
        }
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float c0 = ex2((m0 - mx0) * p.scale_log2);
      const float c1 = ex2((m1 - mx1) * p.scale_log2);
      m0 = mx0;
      m1 = mx1;
      // A row masked so far (max still -1e30) takes p = 0 for its masked
      // entries where the reference takes 1: either way the first real
      // maximum wipes them (its correction factor is 0).  Subtracting 0
      // keeps the FMA's rounding residual at -1e30 (~1e22) out of ex2.
      const float ms0 = mx0 == kNegInf ? 0.f : mx0 * p.scale_log2;
      const float ms1 = mx1 == kNegInf ? 0.f : mx1 * p.scale_log2;
      l0 *= c0;
      l1 *= c1;
#pragma unroll
      for (int n = 0; n < DH / 8; ++n) {
        o[4 * n] *= c0;
        o[4 * n + 1] *= c0;
        o[4 * n + 2] *= c1;
        o[4 * n + 3] *= c1;
      }

      // P = exp2(S scale log2e - m scale log2e): f32 into the row sums,
      // bf16 into A fragments (two neighbouring n8 accumulator tiles are one
      // k16 A fragment).
      uint32_t pf[kBk / 16][4];
#pragma unroll
      for (int j = 0; j < kBk / 8; ++j) {
        const float e0 = ex2(fmaf(s[4 * j], p.scale_log2, -ms0));
        const float e1 = ex2(fmaf(s[4 * j + 1], p.scale_log2, -ms0));
        const float e2 = ex2(fmaf(s[4 * j + 2], p.scale_log2, -ms1));
        const float e3 = ex2(fmaf(s[4 * j + 3], p.scale_log2, -ms1));
        l0 += e0 + e1;
        l1 += e2 + e3;
        pf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(e0, e1);
        pf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(e2, e3);
      }

      // O += P V: each k-step takes 16 keys of the V tile, all dh columns
      // (dh/16 boxes, LBO apart), as an MN-major operand.
      fence_regs(o);
      fence_regs(pf);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
        wgmma_pv<DH>(o, pf[kk],
                     desc_sw32(vt + kk * 16 * kBox * 2, kBoxBytes >> 4, 16),
                     8 * kBoxBytes);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(o);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (++stage == kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (kLse && t == 0) {
    float* lb = p.lse + (static_cast<int64_t>(b) * p.H + h) * p.Sq;
    const float inf = __int_as_float(0x7f800000);
    if (r0 < p.Sq)
      lb[r0] = l0 > 0.f ? (m0 * p.scale_log2 + log2f(l0)) * kLn2 : inf;
    if (r1 < p.Sq)
      lb[r1] = l1 > 0.f ? (m1 * p.scale_log2 + log2f(l1)) * kLn2 : inf;
  }
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
  bf16* ob = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r0 * p.o_ss + c) =
          pack_bf16(o[4 * n] / d0, o[4 * n + 1] / d0);
    if (r1 < p.Sq)
      *reinterpret_cast<uint32_t*>(ob + r1 * p.o_ss + c) =
          pack_bf16(o[4 * n + 2] / d1, o[4 * n + 3] / d1);
  }
}

// ---- host side ------------------------------------------------------------

// The tensor maps of q, k, v (boxes of Cfg<DH>'s query and key rows), then
// the launch.  shape and strides as flash_attention_launch takes them.
template <int DH>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k,
                   const void* v, const int64_t* shape,
                   const int64_t* strides, const Params& p,
                   cudaStream_t stream) {
  const int B = static_cast<int>(shape[0]);
  CUtensorMap tq, tk, tv;
  if (!encode(fn, &tq, q, B, p.Sq, p.H, DH, strides[0], strides[1],
              strides[2], Cfg<DH>::kBq) ||
      !encode(fn, &tk, k, B, p.Sk, p.KV, DH, strides[3], strides[4],
              strides[5], Cfg<DH>::kBk) ||
      !encode(fn, &tv, v, B, p.Sk, p.KV, DH, strides[6], strides[7],
              strides[8], Cfg<DH>::kBk))
    return cudaErrorInvalidValue;
  const int bytes = Smem<DH>::kBytes;
  auto kernel =
      p.prefix > 0
          ? (p.lse ? flash_fwd<DH, true, true> : flash_fwd<DH, true, false>)
          : (p.lse ? flash_fwd<DH, false, true> : flash_fwd<DH, false, false>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + Cfg<DH>::kBq - 1) / Cfg<DH>::kBq, p.H, B);
  kernel<<<grid, Cfg<DH>::kThreads, bytes, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace

// shape: B, H, KV, Sq, Sk, dh.  strides: (batch, seq, head) element strides
// of q, k, v, o in that order.  lse: a contiguous [B, H, Sq] float32 output,
// or null.  window 0: none; prefix 0: none.  Launches
// on `stream`; returns cudaGetLastError() as an int (cudaErrorInvalidValue
// for a head dim it was not compiled for or a tensor map the driver
// refuses, cudaErrorNotSupported without cuTensorMapEncodeTiled).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, float* lse,
                                      const int64_t* shape,
                                      const int64_t* strides, int causal,
                                      int window, int prefix, float scale,
                                      void* stream) {
  const int dh = static_cast<int>(shape[5]);
  if (dh != 64 && dh != 80 && dh != 128 && dh != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  p.o = static_cast<bf16*>(o);
  p.lse = lse;
  p.H = static_cast<int>(shape[1]);
  p.KV = static_cast<int>(shape[2]);
  p.Sq = static_cast<int>(shape[3]);
  p.Sk = static_cast<int>(shape[4]);
  p.o_sb = strides[9];
  p.o_ss = strides[10];
  p.o_sh = strides[11];
  p.causal = causal;
  p.window = window;
  p.prefix = prefix;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  switch (dh) {
    case 64: err = launch<64>(fn, q, k, v, shape, strides, p, s); break;
    case 80: err = launch<80>(fn, q, k, v, shape, strides, p, s); break;
    case 128: err = launch<128>(fn, q, k, v, shape, strides, p, s); break;
    default: err = launch<256>(fn, q, k, v, shape, strides, p, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
