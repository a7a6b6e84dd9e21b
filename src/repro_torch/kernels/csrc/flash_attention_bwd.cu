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
// Output: dq with q's layout, dk/dv with k's and v's, bf16.
// Scratch: float32, flash_attention_bwd_scratch_floats(B, H, Sq) of them.
// dh is 64, 80, 128 or 256 (the forward's instantiations); the wrapper
// zero-pads any other dh, as the forward's does.
//
// What bounds it on an H100: operations.  At the h2o-danube-1.8b training
// shape (B 8, S 2048, H 32, KV 8, dh 80, causal) the live score entries need
// five products of 2 B H dh per entry (S, dP, dV, dK, dQ): 5 * 2 * B * H *
// dh * 2.1M = 430 GFLOP, 0.43 ms at the bf16 tensor-core peak, against 5 x
// 84 MB of q, k, v, o, dO, lse, dq, dk, dv, 0.13 ms at the memory rate.
// This kernel does seven products: the dQ kernel computes S and dP again,
// so it can reach at most 5/7 = 71% of that bound.  Next to the products,
// every live entry costs an exp2 on the MUFU unit in each kernel and two
// bf16 conversions; at dh 64-80 those take about half as long as the
// entry's products, so every block runs two consumer warpgroups: one's
// products run on the tensor cores while the other computes exponentials.
//
// Two launches, both on the machinery of the forward (sm90.cuh: TMA tile
// loads of 16-column boxes with the 32-byte swizzle into an mbarrier ring,
// wgmma products with the accumulators in registers):
// 1. flash_bwd_dq: one block per (query tile, head, batch), the heaviest
//    query tiles of the causal mask (the last) launched first.  The
//    producer warp loads the tile's Q, dO and O once, then keeps a ring of
//    64-key K/V tiles in flight.  Two consumer warpgroups of 64 rows each
//    (one at dh 256; setmaxnreg gives them 240 registers a thread, the
//    producer's warpgroup 24) first take delta = rowsum(dO * O) of their
//    rows from the same swizzled tiles and write it, with lse * log2(e),
//    into a scratch padded to whole 128-row tiles (+inf and 0 on the pad
//    rows, so a tile past Sq needs no mask: its P is exp2(-inf) = 0).  Per
//    K/V tile they compute S = Q K^T and dP = dO V^T, P = exp2(S scale
//    log2(e) - lse log2(e)) and dS = P (dP - delta) in registers, and
//    dQ += dS K with dS rounded to bf16 as the A operand from registers
//    and the K tile as an MN-major B operand (the forward's P V).  Up to dh
//    128, Q and dO stay in registers as A fragments, so S and dP read only
//    the K and V tiles from shared memory;
// 2. flash_bwd_dkdv: one block per (key tile, kv head, batch), the
//    heaviest key tiles (the first) launched first.  One TMA load brings
//    the tile's K and V; the producer keeps ring entries in flight, each
//    the Q and dO tiles of 64 query rows with their lse and delta from the
//    scratch, walking all g query heads of the group and the query tiles
//    that can see the keys.  Two consumer warpgroups of 64 keys each
//    compute, per entry, S^T = K Q^T and dP^T = V dO^T (K and V as A
//    fragments in registers up to dh 80, else from shared memory, K-major
//    like Q and dO), P^T in registers, dV += P^T dO with P^T rounded to
//    bf16 as the A operand from registers and dO as an MN-major B operand,
//    dS^T = P^T (dP^T - delta), and dK += dS^T Q the same way: four
//    products, the GQA group's sum kept in float32 registers, bf16 written
//    once.  At dh 256 the dK and dV accumulators of 64 keys would be 256
//    registers a thread, so the two warpgroups split the work over the
//    same 64 keys: one computes S^T and dV, the other dP^T and dK, and the
//    first hands P^T (float32, 16 KB) to the second through shared memory
//    under two named barriers.  One pass, nothing recomputed.
// A tile is masked element by element only where an edge cuts it (the
// causal diagonal, the window's lower edge, the prefix's edge, the ragged
// Sk), classified per warpgroup in integer arithmetic as the forward does;
// a warpgroup skips a tile that holds none of its live entries.  P and dS
// are rounded to bf16 as product inputs where the plain version rounds
// them.
//
// Deterministic: no atomics.  Every dK and dV element is summed by one
// thread over the group's heads and query tiles in a fixed order, every dQ
// element by one thread over its key tiles, every delta by four threads in
// a fixed shuffle order; a replayed step gives the same bits.
//
// Tried on an H100 and left out (source variants timed in turns against
// this one, PERF.md section 6): leaving each entry's last products in
// flight until the next entry's first are issued (3-20% slower); the two
// consumer warpgroups issuing their products in strict turns (10-19%
// slower at dh 80, and wrong dK/dV at dh 64); 128-key dQ tiles at dh 64-80
// and three dQ consumer warpgroups there (at most 5% either way); a
// two-stage ring in the dK/dV kernel (no different).

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kPad = 128;  // scratch rows of a head: Sq rounded up to this

struct Params {
  const float* lse;  // [B, H, Sq], natural-log units
  float* lse2;       // scratch [B, H, SqP]: lse * log2(e), +inf past Sq
  float* delta;      // scratch [B, H, SqP]: rowsum(dO * O), 0 past Sq
  bf16 *dq, *dk, *dv;
  int B, H, KV, Sq, Sk, SqP;
  // (batch, seq, head) element strides of q, k, v, o, dO, dq, dk, dv
  int64_t st[8][3];
  int causal, window, prefix;  // window 0: none; prefix 0: none
  float scale, scale_log2;
};

enum { kQ, kK, kV, kO, kDO, kDQ, kDK, kDV };

// The dK/dV kernel's tiles and shared memory (bytes from a 1024-aligned
// base) at one head dim.
template <int DH>
struct KvCfg {
  static constexpr bool kSplit = DH > 128;  // see the note at the top
  static constexpr int kKeys = kSplit ? 64 : 128;  // keys of a block
  static constexpr int kBq = 64;                   // query rows of an entry
  static constexpr int kStages = kSplit ? 2 : 3;
  static constexpr int kThreads = 384;  // 2 consumer warpgroups + producer
  // K and V of a warpgroup's keys held as A fragments in registers (S^T and
  // dP^T then read only Q and dO from shared memory), where they fit.
  static constexpr bool kRegA = DH <= 80;
  static constexpr int kKeyBox = kKeys * kBox * 2;  // one [kKeys, 16] box
  static constexpr int kQBox = kBq * kBox * 2;      // one [kBq, 16] box
  static constexpr int kTileKV = kKeys * DH * 2;
  static constexpr int kTileQ = kBq * DH * 2;
  static constexpr int kK = 0;
  static constexpr int kV = kTileKV;
  static constexpr int kRing = 2 * kTileKV;  // stage s: Q, then dO
  static constexpr int kRows = kRing + kStages * 2 * kTileQ;  // lse2, delta
  static constexpr int kX = kRows + kStages * 2 * kBq * 4;   // P^T handover
  static constexpr int kBar = kX + (kSplit ? 64 * kBq * 4 : 0);
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// The dQ kernel's.
template <int DH>
struct QCfg {
  static constexpr int kGroups = DH > 128 ? 1 : 2;  // consumer warpgroups
  static constexpr int kRows = 64 * kGroups;        // query rows of a block
  static constexpr int kBk = 64;                    // keys of a ring tile
  static constexpr int kStages = DH > 128 ? 2 : 3;
  static constexpr int kThreads = (kGroups + 1) * 128;
  // Q and dO of a warpgroup's rows held as A fragments in registers.
  static constexpr bool kRegA = DH <= 128;
  static constexpr int kRowBox = kRows * kBox * 2;
  static constexpr int kKeyBox = kBk * kBox * 2;
  static constexpr int kTileQ = kRows * DH * 2;
  static constexpr int kTileK = kBk * DH * 2;
  static constexpr int kQ = 0;
  static constexpr int kDO = kTileQ;
  static constexpr int kO = 2 * kTileQ;
  static constexpr int kRing = 3 * kTileQ;  // stage s: K, then V
  static constexpr int kBar = kRing + kStages * 2 * kTileK;
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kPad % kRows == 0, "a block's rows stay inside the scratch");
};

constexpr int kProducerRegs = 24, kConsumerRegs = 240;
constexpr int kReady = 1, kFree = 2;  // named barriers of the P^T handover

// Roles of a dK/dV consumer warpgroup: all four products, or (dh 256) S^T
// and dV, or dP^T and dK.
enum { kBoth, kSV, kDPK };

// The forward's mask: is key `col` visible to query `row`?  (Rows past Sq
// need no test: their lse is +inf in the scratch.)
template <bool kPrefix>
__device__ __forceinline__ bool visible(const Params& p, int row, int col) {
  if (col >= p.Sk) return false;
  if (kPrefix && col < p.prefix) return true;
  if (p.causal && row < col) return false;
  if (p.window > 0 && row - col >= p.window) return false;
  return true;
}

// A float accumulator of 64 columns rounded to bf16 A fragments, k-step by
// k-step: its n8 tiles 2 kk and 2 kk + 1 are k-step kk.
__device__ __forceinline__ void to_frags(uint32_t (&f)[4][4],
                                         const float (&c)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    f[j >> 1][(j & 1) * 2 + 0] = pack_bf16(c[4 * j], c[4 * j + 1]);
    f[j >> 1][(j & 1) * 2 + 1] = pack_bf16(c[4 * j + 2], c[4 * j + 3]);
  }
}

// The two bf16 of a packed word as floats, the low half first.
__device__ __forceinline__ float2 bf16x2_to_float2(uint32_t w) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w));
}

// bf16 rows of an accumulator over 64 rows x DH columns: this thread's rows
// r0 and r0 + 8, times `mul`, rows at or past `limit` skipped.
template <int DH>
__device__ __forceinline__ void store_rows(bf16* g, int64_t ss, int r0,
                                           int limit, const float (&a)[DH / 2],
                                           float mul, int t) {
#pragma unroll
  for (int n = 0; n < DH / 8; ++n) {
    const int c = n * 8 + 2 * t;
    if (r0 < limit)
      *reinterpret_cast<uint32_t*>(g + r0 * ss + c) =
          pack_bf16(a[4 * n] * mul, a[4 * n + 1] * mul);
    if (r0 + 8 < limit)
      *reinterpret_cast<uint32_t*>(g + (r0 + 8) * ss + c) =
          pack_bf16(a[4 * n + 2] * mul, a[4 * n + 3] * mul);
  }
}

// ---- dK and dV -----------------------------------------------------------

// One consumer warpgroup of the dK/dV kernel over the ring's entries: keys
// wk_lo ... wk_lo + 63, whose rows start `rows` bytes into each K and V box.
template <int DH, bool kPrefix, int kRole>
__device__ __forceinline__ void kv_consumer(const Params& p, uint32_t base,
                                            const unsigned char* smem, int b,
                                            int kvh, int wk_lo, uint32_t rows,
                                            int qt_begin, int qt_end) {
  using C = KvCfg<DH>;
  constexpr bool kS = kRole != kDPK;  // S^T, P^T and dV
  constexpr bool kD = kRole != kSV;   // dP^T, dS^T and dK
  constexpr int kChunks = DH / kBox;
  const uint32_t sk = base + C::kK, sv = base + C::kV;
  const uint32_t kv_full = base + C::kBar;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * C::kStages;
  float* xbuf = reinterpret_cast<float*>(
      const_cast<unsigned char*>(smem) + C::kX);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tid = threadIdx.x & 127;
  const int wl = warp & 3, gq = lane >> 2, t = lane & 3;
  const int key0 = wk_lo + wl * 16 + gq;  // this thread's keys: +0 and +8
  const int g = p.H / p.KV;
  const bool has_prefix = kPrefix && wk_lo < p.prefix;
  const bool in_prefix = kPrefix && wk_lo + 64 <= p.prefix;

  float dv[kS ? DH / 2 : 1], dk[kD ? DH / 2 : 1];
#pragma unroll
  for (int i = 0; i < (kS ? DH / 2 : 1); ++i) dv[i] = 0.f;
#pragma unroll
  for (int i = 0; i < (kD ? DH / 2 : 1); ++i) dk[i] = 0.f;

  if constexpr (kRole == kDPK) named_arrive<kFree, 256>();  // buffer is free
  mbar_wait(kv_full, 0);
  // This warp's 16 keys of K and V as A fragments, k-step by k-step.
  uint32_t kf[C::kRegA ? kChunks : 1][4], vf[C::kRegA ? kChunks : 1][4];
  if constexpr (C::kRegA) {
#pragma unroll
    for (int c = 0; c < kChunks; ++c) {
      a_frag_sw32(kf[c], sk + rows + c * C::kKeyBox, wl * 16 + gq, t);
      a_frag_sw32(vf[c], sv + rows + c * C::kKeyBox, wl * 16 + gq, t);
    }
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int j = 0; j < g; ++j) {
    for (int qt = qt_begin; qt < qt_end; ++qt) {
      const int q0 = qt * C::kBq;
      mbar_wait(full0 + 8 * stage, phase);
      // Does a query of the entry see a key of this warpgroup, and must it
      // mask?  As the forward: a tile holding a prefix key is live for
      // every row; one inside the prefix is cut only by Sk.
      const bool live =
          wk_lo < p.Sk &&
          (has_prefix ||
           (!(p.causal && wk_lo > q0 + C::kBq - 1) &&
            !(p.window > 0 && q0 - (wk_lo + 63) >= p.window)));
      if (live) {
        const bool masked =
            wk_lo + 64 > p.Sk ||
            (!in_prefix &&
             (has_prefix || (p.causal && wk_lo + 63 > q0) ||
              (p.window > 0 && q0 + C::kBq - 1 - wk_lo >= p.window)));
        const uint32_t sq = base + C::kRing + stage * 2 * C::kTileQ;
        const uint32_t sdo = sq + C::kTileQ;
        const float* slse = reinterpret_cast<const float*>(
            smem + C::kRows + stage * 2 * C::kBq * 4);
        const float* sdelta = slse + C::kBq;

        // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 queries, dh/16
        // k-steps each.
        float s[32], dp[32];
        wgmma_fence();
        if constexpr (kS) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const uint64_t db = desc_sw32(sq + c * C::kQBox, 1, 16);
            if constexpr (C::kRegA)
              wgmma_rs_n64(s, kf[c], db, c > 0);
            else
              wgmma_ss_n64(s, desc_sw32(sk + rows + c * C::kKeyBox, 1, 16), db,
                           c > 0);
          }
          wgmma_commit();
        }
        if constexpr (kD) {
#pragma unroll
          for (int c = 0; c < kChunks; ++c) {
            const uint64_t db = desc_sw32(sdo + c * C::kQBox, 1, 16);
            if constexpr (C::kRegA)
              wgmma_rs_n64(dp, vf[c], db, c > 0);
            else
              wgmma_ss_n64(dp, desc_sw32(sv + rows + c * C::kKeyBox, 1, 16),
                           db, c > 0);
          }
          wgmma_commit();
        }

        uint32_t pf[4][4];
        if constexpr (kS) {
          if constexpr (kD)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_regs(s);
          // P^T = exp2(S^T scale log2(e) - lse log2(e)), 0 where masked.
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 l = *reinterpret_cast<const float2*>(
                slse + jj * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int col = jj * 8 + 2 * t + (e & 1);
              float x = ex2(fmaf(s[4 * jj + e], p.scale_log2,
                                 -(e & 1 ? l.y : l.x)));
              if (masked && !visible<kPrefix>(p, q0 + col, key0 + (e >> 1) * 8))
                x = 0.f;
              s[4 * jj + e] = x;
            }
          }
          to_frags(pf, s);
          if constexpr (kRole == kSV) {
            named_sync<kFree, 256>();  // the other has read the last P^T
#pragma unroll
            for (int i = 0; i < 32; ++i) xbuf[i * 128 + tid] = s[i];
            named_arrive<kReady, 256>();
          }
          // dV += P^T dO: each k-step takes 16 queries of the dO tile, all
          // dh columns, as an MN-major operand.
          fence_regs(dv);
          fence_regs(pf);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<DH>(dv, pf[kk],
                         desc_sw32(sdo + kk * 16 * kBox * 2, C::kQBox >> 4, 16),
                         8 * C::kQBox);
          wgmma_commit();
        }
        if constexpr (kD) {
          if constexpr (kS)
            wgmma_wait<1>();
          else
            wgmma_wait<0>();
          fence_regs(dp);
          if constexpr (kRole == kDPK) {
            named_sync<kReady, 256>();  // P^T is in the buffer
#pragma unroll
            for (int i = 0; i < 32; ++i) s[i] = xbuf[i * 128 + tid];
            named_arrive<kFree, 256>();
          }
          // dS^T = P^T (dP^T - delta), then dK += dS^T Q.
#pragma unroll
          for (int jj = 0; jj < 8; ++jj) {
            const float2 d = *reinterpret_cast<const float2*>(
                sdelta + jj * 8 + 2 * t);
#pragma unroll
            for (int e = 0; e < 4; ++e)
              dp[4 * jj + e] =
                  s[4 * jj + e] * (dp[4 * jj + e] - (e & 1 ? d.y : d.x));
          }
          uint32_t df[4][4];
          to_frags(df, dp);
          fence_regs(dk);
          fence_regs(df);
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < 4; ++kk)
            wgmma_pv<DH>(dk, df[kk],
                         desc_sw32(sq + kk * 16 * kBox * 2, C::kQBox >> 4, 16),
                         8 * C::kQBox);
          wgmma_commit();
          wgmma_wait<0>();
          fence_regs(df);
          fence_regs(dk);
        } else {
          wgmma_wait<0>();
        }
        if constexpr (kS) {
          fence_regs(pf);
          fence_regs(dv);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(empty0 + 8 * stage);
      if (++stage == C::kStages) {
        stage = 0;
        phase ^= 1;
      }
    }
  }
  if constexpr (kRole == kSV) named_sync<kFree, 256>();  // the last handover

  if constexpr (kS)
    store_rows<DH>(p.dv + b * p.st[kDV][0] + kvh * p.st[kDV][2],
                   p.st[kDV][1], key0, p.Sk, dv, 1.f, t);
  if constexpr (kD)
    store_rows<DH>(p.dk + b * p.st[kDK][0] + kvh * p.st[kDK][2],
                   p.st[kDK][1], key0, p.Sk, dk, p.scale, t);
}

template <int DH, bool kPrefix>
__global__ void __launch_bounds__(KvCfg<DH>::kThreads, 1)
    flash_bwd_dkdv(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv,
                   const __grid_constant__ CUtensorMap tdo,
                   const __grid_constant__ CUtensorMap, const Params p) {
  using C = KvCfg<DH>;
  constexpr int kChunks = DH / kBox;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const unsigned char* smem = smem_raw + (base - raw);
  const uint32_t kv_full = base + C::kBar;
  const uint32_t full0 = kv_full + 8, empty0 = full0 + 8 * C::kStages;

  const int kvh = blockIdx.x % p.KV, b = blockIdx.x / p.KV;
  const int k_lo = blockIdx.y * C::kKeys;  // causal: heaviest first
  // The query rows that can see a key of the block: all of them for a block
  // holding a prefix key, else from the diagonal (causal) to the window's
  // reach.
  int q_begin = 0, q_end = p.Sq;
  if (!(kPrefix && k_lo < p.prefix)) {
    if (p.causal) q_begin = min(k_lo, p.Sq);
    if (p.window > 0) q_end = min(q_end, k_lo + C::kKeys - 1 + p.window);
  }
  const int qt_begin = q_begin / C::kBq;
  const int qt_end =
      q_end > q_begin ? (q_end + C::kBq - 1) / C::kBq : qt_begin;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, 8);  // the consumers' 8 warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // ---- producer: K and V once, then the ring of Q, dO, lse, delta.
    reg_dealloc<kProducerRegs>();
    if (warp == 8 && lane == 0) {
      const uint32_t sk = base + C::kK, sv = base + C::kV;
      mbar_expect_tx(kv_full, 2 * C::kTileKV);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(sk + c * C::kKeyBox, &tk, kv_full, c * kBox, k_lo, kvh, b);
        tma_load(sv + c * C::kKeyBox, &tv, kv_full, c * kBox, k_lo, kvh, b);
      }
      const int g = p.H / p.KV;
      int stage = 0;
      uint32_t phase = 0;
      for (int j = 0; j < g; ++j) {
        const int h = kvh * g + j;
        const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.SqP;
        for (int qt = qt_begin; qt < qt_end; ++qt) {
          const uint32_t full = full0 + 8 * stage;
          mbar_wait(empty0 + 8 * stage, phase ^ 1);
          mbar_expect_tx(full, 2 * C::kTileQ + 2 * C::kBq * 4);
          const uint32_t sq = base + C::kRing + stage * 2 * C::kTileQ;
          const uint32_t sdo = sq + C::kTileQ;
          for (int c = 0; c < kChunks; ++c) {
            tma_load(sq + c * C::kQBox, &tq, full, c * kBox, qt * C::kBq, h, b);
            tma_load(sdo + c * C::kQBox, &tdo, full, c * kBox, qt * C::kBq, h,
                     b);
          }
          const uint32_t srows = base + C::kRows + stage * 2 * C::kBq * 4;
          bulk_load(srows, p.lse2 + row0 + qt * C::kBq, C::kBq * 4, full);
          bulk_load(srows + C::kBq * 4, p.delta + row0 + qt * C::kBq,
                    C::kBq * 4, full);
          if (++stage == C::kStages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // ---- consumers.
    reg_alloc<kConsumerRegs>();
    if constexpr (C::kSplit) {
      if (warp < 4)
        kv_consumer<DH, kPrefix, kSV>(p, base, smem, b, kvh, k_lo, 0,
                                      qt_begin, qt_end);
      else
        kv_consumer<DH, kPrefix, kDPK>(p, base, smem, b, kvh, k_lo, 0,
                                       qt_begin, qt_end);
    } else {
      const int wg = warp >> 2;
      kv_consumer<DH, kPrefix, kBoth>(p, base, smem, b, kvh, k_lo + 64 * wg,
                                      wg * 64 * kBox * 2, qt_begin, qt_end);
    }
  }
}

// ---- dQ, delta and lse * log2(e) ------------------------------------------

template <int DH, bool kPrefix>
__device__ __forceinline__ void q_consumer(const Params& p, uint32_t base,
                                           int b, int h, int q_lo,
                                           int kb_begin, int kb_end) {
  using C = QCfg<DH>;
  using namespace sm90;
  constexpr int kChunks = DH / kBox;
  const uint32_t q_full = base + C::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::kStages;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wg = warp >> 2, wl = warp & 3, gq = lane >> 2, t = lane & 3;
  const int wq_lo = q_lo + 64 * wg;
  const int wq_hi = min(wq_lo + 64, p.Sq);  // exclusive; may be <= wq_lo
  const int r0 = wq_lo + wl * 16 + gq, r1 = r0 + 8;  // this thread's rows
  const uint32_t q_rows = base + C::kQ + wg * 64 * kBox * 2;
  const uint32_t do_rows = base + C::kDO + wg * 64 * kBox * 2;
  const uint32_t o_rows = base + C::kO + wg * 64 * kBox * 2;

  float dq[DH / 2];
#pragma unroll
  for (int i = 0; i < DH / 2; ++i) dq[i] = 0.f;

  mbar_wait(q_full, 0);
  // This warp's 16 rows of Q and dO as A fragments, k-step by k-step, and
  // delta = rowsum(dO * O) of rows r0 and r1 from the same fragments of dO
  // and O (the four threads of a row hold all its columns between them).
  uint32_t qf[C::kRegA ? kChunks : 1][4], dof[C::kRegA ? kChunks : 1][4];
  float d0 = 0.f, d1 = 0.f;
#pragma unroll
  for (int c = 0; c < kChunks; ++c) {
    uint32_t of[4], df[4];
    a_frag_sw32(of, o_rows + c * C::kRowBox, wl * 16 + gq, t);
    a_frag_sw32(df, do_rows + c * C::kRowBox, wl * 16 + gq, t);
    if constexpr (C::kRegA) {
      a_frag_sw32(qf[c], q_rows + c * C::kRowBox, wl * 16 + gq, t);
#pragma unroll
      for (int i = 0; i < 4; ++i) dof[c][i] = df[i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 a = bf16x2_to_float2(of[i]), e = bf16x2_to_float2(df[i]);
      (i & 1 ? d1 : d0) += a.x * e.x + a.y * e.y;
    }
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  // lse * log2(e), +inf past Sq; both into the scratch for the dK/dV
  // kernel, which runs after this one.
  const int64_t lrow = (static_cast<int64_t>(b) * p.H + h) * p.Sq;
  const float inf = __int_as_float(0x7f800000);
  const float l0 = r0 < p.Sq ? p.lse[lrow + r0] * kLog2e : inf;
  const float l1 = r1 < p.Sq ? p.lse[lrow + r1] * kLog2e : inf;
  if (t == 0) {
    const int64_t row0 = (static_cast<int64_t>(b) * p.H + h) * p.SqP;
    p.lse2[row0 + r0] = l0;
    p.lse2[row0 + r1] = l1;
    p.delta[row0 + r0] = d0;
    p.delta[row0 + r1] = d1;
  }
  int stage = 0;
  uint32_t phase = 0;
  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k_lo = kb * C::kBk;
    mbar_wait(full0 + 8 * stage, phase);
    const bool has_prefix = kPrefix && k_lo < p.prefix;
    const bool in_prefix = kPrefix && k_lo + C::kBk <= p.prefix;
    const bool live =
        wq_lo < wq_hi &&
        (has_prefix ||
         (!(p.causal && k_lo > wq_hi - 1) &&
          !(p.window > 0 && k_lo + C::kBk - 1 < wq_lo - p.window + 1)));
    if (live) {
      const bool masked =
          k_lo + C::kBk > p.Sk ||
          (!in_prefix &&
           (has_prefix || (p.causal && k_lo + C::kBk - 1 > wq_lo) ||
            (p.window > 0 && wq_hi - 1 - k_lo >= p.window)));
      const uint32_t kt = base + C::kRing + stage * 2 * C::kTileK;
      const uint32_t vt = kt + C::kTileK;

      // S = Q K^T and dP = dO V^T: 64 rows x 64 keys.
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t db = desc_sw32(kt + c * C::kKeyBox, 1, 16);
        if constexpr (C::kRegA)
          wgmma_rs_n64(s, qf[c], db, c > 0);
        else
          wgmma_ss_n64(s, desc_sw32(q_rows + c * C::kRowBox, 1, 16), db,
                       c > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        const uint64_t db = desc_sw32(vt + c * C::kKeyBox, 1, 16);
        if constexpr (C::kRegA)
          wgmma_rs_n64(dp, dof[c], db, c > 0);
        else
          wgmma_ss_n64(dp, desc_sw32(do_rows + c * C::kRowBox, 1, 16), db,
                       c > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k_lo + jj * 8 + 2 * t + (e & 1);
          float x = ex2(fmaf(s[4 * jj + e], p.scale_log2, e < 2 ? -l0 : -l1));
          if (masked && !visible<kPrefix>(p, e < 2 ? r0 : r1, col)) x = 0.f;
          s[4 * jj + e] = x;
        }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - delta), then dQ += dS K with the K tile as an
      // MN-major operand.
#pragma unroll
      for (int i = 0; i < 32; ++i)
        dp[i] = s[i] * (dp[i] - ((i & 3) < 2 ? d0 : d1));
      uint32_t df[4][4];
      to_frags(df, dp);
      fence_regs(dq);
      fence_regs(df);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_pv<DH>(dq, df[kk],
                     desc_sw32(kt + kk * 16 * kBox * 2, C::kKeyBox >> 4, 16),
                     8 * C::kKeyBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(df);
      fence_regs(dq);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * stage);
    if (++stage == C::kStages) {
      stage = 0;
      phase ^= 1;
    }
  }

  store_rows<DH>(p.dq + b * p.st[kDQ][0] + h * p.st[kDQ][2], p.st[kDQ][1],
                 r0, p.Sq, dq, p.scale, t);
}

template <int DH, bool kPrefix>
__global__ void __launch_bounds__(QCfg<DH>::kThreads, 1)
    flash_bwd_dq(const __grid_constant__ CUtensorMap tq,
                 const __grid_constant__ CUtensorMap tk,
                 const __grid_constant__ CUtensorMap tv,
                 const __grid_constant__ CUtensorMap tdo,
                 const __grid_constant__ CUtensorMap to, const Params p) {
  using C = QCfg<DH>;
  constexpr int kChunks = DH / kBox;
  constexpr int kConsumerWarps = 4 * C::kGroups;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_full = base + C::kBar;
  const uint32_t full0 = q_full + 8, empty0 = full0 + 8 * C::kStages;

  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int kvh = h / (p.H / p.KV);
  const int q_lo = (gridDim.y - 1 - blockIdx.y) * C::kRows;  // heaviest first
  const int q_hi = min(q_lo + C::kRows, p.Sq);               // exclusive
  // The forward's key range of the block.
  int kv_end = p.Sk;
  if (p.causal) kv_end = min(kv_end, kPrefix ? max(q_hi, p.prefix) : q_hi);
  const int kv_begin =
      p.window > 0 && !kPrefix ? max(0, q_lo - p.window + 1) : 0;
  const int kb_begin = kv_begin / C::kBk;
  const int kb_end = (kv_end + C::kBk - 1) / C::kBk;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= kConsumerWarps) {
    // ---- producer: Q, dO and O once, then the K/V ring.
    if constexpr (C::kGroups == 2) reg_dealloc<kProducerRegs>();
    if (warp == kConsumerWarps && lane == 0) {
      mbar_expect_tx(q_full, 3 * C::kTileQ);
      for (int c = 0; c < kChunks; ++c) {
        tma_load(base + C::kQ + c * C::kRowBox, &tq, q_full, c * kBox, q_lo,
                 h, b);
        tma_load(base + C::kDO + c * C::kRowBox, &tdo, q_full, c * kBox,
                 q_lo, h, b);
        tma_load(base + C::kO + c * C::kRowBox, &to, q_full, c * kBox, q_lo,
                 h, b);
      }
      int stage = 0;
      uint32_t phase = 0;
      for (int kb = kb_begin; kb < kb_end; ++kb) {
        const uint32_t full = full0 + 8 * stage;
        mbar_wait(empty0 + 8 * stage, phase ^ 1);
        mbar_expect_tx(full, 2 * C::kTileK);
        const uint32_t kt = base + C::kRing + stage * 2 * C::kTileK;
        for (int c = 0; c < kChunks; ++c) {
          tma_load(kt + c * C::kKeyBox, &tk, full, c * kBox, kb * C::kBk, kvh,
                   b);
          tma_load(kt + C::kTileK + c * C::kKeyBox, &tv, full, c * kBox,
                   kb * C::kBk, kvh, b);
        }
        if (++stage == C::kStages) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
  } else {
    // ---- consumers: warpgroup wg owns query rows q_lo + 64 wg ... + 63.
    if constexpr (C::kGroups == 2) reg_alloc<kConsumerRegs>();
    q_consumer<DH, kPrefix>(p, base, b, h, q_lo, kb_begin, kb_end);
  }
}

// ---- host side ------------------------------------------------------------

template <typename Kernel>
cudaError_t launch_one(Kernel kernel, dim3 grid, int threads, int bytes,
                       const CUtensorMap* maps, const Params& p,
                       cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, bytes, stream>>>(maps[0], maps[1], maps[2], maps[3],
                                           maps[4], p);
  return cudaGetLastError();
}

// The tensor maps of q, k, v, dO and o, boxes of `q_rows` query rows and
// `k_rows` key rows.
bool encode_maps(EncodeTiled fn, CUtensorMap (&maps)[5], const void* q,
                 const void* k, const void* v, const void* dout,
                 const void* o, const Params& p, int dh, int q_rows,
                 int k_rows) {
  return encode(fn, &maps[0], q, p.B, p.Sq, p.H, dh, p.st[kQ][0],
                p.st[kQ][1], p.st[kQ][2], q_rows) &&
         encode(fn, &maps[1], k, p.B, p.Sk, p.KV, dh, p.st[kK][0],
                p.st[kK][1], p.st[kK][2], k_rows) &&
         encode(fn, &maps[2], v, p.B, p.Sk, p.KV, dh, p.st[kV][0],
                p.st[kV][1], p.st[kV][2], k_rows) &&
         encode(fn, &maps[3], dout, p.B, p.Sq, p.H, dh, p.st[kDO][0],
                p.st[kDO][1], p.st[kDO][2], q_rows) &&
         encode(fn, &maps[4], o, p.B, p.Sq, p.H, dh, p.st[kO][0],
                p.st[kO][1], p.st[kO][2], q_rows);
}

// dQ first (it writes lse * log2(e) and delta into the scratch), then dK
// and dV.
template <int DH, bool kPrefix>
cudaError_t launch_grads(EncodeTiled fn, const void* q, const void* k,
                         const void* v, const void* dout, const void* o,
                         const Params& p, cudaStream_t stream) {
  using KC = KvCfg<DH>;
  using QC = QCfg<DH>;
  CUtensorMap maps[5];
  if (!encode_maps(fn, maps, q, k, v, dout, o, p, DH, QC::kRows, QC::kBk))
    return cudaErrorInvalidValue;
  cudaError_t err = launch_one(
      flash_bwd_dq<DH, kPrefix>,
      dim3(p.H * p.B, (p.Sq + QC::kRows - 1) / QC::kRows), QC::kThreads,
      QC::kBytes, maps, p, stream);
  if (err != cudaSuccess) return err;
  if (!encode_maps(fn, maps, q, k, v, dout, o, p, DH, KC::kBq, KC::kKeys))
    return cudaErrorInvalidValue;
  return launch_one(flash_bwd_dkdv<DH, kPrefix>,
                    dim3(p.KV * p.B, (p.Sk + KC::kKeys - 1) / KC::kKeys),
                    KC::kThreads, KC::kBytes, maps, p, stream);
}

template <int DH>
cudaError_t launch(EncodeTiled fn, const void* q, const void* k,
                   const void* v, const void* dout, const void* o,
                   const Params& p, cudaStream_t stream) {
  return p.prefix > 0
             ? launch_grads<DH, true>(fn, q, k, v, dout, o, p, stream)
             : launch_grads<DH, false>(fn, q, k, v, dout, o, p, stream);
}

}  // namespace

// The float32 scratch a call takes (its `delta` argument): lse * log2(e)
// and delta for every row of every head, Sq rounded up to 128 rows.
extern "C" int64_t flash_attention_bwd_scratch_floats(int64_t B, int64_t H,
                                                      int64_t Sq) {
  return 2 * B * H * ((Sq + kPad - 1) / kPad * kPad);
}

// shape: B, H, KV, Sq, Sk, dh.  strides: (batch, seq, head) element strides
// of q, k, v, o, dO, dq, dk, dv in that order; lse is a contiguous
// [B, H, Sq] float32 tensor and delta a float32 scratch of
// flash_attention_bwd_scratch_floats(B, H, Sq).  window 0: none; prefix 0:
// none.  Launches the two kernels on `stream`; returns the first error as
// an int (cudaErrorInvalidValue for a head dim it was not compiled for or a
// tensor map the driver refuses, cudaErrorNotSupported without
// cuTensorMapEncodeTiled).
extern "C" int flash_attention_bwd_launch(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const float* lse, float* delta, void* dq, void* dk,
    void* dv, const int64_t* shape, const int64_t* strides, int causal,
    int window, int prefix, float scale, void* stream) {
  const int dh = static_cast<int>(shape[5]);
  if (dh != 64 && dh != 80 && dh != 128 && dh != 256)
    return static_cast<int>(cudaErrorInvalidValue);
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  Params p;
  p.lse = lse;
  p.dq = static_cast<bf16*>(dq);
  p.dk = static_cast<bf16*>(dk);
  p.dv = static_cast<bf16*>(dv);
  p.B = static_cast<int>(shape[0]);
  p.H = static_cast<int>(shape[1]);
  p.KV = static_cast<int>(shape[2]);
  p.Sq = static_cast<int>(shape[3]);
  p.Sk = static_cast<int>(shape[4]);
  p.SqP = (p.Sq + kPad - 1) / kPad * kPad;
  p.lse2 = delta;
  p.delta = delta + static_cast<int64_t>(p.B) * p.H * p.SqP;
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
    case 64: err = launch<64>(fn, q, k, v, dout, o, p, s); break;
    case 80: err = launch<80>(fn, q, k, v, dout, o, p, s); break;
    case 128: err = launch<128>(fn, q, k, v, dout, o, p, s); break;
    default: err = launch<256>(fn, q, k, v, dout, o, p, s); break;
  }
  return static_cast<int>(err);
}

extern "C" const char* flash_attention_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
