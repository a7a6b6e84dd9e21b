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
// cudaGetDriverEntryPoint, so the library links no more than cudart.
//
// Semantics follow the model's blockwise_attention: scores scaled by the
// real dh^-0.5 in f32 (the wrapper passes it: a padded dh does not change
// it), masked entries set to -1e30 (a row masked so far
// keeps m = -1e30; what it summed is wiped by the first real maximum), p
// rounded to bf16 for the PV product while l sums the f32 p, and the
// output divided by max(l, 1e-30).

#include <cuda.h>  // CUtensorMap and its enums (types only: no -lcuda)
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kBox = 16;        // columns of one TMA box (32 bytes)
constexpr int kStages = 3;      // K/V ring depth
constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

typedef __nv_bfloat16 bf16;

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

// ---- PTX helpers ----------------------------------------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One [kBox cols, rows, 1, 1] box of a 4-D tensor map into shared memory,
// completing on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// wgmma shared-memory descriptor: start address, leading and stride byte
// offsets (16-byte units), layout 3 = 32-byte swizzle.
__device__ __forceinline__ uint64_t desc_sw32(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32) |
         (static_cast<uint64_t>(3) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keep the compiler from moving reads or writes of accumulator registers
// across an asynchronous wgmma (it sees the asm as finished at issue).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
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

// D[64 x 128] (+)= A[64 x 16] B[16 x 128] with A and B in shared memory
// (descriptors da, db), both K-major; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] with A and B in shared memory
// (descriptors da, db), both K-major; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                            uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// S = Q K^T over one k-step for a tile of BK keys.
template <int BK>
__device__ __forceinline__ void wgmma_qk(float (&d)[BK / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (BK == 64) wgmma_ss_n64(d, da, db, accumulate);
  if constexpr (BK == 128) wgmma_ss_n128(d, da, db, accumulate);
}

// D[64 x 64] += A[64 x 16] B[16 x 64] with A in registers (the
// m16n8k16 A fragment, one 16-row slab per warp) and B in shared memory,
// MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 80] += A[64 x 16] B[16 x 80] with A in registers (the
// m16n8k16 A fragment, one 16-row slab per warp) and B in shared memory,
// MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n80_tb(float (&d)[40],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39}"
      ", {%40, %41, %42, %43}, %44, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D[64 x 128] += A[64 x 16] B[16 x 128] with A in registers (the
// m16n8k16 A fragment, one 16-row slab per warp) and B in shared memory,
// MN-major (the transpose flag set).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35,"
      " %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47,"
      " %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59,"
      " %60, %61, %62, %63}"
      ", {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V over one k-step.  db addresses the V tile's first column box;
// at dh 256 the second half of the columns starts `half` bytes further (8
// boxes) and its accumulators are o[64..127], the n128 layout's own order.
template <int DH>
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t db,
                                         uint32_t half) {
  if constexpr (DH == 64) wgmma_rs_n64_tb(d, a, db);
  if constexpr (DH == 80) wgmma_rs_n80_tb(d, a, db);
  if constexpr (DH == 128) wgmma_rs_n128_tb(d, a, db);
  if constexpr (DH == 256) {
    wgmma_rs_n128_tb(*reinterpret_cast<float(*)[64]>(&d[0]), a, db);
    wgmma_rs_n128_tb(*reinterpret_cast<float(*)[64]>(&d[64]), a,
                     db + (half >> 4));
  }
}

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

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver that cudart already loaded.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 4-D map over a strided [batch, seq, heads, dh] bf16 tensor whose boxes
// are [16 columns, rows of the sequence] with the 32-byte swizzle; element
// strides (batch, seq, head) as given, dh contiguous.
bool encode(EncodeTiled fn, CUtensorMap* map, const void* ptr, int batch,
            int seq, int heads, int dh, int64_t sb, int64_t ss, int64_t sh,
            int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(dh),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(ss * 2),
                                 static_cast<cuuint64_t>(sh * 2),
                                 static_cast<cuuint64_t>(sb * 2)};
  const cuuint32_t box[4] = {kBox, static_cast<cuuint32_t>(rows), 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_32B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

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
