// The gradient of the Mamba2 SSD chunked scan, for Hopper.
//
// Replaces jax.grad of src/repro/models/ssm.py:79 ssd_chunked, which the
// JAX package differentiates with XLA: it has no Pallas backward (the
// forward's TPU kernel is src/repro/kernels/ssd_scan.py::_kernel).  The
// plain torch version is repro_torch/kernels/ssd_scan.py::
// ssd_scan_bwd_plain, formula for formula; the Python wrapper is
// ssd_scan_bwd_cuda in the same module, reached through the autograd
// Function SSDScan.
//
// Input:  x [B, S, H, P], b/c [B, S, N], dy [B, S, H, P] bf16 (strided),
//         dt [B, S, H] and a [H] f32, the forward's f32 chunk states
//         [B, NC, H, P, N] (the state entering each chunk of kQ = 64
//         tokens, written by ssd_scan.cu's kStates instantiation) and
//         dfinal [B, H, P, N] f32 or null (zero).
// Output: dx [B, S, H, P] bf16, ddt [B, S, H] f32, per-chunk partial sums
//         of da [B, NC, H] f32 (the wrapper adds them up with one
//         torch.sum: glue in a fixed order, not the product), db/dc
//         [B, S, N] bf16, dinit [B, H, P, N] f32; and, between the two
//         kernels, ds [B, NC, H, P, N] f32, the cotangent of the state
//         leaving each chunk.
// (P, N) is (64, 128); the wrapper zero-pads smaller ones.
//
// Per chunk, with cum the inclusive cumsum of dt a, L[i, j] =
// exp(cum_i - cum_j) for i >= j (else 0), M = (C B^T) ⊙ L, w_j =
// exp(cum_last - cum_j), s the state entering the chunk and G the
// cotangent of the state leaving it:
//   G_prev = exp(cum_last) G + (exp(cum) ⊙ dy)^T C
//   dM = dy xd^T, dS = sum_h dM ⊙ L, T = dM ⊙ M
//   dxd = M^T dy + w ⊙ (B G^T), dw_j = xd_j · (G B_j)
//   dC = dS B + sum_h (exp(cum) ⊙ dy) s, dB = dS^T C + sum_h w ⊙ (xd G)
//   dcum_i = sum_j T_ij - sum_j T_ji + exp(cum_i) dy_i · (s C_i) - w_i dw_i,
//   dcum_last += sum_j w_j dw_j + exp(cum_last) <G, s>
//   d(dA) = reverse cumsum of dcum, ddt = d(dA) a + sum_p dxd x,
//   dx = dxd dt, da = sum d(dA) dt.
// Every product takes bf16 operands and sums in f32, as the plain version
// rounds them; the decay term <G, s> reads both in f32.
//
// Two kernels:
// (a) ssd_bwd_state<kHeads>, one warpgroup per (batch, head), kHeads
//     heads a block, walks the chunks from the last to the first with G in
//     registers (the wgmma m64n128 accumulator: warp w of the warpgroup
//     owns state rows 16w..16w+15), writes each chunk's G for (b) and
//     dinit at the end: the forward's chain, run backwards.
// (b) ssd_bwd_chunk, one block of eight warps per (batch, chunk), runs
//     over all H heads in order: given s (the forward's chunk state) and G
//     (from (a)) a chunk's terms need nothing from another chunk.  B and C
//     are one group shared by every head, so dB, dC and dS of the chunk
//     are summed over the heads inside the block, in accumulator
//     registers: a fixed order, no atomics and no [B, S, H, N] partials,
//     so two calls give the same bits.  Warp (r, h2) owns rows 16r.. of
//     every product and half h2 of its columns; row and column sums across
//     warps go through shared memory and are added in a fixed order.
//
// What bounds it on an H100.  At mamba2-370m's training shape (B 8, S
// 2048, H 32, P 64, N 128) the products are about 47 GFLOP (0.05 ms at the
// bf16 peak), the gradient's own operands 0.22 GB (0.07 ms at 3.35 TB/s),
// and the design moves 0.81 GB more: the forward's f32 chunk states, read
// once, and G, written by (a) and read by (b) (chip_smoke.
// ssd_bwd_kernel_bytes counts each launch's traffic: 0.35 GB for (a),
// 0.76 GB for (b), 0.10 and 0.23 ms at the memory rate).  (a) is bound by
// its loads and by writing G; (b) by the latency of its per-head chain of
// products and barriers (served from L2, its loads take it no faster).
// The first version of this file lost both to latency: synchronous loads
// with nothing in flight while the products ran, G leaving in scattered
// 8-byte stores, barriers on serial work, one block per SM.
//
// What the design does about it:
// - (a): the next chunk's dy, c and dt are in flight (cp.async, two
//   stages; a third measured no faster) while the chunk's G is stored and
//   updated.  c is one group shared by every head, and the 32 heads of a
//   batch fetching the same c tile at once held each chain back most: two
//   heads a block load it once for both, where those blocks still cover
//   three quarters of the SMs (launch() picks kHeads from B and H; one
//   head a block spreads a small grid over twice the SMs).  G leaves
//   through a per-warp staging tile in whole 512-byte rows: from
//   registers, its 8-byte stores cost twice the time of everything else
//   in (a).  (exp(cum) dy)^T is built in registers (ldmatrix.trans of dy,
//   scaled by exp(cum) per token and rounded to bf16 as the plain version
//   rounds it), and the update is one wgmma m64n128k16 per 16 tokens with
//   C, cp.async'd straight into wgmma's canonical layout, as the MN-major
//   operand.  All of a grid's chains run at once (137 KB a block of two
//   heads, one an SM; 86 KB of one, two an SM).  Measured no faster on an
//   H100: each chain's N split over two blocks, and G leaving by bulk
//   copies from the staging tile, by streaming stores, or while the
//   update's wgmma runs.
// - (b): while head h computes, head h + 1's f32 G and s (one bulk copy,
//   cp.async.bulk, a 512-byte row each, completing on an mbarrier) and x,
//   dy, dt (cp.async) are in flight: 80 KB a head.  A head is three block
//   barriers: its loads have landed, its operands are formed (G and s
//   rounded to bf16, <G, s> in f32, dt x and exp(cum) dy, all in wgmma's
//   canonical layout), and M is in place for M^T dy.  Every state-sized
//   product is a wgmma with both operands in shared memory, 24 a warpgroup
//   a head started together: dC += (exp(cum) dy) s and dB's xd G over the
//   warpgroup's half of N (m64n64k16, s and G MN-major), C s^T and B G^T
//   over its half of P (m64n32k16, s and G K-major); they run while dM =
//   dy xd^T, M, T and dS are built on mma.sync.  C B^T (f32, shared
//   memory) and dS (registers) live across the heads; T's row and column
//   sums come from registers (quad and column shuffles, then per-warp
//   partials added in a fixed order), with no f32 T tile; a head's scalar
//   tail (dcum, its reverse cumsum, ddt, da) runs on a warp that builds no
//   dM tile while the next head's products run, instead of holding the
//   others at a barrier; dx leaves through per-warp staging in whole
//   sectors.
// Storing the chunk states and G in bf16 would cut the design's bytes by
// 0.40 GB; see ssd_scan.cu for why the states are f32.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kQ = 64;     // chunk length, the forward's
constexpr int kP = 64;     // head dim the kernels are compiled for
constexpr int kN = 128;    // state size
constexpr unsigned kAll = 0xffffffffu;

struct Params {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  const float* states;  // [B, NC, H, P, N]: the state entering each chunk
  const bf16* dy;
  const float* dfinal;  // may be null
  float* ds;            // [B, NC, H, P, N]: G of each chunk
  bf16* dx;             // [B, S, H, P]
  float* ddt;           // [B, S, H]
  float* da_part;       // [B, NC, H]
  bf16* db;             // [B, S, N]
  bf16* dc;             // [B, S, N]
  float* dinit;         // [B, H, P, N]
  int B, S, H, NC;
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
      dy_sb, dy_ss, dy_sh;
};

// 16 (or 4) bytes global -> shared, zero-filled when !pred.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// Wait until at most N of this thread's committed groups are pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The bf16 tiles that wgmma reads (c in (a); b, c, G, s, dt x and
// exp(cum) dy in (b)) are stored in its canonical layout without swizzle,
// as ssd_scan.cu stores w b and the state: 8x8 core matrices of 128
// contiguous bytes (eight 16-byte rows), core matrix (row / 8, col / 8) of
// a [rows][W] tile at (row / 8 * W / 8 + col / 8) * 128.  In the
// descriptors the leading byte offset steps along the product's k and the
// stride byte offset along its m or n (ssd_scan.cu's two layouts read so):
// - the tile's row as k (MN-major, a B operand): k16 step kk starts at
//   tile + kk * 2 * W * 16, LBO W * 16 bytes, SBO 128;
// - the tile's column as k (K-major, A or B): k16 step kk starts at
//   tile + kk * 256, LBO 128 bytes, SBO W * 16.
template <int W>
__device__ __forceinline__ uint32_t core_at(uint32_t base, int row, int col) {
  return base + ((((row >> 3) * (W / 8)) + (col >> 3)) << 7) +
         ((row & 7) << 4) + ((col & 7) << 1);
}

// wgmma shared-memory descriptor for the canonical layout without swizzle:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32);
}
// The descriptors of k16 step kk of a [rows][W] core-matrix tile (from its
// first row: offset the start by whole core rows for a later m or n).
template <int W>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_plain(tile + kk * 2 * W * 16, W, 8);
}
template <int W>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_plain(tile + kk * 256, 8, W);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], A K-major and B MN-major, both
// in shared memory; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n64_tb(float (&d)[32], uint64_t da,
                                                uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", %32, %33, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], both K-major in shared memory;
// accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15}"
      ", %16, %17, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Four 8x8 bf16 tiles from shared memory; .trans delivers each transposed.
__device__ __forceinline__ void ldsm4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}
__device__ __forceinline__ void ldsm4_t(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// D = A B + D for one 16x8x16 tile: A row-major 16x16 bf16 (4 regs), B
// column-major 16x8 bf16 (2 regs), D 16x8 f32 (4 regs at d).  D element e
// of the thread (lane = 4g + t) is row g (+8 for e >= 2), column 2t (+1
// for odd e).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// A bf16 pair times (lo, hi), each rounded to bf16 again.
__device__ __forceinline__ uint32_t scale2(uint32_t v, float lo, float hi) {
  const float2 f = unpack_bf16(v);
  return pack_bf16(f.x * lo, f.y * hi);
}

// Eight bf16 values times s, each rounded to bf16 again.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = scale2(w[i], s, s);
  return v;
}

// Shared-memory address of lane's row for an ldmatrix.x4 over a 16x16 tile
// at (r, col) of a row-major tile with row stride `ld` elements (as in
// ssd_scan.cu).  at_a: the A fragment of the tile (non-trans), or the B
// fragments of its two n8 column halves when the tile is B stored [k][n]
// (trans).  at_b: the B fragments of rows r.. and r+8.. as two n8 tiles
// when the tile is B^T stored [n][k] (non-trans), or the A fragment of the
// tile's transpose (trans).  core_a and core_b: at_a and at_b over a
// [rows][W] tile in the canonical layout (core_at).
__device__ __forceinline__ uint32_t at_a(uint32_t base, int ld, int r, int col,
                                         int lane) {
  return base + 2 * ((r + (lane & 15)) * ld + col + (lane >> 4) * 8);
}
__device__ __forceinline__ uint32_t at_b(uint32_t base, int ld, int r, int col,
                                         int lane) {
  return base +
         2 * ((r + (lane & 7) + ((lane >> 4) << 3)) * ld + col +
              ((lane >> 3) & 1) * 8);
}
template <int W>
__device__ __forceinline__ uint32_t core_a(uint32_t base, int r, int col,
                                           int lane) {
  return core_at<W>(base, r + (lane & 15), col + (lane >> 4) * 8);
}
template <int W>
__device__ __forceinline__ uint32_t core_b(uint32_t base, int r, int col,
                                           int lane) {
  return core_at<W>(base, r + (lane & 7) + ((lane >> 4) << 3),
                    col + ((lane >> 3) & 1) * 8);
}

// Inclusive cumsum of dt a over a chunk in log2 units, as the forward
// takes it: lane l gets tokens 2l (c2e) and 2l + 1 (c2o).
__device__ __forceinline__ void chunk_cum2(const float* dts, float a, int lane,
                                           float& c2e, float& c2o) {
  const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
  const float da0 = d.x * a, da1 = d.y * a;
  float run = da0 + da1;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float u = __shfl_up_sync(kAll, run, off);
    if (lane >= off) run += u;
  }
  float excl = __shfl_up_sync(kAll, run, 1);
  if (lane == 0) excl = 0.f;
  const float ce = excl + da0;
  c2e = ce * kLog2e;
  c2o = (ce + da1) * kLog2e;
}

// Token j's value of a pair (lane l holds tokens 2l, 2l + 1); every lane of
// the warp must call it.
__device__ __forceinline__ float pair_at(float ev, float od, int j) {
  const float e = __shfl_sync(kAll, ev, (j >> 1) & 31);
  const float o = __shfl_sync(kAll, od, (j >> 1) & 31);
  return (j & 1) ? o : e;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(kAll, v, off);
  return v;
}

// Sum over the four lanes of a quad (the t of one row g).
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(kAll, v, 1);
  v += __shfl_xor_sync(kAll, v, 2);
  return v;
}

// Sum over the eight lanes of one t (the g of one column 2t, 2t + 1).
__device__ __forceinline__ float column_sum(float v) {
  v += __shfl_xor_sync(kAll, v, 4);
  v += __shfl_xor_sync(kAll, v, 8);
  v += __shfl_xor_sync(kAll, v, 16);
  return v;
}

// ---------------------------------------------------------------------------
// (a) The state cotangent, chunk by chunk from the last.
// ---------------------------------------------------------------------------

// A block of (a) holds kHeads heads, one warpgroup each (see launch()).
template <int kHeads>
struct SmemA {
  static constexpr int kStages = 2;      // the chunk and the next
  static constexpr int kYS = kP + 8;     // dy row stride (elements)
  static constexpr int kGS = kN + 8;     // staged G row stride (floats)
  static constexpr int kC = 0;                       // c [kQ][kN], core matrices
  static constexpr int kDy = kC + kQ * kN * 2;       // dy [kHeads][kQ][kYS]
  static constexpr int kDt = kDy + kHeads * kQ * kYS * 2;  // dt [kHeads][kQ]
  static constexpr int kStage = kDt + kHeads * kQ * 4;
  // G on its way out, each warp's 16 rows [16][kGS] f32.
  static constexpr int kG = kStages * kStage;
  static constexpr int kBytes = kG + kHeads * kP * kGS * 4;
};

template <int kHeads>
__global__ void __launch_bounds__(128 * kHeads)
    ssd_bwd_state(const Params p) {
  using L = SmemA<kHeads>;
  constexpr int kThreadsA = 128 * kHeads;
  constexpr int kNt = kN / 8;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sm = smem_addr(smem_raw);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wg = warp >> 2, wl = warp & 3;  // this warpgroup's head, row slab
  const int h0 = blockIdx.x * kHeads, h = h0 + wg, bb = blockIdx.y;
  const bool has_head = h < p.H;  // an odd H leaves the last block one head
  const float a = has_head ? p.a[h] : 0.f;
  const int64_t hs = (static_cast<int64_t>(bb) * p.H + h) * kP * kN;
  const int r0 = wl * 16 + g, r1 = r0 + 8;  // this thread's state rows

  // dy and dt of the block's heads and c (one group, shared) of chunk `ch`
  // into `stage`; rows past S are zero.
  auto load_chunk = [&](int ch, int stage) {
    const uint32_t buf = sm + stage * L::kStage;
    const int s0 = ch * kQ;
    for (int i = tid; i < kHeads * kQ * (kP / 8); i += kThreadsA) {
      const int hh = i / (kQ * (kP / 8)), row = (i >> 3) % kQ, cc = i & 7;
      const int s = s0 + row;
      const bool ok = s < p.S && h0 + hh < p.H;
      cp_async16(buf + L::kDy + 2 * ((hh * kQ + row) * L::kYS + cc * 8),
                 ok ? p.dy + bb * p.dy_sb + s * p.dy_ss + (h0 + hh) * p.dy_sh +
                          cc * 8
                    : p.dy,
                 ok);
    }
    for (int i = tid; i < kQ * (kN / 8); i += kThreadsA) {
      const int row = i >> 4, cc = i & 15, s = s0 + row;
      const bool ok = s < p.S;
      cp_async16(core_at<kN>(buf + L::kC, row, cc * 8),
                 ok ? p.c + bb * p.c_sb + s * p.c_ss + cc * 8 : p.c, ok);
    }
    if (tid < kHeads * kQ) {
      const int hh = tid / kQ, s = s0 + tid % kQ;
      const bool ok = s < p.S && h0 + hh < p.H;
      cp_async4(buf + L::kDt + 4 * tid,
                ok ? p.dt + bb * p.dt_sb + s * p.dt_ss + (h0 + hh) * p.dt_sh
                   : p.dt,
                ok);
    }
  };

  // G in the accumulator layout: ds[4 nt + e] is row r0 (r1 for e >= 2),
  // column 8 nt + 2t (+1 for odd e).
  float ds[4 * kNt];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = nt * 8 + 2 * t;
    float2 u = make_float2(0.f, 0.f), v = u;
    if (p.dfinal && has_head) {
      u = *reinterpret_cast<const float2*>(p.dfinal + hs + r0 * kN + col);
      v = *reinterpret_cast<const float2*>(p.dfinal + hs + r1 * kN + col);
    }
    ds[4 * nt] = u.x; ds[4 * nt + 1] = u.y;
    ds[4 * nt + 2] = v.x; ds[4 * nt + 3] = v.y;
  }

  float* gs = reinterpret_cast<float*>(smem_raw + L::kG) + warp * 16 * L::kGS;
  const int nc = p.NC;
  // Chunk i of the walk is chunk nc - 1 - i, in stage i % kStages.
#pragma unroll
  for (int i = 0; i < L::kStages - 1; ++i) {
    if (i < nc) load_chunk(nc - 1 - i, i);
    cp_async_commit();
  }
  for (int i = 0; i < nc; ++i) {
    const int ch = nc - 1 - i, stage = i % L::kStages;
    cp_async_wait<L::kStages - 2>();
    // c was written by cp.async and is read by wgmma through the async
    // proxy: make this thread's copies visible to it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // chunk i has landed; chunk i - 1's stage is consumed
    if (i + L::kStages - 1 < nc)
      load_chunk(ch - (L::kStages - 1), (i + L::kStages - 1) % L::kStages);
    cp_async_commit();

    // G of this chunk (the cotangent of the state leaving it), for (b):
    // this warp's 16 rows through its staging tile (rows 136 floats apart,
    // no bank conflict), then out a whole 512-byte row per store.  (A
    // warpgroup without a head runs on zeros and stores nothing.)
    if (has_head) {
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(gs + g * L::kGS + col) =
            make_float2(ds[4 * nt], ds[4 * nt + 1]);
        *reinterpret_cast<float2*>(gs + (g + 8) * L::kGS + col) =
            make_float2(ds[4 * nt + 2], ds[4 * nt + 3]);
      }
      __syncwarp();
      float* gp = p.ds + ((static_cast<int64_t>(bb) * p.NC + ch) * p.H + h) *
                             kP * kN + wl * 16 * kN;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        *reinterpret_cast<float4*>(gp + r * kN + 4 * lane) =
            *reinterpret_cast<const float4*>(gs + r * L::kGS + 4 * lane);
    }

    const uint32_t buf = sm + stage * L::kStage;
    const float* dts = reinterpret_cast<const float*>(
                           smem_raw + stage * L::kStage + L::kDt) + wg * kQ;
    float c2e, c2o;
    chunk_cum2(dts, a, lane, c2e, c2o);
    const float clast = __shfl_sync(kAll, c2o, 31);

    // A = (exp(cum) dy)^T for this warp's state rows, 16 tokens a k-step:
    // the dy tile taken transposed, each token's column scaled by its
    // exp(cum) and rounded to bf16.  Registers 0 and 1 of a k-step hold
    // tokens 16 kk + 2t, +1 (lane 8 kk + t's pair), 2 and 3 tokens
    // 16 kk + 8 + 2t, +1 (lane 8 kk + 4 + t's).
    uint32_t af[kQ / 16][4];
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      ldsm4_t(af[kk], at_b(buf + L::kDy + wg * kQ * L::kYS * 2, L::kYS,
                           kk * 16, wl * 16, lane));
      const float e0 = ex2(__shfl_sync(kAll, c2e, 8 * kk + t));
      const float e1 = ex2(__shfl_sync(kAll, c2o, 8 * kk + t));
      const float e2 = ex2(__shfl_sync(kAll, c2e, 8 * kk + 4 + t));
      const float e3 = ex2(__shfl_sync(kAll, c2o, 8 * kk + 4 + t));
      af[kk][0] = scale2(af[kk][0], e0, e1);
      af[kk][1] = scale2(af[kk][1], e0, e1);
      af[kk][2] = scale2(af[kk][2], e2, e3);
      af[kk][3] = scale2(af[kk][3], e2, e3);
    }

    // G = exp(cum_last) G + (exp(cum) dy)^T C: one wgmma per 16 tokens over
    // the warpgroup's 64 state rows, C (the block's one copy) the MN-major B
    // operand.
    const float dec = ex2(clast);
#pragma unroll
    for (int k = 0; k < 4 * kNt; ++k) ds[k] *= dec;
    fence_regs(ds);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk)
      wgmma_rs_n128_tb(ds, af[kk], desc_mn<kN>(buf + L::kC, kk));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(ds);
    fence_regs(af);
  }

  if (!has_head) return;
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = nt * 8 + 2 * t;
    *reinterpret_cast<float2*>(p.dinit + hs + r0 * kN + col) =
        make_float2(ds[4 * nt], ds[4 * nt + 1]);
    *reinterpret_cast<float2*>(p.dinit + hs + r1 * kN + col) =
        make_float2(ds[4 * nt + 2], ds[4 * nt + 3]);
  }
}

// ---------------------------------------------------------------------------
// (b) Every chunk's gradients, all heads of a (batch, chunk) in one block.
// ---------------------------------------------------------------------------

struct SmemB {
  static constexpr int kXS = kP + 8;   // x, dy, M row stride
  static constexpr int kFS = kQ + 8;   // C B^T f32 row stride
  static constexpr int kGS = kN + 8;   // staged f32 G and s row stride
  static constexpr int kTile = kQ * kXS * 2;            // one [kQ][kXS] bf16
  // The next head's f32 G and s, [2][kP][kGS], one bulk copy a row.
  static constexpr int kStg = 0;
  // Core-matrix tiles (core_at): G and s [kP][kN], b and c [kQ][kN], dt x
  // (then dx on its way out) and exp(cum) dy [kQ][kP].
  static constexpr int kGb = kStg + 2 * kP * kGS * 4;
  static constexpr int kSb = kGb + kP * kN * 2;
  static constexpr int kB = kSb + kP * kN * 2;
  static constexpr int kC = kB + kQ * kN * 2;
  static constexpr int kScore = kC + kQ * kN * 2;       // C B^T f32 [kQ][kFS]
  static constexpr int kRaw = kScore + kQ * kFS * 4;    // [2 stages][x, dy]
  static constexpr int kXd = kRaw + 4 * kTile;
  static constexpr int kDyw = kXd + kQ * kP * 2;
  static constexpr int kM = kDyw + kQ * kP * 2;         // M (then dS) bf16
  static constexpr int kDt = kM + kTile;                // [3][kQ] f32
  static constexpr int kCum = kDt + 3 * kQ * 4;         // cum (log2) [kQ]
  // Per-token partial sums of a head, [2 (head parity)][kParts][kQ] f32:
  // dy · (s C) and xd · (G B) and dxd · x over each column half (kVp,
  // kWp, kXp), T's row sums over each column half (kRp) and its column
  // sums over each row slab (kCp).
  static constexpr int kVp = 0, kWp = 2, kXp = 4, kRp = 6, kCp = 8;
  static constexpr int kParts = 12;
  static constexpr int kPart = kCum + kQ * 4;
  static constexpr int kRed = kPart + 2 * kParts * kQ * 4;  // [2][8] <G, s>
  static constexpr int kBar = kRed + 2 * 8 * 4;             // mbarrier
  static constexpr int kBytes = kBar + 8;
};

constexpr int kThreadsB = 256;
constexpr int kGsBytes = 2 * kP * kN * 4;   // f32 G and s of one head

__global__ void __launch_bounds__(kThreadsB, 1) ssd_bwd_chunk(const Params p) {
  using L = SmemB;
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const uint32_t sm = smem_addr(smem_raw);
  const float* score = reinterpret_cast<const float*>(smem_raw + L::kScore);
  float* cum2 = reinterpret_cast<float*>(smem_raw + L::kCum);
  float* red = reinterpret_cast<float*>(smem_raw + L::kRed);
  const uint32_t bar = sm + L::kBar;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp & 3, hf = warp >> 2;  // row slab, column half
  const int r0 = rs * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int ch = blockIdx.x, bb = blockIdx.y, s0 = ch * kQ;
  const int64_t chunk_heads = (static_cast<int64_t>(bb) * p.NC + ch) * p.H;

  // Stage and parity buffers of head h.  dt has three: head h - 1's tail
  // reads it while head h + 1's loads land.
  auto raw = [&](int h, int which) {  // which 0: x, 1: dy
    return L::kRaw + ((h & 1) * 2 + which) * L::kTile;
  };
  auto dts_of = [&](int h) {
    return reinterpret_cast<float*>(smem_raw + L::kDt) + (h % 3) * kQ;
  };
  auto part = [&](int h, int k) {
    return reinterpret_cast<float*>(smem_raw + L::kPart) +
           ((h & 1) * L::kParts + k) * kQ;
  };

  // Head h's x, dy and dt (cp.async, rows past S zero) and f32 G and s (a
  // bulk copy a row, completing on `bar`, which thread 0 armed with
  // kGsBytes before the barrier this follows).
  auto load_head = [&](int h) {
    for (int i = tid; i < 2 * kQ * (kP / 8); i += kThreadsB) {
      const int which = i >> 9, row = (i >> 3) & 63, cc = i & 7,
                s = s0 + row;
      const bool ok = s < p.S;
      const bf16* src =
          which ? p.dy + bb * p.dy_sb + s * p.dy_ss + h * p.dy_sh
                : p.x + bb * p.x_sb + s * p.x_ss + h * p.x_sh;
      cp_async16(sm + raw(h, which) + 2 * (row * L::kXS + cc * 8),
                 ok ? src + cc * 8 : p.x, ok);
    }
    if (tid < kQ) {
      const int s = s0 + tid;
      const bool ok = s < p.S;
      cp_async4(smem_addr(dts_of(h) + tid),
                ok ? p.dt + bb * p.dt_sb + s * p.dt_ss + h * p.dt_sh : p.dt,
                ok);
    }
    cp_async_commit();
    if (tid < 2 * kP) {
      const int which = tid >> 6, row = tid & 63;
      const float* src = (which ? p.states : p.ds) +
                         (chunk_heads + h) * kP * kN + row * kN;
      bulk_load(sm + L::kStg + (which * kP + row) * L::kGS * 4, src, kN * 4,
                bar);
    }
  };

  // dcum, its reverse cumsum d(dA), ddt and da's partial of head hh (whose
  // a is `a`) from its per-token partial sums: one warp, lane l tokens 2l
  // and 2l + 1.
  auto tail = [&](int hh, float a) {
    const float* dts = dts_of(hh);
    float c2e, c2o;
    chunk_cum2(dts, a, lane, c2e, c2o);
    const float clast = __shfl_sync(kAll, c2o, 31);
    const float* vp = part(hh, L::kVp);
    const float* wp = part(hh, L::kWp);
    const float* xp = part(hh, L::kXp);
    const float* rp = part(hh, L::kRp);
    const float* cp = part(hh, L::kCp);
    const int je = 2 * lane;
    float dw[2], dc2[2], wj[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = je + e;
      const float c = e ? c2o : c2e;
      wj[e] = ex2(clast - c);
      dw[e] = wp[j] + wp[kQ + j];
      const float rsum = rp[j] + rp[kQ + j];
      const float csum = ((cp[j] + cp[kQ + j]) + cp[2 * kQ + j]) + cp[3 * kQ + j];
      dc2[e] = rsum - csum + ex2(c) * (vp[j] + vp[kQ + j]) - wj[e] * dw[e];
    }
    const float* rd = red + (hh & 1) * 8;
    float dot = 0.f;
#pragma unroll
    for (int k = 0; k < kThreadsB / 32; ++k) dot += rd[k];
    const float last =
        warp_sum(wj[0] * dw[0] + wj[1] * dw[1]) + ex2(clast) * dot;
    if (lane == 31) dc2[1] += last;
    // Sum over the tokens from this one to the chunk's end.
    const float pair = dc2[0] + dc2[1];
    float run = pair;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float u = __shfl_down_sync(kAll, run, off);
      if (lane + off < 32) run += u;
    }
    float after = __shfl_down_sync(kAll, run, 1);  // the lanes above
    if (lane == 31) after = 0.f;
    const float dda[2] = {pair + after, dc2[1] + after};
    float dap = 0.f;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = je + e, s = s0 + j;
      dap += dda[e] * dts[j];
      if (s < p.S)
        p.ddt[(static_cast<int64_t>(bb) * p.S + s) * p.H + hh] =
            dda[e] * a + (xp[j] + xp[kQ + j]);
    }
    dap = warp_sum(dap);
    if (lane == 0) p.da_part[chunk_heads + hh] = dap;
  };

  if (tid == 0) {
    mbar_init(bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    mbar_expect_tx(bar, kGsBytes);  // head 0's G and s
  }
  __syncthreads();
  // b and c of the chunk, once for every head; rows past S are zero.
  for (int i = tid; i < 2 * kQ * (kN / 8); i += kThreadsB) {
    const int which = i / (kQ * (kN / 8)), rem = i - which * kQ * (kN / 8);
    const int row = rem / (kN / 8), cc = rem - row * (kN / 8), s = s0 + row;
    const bool ok = s < p.S;
    const bf16* src = which ? p.c + bb * p.c_sb + s * p.c_ss
                            : p.b + bb * p.b_sb + s * p.b_ss;
    cp_async16(core_at<kN>(sm + (which ? L::kC : L::kB), row, cc * 8),
               ok ? src + cc * 8 : p.b, ok);
  }
  load_head(0);
  cp_async_wait<0>();
  __syncthreads();
  // C B^T: warp (rs, hf) computes rows 16 rs.., columns 32 hf...
  {
    float sc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t af[4];
      ldsm4(af, core_a<kN>(sm + L::kC, rs * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        ldsm4(bf, core_b<kN>(sm + L::kB, hf * 32 + jp * 16, kk * 16, lane));
        mma_bf16(sc + 8 * jp, af, bf);
        mma_bf16(sc + 8 * jp + 4, af, bf + 2);
      }
    }
    float* sw = reinterpret_cast<float*>(smem_raw + L::kScore);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = hf * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(&sw[r0 * L::kFS + col]) =
          make_float2(sc[4 * nt], sc[4 * nt + 1]);
      *reinterpret_cast<float2*>(&sw[r1 * L::kFS + col]) =
          make_float2(sc[4 * nt + 2], sc[4 * nt + 3]);
    }
  }

  // dB and dC of this warp's rows and columns 64 hf.. (the warpgroup's
  // wgmma m64n64 accumulators), and dS of its rows 16 rs.., columns 32
  // hf.. (the dM layout), summed over heads.
  float dbacc[32], dcacc[32], dsacc[16];
#pragma unroll
  for (int i = 0; i < 32; ++i) dbacc[i] = dcacc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 16; ++i) dsacc[i] = 0.f;
  // The warps of the two tiles wholly above the diagonal build no dM.
  const bool live = hf * 32 <= rs * 16 + 15;

  float a_prev = 0.f;  // a of the head before
  for (int h = 0; h < p.H; ++h) {
    const float a = p.a[h];
    cp_async_wait<0>();
    mbar_wait(bar, h & 1);
    __syncthreads();  // head h has landed; head h - 1 is consumed
    if (tid == 0 && h + 1 < p.H) mbar_expect_tx(bar, kGsBytes);

    // G and s rounded to bf16 into core matrices, <G, s> in f32.  Sixteen
    // threads fill one core matrix (a 128-byte write); eight read rows 136
    // floats apart (no bank conflict).
    {
      const float* stg = reinterpret_cast<const float*>(smem_raw + L::kStg);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kP * kN / 4 / kThreadsB; ++k) {
        const int idx = tid + k * kThreadsB;  // four values of a core row
        const int core = idx >> 4, pr = (idx >> 1) & 7, half = idx & 1;
        const int row = (core >> 4) * 8 + pr, col = (core & 15) * 8 + half * 4;
        const float4 gv =
            *reinterpret_cast<const float4*>(stg + row * L::kGS + col);
        const float4 sv =
            *reinterpret_cast<const float4*>(stg + (kP + row) * L::kGS + col);
        dot += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
        const int at = core * 128 + pr * 16 + half * 8;
        *reinterpret_cast<uint2*>(smem_raw + L::kGb + at) =
            make_uint2(pack_bf16(gv.x, gv.y), pack_bf16(gv.z, gv.w));
        *reinterpret_cast<uint2*>(smem_raw + L::kSb + at) =
            make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
      }
      dot = warp_sum(dot);
      if (lane == 0) red[(h & 1) * 8 + warp] = dot;
    }

    // cum in every warp; dt x and exp(cum) dy rounded to bf16, four threads
    // a token row, 16 columns each (eight neighbouring threads fill a core
    // matrix: no bank conflict).
    {
      const float* dts = dts_of(h);
      float c2e, c2o;
      chunk_cum2(dts, a, lane, c2e, c2o);
      if (warp == 0) {
        cum2[2 * lane] = c2e;
        cum2[2 * lane + 1] = c2o;
      }
      const int row = tid & 63, q4 = tid >> 6;
      const float e = ex2(pair_at(c2e, c2o, row));
      const float d = dts[row];
      const int at = 2 * (row * L::kXS + q4 * 16);
      const uint4* xr =
          reinterpret_cast<const uint4*>(smem_raw + raw(h, 0) + at);
      const uint4* yr =
          reinterpret_cast<const uint4*>(smem_raw + raw(h, 1) + at);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        const int cut = core_at<kP>(0, row, q4 * 16 + v * 8);
        *reinterpret_cast<uint4*>(smem_raw + L::kXd + cut) = scale8(xr[v], d);
        *reinterpret_cast<uint4*>(smem_raw + L::kDyw + cut) = scale8(yr[v], e);
      }
    }
    // The bf16 G, s, dt x and exp(cum) dy were written by ordinary stores
    // and are read by wgmma through the async proxy: make the writes
    // visible to it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // G, s, cum, dt x and exp(cum) dy are in place
    if (h + 1 < p.H) load_head(h + 1);

    const uint32_t ys = sm + raw(h, 1);
    const bf16* xsm = reinterpret_cast<const bf16*>(smem_raw + raw(h, 0));
    const bf16* dysm = reinterpret_cast<const bf16*>(smem_raw + raw(h, 1));
    // cum (log2) at this thread's rows, w at them.
    const float c0 = cum2[r0], c1 = cum2[r1], clast = cum2[kQ - 1];
    const float w0 = ex2(clast - c0), w1 = ex2(clast - c1);

    // The state-sized products of the head, over this warpgroup's part of
    // their columns, all operands in shared memory: dC += (exp(cum) dy) s
    // and tmp = xd G over columns 64 hf.. of N (the bf16 s and G as
    // MN-major B), V = C s^T and U = B G^T over columns 32 hf.. of P (s
    // and G as K-major B).  They run while dM is built on mma.sync.
    float tmp[32], v[16], u[16];
    fence_regs(dcacc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss_n64_tb(dcacc, desc_k<kP>(sm + L::kDyw, kk),
                      desc_mn<kN>(sm + L::kSb + hf * 8 * 128, kk), 1);
#pragma unroll
    for (int kk = 0; kk < kP / 16; ++kk)
      wgmma_ss_n64_tb(tmp, desc_k<kP>(sm + L::kXd, kk),
                      desc_mn<kN>(sm + L::kGb + hf * 8 * 128, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_ss_n32(v, desc_k<kN>(sm + L::kC, kk),
                   desc_k<kN>(sm + L::kSb + hf * 4 * kN * 16, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk)
      wgmma_ss_n32(u, desc_k<kN>(sm + L::kB, kk),
                   desc_k<kN>(sm + L::kGb + hf * 4 * kN * 16, kk), kk > 0);
    wgmma_commit();

    // dM = dy xd^T over rows 16 rs.. and columns 32 hf..; then M (bf16),
    // T = dM M with its row and column sums, and dS += dM L, on and below
    // the diagonal (above it L is 0 and its exponent could overflow).
    {
      float rsum0 = 0.f, rsum1 = 0.f, csum[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) csum[k] = 0.f;
      if (live) {
        float dm[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) dm[j] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kP / 16; ++kk) {
          uint32_t af[4];
          ldsm4(af, at_a(ys, L::kXS, rs * 16, kk * 16, lane));
#pragma unroll
          for (int jp = 0; jp < 2; ++jp) {
            uint32_t bf[4];
            ldsm4(bf, core_b<kP>(sm + L::kXd, hf * 32 + jp * 16, kk * 16,
                                 lane));
            mma_bf16(dm + 8 * jp, af, bf);
            mma_bf16(dm + 8 * jp + 4, af, bf + 2);
          }
        }
        // Entries above the diagonal take L = 0 (selected, not computed:
        // their exponent could overflow), so they add nothing.
        const bool cross = hf * 32 + 31 > rs * 16;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int j = hf * 32 + nt * 8 + 2 * t;
          const float2 cj = *reinterpret_cast<const float2*>(cum2 + j);
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int i = half ? r1 : r0;
            const float ci = half ? c1 : c0;
            const float2 sc =
                *reinterpret_cast<const float2*>(score + i * L::kFS + j);
            float l0 = ex2(ci - cj.x), l1 = ex2(ci - cj.y);
            if (cross) {
              l0 = j <= i ? l0 : 0.f;
              l1 = j + 1 <= i ? l1 : 0.f;
            }
            const float d0 = dm[4 * nt + 2 * half];
            const float d1 = dm[4 * nt + 2 * half + 1];
            const float m0 = sc.x * l0, m1 = sc.y * l1;
            const float t0 = d0 * m0, t1 = d1 * m1;
            if (half) rsum1 += t0 + t1; else rsum0 += t0 + t1;
            csum[2 * nt] += t0;
            csum[2 * nt + 1] += t1;
            dsacc[4 * nt + 2 * half] += d0 * l0;
            dsacc[4 * nt + 2 * half + 1] += d1 * l1;
            *reinterpret_cast<uint32_t*>(smem_raw + L::kM +
                                         2 * (i * L::kXS + j)) =
                pack_bf16(m0, m1);
          }
        }
      }
      // The head before's scalar tail, on a warp with no dM tile.
      if (!live && rs == 0 && h > 0) tail(h - 1, a_prev);
      rsum0 = quad_sum(rsum0);
      rsum1 = quad_sum(rsum1);
      if (t == 0) {
        part(h, L::kRp + hf)[r0] = rsum0;
        part(h, L::kRp + hf)[r1] = rsum1;
      }
#pragma unroll
      for (int k = 0; k < 8; ++k) csum[k] = column_sum(csum[k]);
      if (g == 0) {
        float* cp = part(h, L::kCp + rs) + hf * 32 + 2 * t;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          *reinterpret_cast<float2*>(cp + nt * 8) =
              make_float2(csum[2 * nt], csum[2 * nt + 1]);
      }
    }

    wgmma_wait_all();
    fence_regs(dcacc);
    fence_regs(tmp);
    fence_regs(v);
    fence_regs(u);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      dbacc[4 * nt] += w0 * tmp[4 * nt];
      dbacc[4 * nt + 1] += w0 * tmp[4 * nt + 1];
      dbacc[4 * nt + 2] += w1 * tmp[4 * nt + 2];
      dbacc[4 * nt + 3] += w1 * tmp[4 * nt + 3];
    }

    // dy · (s C) and xd · (G B) at this warp's rows, over columns 32 hf..
    // of P; dxd starts as w U.
    float dxd[16];
    {
      float v0 = 0.f, v1 = 0.f, u0 = 0.f, u1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = hf * 32 + nt * 8 + 2 * t;
        const float2 y0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dysm + r0 * L::kXS + col));
        const float2 y1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dysm + r1 * L::kXS + col));
        const float2 x0 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            smem_raw + L::kXd + core_at<kP>(0, r0, col)));
        const float2 x1 = unpack_bf16(*reinterpret_cast<const uint32_t*>(
            smem_raw + L::kXd + core_at<kP>(0, r1, col)));
        v0 += y0.x * v[4 * nt] + y0.y * v[4 * nt + 1];
        v1 += y1.x * v[4 * nt + 2] + y1.y * v[4 * nt + 3];
        u0 += x0.x * u[4 * nt] + x0.y * u[4 * nt + 1];
        u1 += x1.x * u[4 * nt + 2] + x1.y * u[4 * nt + 3];
        dxd[4 * nt] = w0 * u[4 * nt];
        dxd[4 * nt + 1] = w0 * u[4 * nt + 1];
        dxd[4 * nt + 2] = w1 * u[4 * nt + 2];
        dxd[4 * nt + 3] = w1 * u[4 * nt + 3];
      }
      v0 = quad_sum(v0);
      v1 = quad_sum(v1);
      u0 = quad_sum(u0);
      u1 = quad_sum(u1);
      if (t == 0) {
        part(h, L::kVp + hf)[r0] = v0;
        part(h, L::kVp + hf)[r1] = v1;
        part(h, L::kWp + hf)[r0] = u0;
        part(h, L::kWp + hf)[r1] = u1;
      }
    }
    __syncthreads();  // M is in place; dt x and exp(cum) dy are consumed

    // dxd += M^T dy over the token blocks at and below this warp's rows;
    // then dx = dxd dt through this warp's piece of the dt x tile, and
    // dxd · x for ddt.
    {
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (kk < rs) continue;
        uint32_t af[4];
        ldsm4_t(af, at_b(sm + L::kM, L::kXS, kk * 16, rs * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm4_t(bf, at_a(ys, L::kXS, kk * 16, hf * 32 + np * 16, lane));
          mma_bf16(dxd + 8 * np, af, bf);
          mma_bf16(dxd + 8 * np + 4, af, bf + 2);
        }
      }
      const float* dts = dts_of(h);
      const float d0 = dts[r0], d1 = dts[r1];
      float s0v = 0.f, s1v = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = hf * 32 + nt * 8 + 2 * t;
        const float2 x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xsm + r0 * L::kXS + col));
        const float2 x1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xsm + r1 * L::kXS + col));
        s0v += dxd[4 * nt] * x0.x + dxd[4 * nt + 1] * x0.y;
        s1v += dxd[4 * nt + 2] * x1.x + dxd[4 * nt + 3] * x1.y;
        *reinterpret_cast<uint32_t*>(smem_raw + L::kXd +
                                     core_at<kP>(0, r0, col)) =
            pack_bf16(dxd[4 * nt] * d0, dxd[4 * nt + 1] * d0);
        *reinterpret_cast<uint32_t*>(smem_raw + L::kXd +
                                     core_at<kP>(0, r1, col)) =
            pack_bf16(dxd[4 * nt + 2] * d1, dxd[4 * nt + 3] * d1);
      }
      s0v = quad_sum(s0v);
      s1v = quad_sum(s1v);
      if (t == 0) {
        part(h, L::kXp + hf)[r0] = s0v;
        part(h, L::kXp + hf)[r1] = s1v;
      }
      __syncwarp();
      // This warp's 16 rows x 32 columns of dx, 16 bytes a lane (a core
      // matrix a phase of eight lanes; 32 bytes of a row a lane pair).
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        const int idx = lane + 32 * k, row = rs * 16 + (idx & 15);
        const int col = hf * 32 + (idx >> 4) * 8, s = s0 + row;
        const uint4 v = *reinterpret_cast<const uint4*>(
            smem_raw + L::kXd + core_at<kP>(0, row, col));
        if (s < p.S)
          *reinterpret_cast<uint4*>(
              p.dx + ((static_cast<int64_t>(bb) * p.S + s) * p.H + h) * kP +
              col) = v;
      }
    }
    a_prev = a;
  }

  __syncthreads();  // the last head's partial sums are in place
  if (warp == 0) tail(p.H - 1, a_prev);
  // The heads' dS, rounded to bf16 once, into M's place; then dC += dS B
  // and dB += dS^T C (on and below the diagonal).
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int j = hf * 32 + nt * 8 + 2 * t;
    *reinterpret_cast<uint32_t*>(smem_raw + L::kM + 2 * (r0 * L::kXS + j)) =
        pack_bf16(dsacc[4 * nt], dsacc[4 * nt + 1]);
    *reinterpret_cast<uint32_t*>(smem_raw + L::kM + 2 * (r1 * L::kXS + j)) =
        pack_bf16(dsacc[4 * nt + 2], dsacc[4 * nt + 3]);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    uint32_t af[4];
    if (kk <= rs) {
      ldsm4(af, at_a(sm + L::kM, L::kXS, rs * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, core_a<kN>(sm + L::kB, kk * 16, hf * 64 + np * 16,
                               lane));
        mma_bf16(dcacc + 8 * np, af, bf);
        mma_bf16(dcacc + 8 * np + 4, af, bf + 2);
      }
    }
    if (kk >= rs) {
      ldsm4_t(af, at_b(sm + L::kM, L::kXS, kk * 16, rs * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, core_a<kN>(sm + L::kC, kk * 16, hf * 64 + np * 16,
                               lane));
        mma_bf16(dbacc + 8 * np, af, bf);
        mma_bf16(dbacc + 8 * np + 4, af, bf + 2);
      }
    }
  }
  {
    const int sa = s0 + r0, sb = s0 + r1;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const int col = hf * 64 + nt * 8 + 2 * t;
      if (sa < p.S) {
        const int64_t o = (static_cast<int64_t>(bb) * p.S + sa) * kN + col;
        *reinterpret_cast<uint32_t*>(p.db + o) =
            pack_bf16(dbacc[4 * nt], dbacc[4 * nt + 1]);
        *reinterpret_cast<uint32_t*>(p.dc + o) =
            pack_bf16(dcacc[4 * nt], dcacc[4 * nt + 1]);
      }
      if (sb < p.S) {
        const int64_t o = (static_cast<int64_t>(bb) * p.S + sb) * kN + col;
        *reinterpret_cast<uint32_t*>(p.db + o) =
            pack_bf16(dbacc[4 * nt + 2], dbacc[4 * nt + 3]);
        *reinterpret_cast<uint32_t*>(p.dc + o) =
            pack_bf16(dcacc[4 * nt + 2], dcacc[4 * nt + 3]);
      }
    }
  }
}

// The two launches of a backward: `parts` bit 0 the state cotangent, bit 1
// every chunk's gradients.  (a) takes two heads a block, which then load
// their shared c once, where those blocks still cover three quarters of
// the SMs; one head a block otherwise (a small batch or few heads), whose
// chains spread over twice the SMs.
int launch(const Params& p, cudaStream_t s, int parts) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const bool pairs = 4 * p.B * ((p.H + 1) / 2) >= 3 * sms;
  auto state = pairs ? ssd_bwd_state<2> : ssd_bwd_state<1>;
  const int heads = pairs ? 2 : 1;
  const int state_bytes = pairs ? SmemA<2>::kBytes : SmemA<1>::kBytes;
  err = cudaFuncSetAttribute(
      state, cudaFuncAttributeMaxDynamicSharedMemorySize, state_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SmemB::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (parts & 1) {
    const dim3 grid((p.H + heads - 1) / heads, p.B);
    state<<<grid, 128 * heads, state_bytes, s>>>(p);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (parts & 2) {
    ssd_bwd_chunk<<<dim3(p.NC, p.B), kThreadsB, SmemB::kBytes, s>>>(p);
    err = cudaGetLastError();
  }
  return static_cast<int>(err);
}

}  // namespace

// shape: B, S, H, P, N.  strides: x (batch, seq, head), dt (batch, seq,
// head), b (batch, seq), c (batch, seq), dy (batch, seq, head), in
// elements.  states, ds, dx, ddt, da_part, db, dc, dinit are contiguous
// (states and ds 16-byte aligned: they move by bulk copies); dfinal is
// null or contiguous.  ssd_scan_bwd_launch_parts launches (a) where bit 0
// of `parts` is set, then (b) where bit 1 is, on `stream` (a probe reads
// between the two); ssd_scan_bwd_launch launches both.  Each returns
// cudaGetLastError() as an int (cudaErrorInvalidValue for a (P, N) it was
// not compiled for).
extern "C" int ssd_scan_bwd_launch_parts(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* states, const void* dy, const void* dfinal,
    void* ds, void* dx, void* ddt, void* da_part, void* db, void* dc,
    void* dinit, const int64_t* shape, const int64_t* strides, void* stream,
    int parts) {
  if (shape[3] != kP || shape[4] != kN)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<const bf16*>(c);
  p.states = static_cast<const float*>(states);
  p.dy = static_cast<const bf16*>(dy);
  p.dfinal = static_cast<const float*>(dfinal);
  p.ds = static_cast<float*>(ds);
  p.dx = static_cast<bf16*>(dx);
  p.ddt = static_cast<float*>(ddt);
  p.da_part = static_cast<float*>(da_part);
  p.db = static_cast<bf16*>(db);
  p.dc = static_cast<bf16*>(dc);
  p.dinit = static_cast<float*>(dinit);
  p.B = static_cast<int>(shape[0]);
  p.S = static_cast<int>(shape[1]);
  p.H = static_cast<int>(shape[2]);
  p.NC = (p.S + kQ - 1) / kQ;
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4]; p.dt_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.dy_sb = strides[10]; p.dy_ss = strides[11]; p.dy_sh = strides[12];
  return launch(p, static_cast<cudaStream_t>(stream), parts);
}

extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* states, const void* dy, const void* dfinal,
    void* ds, void* dx, void* ddt, void* da_part, void* db, void* dc,
    void* dinit, const int64_t* shape, const int64_t* strides, void* stream) {
  return ssd_scan_bwd_launch_parts(x, dt, a, b, c, states, dy, dfinal, ds, dx,
                                   ddt, da_part, db, dc, dinit, shape, strides,
                                   stream, 3);
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
