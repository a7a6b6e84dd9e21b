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
// (a) ssd_bwd_state, one block of four warps per (batch, head), walks the
//     chunks from the last to the first with G in registers (warp w owns
//     state rows 16w..16w+15, mma.sync accumulator layout), writes each
//     chunk's G for (b) and dinit at the end: the forward's chain, run
//     backwards.
// (b) ssd_bwd_chunk, one block of eight warps per (batch, chunk), runs
//     over all H heads in order: given s (the forward's chunk state) and G
//     (from (a)) a chunk's terms need nothing from another chunk.  B and C
//     are one group shared by every head, so dB and dC of the chunk are
//     summed over the heads inside the block, in accumulator registers, and
//     dS in shared memory: a fixed order, no atomics and no [B, S, H, N]
//     partials, so two calls give the same bits.  Warp (r, h2) owns rows
//     16r.. of every product and half h2 of its columns; row sums across
//     the two halves go through shared memory in a fixed order.
//
// What bounds it on an H100: memory.  At mamba2-370m's training shape (B
// 8, S 2048, H 32, P 64, N 128) the products are about 48 GFLOP (0.05 ms
// at the bf16 peak) and the bytes it must move are x, dy, dx, b, c, db,
// dc, dt, ddt and the chunk states in and G out and in again, about 1.04
// GB (0.31 ms at 3.35 TB/s): the chunk states and G (3 x 268 MB) are most
// of it (chip_smoke.ssd_bwd_bound counts them).  This
// first version is written to be right and simple: mma.sync on ldmatrix
// fragments, synchronous loads, a few block barriers per head, one block
// of (b) per SM (173 KB of shared memory); it is latency-bound, not
// bandwidth-bound.  Storing the chunk states and G in bf16 would halve the
// bytes; see ssd_scan.cu for why the states are f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 64;     // chunk length, the forward's
constexpr int kP = 64;     // head dim the kernels are compiled for
constexpr int kN = 128;    // state size
constexpr float kLog2e = 1.4426950408889634f;
constexpr unsigned kAll = 0xffffffffu;

typedef __nv_bfloat16 bf16;

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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Eight bf16 values times s, each rounded to bf16 again.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = unpack_bf16(w[i]);
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
  return v;
}

// Shared-memory address of lane's row for an ldmatrix.x4 over a 16x16 tile
// at (r, col) of a row-major tile with row stride `ld` elements (as in
// ssd_scan.cu).  at_a: the A fragment of the tile (non-trans), or the B
// fragments of its two n8 column halves when the tile is B stored [k][n]
// (trans).  at_b: the B fragments of rows r.. and r+8.. as two n8 tiles
// when the tile is B^T stored [n][k] (non-trans), or the A fragment of the
// tile's transpose (trans).
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

// ---------------------------------------------------------------------------
// (a) The state cotangent, chunk by chunk from the last.
// ---------------------------------------------------------------------------

struct SmemA {
  static constexpr int kYS = kP + 8;  // dy row stride (elements)
  static constexpr int kNS = kN + 8;  // c row stride
  static constexpr int kDy = 0;                          // dy [kQ][kYS]
  static constexpr int kDyw = kDy + kQ * kYS * 2;        // exp(cum) dy
  static constexpr int kC = kDyw + kQ * kYS * 2;         // c [kQ][kNS]
  static constexpr int kDt = kC + kQ * kNS * 2;          // dt [kQ] f32
  static constexpr int kBytes = kDt + kQ * 4;
};

constexpr int kThreadsA = 128;

__global__ void __launch_bounds__(kThreadsA) ssd_bwd_state(const Params p) {
  using L = SmemA;
  constexpr int kNt = kN / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sm = smem_addr(smem_raw);
  float* dts = reinterpret_cast<float*>(smem_raw + L::kDt);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int h = blockIdx.x, bb = blockIdx.y;
  const float a = p.a[h];
  const int64_t hs = (static_cast<int64_t>(bb) * p.H + h) * kP * kN;
  const int r0 = warp * 16 + g, r1 = r0 + 8;  // this thread's state rows

  float ds[4 * kNt];
#pragma unroll
  for (int nt = 0; nt < kNt; ++nt) {
    const int col = nt * 8 + 2 * t;
    float2 u = make_float2(0.f, 0.f), v = u;
    if (p.dfinal) {
      u = *reinterpret_cast<const float2*>(p.dfinal + hs + r0 * kN + col);
      v = *reinterpret_cast<const float2*>(p.dfinal + hs + r1 * kN + col);
    }
    ds[4 * nt] = u.x; ds[4 * nt + 1] = u.y;
    ds[4 * nt + 2] = v.x; ds[4 * nt + 3] = v.y;
  }

  for (int ch = p.NC - 1; ch >= 0; --ch) {
    const int s0 = ch * kQ;
    __syncthreads();  // the chunk before (in this order) is consumed
    for (int i = tid; i < kQ * (kP / 8); i += kThreadsA) {
      const int row = i / (kP / 8), cc = i - row * (kP / 8), s = s0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < p.S)
        v = *reinterpret_cast<const uint4*>(p.dy + bb * p.dy_sb +
                                            s * p.dy_ss + h * p.dy_sh + cc * 8);
      *reinterpret_cast<uint4*>(smem_raw + L::kDy +
                                2 * (row * L::kYS + cc * 8)) = v;
    }
    for (int i = tid; i < kQ * (kN / 8); i += kThreadsA) {
      const int row = i / (kN / 8), cc = i - row * (kN / 8), s = s0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < p.S)
        v = *reinterpret_cast<const uint4*>(p.c + bb * p.c_sb + s * p.c_ss +
                                            cc * 8);
      *reinterpret_cast<uint4*>(smem_raw + L::kC +
                                2 * (row * L::kNS + cc * 8)) = v;
    }
    if (tid < kQ) {
      const int s = s0 + tid;
      dts[tid] = s < p.S ? p.dt[bb * p.dt_sb + s * p.dt_ss + h * p.dt_sh]
                         : 0.f;
    }
    // G of this chunk (the cotangent of the state leaving it), for (b).
    {
      float* gp = p.ds + ((static_cast<int64_t>(bb) * p.NC + ch) * p.H + h) *
                             kP * kN;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<float2*>(gp + r0 * kN + col) =
            make_float2(ds[4 * nt], ds[4 * nt + 1]);
        *reinterpret_cast<float2*>(gp + r1 * kN + col) =
            make_float2(ds[4 * nt + 2], ds[4 * nt + 3]);
      }
    }
    __syncthreads();  // dy, c and dt are in place

    float c2e, c2o;
    chunk_cum2(dts, a, lane, c2e, c2o);
    const float clast = __shfl_sync(kAll, c2o, 31);
    // exp(cum) dy rounded to bf16: two threads a token row, 32 columns
    // each.
    {
      const int row = tid >> 1, half = tid & 1;
      const float e = ex2(pair_at(c2e, c2o, row));
      const uint4* src = reinterpret_cast<const uint4*>(
          smem_raw + L::kDy + 2 * (row * L::kYS + half * (kP / 2)));
      uint4* dst = reinterpret_cast<uint4*>(
          smem_raw + L::kDyw + 2 * (row * L::kYS + half * (kP / 2)));
#pragma unroll
      for (int v = 0; v < kP / 16; ++v) dst[v] = scale8(src[v], e);
    }
    __syncthreads();

    // G = exp(cum_last) G + (exp(cum) dy)^T C: rows p of this warp, k over
    // the chunk's tokens.
    const float dec = ex2(clast);
#pragma unroll
    for (int i = 0; i < 4 * kNt; ++i) ds[i] *= dec;
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      uint32_t af[4];
      ldsm4_t(af, at_b(sm + L::kDyw, L::kYS, kk * 16, warp * 16, lane));
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, at_a(sm + L::kC, L::kNS, kk * 16, np * 16, lane));
        mma_bf16(ds + 8 * np, af, bf);
        mma_bf16(ds + 8 * np + 4, af, bf + 2);
      }
    }
  }

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
  static constexpr int kXS = kP + 8;   // x, xd, dy, exp(cum) dy row stride
  static constexpr int kNS = kN + 8;   // b, c, G, s row stride
  static constexpr int kMS = kQ + 8;   // M (then dS) bf16 row stride
  static constexpr int kFS = kQ + 8;   // f32 [kQ][kQ] tiles' row stride
  static constexpr int kB = 0;                          // b [kQ][kNS]
  static constexpr int kC = kB + kQ * kNS * 2;          // c [kQ][kNS]
  static constexpr int kScore = kC + kQ * kNS * 2;      // C B^T f32
  static constexpr int kDS = kScore + kQ * kFS * 4;     // dS f32, all heads
  static constexpr int kT = kDS + kQ * kFS * 4;         // T f32
  static constexpr int kX = kT + kQ * kFS * 4;          // x [kQ][kXS]
  static constexpr int kXd = kX + kQ * kXS * 2;         // dt x, bf16
  static constexpr int kDy = kXd + kQ * kXS * 2;        // dy
  static constexpr int kDyw = kDy + kQ * kXS * 2;       // exp(cum) dy, bf16
  static constexpr int kM = kDyw + kQ * kXS * 2;        // M bf16 [kQ][kMS]
  static constexpr int kG = kM + kQ * kMS * 2;          // G bf16 [kP][kNS]
  static constexpr int kS = kG + kP * kNS * 2;          // s bf16 [kP][kNS]
  static constexpr int kDt = kS + kP * kNS * 2;         // dt [kQ] f32
  static constexpr int kCum = kDt + kQ * 4;             // cum (log2) [kQ]
  // Per-token partial sums [kQ] f32: the two column halves' dy · (s C),
  // xd · (G B) and dxd · x, and T's row and column sums.
  static constexpr int kVp = kCum + kQ * 4;             // [2][kQ]
  static constexpr int kWp = kVp + 2 * kQ * 4;          // [2][kQ]
  static constexpr int kXp = kWp + 2 * kQ * 4;          // [2][kQ]
  static constexpr int kRs = kXp + 2 * kQ * 4;          // [kQ]
  static constexpr int kCs = kRs + kQ * 4;              // [kQ]
  static constexpr int kRed = kCs + kQ * 4;             // <G, s> per warp
  static constexpr int kBytes = kRed + 8 * 4;
};

constexpr int kThreadsB = 256;

__global__ void __launch_bounds__(kThreadsB, 1) ssd_bwd_chunk(const Params p) {
  using L = SmemB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sm = smem_addr(smem_raw);
  float* score = reinterpret_cast<float*>(smem_raw + L::kScore);
  float* dsum = reinterpret_cast<float*>(smem_raw + L::kDS);
  float* tm = reinterpret_cast<float*>(smem_raw + L::kT);
  float* dts = reinterpret_cast<float*>(smem_raw + L::kDt);
  float* cum2 = reinterpret_cast<float*>(smem_raw + L::kCum);
  float* vpart = reinterpret_cast<float*>(smem_raw + L::kVp);
  float* wpart = reinterpret_cast<float*>(smem_raw + L::kWp);
  float* xpart = reinterpret_cast<float*>(smem_raw + L::kXp);
  float* rsum = reinterpret_cast<float*>(smem_raw + L::kRs);
  float* csum = reinterpret_cast<float*>(smem_raw + L::kCs);
  float* red = reinterpret_cast<float*>(smem_raw + L::kRed);
  const bf16* xsm = reinterpret_cast<const bf16*>(smem_raw + L::kX);
  const bf16* xdsm = reinterpret_cast<const bf16*>(smem_raw + L::kXd);
  const bf16* dysm = reinterpret_cast<const bf16*>(smem_raw + L::kDy);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int rs = warp & 3, hf = warp >> 2;  // row slab, column half
  const int r0 = rs * 16 + g, r1 = r0 + 8;  // this thread's rows
  const int ch = blockIdx.x, bb = blockIdx.y, s0 = ch * kQ;
  const int64_t chunk_heads = (static_cast<int64_t>(bb) * p.NC + ch) * p.H;

  // b and c of the chunk, once for every head; rows past S are zero.
  for (int i = tid; i < 2 * kQ * (kN / 8); i += kThreadsB) {
    const int which = i / (kQ * (kN / 8)), rem = i - which * kQ * (kN / 8);
    const int row = rem / (kN / 8), cc = rem - row * (kN / 8), s = s0 + row;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (s < p.S)
      v = *reinterpret_cast<const uint4*>(
          which ? p.c + bb * p.c_sb + s * p.c_ss + cc * 8
                : p.b + bb * p.b_sb + s * p.b_ss + cc * 8);
    *reinterpret_cast<uint4*>(smem_raw + (which ? L::kC : L::kB) +
                              2 * (row * L::kNS + cc * 8)) = v;
  }
  for (int i = tid; i < kQ * L::kFS; i += kThreadsB) dsum[i] = 0.f;
  __syncthreads();
  // C B^T: warp (rs, hf) computes rows 16 rs.., columns 32 hf...
  {
    float sc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) sc[j] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kN / 16; ++kk) {
      uint32_t af[4];
      ldsm4(af, at_a(sm + L::kC, L::kNS, rs * 16, kk * 16, lane));
#pragma unroll
      for (int jp = 0; jp < 2; ++jp) {
        uint32_t bf[4];
        ldsm4(bf, at_b(sm + L::kB, L::kNS, hf * 32 + jp * 16, kk * 16, lane));
        mma_bf16(sc + 8 * jp, af, bf);
        mma_bf16(sc + 8 * jp + 4, af, bf + 2);
      }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = hf * 32 + nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(&score[r0 * L::kFS + col]) =
          make_float2(sc[4 * nt], sc[4 * nt + 1]);
      *reinterpret_cast<float2*>(&score[r1 * L::kFS + col]) =
          make_float2(sc[4 * nt + 2], sc[4 * nt + 3]);
    }
  }

  // dB and dC of this warp's rows and columns 64 hf.., summed over heads.
  float dbacc[32], dcacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) dbacc[i] = dcacc[i] = 0.f;

  for (int h = 0; h < p.H; ++h) {
    const float a = p.a[h];
    __syncthreads();  // the head before is consumed (C B^T is in place)
    // x, dy and dt of the head; G and s rounded to bf16, and <G, s> in f32.
    for (int i = tid; i < 2 * kQ * (kP / 8); i += kThreadsB) {
      const int which = i / (kQ * (kP / 8)), rem = i - which * kQ * (kP / 8);
      const int row = rem / (kP / 8), cc = rem - row * (kP / 8), s = s0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < p.S)
        v = *reinterpret_cast<const uint4*>(
            which ? p.dy + bb * p.dy_sb + s * p.dy_ss + h * p.dy_sh + cc * 8
                  : p.x + bb * p.x_sb + s * p.x_ss + h * p.x_sh + cc * 8);
      *reinterpret_cast<uint4*>(smem_raw + (which ? L::kDy : L::kX) +
                                2 * (row * L::kXS + cc * 8)) = v;
    }
    if (tid < kQ) {
      const int s = s0 + tid;
      dts[tid] = s < p.S ? p.dt[bb * p.dt_sb + s * p.dt_ss + h * p.dt_sh]
                         : 0.f;
    }
    {
      const int64_t off = (chunk_heads + h) * kP * kN;
      const float4* gp = reinterpret_cast<const float4*>(p.ds + off);
      const float4* sp = reinterpret_cast<const float4*>(p.states + off);
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kP * kN / 4 / kThreadsB; ++k) {
        const int i = tid + k * kThreadsB;  // float4 index
        const float4 gv = gp[i], sv = sp[i];
        dot += gv.x * sv.x + gv.y * sv.y + gv.z * sv.z + gv.w * sv.w;
        const int row = (4 * i) / kN, col = (4 * i) % kN;
        *reinterpret_cast<uint2*>(smem_raw + L::kG +
                                  2 * (row * L::kNS + col)) =
            make_uint2(pack_bf16(gv.x, gv.y), pack_bf16(gv.z, gv.w));
        *reinterpret_cast<uint2*>(smem_raw + L::kS +
                                  2 * (row * L::kNS + col)) =
            make_uint2(pack_bf16(sv.x, sv.y), pack_bf16(sv.z, sv.w));
      }
      dot = warp_sum(dot);
      if (lane == 0) red[warp] = dot;
    }
    __syncthreads();  // x, dy, dt, G and s are in place

    // cum in every warp; dt x and exp(cum) dy rounded to bf16, four threads
    // a token row, 16 columns each.
    float c2e, c2o;
    chunk_cum2(dts, a, lane, c2e, c2o);
    const float clast = __shfl_sync(kAll, c2o, 31);
    if (warp == 0) {
      cum2[2 * lane] = c2e;
      cum2[2 * lane + 1] = c2o;
    }
    {
      const int row = tid >> 2, q4 = tid & 3;
      const float e = ex2(pair_at(c2e, c2o, row));
      const float d = dts[row];
      const int at = 2 * (row * L::kXS + q4 * 16);
      const uint4* xr = reinterpret_cast<const uint4*>(smem_raw + L::kX + at);
      const uint4* yr = reinterpret_cast<const uint4*>(smem_raw + L::kDy + at);
      uint4* xdr = reinterpret_cast<uint4*>(smem_raw + L::kXd + at);
      uint4* ywr = reinterpret_cast<uint4*>(smem_raw + L::kDyw + at);
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        xdr[v] = scale8(xr[v], d);
        ywr[v] = scale8(yr[v], e);
      }
    }
    __syncthreads();  // cum, dt x and exp(cum) dy are in place

    // cum (log2) at this thread's rows, w at them.
    const float c0 = cum2[r0], c1 = cum2[r1];
    const float w0 = ex2(clast - c0), w1 = ex2(clast - c1);

    // dM = dy xd^T over rows 16 rs.. and columns 32 hf..; then M (bf16),
    // T = dM M and dS += dM L, on and below the diagonal (above it L is 0
    // and its exponent could overflow).  A tile wholly above the diagonal
    // is skipped: nothing reads it.
    if (hf * 32 <= rs * 16 + 15) {
      float dm[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) dm[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk) {
        uint32_t af[4];
        ldsm4(af, at_a(sm + L::kDy, L::kXS, rs * 16, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm4(bf, at_b(sm + L::kXd, L::kXS, hf * 32 + jp * 16, kk * 16,
                         lane));
          mma_bf16(dm + 8 * jp, af, bf);
          mma_bf16(dm + 8 * jp + 4, af, bf + 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = half ? r1 : r0;
          const float ci = half ? c1 : c0;
          const int j = hf * 32 + nt * 8 + 2 * t;
          float mv[2], tv[2], sv[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float d = dm[4 * nt + 2 * half + e];
            if (j + e <= i) {
              const float l = ex2(ci - cum2[j + e]);
              const float m = score[i * L::kFS + j + e] * l;
              mv[e] = m;
              tv[e] = d * m;
              sv[e] = d * l;
            } else {
              mv[e] = tv[e] = sv[e] = 0.f;
            }
          }
          *reinterpret_cast<uint32_t*>(smem_raw + L::kM +
                                       2 * (i * L::kMS + j)) =
              pack_bf16(mv[0], mv[1]);
          *reinterpret_cast<float2*>(&tm[i * L::kFS + j]) =
              make_float2(tv[0], tv[1]);
          float2* dsp = reinterpret_cast<float2*>(&dsum[i * L::kFS + j]);
          const float2 old = *dsp;
          *dsp = make_float2(old.x + sv[0], old.y + sv[1]);
        }
      }
    }

    // dy · (s C) at this warp's rows, over columns 32 hf.. of P.
    {
      float v[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) v[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t af[4];
        ldsm4(af, at_a(sm + L::kC, L::kNS, rs * 16, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm4(bf, at_b(sm + L::kS, L::kNS, hf * 32 + jp * 16, kk * 16,
                         lane));
          mma_bf16(v + 8 * jp, af, bf);
          mma_bf16(v + 8 * jp + 4, af, bf + 2);
        }
      }
      float s0v = 0.f, s1v = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = hf * 32 + nt * 8 + 2 * t;
        const float2 y0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dysm + r0 * L::kXS + col));
        const float2 y1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(dysm + r1 * L::kXS + col));
        s0v += y0.x * v[4 * nt] + y0.y * v[4 * nt + 1];
        s1v += y1.x * v[4 * nt + 2] + y1.y * v[4 * nt + 3];
      }
      s0v = quad_sum(s0v);
      s1v = quad_sum(s1v);
      if (t == 0) {
        vpart[hf * kQ + r0] = s0v;
        vpart[hf * kQ + r1] = s1v;
      }
    }

    // U = B G^T at this warp's rows (tokens j) and columns 32 hf.. (p):
    // dxd starts as w U, and xd · U gives dw.
    float dxd[16];
    {
#pragma unroll
      for (int j = 0; j < 16; ++j) dxd[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {
        uint32_t af[4];
        ldsm4(af, at_a(sm + L::kB, L::kNS, rs * 16, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm4(bf, at_b(sm + L::kG, L::kNS, hf * 32 + jp * 16, kk * 16,
                         lane));
          mma_bf16(dxd + 8 * jp, af, bf);
          mma_bf16(dxd + 8 * jp + 4, af, bf + 2);
        }
      }
      float s0v = 0.f, s1v = 0.f;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = hf * 32 + nt * 8 + 2 * t;
        const float2 x0 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xdsm + r0 * L::kXS + col));
        const float2 x1 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xdsm + r1 * L::kXS + col));
        s0v += x0.x * dxd[4 * nt] + x0.y * dxd[4 * nt + 1];
        s1v += x1.x * dxd[4 * nt + 2] + x1.y * dxd[4 * nt + 3];
        dxd[4 * nt] *= w0; dxd[4 * nt + 1] *= w0;
        dxd[4 * nt + 2] *= w1; dxd[4 * nt + 3] *= w1;
      }
      s0v = quad_sum(s0v);
      s1v = quad_sum(s1v);
      if (t == 0) {
        wpart[hf * kQ + r0] = s0v;
        wpart[hf * kQ + r1] = s1v;
      }
    }
    __syncthreads();  // M and T are in place

    // dxd += M^T dy over the token blocks at and below this warp's rows;
    // then dx = dxd dt, and dxd · x for ddt.
    {
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        if (kk < rs) continue;
        uint32_t af[4];
        ldsm4_t(af, at_b(sm + L::kM, L::kMS, kk * 16, rs * 16, lane));
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t bf[4];
          ldsm4_t(bf, at_a(sm + L::kDy, L::kXS, kk * 16, hf * 32 + np * 16,
                           lane));
          mma_bf16(dxd + 8 * np, af, bf);
          mma_bf16(dxd + 8 * np + 4, af, bf + 2);
        }
      }
      const float d0 = dts[r0], d1 = dts[r1];
      const int sa = s0 + r0, sb = s0 + r1;
      bf16* dx0 = p.dx + ((static_cast<int64_t>(bb) * p.S + sa) * p.H + h) * kP;
      bf16* dx1 = p.dx + ((static_cast<int64_t>(bb) * p.S + sb) * p.H + h) * kP;
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
        if (sa < p.S)
          *reinterpret_cast<uint32_t*>(dx0 + col) =
              pack_bf16(dxd[4 * nt] * d0, dxd[4 * nt + 1] * d0);
        if (sb < p.S)
          *reinterpret_cast<uint32_t*>(dx1 + col) =
              pack_bf16(dxd[4 * nt + 2] * d1, dxd[4 * nt + 3] * d1);
      }
      s0v = quad_sum(s0v);
      s1v = quad_sum(s1v);
      if (t == 0) {
        xpart[hf * kQ + r0] = s0v;
        xpart[hf * kQ + r1] = s1v;
      }
    }

    // dC += (exp(cum) dy) s and dB += w (xd G) at this warp's rows and
    // columns 64 hf.. of N.
    {
      float tmp[32];
#pragma unroll
      for (int i = 0; i < 32; ++i) tmp[i] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kP / 16; ++kk) {
        uint32_t ay[4], ax[4];
        ldsm4(ay, at_a(sm + L::kDyw, L::kXS, rs * 16, kk * 16, lane));
        ldsm4(ax, at_a(sm + L::kXd, L::kXS, rs * 16, kk * 16, lane));
#pragma unroll
        for (int np = 0; np < 4; ++np) {
          uint32_t bs[4], bg[4];
          ldsm4_t(bs, at_a(sm + L::kS, L::kNS, kk * 16, hf * 64 + np * 16,
                           lane));
          ldsm4_t(bg, at_a(sm + L::kG, L::kNS, kk * 16, hf * 64 + np * 16,
                           lane));
          mma_bf16(dcacc + 8 * np, ay, bs);
          mma_bf16(dcacc + 8 * np + 4, ay, bs + 2);
          mma_bf16(tmp + 8 * np, ax, bg);
          mma_bf16(tmp + 8 * np + 4, ax, bg + 2);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        dbacc[4 * nt] += w0 * tmp[4 * nt];
        dbacc[4 * nt + 1] += w0 * tmp[4 * nt + 1];
        dbacc[4 * nt + 2] += w1 * tmp[4 * nt + 2];
        dbacc[4 * nt + 3] += w1 * tmp[4 * nt + 3];
      }
    }

    // T's row sums (threads 0-63) and column sums (64-127), on and below
    // the diagonal, in order.
    if (tid < kQ) {
      float acc = 0.f;
      for (int j = 0; j <= tid; ++j) acc += tm[tid * L::kFS + j];
      rsum[tid] = acc;
    } else if (tid < 2 * kQ) {
      const int j = tid - kQ;
      float acc = 0.f;
      for (int i = j; i < kQ; ++i) acc += tm[i * L::kFS + j];
      csum[j] = acc;
    }
    __syncthreads();  // every per-token partial is in place

    // dcum, its reverse cumsum d(dA), ddt and da's partial: warp 0, lane l
    // tokens 2l and 2l + 1.
    if (warp == 0) {
      const int je = 2 * lane;
      float dw[2], dc2[2], wj[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = je + e;
        const float c = e ? c2o : c2e;
        wj[e] = ex2(clast - c);
        dw[e] = wpart[j] + wpart[kQ + j];
        dc2[e] = rsum[j] - csum[j] + ex2(c) * (vpart[j] + vpart[kQ + j]) -
                 wj[e] * dw[e];
      }
      float dot = 0.f;
#pragma unroll
      for (int k = 0; k < kThreadsB / 32; ++k) dot += red[k];
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
          p.ddt[(static_cast<int64_t>(bb) * p.S + s) * p.H + h] =
              dda[e] * a + (xpart[j] + xpart[kQ + j]);
      }
      dap = warp_sum(dap);
      if (lane == 0) p.da_part[chunk_heads + h] = dap;
    }
  }

  // The heads' dS, rounded to bf16 once, into M's place; then dC += dS B
  // and dB += dS^T C (on and below the diagonal).
  __syncthreads();
  for (int i = tid; i < kQ * kQ / 2; i += kThreadsB) {
    const int row = (2 * i) / kQ, col = (2 * i) % kQ;
    const float2 v = *reinterpret_cast<const float2*>(&dsum[row * L::kFS + col]);
    *reinterpret_cast<uint32_t*>(smem_raw + L::kM + 2 * (row * L::kMS + col)) =
        pack_bf16(v.x, v.y);
  }
  __syncthreads();
#pragma unroll
  for (int kk = 0; kk < kQ / 16; ++kk) {
    uint32_t af[4];
    if (kk <= rs) {
      ldsm4(af, at_a(sm + L::kM, L::kMS, rs * 16, kk * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, at_a(sm + L::kB, L::kNS, kk * 16, hf * 64 + np * 16,
                         lane));
        mma_bf16(dcacc + 8 * np, af, bf);
        mma_bf16(dcacc + 8 * np + 4, af, bf + 2);
      }
    }
    if (kk >= rs) {
      ldsm4_t(af, at_b(sm + L::kM, L::kMS, kk * 16, rs * 16, lane));
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, at_a(sm + L::kC, L::kNS, kk * 16, hf * 64 + np * 16,
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

}  // namespace

// shape: B, S, H, P, N.  strides: x (batch, seq, head), dt (batch, seq,
// head), b (batch, seq), c (batch, seq), dy (batch, seq, head), in
// elements.  states, ds, dx, ddt, da_part, db, dc, dinit are contiguous;
// dfinal is null or contiguous.  Launches (a) then (b) on `stream`;
// returns cudaGetLastError() as an int (cudaErrorInvalidValue for a (P, N)
// it was not compiled for).
extern "C" int ssd_scan_bwd_launch(
    const void* x, const void* dt, const void* a, const void* b,
    const void* c, const void* states, const void* dy, const void* dfinal,
    void* ds, void* dx, void* ddt, void* da_part, void* db, void* dc,
    void* dinit, const int64_t* shape, const int64_t* strides, void* stream) {
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_bwd_state, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SmemA::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_bwd_chunk,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             SmemB::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_state<<<dim3(p.H, p.B), kThreadsA, SmemA::kBytes, s>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_bwd_chunk<<<dim3(p.NC, p.B), kThreadsB, SmemB::kBytes, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* ssd_scan_bwd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
