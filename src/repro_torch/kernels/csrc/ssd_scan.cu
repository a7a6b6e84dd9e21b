// Mamba2 SSD chunked scan (state-space duality) for Hopper.
//
// Replaces the JAX package's Pallas TPU kernel
// src/repro/kernels/ssd_scan.py::_kernel, launched there by ssd_scan.  The
// contract is the model's ssd_chunked (src/repro/models/ssm.py:79): it
// returns the output AND the final [P, N] f32 state, which prefill needs
// for the decode cache, and takes an optional initial state.  The plain
// torch version is repro_torch/kernels/ssd_scan.py::ssd_scan_plain; the
// Python wrapper is ssd_scan_cuda in the same module.
//
// Input:  x [B, S, H, P] bf16 and b/c [B, S, N] bf16 (strided: the model
//         passes slices of the conv output), dt [B, S, H] f32 (softplus'd),
//         a [H] f32 (negative), init [B, H, P, N] f32 or null (zeros).
// Output: y [B, S, H, P] bf16 (no D-skip term), fin [B, H, P, N] f32 and,
//         in the instantiation with kStates (training), the f32 state
//         entering each chunk of kQ tokens, states [B, ceil(S/kQ), H, P, N],
//         which the backward (ssd_scan_bwd.cu) reads.  Without it the
//         kernel compiles to what it was before the flag existed (the
//         serving path).
// (P, N) is (64, 128), mamba2's head dim and state size: the one shape the
// serving path gives it.
//
// Per chunk of kQ = 64 tokens (cum = inclusive cumsum of dt * a):
//   y      = (C B^T ⊙ L) (dt x) + exp(cum) ⊙ (C state^T),
//            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) (dt x)_j b_j^T
// The chunked dual form is exact for any chunk length, so the kernel's kQ
// need not be the model's ssm_chunk (256): a [256, 256] f32 score tile is
// 256 KB, more than a block's 227 KB of shared memory.  Rounding points
// follow the reference: dt x, w b and M rounded to bf16, and the carried
// state rounded to bf16 where it meets C.
//
// What bounds it on an H100: memory.  At the mamba2-370m prefill shape
// (B 8, S 2048, H 32, P 64, N 128) it must read x, dt, b, c and write y and
// the final state, about 153 MB (0.046 ms at 3.35 TB/s), while the chunked
// products need about 20 GFLOP (0.02 ms at the bf16 tensor-core peak).  The
// scan is a chain over the chunks of each (batch, head); only the state
// update state' = decay state + U is serial, every product of a chunk is
// independent of the chain.  What it loses is latency: loads waiting in
// the chain, serial work between barriers, and too few warps to hide them.
//
// What the design does about it:
// - One block of two warpgroups per (batch, pair of heads).  C B^T is the
//   same for every head of a chunk (one b/c group): the eight warps compute
//   it once per chunk into shared memory (each a 16 x 32 piece), and b and
//   c are loaded once per chunk for both heads.  Each warpgroup then owns
//   one head: warp w of it owns chunk rows and state rows 16w..16w+15, and
//   keeps those rows of the [P, N] f32 state in accumulator registers
//   across the whole sequence.
// - The next chunk's x, dt, b and c are in flight (cp.async, two stages)
//   while the current chunk's products run; two block barriers a chunk.
// - The two large products of a head's chunk, C state^T and the state
//   update (dt x)^T (w b), are one wgmma per k16 step over the warpgroup's
//   64 rows (A from registers, B from shared memory in wgmma's canonical
//   layout); C B^T and the triangular M (dt x) run on mma.sync.  Every
//   operand comes from row-major tiles by ldmatrix (rows padded by 16
//   bytes, conflict-free), the transposed ones, (dt x)^T and dt x as B,
//   with ldmatrix.trans; dt x and w b are formed once per chunk and head in
//   shared memory, so nothing is transposed through scalar stores.
// - The cumsum is a warp scan (__shfl_up_sync) that every warp runs for its
//   own head; values travel by shuffles.  Decays are exp2 of cumsums taken
//   in log2 units, and L is evaluated only on the diagonal tile and the
//   tiles below it (above it the entry is 0 and its exponent could
//   overflow).
// - Training (kStates): the backward needs the state entering each chunk.
//   The block holds it in f32 registers at the top of each chunk and
//   writes it there: 268 MB at mamba2-370m's training shape, one layer's
//   at a time under the model's per-layer remat.  It stays f32: from the
//   same states rounded to bf16 the backward's ddt error against its plain
//   version grows up to 3.5 times (1.9e-3 to 7.2e-3 from an initial state,
//   4.5e-3 to 1.6e-2 at the 100m preset's (16, 64); chip_smoke.py phase
//   "ssd backward" on an H100), as the decay term <G, s> then reads a
//   rounded state, where bf16 would save about 0.08 ms of the backward's
//   0.94.  Writing them adds about 0.05 ms to the forward's 0.18.
// Measured on the card and not kept, for being no faster: mma.sync for all
// four products, and issuing both wgmmas before building M so that they
// overlap it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 64;          // chunk length (16 rows per warp)
constexpr int kHeads = 2;       // heads of a block, one warpgroup each
constexpr int kThreads = 128 * kHeads;
constexpr float kLog2e = 1.4426950408889634f;

typedef __nv_bfloat16 bf16;

struct Params {
  const bf16* x;
  const float* dt;
  const float* a;
  const bf16* b;
  const bf16* c;
  const float* init;  // may be null
  bf16* y;
  float* fin;
  int B, S, H;
  int64_t x_sb, x_ss, x_sh, dt_sb, dt_ss, dt_sh, b_sb, b_ss, c_sb, c_ss,
      y_sb, y_ss, y_sh;
  float* states;  // last, so that the other members keep their offsets
};

// Shared memory in bytes.  The tiles read by ldmatrix are row-major with
// rows padded by 16 bytes, so the eight 16-byte rows of an 8x8 tile fall on
// distinct banks.  The B operands of the two wgmma products (the bf16 state
// and w b) are stored in wgmma's canonical layout without swizzle: 8x8
// "core matrices" of 128 contiguous bytes (eight 16-byte rows).
template <int P, int N>
struct Smem {
  static constexpr int kXS = P + 8;         // x row stride (elements)
  static constexpr int kNS = N + 8;         // b, c row stride
  static constexpr int kSS = kQ + 8;        // C B^T row stride (floats)
  static constexpr int kX = 0;              // x [kHeads][kQ][kXS] bf16
  static constexpr int kBt = kX + kHeads * kQ * kXS * 2;  // b [kQ][kNS]
  static constexpr int kCt = kBt + kQ * kNS * 2;          // c [kQ][kNS]
  static constexpr int kDt = kCt + kQ * kNS * 2;          // dt [kHeads][kQ]
  static constexpr int kStage = kDt + kHeads * kQ * 4;    // one stage
  static constexpr int kScore = 2 * kStage;               // C B^T [kQ][kSS]
  // state [kHeads]: core matrix (p / 8, n / 8) at (n / 8 * P / 8 + p / 8) *
  // 128, row p % 8 (K-major: the state's n is the product's k).
  static constexpr int kState = kScore + kQ * kSS * 4;
  // w b [kHeads]: core matrix (token / 8, n / 8) at (token / 8 * N / 8 + n /
  // 8) * 128, row token % 8 (MN-major: the token is the product's k).
  static constexpr int kWb = kState + kHeads * P * N * 2;
  static constexpr int kBytes = kWb + kHeads * kQ * N * 2;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
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
// column-major 16x8 bf16 (2 regs), D 16x8 f32 (4 regs at d).
__device__ __forceinline__ void mma_bf16(float* d, const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// wgmma shared-memory descriptor for the canonical layout without swizzle:
// start address, leading and stride byte offsets (16-byte units).
__device__ __forceinline__ uint64_t desc_plain(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo & 0x3FFF) << 16) |
         (static_cast<uint64_t>(sbo & 0x3FFF) << 32);
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

// D[64 x 64] (+)= A[64 x 16] B[16 x 64] with A in registers (the
// m16n8k16 A fragment, one 16-row slab per warp) and B in shared memory,
// K-major; accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11,"
      " %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23,"
      " %24, %25, %26, %27, %28, %29, %30, %31}"
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128] with A in registers (the
// m16n8k16 A fragment, one 16-row slab per warp) and B in shared memory,
// MN-major (the transpose flag set); accumulate 0 overwrites D.
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64],
                                          const uint32_t (&a)[4], uint64_t db,
                                          int accumulate) {
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
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

// Eight bf16 values times s, each rounded to bf16 again.
__device__ __forceinline__ uint4 scale8(uint4 v, float s) {
  uint32_t* w = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f =
        __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&w[i]));
    w[i] = pack_bf16(f.x * s, f.y * s);
  }
  return v;
}

// Shared-memory address of lane's row for an ldmatrix.x4 over a 16x16 tile
// at (r, col) of a row-major tile with row stride `ld` elements.  Pattern A
// gives the A fragment (non-trans) or the B fragments of the two n8 column
// halves (trans); pattern B gives the B fragments of rows r.., r+8.. taken
// as two n8 tiles (non-trans) or the A fragment of the transpose (trans).
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

template <int P, int N, bool kStates>
__global__ void __launch_bounds__(kThreads, 1) ssd_fwd(const Params p) {
  using L = Smem<P, N>;
  static_assert(P == 64 && N % 16 == 0, "one warp per 16 of P = 64 rows");
  constexpr int kNt = N / 8;  // state n8 tiles
  constexpr int kPt = P / 8;  // y n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const uint32_t sm = smem_addr(smem_raw);
  float* score = reinterpret_cast<float*>(smem_raw + L::kScore);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int hd = warp >> 2, wl = warp & 3;  // head of the block, row slab
  const int h = blockIdx.x * kHeads + hd, bb = blockIdx.y;
  const bool has_head = h < p.H;  // uniform over the warpgroup
  const float a = has_head ? p.a[h] : 0.f;
  bf16* yb = p.y + bb * p.y_sb + h * p.y_sh;
  const int64_t st_off = (static_cast<int64_t>(bb) * p.H + h) * P * N;
  const int n_chunks = (p.S + kQ - 1) / kQ;

  // Issue the loads of chunk `ch` into stage `stage`: x and dt of both
  // heads, b and c once.  Rows past S are zero-filled.
  auto load_chunk = [&](int ch, int stage) {
    const uint32_t buf = sm + stage * L::kStage;
    const int s0 = ch * kQ;
    constexpr int kXc = P / 8, kNc = N / 8;  // 16-byte pieces of a row
    for (int i = tid; i < kHeads * kQ * kXc; i += kThreads) {
      const int hh = i / (kQ * kXc), rem = i - hh * kQ * kXc;
      const int row = rem / kXc, cc = rem - row * kXc;
      const int s = s0 + row, head = blockIdx.x * kHeads + hh;
      const bool ok = s < p.S && head < p.H;
      const bf16* src =
          ok ? p.x + bb * p.x_sb + s * p.x_ss + head * p.x_sh + cc * 8 : p.x;
      cp_async16(buf + L::kX + 2 * ((hh * kQ + row) * L::kXS + cc * 8), src,
                 ok);
    }
    for (int i = tid; i < 2 * kQ * kNc; i += kThreads) {
      const int which = i / (kQ * kNc), rem = i - which * kQ * kNc;
      const int row = rem / kNc, cc = rem - row * kNc;
      const int s = s0 + row;
      const bool ok = s < p.S;
      const bf16* src =
          which ? p.c + bb * p.c_sb + s * p.c_ss : p.b + bb * p.b_sb + s * p.b_ss;
      cp_async16(buf + (which ? L::kCt : L::kBt) + 2 * (row * L::kNS + cc * 8),
                 ok ? src + cc * 8 : p.b, ok);
    }
    if (tid < kHeads * kQ) {
      const int hh = tid / kQ, row = tid - hh * kQ;
      const int s = s0 + row, head = blockIdx.x * kHeads + hh;
      const bool ok = s < p.S && head < p.H;
      cp_async4(buf + L::kDt + 4 * tid,
                ok ? p.dt + bb * p.dt_sb + s * p.dt_ss + head * p.dt_sh : p.dt,
                ok);
    }
    cp_async_commit();
  };

  // The carried state, in accumulator layout (of mma.sync and of wgmma
  // alike): st[4 nt + e] is row wl*16 + g (+8 for e >= 2), col nt*8 + 2t
  // (+1 for odd e).
  float st[4 * kNt];
  {
    const int row = wl * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (p.init && has_head) {
        const float2 u = *reinterpret_cast<const float2*>(
            p.init + st_off + row * N + col);
        const float2 v = *reinterpret_cast<const float2*>(
            p.init + st_off + (row + 8) * N + col);
        st[4 * nt] = u.x; st[4 * nt + 1] = u.y;
        st[4 * nt + 2] = v.x; st[4 * nt + 3] = v.y;
      } else {
        st[4 * nt] = st[4 * nt + 1] = st[4 * nt + 2] = st[4 * nt + 3] = 0.f;
      }
    }
  }

  load_chunk(0, 0);
  const int i0 = wl * 16 + g, i1 = i0 + 8;  // this thread's chunk rows
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int stage = ch & 1, s0 = ch * kQ;
    const uint32_t sbase = sm + stage * L::kStage;
    const uint32_t xs = sbase + L::kX + 2 * hd * kQ * L::kXS;
    const uint32_t bs = sbase + L::kBt, cs = sbase + L::kCt;
    const float* dts = reinterpret_cast<const float*>(
        smem_raw + stage * L::kStage + L::kDt) + hd * kQ;
    const uint32_t sts = sm + L::kState + 2 * hd * P * N;
    const uint32_t wbs = sm + L::kWb + 2 * hd * kQ * N;
    cp_async_wait_all();
    __syncthreads();  // chunk ch has landed; chunk ch - 1 is consumed
    if (ch + 1 < n_chunks) load_chunk(ch + 1, stage ^ 1);

    // The state entering the chunk, rounded to bf16 for C state^T, into
    // core matrices (row p = wl*16 + g (+8), col n = nt*8 + 2t).
    {
      unsigned char* stw = smem_raw + L::kState + 2 * hd * P * N;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int at = (nt * (P / 8) + 2 * wl) * 128 + g * 16 + t * 4;
        *reinterpret_cast<uint32_t*>(stw + at) =
            pack_bf16(st[4 * nt], st[4 * nt + 1]);
        *reinterpret_cast<uint32_t*>(stw + at + 128) =
            pack_bf16(st[4 * nt + 2], st[4 * nt + 3]);
      }
    }
    // Training: the f32 state entering the chunk, for the backward.
    if constexpr (kStates) {
      if (has_head) {
        float* sp = p.states +
                    ((static_cast<int64_t>(bb) * n_chunks + ch) * p.H + h) *
                        P * N;
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          const int col = nt * 8 + 2 * t;
          *reinterpret_cast<float2*>(sp + i0 * N + col) =
              make_float2(st[4 * nt], st[4 * nt + 1]);
          *reinterpret_cast<float2*>(sp + i1 * N + col) =
              make_float2(st[4 * nt + 2], st[4 * nt + 3]);
        }
      }
    }
    // C B^T once for both heads: warp (hd, wl) computes rows wl*16..+15,
    // cols hd*32..+31.
    {
      float sc[16];
#pragma unroll
      for (int j = 0; j < 16; ++j) sc[j] = 0.f;
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t af[4];
        ldsm4(af, at_a(cs, L::kNS, wl * 16, kk * 16, lane));
#pragma unroll
        for (int jp = 0; jp < 2; ++jp) {
          uint32_t bf[4];
          ldsm4(bf, at_b(bs, L::kNS, hd * 32 + jp * 16, kk * 16, lane));
          mma_bf16(sc + 8 * jp, af, bf);
          mma_bf16(sc + 8 * jp + 4, af, bf + 2);
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = hd * 32 + j * 8 + 2 * t;
        *reinterpret_cast<float2*>(&score[i0 * L::kSS + col]) =
            make_float2(sc[4 * j], sc[4 * j + 1]);
        *reinterpret_cast<float2*>(&score[i1 * L::kSS + col]) =
            make_float2(sc[4 * j + 2], sc[4 * j + 3]);
      }
    }
    // Inclusive cumsum of dt * a over the chunk, in log2 units: lane l holds
    // tokens 2l and 2l + 1.  cum2(j) fetches token j's from its lane (every
    // lane must take part in each shuffle).
    float c2e, c2o;
    {
      const float2 d = *reinterpret_cast<const float2*>(dts + 2 * lane);
      const float da0 = d.x * a, da1 = d.y * a;
      float run = da0 + da1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float u = __shfl_up_sync(0xffffffffu, run, off);
        if (lane >= off) run += u;
      }
      float excl = __shfl_up_sync(0xffffffffu, run, 1);
      if (lane == 0) excl = 0.f;
      const float ce = excl + da0;
      c2e = ce * kLog2e;
      c2o = (ce + da1) * kLog2e;
    }
    auto cum2 = [&](int j) {
      const float e = __shfl_sync(0xffffffffu, c2e, j >> 1);
      const float o = __shfl_sync(0xffffffffu, c2o, j >> 1);
      return (j & 1) ? o : e;
    };
    const float clast = __shfl_sync(0xffffffffu, c2o, 31);
    // The head's operands, once: x scaled in place by dt (dt x, rounded as
    // the reference's xd) and (w b) with w_j = exp(cum_last - cum_j) into
    // core matrices.  Two threads a token row: x columns half * 32.., b
    // columns half * 64...
    {
      const int row = tid & 63, half = (tid >> 6) & 1;
      const float w = ex2(clast - cum2(row));
      if (has_head) {
        const float d = dts[row];
        uint4* xr = reinterpret_cast<uint4*>(
            smem_raw + stage * L::kStage + L::kX +
            2 * ((hd * kQ + row) * L::kXS + half * (P / 2)));
#pragma unroll
        for (int v = 0; v < P / 16; ++v) xr[v] = scale8(xr[v], d);
        const uint4* br = reinterpret_cast<const uint4*>(
            smem_raw + stage * L::kStage + L::kBt +
            2 * (row * L::kNS + half * (N / 2)));
        unsigned char* wr = smem_raw + L::kWb + 2 * hd * kQ * N +
                            ((row >> 3) * (N / 8) + half * (N / 16)) * 128 +
                            (row & 7) * 16;
#pragma unroll
        for (int v = 0; v < N / 16; ++v)
          *reinterpret_cast<uint4*>(wr + v * 128) = scale8(br[v], w);
      }
    }
    // The bf16 state and w b were written by ordinary stores and are read
    // by wgmma through the async proxy: make the writes visible to it.
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // C B^T, both states, dt x and w b are in place
    if (!has_head) continue;

    // cum at this thread's rows and at the columns 8n + 2t (+1) it holds.
    const float ci0 = cum2(i0), ci1 = cum2(i1);
    float cj[kQ / 8][2];
#pragma unroll
    for (int n = 0; n < kQ / 8; ++n) {
      cj[n][0] = __shfl_sync(0xffffffffu, c2e, 4 * n + t);
      cj[n][1] = __shfl_sync(0xffffffffu, c2o, 4 * n + t);
    }

    // y = exp(cum_i) (C state^T), the carried state's contribution: one
    // wgmma per k16 step over the warpgroup's 64 chunk rows, C fragments
    // from registers, the bf16 state as the K-major B operand (core
    // matrices 128 bytes apart along p, P/8 * 128 = P * 16 along n: the
    // descriptor counts 16-byte units).
    float y[4 * kPt];
    {
      uint32_t af[N / 16][4];
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        ldsm4(af[kk], at_a(cs, L::kNS, wl * 16, kk * 16, lane));
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk)
        wgmma_rs_n64(y, af[kk], desc_plain(sts + kk * 2 * P * 16, P, 8),
                     kk > 0);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(y);
      const float e0 = ex2(ci0), e1 = ex2(ci1);
#pragma unroll
      for (int n = 0; n < kPt; ++n) {
        y[4 * n] *= e0; y[4 * n + 1] *= e0;
        y[4 * n + 2] *= e1; y[4 * n + 3] *= e1;
      }
    }

    // y += M (dt x), M = C B^T ⊙ L rounded to bf16, over the k16 column
    // blocks on and below this warp's diagonal block.
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
      if (kk > wl) break;
      uint32_t mf[4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int n = 2 * kk + half;
        const int col = n * 8 + 2 * t;
        const float2 u = *reinterpret_cast<const float2*>(&score[i0 * L::kSS + col]);
        const float2 v = *reinterpret_cast<const float2*>(&score[i1 * L::kSS + col]);
        float m00 = u.x * ex2(ci0 - cj[n][0]), m01 = u.y * ex2(ci0 - cj[n][1]);
        float m10 = v.x * ex2(ci1 - cj[n][0]), m11 = v.y * ex2(ci1 - cj[n][1]);
        if (kk == wl) {  // the diagonal block: keep i >= j only
          if (col > i0) m00 = 0.f;
          if (col + 1 > i0) m01 = 0.f;
          if (col > i1) m10 = 0.f;
          if (col + 1 > i1) m11 = 0.f;
        }
        mf[2 * half] = pack_bf16(m00, m01);
        mf[2 * half + 1] = pack_bf16(m10, m11);
      }
#pragma unroll
      for (int np = 0; np < kPt / 2; ++np) {
        uint32_t bf[4];
        ldsm4_t(bf, at_a(xs, L::kXS, kk * 16, np * 16, lane));
        mma_bf16(y + 8 * np, mf, bf);
        mma_bf16(y + 8 * np + 4, mf, bf + 2);
      }
    }
    {
      const int sa = s0 + i0, sb = s0 + i1;
#pragma unroll
      for (int n = 0; n < kPt; ++n) {
        const int col = n * 8 + 2 * t;
        if (sa < p.S)
          *reinterpret_cast<uint32_t*>(yb + sa * p.y_ss + col) =
              pack_bf16(y[4 * n], y[4 * n + 1]);
        if (sb < p.S)
          *reinterpret_cast<uint32_t*>(yb + sb * p.y_ss + col) =
              pack_bf16(y[4 * n + 2], y[4 * n + 3]);
      }
    }

    // state = exp(cum_last) state + (dt x)^T (w b): one wgmma per k16 step
    // of tokens over the warpgroup's 64 state rows, A = (dt x)^T from
    // registers (the dt x tile taken transposed), B = w b as the MN-major
    // operand (core matrices 128 bytes apart along n, N/8 * 128 = N * 16
    // along the tokens).
    {
      uint32_t af[kQ / 16][4];
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        ldsm4_t(af[kk], at_b(xs, L::kXS, kk * 16, wl * 16, lane));
      const float dec = ex2(clast);
#pragma unroll
      for (int i = 0; i < 4 * kNt; ++i) st[i] *= dec;
      fence_regs(st);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk)
        wgmma_rs_n128_tb(st, af[kk],
                         desc_plain(wbs + kk * 2 * N * 16, N, 8), 1);
      wgmma_commit();
      wgmma_wait_all();
      fence_regs(st);
    }
  }

  // The final state, f32.
  if (has_head) {
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = nt * 8 + 2 * t;
      *reinterpret_cast<float2*>(p.fin + st_off + i0 * N + col) =
          make_float2(st[4 * nt], st[4 * nt + 1]);
      *reinterpret_cast<float2*>(p.fin + st_off + i1 * N + col) =
          make_float2(st[4 * nt + 2], st[4 * nt + 3]);
    }
  }
}

template <int P, int N, bool kStates>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int bytes = Smem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<P, N, kStates>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.H + kHeads - 1) / kHeads, p.B);
  ssd_fwd<P, N, kStates><<<grid, kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// shape: B, S, H, P, N.  strides: x (batch, seq, head), dt (batch, seq,
// head), b (batch, seq), c (batch, seq), y (batch, seq, head), in elements.
// init may be null; states null runs the serving instantiation, else the
// one that writes the chunk states there (contiguous [B, ceil(S/64), H, P,
// N]).  Launches on `stream`; returns cudaGetLastError() as an int
// (cudaErrorInvalidValue for a (P, N) it was not compiled for).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* init,
                               void* y, void* fin, void* states,
                               const int64_t* shape, const int64_t* strides,
                               void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<const bf16*>(c);
  p.init = static_cast<const float*>(init);
  p.y = static_cast<bf16*>(y);
  p.fin = static_cast<float*>(fin);
  p.states = static_cast<float*>(states);
  p.B = static_cast<int>(shape[0]);
  p.S = static_cast<int>(shape[1]);
  p.H = static_cast<int>(shape[2]);
  p.x_sb = strides[0]; p.x_ss = strides[1]; p.x_sh = strides[2];
  p.dt_sb = strides[3]; p.dt_ss = strides[4]; p.dt_sh = strides[5];
  p.b_sb = strides[6]; p.b_ss = strides[7];
  p.c_sb = strides[8]; p.c_ss = strides[9];
  p.y_sb = strides[10]; p.y_ss = strides[11]; p.y_sh = strides[12];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t P = shape[3], N = shape[4];
  if (P == 64 && N == 128)
    return static_cast<int>(states ? launch<64, 128, true>(p, s)
                                   : launch<64, 128, false>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
