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
// Output: y [B, S, H, P] bf16 (no D-skip term), fin [B, H, P, N] f32.
// (P, N) is (64, 128), mamba2's head dim and state size: the one shape the
// serving path gives it.  Another shape is one more instantiation of the
// ssd_fwd template (P a multiple of 64, N of 16).
//
// Per chunk of kQ = 64 tokens (cum = inclusive cumsum of dt * a):
//   y      = (C B^T ⊙ L) (dt x) + exp(cum) ⊙ (C state^T),
//            L[i, j] = exp(cum_i - cum_j) for i >= j, else 0
//   state' = exp(cum_last) state + sum_j exp(cum_last - cum_j) (dt x)_j b_j^T
// The chunked dual form is exact for any chunk length, so the kernel's kQ
// need not be the model's ssm_chunk (256): a [256, 256] f32 score tile is
// 256 KB, more than a block's 227 KB of shared memory.
//
// What bounds it on an H100: memory.  At the mamba2-370m prefill shape
// (B 8, S 2048, H 32, P 64, N 128) it must read x, dt, b, c and write y and
// the final state, about 153 MB (0.046 ms at 3.35 TB/s), while the chunked
// products need about 20 GFLOP (0.02 ms at the bf16 tensor-core peak).
//
// What the design does about it: one block of 4 warps per (head, batch)
// and a loop over the chunks inside it (the Pallas kernel's sequential
// chunk grid axis; CUDA blocks run in no order).  The [P, N] f32 state
// never leaves the chip: it lives in the mma accumulator registers of the
// warps across the whole sequence (warp w owns P/4 state rows), and a bf16
// copy is staged in shared memory per chunk for the C state^T product, as
// the reference rounds the carried state to bf16 there.  Each chunk reads
// x, dt, b and c once and writes y once; all four products run on the
// tensor cores (mma.sync bf16 -> f32).  The decay exp(cum_i - cum_j) is
// computed only on and below the diagonal (above it the exponent is
// positive and could overflow; the entry is 0).  C B^T is the same for
// every head of a chunk (one b/c group), yet every (head, batch) block
// recomputes it, as the Pallas kernel does: sharing it is the redesign's
// work, as are overlapping the loads with the products and filling more
// than B * H blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kQ = 64;        // chunk length (16 rows per warp)
constexpr int kThreads = 128;
constexpr int kWarps = 4;

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
};

__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// A fragment (16x16, row-major) at rows r0..r0+15, cols k0..k0+15 of a
// shared-memory matrix with row stride `ld` elements.
__device__ __forceinline__ void load_a(uint32_t a[4], const bf16* m, int ld,
                                       int r0, int k0, int g, int t) {
  const bf16* p = m + (r0 + g) * ld + k0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B fragment (16x8, column-major) from a shared-memory matrix stored as its
// transpose: rows n0..n0+7 (the n index), cols k0..k0+15 (the k index).
__device__ __forceinline__ void load_b(uint32_t b[2], const bf16* m, int ld,
                                       int n0, int k0, int g, int t) {
  const bf16* p = m + (n0 + g) * ld + k0 + 2 * t;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

template <int P, int N>
struct Smem {
  static constexpr int kNS = N + 8;   // row stride of [*][N] tiles
  static constexpr int kQS = kQ + 8;  // row stride of [*][kQ] tiles
  static constexpr int kC = 0;                      // C chunk [kQ][kNS]
  static constexpr int kB = kC + kQ * kNS;          // B chunk [kQ][kNS]
  static constexpr int kWbt = kB + kQ * kNS;        // (w_j b_j)^T [N][kQS]
  static constexpr int kXdt = kWbt + N * kQS;       // (dt x)^T [P][kQS]
  static constexpr int kSt = kXdt + P * kQS;        // state bf16 [P][kNS]
  static constexpr int kElems = kSt + P * kNS;      // bf16 elements
  static constexpr int kBytes = kElems * 2 + 2 * kQ * 4;  // + cum, dt
};

template <int P, int N>
__global__ void __launch_bounds__(kThreads) ssd_fwd(const Params p) {
  using L = Smem<P, N>;
  constexpr int kMt = P / 16 / kWarps;  // state m-tiles per warp
  constexpr int kNt = N / 8;            // state n8 tiles
  constexpr int kPt = P / 8;            // y n8 tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sm = reinterpret_cast<bf16*>(smem_raw);
  bf16* cs = sm + L::kC;
  bf16* bs = sm + L::kB;
  bf16* wbt = sm + L::kWbt;
  bf16* xdt = sm + L::kXdt;
  bf16* sts = sm + L::kSt;
  float* cum = reinterpret_cast<float*>(sm + L::kElems);
  float* dts = cum + kQ;

  const int h = blockIdx.x, bb = blockIdx.y;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const float a = p.a[h];
  const bf16* xb = p.x + bb * p.x_sb + h * p.x_sh;
  const float* dtb = p.dt + bb * p.dt_sb + h * p.dt_sh;
  const bf16* bbase = p.b + bb * p.b_sb;
  const bf16* cbase = p.c + bb * p.c_sb;
  bf16* yb = p.y + bb * p.y_sb + h * p.y_sh;
  const int64_t st_off = (static_cast<int64_t>(bb) * p.H + h) * P * N;

  // The carried state, in accumulator layout: rows (warp*kMt + i)*16 + g
  // (+8), cols nt*8 + 2t (+1).
  float st[kMt][kNt][4];
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
    const int row = (warp * kMt + i) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      const int col = nt * 8 + 2 * t;
      if (p.init) {
        const float* s0 = p.init + st_off + row * N + col;
        st[i][nt][0] = s0[0];
        st[i][nt][1] = s0[1];
        st[i][nt][2] = s0[8 * N];
        st[i][nt][3] = s0[8 * N + 1];
      } else {
        st[i][nt][0] = st[i][nt][1] = st[i][nt][2] = st[i][nt][3] = 0.f;
      }
    }
  }

  const int n_chunks = (p.S + kQ - 1) / kQ;
  for (int ch = 0; ch < n_chunks; ++ch) {
    const int s0 = ch * kQ;
    __syncthreads();  // the previous chunk's shared tiles are consumed

    // dt of the chunk (0 past S: the cumsum stays flat there, and the
    // zero-filled x, b, c rows add nothing).
    if (tid < kQ) {
      const int s = s0 + tid;
      dts[tid] = s < p.S ? dtb[s * p.dt_ss] : 0.f;
    }
    // The state entering the chunk, rounded to bf16 for C state^T.
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      const int row = (warp * kMt + i) * 16 + g;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        const int col = nt * 8 + 2 * t;
        *reinterpret_cast<uint32_t*>(&sts[row * L::kNS + col]) =
            pack_bf16(st[i][nt][0], st[i][nt][1]);
        *reinterpret_cast<uint32_t*>(&sts[(row + 8) * L::kNS + col]) =
            pack_bf16(st[i][nt][2], st[i][nt][3]);
      }
    }
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum of dt * a, in order
      float run = 0.f;
      for (int i = 0; i < kQ; ++i) {
        run += dts[i] * a;
        cum[i] = run;
      }
    }
    __syncthreads();

    // x -> (dt x)^T, rounded to bf16 as the reference's xd.
    constexpr int kXCh = P / 8;
    for (int i = tid; i < kQ * kXCh; i += kThreads) {
      const int row = i / kXCh, cc = i - row * kXCh;
      const int s = s0 + row;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (s < p.S) v = *reinterpret_cast<const uint4*>(xb + s * p.x_ss + cc * 8);
      const bf16* ve = reinterpret_cast<const bf16*>(&v);
      const float d = dts[row];
#pragma unroll
      for (int e = 0; e < 8; ++e)
        xdt[(cc * 8 + e) * L::kQS + row] =
            __float2bfloat16_rn(__bfloat162float(ve[e]) * d);
    }
    // b, c rows as they are; (w_j b_j)^T with w_j = exp(cum_last - cum_j).
    constexpr int kNCh = N / 8;
    const float cum_last = cum[kQ - 1];
    for (int i = tid; i < kQ * kNCh; i += kThreads) {
      const int row = i / kNCh, cc = i - row * kNCh;
      const int s = s0 + row;
      uint4 bv = make_uint4(0u, 0u, 0u, 0u), cv = make_uint4(0u, 0u, 0u, 0u);
      if (s < p.S) {
        bv = *reinterpret_cast<const uint4*>(bbase + s * p.b_ss + cc * 8);
        cv = *reinterpret_cast<const uint4*>(cbase + s * p.c_ss + cc * 8);
      }
      *reinterpret_cast<uint4*>(&bs[row * L::kNS + cc * 8]) = bv;
      *reinterpret_cast<uint4*>(&cs[row * L::kNS + cc * 8]) = cv;
      const float w = expf(cum_last - cum[row]);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
      for (int e = 0; e < 8; ++e)
        wbt[(cc * 8 + e) * L::kQS + row] =
            __float2bfloat16_rn(__bfloat162float(be[e]) * w);
    }
    __syncthreads();

    const int q0 = warp * 16;  // this warp's 16 chunk rows
    const int i0 = q0 + g, i1 = i0 + 8;

    // Scores C B^T for the warp's rows, all kQ columns.
    float sc[kQ / 8][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      load_a(af, cs, L::kNS, q0, kk * 16, g, t);
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        uint32_t bfr[2];
        load_b(bfr, bs, L::kNS, j * 8, kk * 16, g, t);
        mma_bf16(sc[j], af, bfr);
      }
    }
    // M = scores ⊙ L, rounded to bf16 into A fragments (two neighbouring n8
    // accumulator tiles form one k16 A fragment).
    uint32_t mf[kQ / 16][4];
#pragma unroll
    for (int j = 0; j < kQ / 8; ++j) {
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e < 2 ? i0 : i1;
        const int jj = j * 8 + 2 * t + (e & 1);
        v[e] = i >= jj ? sc[j][e] * expf(cum[i] - cum[jj]) : 0.f;
      }
      mf[j >> 1][(j & 1) * 2 + 0] = pack_bf16(v[0], v[1]);
      mf[j >> 1][(j & 1) * 2 + 1] = pack_bf16(v[2], v[3]);
    }
    // y = exp(cum_i) (C state^T), the carried state's contribution.
    float y[kPt][4];
#pragma unroll
    for (int n = 0; n < kPt; ++n) y[n][0] = y[n][1] = y[n][2] = y[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < N / 16; ++kk) {
      uint32_t af[4];
      load_a(af, cs, L::kNS, q0, kk * 16, g, t);
#pragma unroll
      for (int n = 0; n < kPt; ++n) {
        uint32_t bfr[2];
        load_b(bfr, sts, L::kNS, n * 8, kk * 16, g, t);
        mma_bf16(y[n], af, bfr);
      }
    }
    const float e0 = expf(cum[i0]), e1 = expf(cum[i1]);
#pragma unroll
    for (int n = 0; n < kPt; ++n) {
      y[n][0] *= e0; y[n][1] *= e0;
      y[n][2] *= e1; y[n][3] *= e1;
    }

    // y += M (dt x).
#pragma unroll
    for (int kk = 0; kk < kQ / 16; ++kk) {
#pragma unroll
      for (int n = 0; n < kPt; ++n) {
        uint32_t bfr[2];
        load_b(bfr, xdt, L::kQS, n * 8, kk * 16, g, t);
        mma_bf16(y[n], mf[kk], bfr);
      }
    }
    const int sa = s0 + i0, sb = s0 + i1;
#pragma unroll
    for (int n = 0; n < kPt; ++n) {
      const int col = n * 8 + 2 * t;
      if (sa < p.S)
        *reinterpret_cast<uint32_t*>(yb + sa * p.y_ss + col) =
            pack_bf16(y[n][0], y[n][1]);
      if (sb < p.S)
        *reinterpret_cast<uint32_t*>(yb + sb * p.y_ss + col) =
            pack_bf16(y[n][2], y[n][3]);
    }

    // state = exp(cum_last) state + (dt x)^T (w b): A = (dt x)^T rows of this
    // warp's state m-tiles, B = (w b)^T.
    const float dec = expf(cum_last);
#pragma unroll
    for (int i = 0; i < kMt; ++i) {
      const int r0 = (warp * kMt + i) * 16;
#pragma unroll
      for (int nt = 0; nt < kNt; ++nt) {
        st[i][nt][0] *= dec; st[i][nt][1] *= dec;
        st[i][nt][2] *= dec; st[i][nt][3] *= dec;
      }
#pragma unroll
      for (int kk = 0; kk < kQ / 16; ++kk) {
        uint32_t af[4];
        load_a(af, xdt, L::kQS, r0, kk * 16, g, t);
#pragma unroll
        for (int nt = 0; nt < kNt; ++nt) {
          uint32_t bfr[2];
          load_b(bfr, wbt, L::kQS, nt * 8, kk * 16, g, t);
          mma_bf16(st[i][nt], af, bfr);
        }
      }
    }
  }

  // The final state, f32.
#pragma unroll
  for (int i = 0; i < kMt; ++i) {
    const int row = (warp * kMt + i) * 16 + g;
#pragma unroll
    for (int nt = 0; nt < kNt; ++nt) {
      float* d = p.fin + st_off + row * N + nt * 8 + 2 * t;
      d[0] = st[i][nt][0];
      d[1] = st[i][nt][1];
      d[8 * N] = st[i][nt][2];
      d[8 * N + 1] = st[i][nt][3];
    }
  }
}

template <int P, int N>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int bytes = Smem<P, N>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(
      ssd_fwd<P, N>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  ssd_fwd<P, N><<<dim3(p.H, p.B), kThreads, bytes, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// shape: B, S, H, P, N.  strides: x (batch, seq, head), dt (batch, seq,
// head), b (batch, seq), c (batch, seq), y (batch, seq, head), in elements.
// init may be null.  Launches on `stream`; returns cudaGetLastError() as an
// int (cudaErrorInvalidValue for a (P, N) it was not compiled for).
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* a,
                               const void* b, const void* c, const void* init,
                               void* y, void* fin, const int64_t* shape,
                               const int64_t* strides, void* stream) {
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.dt = static_cast<const float*>(dt);
  p.a = static_cast<const float*>(a);
  p.b = static_cast<const bf16*>(b);
  p.c = static_cast<const bf16*>(c);
  p.init = static_cast<const float*>(init);
  p.y = static_cast<bf16*>(y);
  p.fin = static_cast<float*>(fin);
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
  if (P == 64 && N == 128) return static_cast<int>(launch<64, 128>(p, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
