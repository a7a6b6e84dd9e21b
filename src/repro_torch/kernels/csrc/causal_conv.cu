// Mamba-2's depthwise causal conv, its bias and its SiLU, forward and
// backward, for Hopper.
//
// Replaces no Pallas kernel: the JAX package's models/ssm.py::_causal_conv
// is W shifted multiply-adds over a zero-padded copy of its input, which
// XLA fuses into one pass.  Eager torch runs the same code as ~12 passes
// over the input in the forward (the pad, W products, W adds, the bias, a
// cast to float32 and back around the SiLU) and ~20 in autograd's backward,
// several of them float32, each over a strided view of in_proj's output.
// The port's plain version is repro_torch/kernels/causal_conv.py::
// causal_conv_plain (its backward causal_conv_bwd_plain); the Python
// wrappers are causal_conv_cuda and causal_conv_bwd_cuda in that module.
//
//   y[b, t, c] = silu(bias[c] + sum_i w[i, c] x[b, t + i - (W - 1), c])
//
// with x at times -(W - 1) .. -1 the conv state [B, W - 1, C] where one is
// given (a continued prefill), else zero.  W (the conv width) is 1 to 4.
//
// What bounds it on an H100: device memory.  The forward must read x and
// write y, 2 x B S C x 2 bytes; the backward read x and dy and write dx,
// 3 x B S C x 2 bytes (the weights, the bias and their gradients are a few
// kilobytes).  At granite-4.0-h-micro's training shape (B 1, S 16,384, C
// 4,352) that is 285 MB (0.085 ms at 3.35 TB/s) and 428 MB (0.128 ms).
// The arithmetic, ~2W + 20 operations an element, is far below the card's
// rate.
//
// What the design does about it:
// - A thread owns V adjacent channels and walks a run of time steps of
//   them, keeping the last W - 1 inputs in registers: every row of x is
//   read once, plus a halo of W - 1 rows a thread, which its neighbour in
//   time has just brought into L2.  V is 4 (one 8-byte load) where the view
//   allows it; the wrapper picks 4, 2 or 1 from the pointers and strides
//   alone, so a view that is not 8-byte aligned (a model-axis split) takes
//   narrower loads instead of a copy.  A warp covers 32 groups of channels
//   of one row: 256 contiguous bytes at V 4.  16-byte loads (V 8) were
//   slower on an H100 at granite's and mamba2-370m's training shapes
//   (forward 0.152 against 0.133 ms, backward 0.375 against 0.276 ms at
//   granite's): a thread holds twice the registers, so half the threads
//   are in flight to hide the loads' latency.
// - x is read in place from the strided view (its batch and row strides
//   are parameters); y and dx are written contiguous [B, S, C].
// - Rows are loaded several at a time before the first of them is used,
//   so each thread keeps several loads in flight.
// - The taps, the bias and the SiLU are float32 (the taps contracted into
//   FMAs); y and dx are rounded to bf16 once.
// - The backward recomputes the pre-activation u from the same halo, forms
//   g = dy silu'(u) and writes dx[t] = sum_k w[W - 1 - k] g[t + k]: a
//   thread walks W - 1 rows past its tile to have those g, and the thread
//   at t = 0 writes the state's gradient where a state was given.  dw and
//   db are float32 sums over the block's rows (each thread's, then the
//   block's slabs added in a fixed order in shared memory), written as one
//   partial row a block; a second launch adds the partial rows of every
//   block in a fixed order.  No atomics: the same inputs give the same bits
//   on every run.
//
// The kernels allocate nothing: the wrapper allocates y, dx, the state's
// gradient, the partial sums, dw and db.  Every launch goes on the stream
// it is given.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

// Channel groups a block (threadIdx.x): one warp along the channels.
constexpr int kGroups = 32;
// A block's time slabs (threadIdx.y), each one thread's rows, and the rows
// a thread loads before the first of them is used: forward, backward.
constexpr int kFwdSlabs = 8;
constexpr int kFwdRows = 32;
constexpr int kFwdAhead = 8;
constexpr int kBwdSlabs = 4;
constexpr int kBwdRows = 32;
constexpr int kBwdAhead = 4;
// Time steps a backward block covers: it writes one partial row.
constexpr int kBwdBlockRows = kBwdSlabs * kBwdRows;
constexpr int kMaxWidth = 4;
// Partial rows the reduce adds in parallel for one column (threadIdx.y).
constexpr int kSumRows = 8;

struct ConvParams {
  const bf16* x;       // x[b, t, c] at x[b * x_sb + t * x_ss + c]
  int64_t x_sb, x_ss;
  const bf16* w;       // [W, C]
  const bf16* bias;    // [C]
  const bf16* state;   // [B, W - 1, C] or null (zeros)
  const bf16* dy;      // backward: dy[b, t, c] at dy[b * dy_sb + t * dy_ss + c]
  int64_t dy_sb, dy_ss;
  bf16* out;           // forward y, backward dx: [B, S, C]
  float* dstate;       // backward: [B, W - 1, C] or null
  float* partials;     // backward: [B * blocks_t, W + 1, C]
  int64_t S, C;
};

// V bf16 values as one load or store.
template <int V> struct Raw;
template <> struct Raw<4> { using T = uint2; };
template <> struct Raw<2> { using T = unsigned int; };
template <> struct Raw<1> { using T = unsigned short; };

template <int V>
__device__ __forceinline__ typename Raw<V>::T load_raw(const bf16* p) {
  return *reinterpret_cast<const typename Raw<V>::T*>(p);
}

template <int V>
__device__ __forceinline__ void store_raw(bf16* p, typename Raw<V>::T v) {
  *reinterpret_cast<typename Raw<V>::T*>(p) = v;
}

__device__ __forceinline__ unsigned int word(uint2 r, int k) {
  return k == 0 ? r.x : r.y;
}
__device__ __forceinline__ unsigned int word(unsigned int r, int) { return r; }
__device__ __forceinline__ unsigned int word(unsigned short r, int) {
  return r;
}

// bf16 -> float is exact: the bf16 bits are a float's upper half.
template <int V>
__device__ __forceinline__ void unpack(typename Raw<V>::T raw, float (&out)[V]) {
#pragma unroll
  for (int i = 0; i < V; ++i) {
    const unsigned int u = word(raw, i / 2);
    out[i] = __uint_as_float((i & 1) ? (u & 0xffff0000u) : (u << 16));
  }
}

__device__ __forceinline__ unsigned int bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ unsigned int pack2(float lo, float hi) {
  return bits(lo) | (bits(hi) << 16);
}

// Each value rounded to bf16 (round to nearest even).
template <int V>
__device__ __forceinline__ typename Raw<V>::T pack(const float (&v)[V]) {
  if constexpr (V == 4) {
    return make_uint2(pack2(v[0], v[1]), pack2(v[2], v[3]));
  } else if constexpr (V == 2) {
    return pack2(v[0], v[1]);
  } else {
    return static_cast<unsigned short>(bits(v[0]));
  }
}

// Row t of the conv's input for channels c.. of batch b: x where t >= 0,
// the state at -(W - 1) <= t < 0, zeros there without one.
template <int W, int V>
__device__ __forceinline__ typename Raw<V>::T input_row(const ConvParams& p,
                                                        int64_t b, int64_t c,
                                                        int64_t t) {
  if (t >= 0) return load_raw<V>(p.x + b * p.x_sb + t * p.x_ss + c);
  if (p.state != nullptr) {
    return load_raw<V>(p.state + (b * (W - 1) + (W - 1) + t) * p.C + c);
  }
  return typename Raw<V>::T{};
}

// The taps, the bias and the weights' rows for channels c.., in float32.
template <int W, int V>
__device__ __forceinline__ void load_weights(const ConvParams& p, int64_t c,
                                             float (&w)[W][V],
                                             float (&bias)[V]) {
#pragma unroll
  for (int i = 0; i < W; ++i) unpack<V>(load_raw<V>(p.w + i * p.C + c), w[i]);
  unpack<V>(load_raw<V>(p.bias + c), bias);
}

// u = (sum_i w[i] win[i]) + bias, the taps in the plain version's order.
template <int W>
__device__ __forceinline__ float preact(const float* w, const float* win,
                                        float bias) {
  float u = w[0] * win[0];
#pragma unroll
  for (int i = 1; i < W; ++i) u = fmaf(w[i], win[i], u);
  return u + bias;
}

template <int W, int V>
__device__ __forceinline__ void shift(float (&win)[W][V]) {
#pragma unroll
  for (int j = 0; j + 1 < W; ++j) {
#pragma unroll
    for (int v = 0; v < V; ++v) win[j][v] = win[j + 1][v];
  }
}

// grid (ceil(C / V / kGroups), ceil(S / (kFwdSlabs kFwdRows)), B), block
// (kGroups, kFwdSlabs).  The thread (gx, slab) of block (bx, by, b) owns
// channels (bx kGroups + gx) V .. + V and rows (by kFwdSlabs + slab)
// kFwdRows .. + kFwdRows.
template <int W, int V>
__global__ void __launch_bounds__(kGroups * kFwdSlabs)
causal_conv1d_fwd(const ConvParams p) {
  constexpr int kRows = kFwdRows, kAhead = kFwdAhead;
  const int64_t c = (int64_t{blockIdx.x} * kGroups + threadIdx.x) * V;
  const int64_t t0 = (int64_t{blockIdx.y} * kFwdSlabs + threadIdx.y) * kRows;
  if (c >= p.C || t0 >= p.S) return;
  const int64_t b = blockIdx.z;
  float w[W][V], bias[V];
  load_weights<W, V>(p, c, w, bias);
  // win[0 .. W-2]: the W - 1 rows before the current one; win[W-1]: it.
  float win[W][V];
#pragma unroll
  for (int j = 0; j + 1 < W; ++j) {
    unpack<V>(input_row<W, V>(p, b, c, t0 - (W - 1) + j), win[j]);
  }
  const int n = static_cast<int>(p.S - t0 < kRows ? p.S - t0 : kRows);
  const bf16* xr = p.x + b * p.x_sb + t0 * p.x_ss + c;
  bf16* yr = p.out + (b * p.S + t0) * p.C + c;
  for (int r0 = 0; r0 < n; r0 += kAhead) {
    typename Raw<V>::T ahead[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (r0 + k < n) ahead[k] = load_raw<V>(xr + (r0 + k) * p.x_ss);
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (r0 + k < n) {
        unpack<V>(ahead[k], win[W - 1]);
        float y[V];
#pragma unroll
        for (int v = 0; v < V; ++v) {
          float tap[W], wv[W];
#pragma unroll
          for (int i = 0; i < W; ++i) {
            tap[i] = win[i][v];
            wv[i] = w[i][v];
          }
          const float u = preact<W>(wv, tap, bias[v]);
          y[v] = u / (1.0f + __expf(-u));
        }
        store_raw<V>(yr + (r0 + k) * p.C, pack<V>(y));
        shift<W, V>(win);
      }
    }
  }
}

// The backward's main launch: dx (and the state's gradient) and the
// block's partial sums of dw and db.  Grid and block as the forward's, with
// the backward's slabs and rows.
template <int W, int V>
__global__ void __launch_bounds__(kGroups * kBwdSlabs)
causal_conv1d_bwd_dx(const ConvParams p) {
  constexpr int kSlabs = kBwdSlabs, kRows = kBwdRows;
  // The slabs' sums: [slab][row i of (dw, db)][group][V + 1], padded so
  // that neither the writes (a group a thread) nor the reads (a channel a
  // thread) meet in one bank.
  __shared__ float red[kSlabs][W + 1][kGroups * (V + 1)];
  const int64_t c = (int64_t{blockIdx.x} * kGroups + threadIdx.x) * V;
  const int64_t t0 = (int64_t{blockIdx.y} * kSlabs + threadIdx.y) * kRows;
  const int64_t b = blockIdx.z;
  float dw[W][V], db[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    db[v] = 0.0f;
#pragma unroll
    for (int i = 0; i < W; ++i) dw[i][v] = 0.0f;
  }
  if (c < p.C && t0 < p.S) {
    float w[W][V], bias[V];
    load_weights<W, V>(p, c, w, bias);
    float win[W][V];
#pragma unroll
    for (int j = 0; j + 1 < W; ++j) {
      unpack<V>(input_row<W, V>(p, b, c, t0 - (W - 1) + j), win[j]);
    }
    // gr[k]: g at the current time - (W - 1) + k (gr[W-1] the current one).
    float gr[W][V];
#pragma unroll
    for (int k = 0; k < W; ++k) {
#pragma unroll
      for (int v = 0; v < V; ++v) gr[k][v] = 0.0f;
    }
    // The tile is rows [t0, t1); dx there needs g up to t1 + W - 2, and g
    // is zero from S on.
    const int64_t t1 = p.S - t0 < kRows ? p.S : t0 + kRows;
    const int end = static_cast<int>(t1 - t0) + (W - 1);
    const int live = static_cast<int>((p.S < t1 + (W - 1) ? p.S : t1 + (W - 1)) - t0);
    const int tile = static_cast<int>(t1 - t0);
    const bf16* xr = p.x + b * p.x_sb + t0 * p.x_ss + c;
    const bf16* dyr = p.dy + b * p.dy_sb + t0 * p.dy_ss + c;
    bf16* dxr = p.out + (b * p.S + t0) * p.C + c;
    for (int r0 = 0; r0 < end; r0 += kBwdAhead) {
      typename Raw<V>::T xa[kBwdAhead], da[kBwdAhead];
#pragma unroll
      for (int k = 0; k < kBwdAhead; ++k) {
        if (r0 + k < live) {
          xa[k] = load_raw<V>(xr + (r0 + k) * p.x_ss);
          da[k] = load_raw<V>(dyr + (r0 + k) * p.dy_ss);
        }
      }
#pragma unroll
      for (int k = 0; k < kBwdAhead; ++k) {
        const int r = r0 + k;
        if (r < end) {
          shift<W, V>(gr);
          if (r < live) {
            unpack<V>(xa[k], win[W - 1]);
            float dyv[V];
            unpack<V>(da[k], dyv);
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float tap[W], wv[W];
#pragma unroll
              for (int i = 0; i < W; ++i) {
                tap[i] = win[i][v];
                wv[i] = w[i][v];
              }
              const float u = preact<W>(wv, tap, bias[v]);
              const float s = 1.0f / (1.0f + __expf(-u));
              const float g = dyv[v] * s * (1.0f + u * (1.0f - s));
              gr[W - 1][v] = g;
              if (r < tile) {
#pragma unroll
                for (int i = 0; i < W; ++i) dw[i][v] = fmaf(g, win[i][v], dw[i][v]);
                db[v] += g;
              }
            }
            shift<W, V>(win);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) gr[W - 1][v] = 0.0f;
          }
          if (r >= W - 1) {  // dx at t0 + r - (W - 1): g there .. W - 1 on
            float dx[V];
#pragma unroll
            for (int v = 0; v < V; ++v) {
              float s = w[W - 1][v] * gr[0][v];
#pragma unroll
              for (int k2 = 1; k2 < W; ++k2) s = fmaf(w[W - 1 - k2][v], gr[k2][v], s);
              dx[v] = s;
            }
            store_raw<V>(dxr + (r - (W - 1)) * p.C, pack<V>(dx));
          }
          // The state's gradient: dstate[j] = sum_{i <= j} w[i] g[j - i],
          // with g[0 .. W-2] in gr[1 .. W-1] once r = W - 2.
          if (W > 1 && p.dstate != nullptr && t0 == 0 && r == W - 2) {
#pragma unroll
            for (int j = 0; j + 1 < W; ++j) {
#pragma unroll
              for (int v = 0; v < V; ++v) {
                float s = w[0][v] * gr[1 + j][v];
#pragma unroll
                for (int i = 1; i <= j; ++i) s = fmaf(w[i][v], gr[1 + j - i][v], s);
                p.dstate[(b * (W - 1) + j) * p.C + c + v] = s;
              }
            }
          }
        }
      }
    }
  }
  // The block's partial row: its slabs' sums added in order, for every
  // channel of the block below C (zeros from slabs past S).
  const int gx = threadIdx.x, slab = threadIdx.y;
#pragma unroll
  for (int v = 0; v < V; ++v) {
#pragma unroll
    for (int i = 0; i < W; ++i) red[slab][i][gx * (V + 1) + v] = dw[i][v];
    red[slab][W][gx * (V + 1) + v] = db[v];
  }
  __syncthreads();
  const int64_t c0 = int64_t{blockIdx.x} * kGroups * V;
  float* row = p.partials + (int64_t{blockIdx.z} * gridDim.y + blockIdx.y) * (W + 1) * p.C;
  for (int k = slab * kGroups + gx; k < (W + 1) * kGroups * V;
       k += kGroups * kSlabs) {
    const int i = k / (kGroups * V), ch = k % (kGroups * V);
    const int at = (ch / V) * (V + 1) + ch % V;
    if (c0 + ch < p.C) {
      float s = red[0][i][at];
#pragma unroll
      for (int sl = 1; sl < kSlabs; ++sl) s += red[sl][i][at];
      row[i * p.C + c0 + ch] = s;
    }
  }
}

// dw [W, C] and db [C] (bf16) from the partial rows: column j of the
// flattened (W + 1) x C row, its rows added by kSumRows threads (thread y
// takes rows y, y + kSumRows, ..., in order) and then in order of y.
// grid ceil((W + 1) C / kGroups), block (kGroups, kSumRows).
__global__ void __launch_bounds__(kGroups * kSumRows)
causal_conv1d_bwd_dw(const float* partials, int64_t rows, int64_t cols,
                     int64_t wc, bf16* dw, bf16* db) {
  __shared__ float part[kSumRows][kGroups];
  const int64_t j = int64_t{blockIdx.x} * kGroups + threadIdx.x;
  float s = 0.0f;
  if (j < cols) {
#pragma unroll 4
    for (int64_t r = threadIdx.y; r < rows; r += kSumRows) s += partials[r * cols + j];
  }
  part[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < cols) {
    float t = part[0][threadIdx.x];
#pragma unroll
    for (int y = 1; y < kSumRows; ++y) t += part[y][threadIdx.x];
    const bf16 h = __float2bfloat16_rn(t);
    if (j < wc) {
      dw[j] = h;
    } else {
      db[j - wc] = h;
    }
  }
}

bool grid_ok(dim3 g) {
  return g.x >= 1 && g.x < (1u << 31) && g.y >= 1 && g.y <= 65535 &&
         g.z >= 1 && g.z <= 65535;
}

dim3 conv_grid(int64_t B, int64_t S, int64_t C, int vec, int block_rows) {
  const int64_t groups = C / vec;
  return dim3(static_cast<unsigned int>((groups + kGroups - 1) / kGroups),
              static_cast<unsigned int>((S + block_rows - 1) / block_rows),
              static_cast<unsigned int>(B));
}

template <int W, int V>
cudaError_t fwd_launch(const ConvParams& p, dim3 grid, cudaStream_t s) {
  causal_conv1d_fwd<W, V><<<grid, dim3(kGroups, kFwdSlabs), 0, s>>>(p);
  return cudaGetLastError();
}

template <int W, int V>
cudaError_t bwd_launch(const ConvParams& p, dim3 grid, cudaStream_t s) {
  causal_conv1d_bwd_dx<W, V><<<grid, dim3(kGroups, kBwdSlabs), 0, s>>>(p);
  return cudaGetLastError();
}

// fn<W, V>(args...) for the runtime (width, vec); cudaErrorInvalidValue
// for any other pair.
#define CAUSAL_CONV_DISPATCH(FN, WIDTH, VEC, ...)                          \
  switch ((WIDTH) * 16 + (VEC)) {                                          \
    case 1 * 16 + 1: return FN<1, 1>(__VA_ARGS__);                         \
    case 1 * 16 + 2: return FN<1, 2>(__VA_ARGS__);                         \
    case 1 * 16 + 4: return FN<1, 4>(__VA_ARGS__);                         \
    case 2 * 16 + 1: return FN<2, 1>(__VA_ARGS__);                         \
    case 2 * 16 + 2: return FN<2, 2>(__VA_ARGS__);                         \
    case 2 * 16 + 4: return FN<2, 4>(__VA_ARGS__);                         \
    case 3 * 16 + 1: return FN<3, 1>(__VA_ARGS__);                         \
    case 3 * 16 + 2: return FN<3, 2>(__VA_ARGS__);                         \
    case 3 * 16 + 4: return FN<3, 4>(__VA_ARGS__);                         \
    case 4 * 16 + 1: return FN<4, 1>(__VA_ARGS__);                         \
    case 4 * 16 + 2: return FN<4, 2>(__VA_ARGS__);                         \
    case 4 * 16 + 4: return FN<4, 4>(__VA_ARGS__);                         \
    default: return cudaErrorInvalidValue;                                 \
  }

cudaError_t fwd_dispatch(const ConvParams& p, dim3 grid, cudaStream_t s,
                         int width, int vec) {
  CAUSAL_CONV_DISPATCH(fwd_launch, width, vec, p, grid, s)
}

cudaError_t bwd_dispatch(const ConvParams& p, dim3 grid, cudaStream_t s,
                         int width, int vec) {
  CAUSAL_CONV_DISPATCH(bwd_launch, width, vec, p, grid, s)
}

}  // namespace

// Time steps a block covers: a backward launch writes B * ceil(S / this)
// partial rows of (W + 1) x C floats.
extern "C" int64_t causal_conv_block_rows() { return kBwdBlockRows; }

extern "C" int causal_conv_max_width() { return kMaxWidth; }

// y [B, S, C] (contiguous bf16) from x (bf16, x[b * x_sb + t * x_ss + c]),
// w [W, C], bias [C] and state [B, W - 1, C] or null, all bf16 and
// contiguous.  vec: channels a load (4, 2 or 1), which every pointer
// and stride must allow.  One launch; B, S, C > 0.
extern "C" int causal_conv_fwd_launch(const void* x, int64_t x_sb,
                                      int64_t x_ss, const void* w,
                                      const void* bias, const void* state,
                                      void* y, int64_t B, int64_t S,
                                      int64_t C, int width, int vec,
                                      void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || vec <= 0 || C % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = conv_grid(B, S, C, vec, kFwdSlabs * kFwdRows);
  if (!grid_ok(grid)) return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p{};
  p.x = static_cast<const bf16*>(x);
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.state = static_cast<const bf16*>(state);
  p.out = static_cast<bf16*>(y);
  p.S = S;
  p.C = C;
  return static_cast<int>(fwd_dispatch(p, grid, static_cast<cudaStream_t>(stream), width, vec));
}

// dx [B, S, C] (contiguous bf16), the state's gradient dstate [B, W - 1, C]
// (float32, where state is not null), dw [W, C] and db [C] (bf16) from the
// forward's operands and dy (bf16, dy[b * dy_sb + t * dy_ss + c]).
// partials: float32 [B * ceil(S / causal_conv_block_rows()), W + 1, C].
// Two launches.
extern "C" int causal_conv_bwd_launch(const void* x, int64_t x_sb,
                                      int64_t x_ss, const void* w,
                                      const void* bias, const void* state,
                                      const void* dy, int64_t dy_sb,
                                      int64_t dy_ss, void* dx, void* dstate,
                                      void* partials, void* dw, void* db,
                                      int64_t B, int64_t S, int64_t C,
                                      int width, int vec, void* stream) {
  if (B <= 0 || S <= 0 || C <= 0 || vec <= 0 || C % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid = conv_grid(B, S, C, vec, kBwdBlockRows);
  if (!grid_ok(grid)) return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p{};
  p.x = static_cast<const bf16*>(x);
  p.x_sb = x_sb;
  p.x_ss = x_ss;
  p.w = static_cast<const bf16*>(w);
  p.bias = static_cast<const bf16*>(bias);
  p.state = static_cast<const bf16*>(state);
  p.dy = static_cast<const bf16*>(dy);
  p.dy_sb = dy_sb;
  p.dy_ss = dy_ss;
  p.out = static_cast<bf16*>(dx);
  p.dstate = state != nullptr ? static_cast<float*>(dstate) : nullptr;
  p.partials = static_cast<float*>(partials);
  p.S = S;
  p.C = C;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bwd_dispatch(p, grid, s, width, vec);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t rows = B * grid.y, cols = (width + 1) * C;
  const dim3 sum_grid(static_cast<unsigned int>((cols + kGroups - 1) / kGroups));
  if (!grid_ok(sum_grid)) return static_cast<int>(cudaErrorInvalidValue);
  causal_conv1d_bwd_dw<<<sum_grid, dim3(kGroups, kSumRows), 0, s>>>(static_cast<const float*>(partials), rows, cols, width * C, static_cast<bf16*>(dw), static_cast<bf16*>(db));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* causal_conv_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
