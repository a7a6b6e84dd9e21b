// AdamW with global-norm clipping as one multi-tensor update for Hopper.
//
// Replaces no Pallas kernel: the JAX package's optim/adamw.py leaves the
// update to XLA, which fuses each leaf's element-wise work.  The port's
// plain version, a loop over the leaves of about 21 float32 passes each, is
// repro_torch/kernels/adamw.py::update_plain (with sq_norms_plain for the
// norm); the Python wrappers are sq_norms_cuda and update_cuda in the same
// module.
//
// What bounds it on an H100: device memory.  Clipping needs the global
// norm before any element changes, so the least work is two passes: read g
// (4 bytes an element), then read g, p, m and v and write p, m and v (28
// bytes): 32 bytes an element, 17.5 ms for h2o-danube-1.8b's 1.83B float32
// parameters at 3.35 TB/s.  The arithmetic (two divisions and a square
// root an element) is far below the card's rate.
//
// What the design does about it:
// * One table describes every leaf: its g, p, m and v pointers and its
//   element count, then the prefix of its chunk counts.  A leaf is cut
//   into chunks of kChunk elements (its last chunk shorter, an empty leaf
//   none); a block finds a chunk's leaf by binary search over the prefix.
//   One launch covers every leaf however many there are: a large leaf
//   (danube's 82M-element embedding) is spread over every SM, and a
//   persistent grid of a few blocks an SM walks the chunks, so hundreds of
//   small leaves (mamba2's 32 to 1,024 elements) do not each take a block.
// * Each thread moves 16 bytes a load and a store (float4), with a scalar
//   tail for a count that is not a multiple of 4; a leaf whose pointers are
//   not 16-byte aligned takes the scalar loop.  Loads and stores carry the
//   streaming hint: every byte is touched once a pass.
// * The norm: adamw_sq_partials writes each chunk's sum of squares (each
//   square rounded to float32, as torch.square(g.float()) rounds it,
//   summed in float64) to a partials buffer, and adamw_leaf_sums adds a
//   leaf's partials, one warp a leaf, in a fixed order.  No atomics: the
//   same inputs give the same bits on every run and every grid.
// * The update reads the four step scalars (clip scale, lr, 1 - b1^t,
//   1 - b2^t) from one device tensor, so nothing waits for the host, and
//   computes in the plain version's order, each operation rounded once:
//   g*scale; m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g^2;
//   step = (m/bc1) / (sqrt(v/bc2) + eps) + wd*p; p = p - lr*step.  The
//   build passes -fmad=false, so no a*b+c is contracted, and division and
//   square root are IEEE round-to-nearest (no fast math): the update is
//   bit-equal to the plain per-leaf arithmetic for the same scalars.
//
// The kernels allocate nothing: the wrapper allocates the table, the
// partials and the output.  Every launch goes on the stream it is given.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Elements a chunk: the unit of work a block takes from the table.
constexpr int64_t kChunk = int64_t{1} << 15;
// Persistent blocks an SM (kThreads x kBlocksPerSm = 2,048 threads, the
// SM's limit).
constexpr int kBlocksPerSm = 8;

// A leaf's five words of the table.
struct Leaf {
  const float* g;
  float* p;
  float* m;
  float* v;
  int64_t n;
};
static_assert(sizeof(Leaf) == 5 * sizeof(int64_t),
              "a leaf is five int64 words of the table");

// The update's constants, as float32 values of torch's scalar operands.
struct Hyper {
  float b1, b2, c1, c2, eps, wd;  // c1 = 1 - b1, c2 = 1 - b2
};

// The leaf that holds chunk c: the last i < n_leaves with first[i] <= c
// (an empty leaf shares its first with the next and is never the last).
__device__ __forceinline__ int leaf_of(const int64_t* first, int n_leaves,
                                       int64_t c) {
  int lo = 0, hi = n_leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (first[mid] <= c) {
      lo = mid;
    } else {
      hi = mid - 1;
    }
  }
  return lo;
}

// Elements of the chunk that starts at element start of a leaf of n.
__device__ __forceinline__ int chunk_count(int64_t n, int64_t start) {
  const int64_t rest = n - start;
  return static_cast<int>(rest < kChunk ? rest : kChunk);
}

__device__ __forceinline__ double warp_sum(double x) {
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ double sq(float x) {
  return static_cast<double>(x * x);
}

// Pass 1: one partial sum of squares a chunk.
__global__ void __launch_bounds__(kThreads)
adamw_sq_partials(const int64_t* __restrict__ table, int n_leaves,
                  int64_t n_chunks, double* __restrict__ partials) {
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const int64_t* first = table + 5 * static_cast<int64_t>(n_leaves);
  __shared__ double warp_sums[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int i = leaf_of(first, n_leaves, c);
    const float* g = leaves[i].g;
    const int64_t start = (c - first[i]) * kChunk;
    const int count = chunk_count(leaves[i].n, start);
    g += start;
    double acc = 0.0;
    int head = 0;
    if ((reinterpret_cast<uintptr_t>(g) & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      const int vecs = count >> 2;
      for (int k = threadIdx.x; k < vecs; k += kThreads) {
        const float4 x = __ldcs(g4 + k);
        acc += sq(x.x);
        acc += sq(x.y);
        acc += sq(x.z);
        acc += sq(x.w);
      }
      head = vecs << 2;
    }
    for (int k = head + threadIdx.x; k < count; k += kThreads) {
      acc += sq(__ldcs(g + k));
    }
    acc = warp_sum(acc);
    if (lane == 0) warp_sums[warp] = acc;
    __syncthreads();
    if (threadIdx.x == 0) {
      double s = 0.0;
      for (int w = 0; w < kWarps; ++w) s += warp_sums[w];
      partials[c] = s;
    }
    __syncthreads();
  }
}

// Pass 1's second launch: each leaf's partials added in order, one warp a
// leaf; an empty leaf reads 0.
__global__ void __launch_bounds__(kThreads)
adamw_leaf_sums(const int64_t* __restrict__ table, int n_leaves,
                const double* __restrict__ partials, float* __restrict__ out) {
  const int64_t* first = table + 5 * static_cast<int64_t>(n_leaves);
  const int leaf = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (leaf >= n_leaves) return;   // the whole warp
  double s = 0.0;
  for (int64_t c = first[leaf] + lane; c < first[leaf + 1]; c += 32) {
    s += partials[c];
  }
  s = warp_sum(s);
  if (lane == 0) out[leaf] = static_cast<float>(s);
}

// One element's update, each operation rounded to float32 (-fmad=false).
__device__ __forceinline__ void adamw_step(float g, float& p, float& m,
                                           float& v, float scale, float lr,
                                           float bc1, float bc2,
                                           const Hyper& h) {
  g = g * scale;
  m = h.b1 * m + h.c1 * g;
  v = h.b2 * v + h.c2 * (g * g);
  const float step = (m / bc1) / (sqrtf(v / bc2) + h.eps) + h.wd * p;
  p = p - lr * step;
}

// Pass 2: p, m and v updated in place.
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(const int64_t* __restrict__ table, int n_leaves,
                    int64_t n_chunks, const float* __restrict__ scalars,
                    Hyper h) {
  const Leaf* leaves = reinterpret_cast<const Leaf*>(table);
  const int64_t* first = table + 5 * static_cast<int64_t>(n_leaves);
  const float scale = scalars[0], lr = scalars[1];
  const float bc1 = scalars[2], bc2 = scalars[3];
  for (int64_t c = blockIdx.x; c < n_chunks; c += gridDim.x) {
    const int i = leaf_of(first, n_leaves, c);
    const Leaf leaf = leaves[i];
    const int64_t start = (c - first[i]) * kChunk;
    const int count = chunk_count(leaf.n, start);
    const float* g = leaf.g + start;
    float* p = leaf.p + start;
    float* m = leaf.m + start;
    float* v = leaf.v + start;
    int head = 0;
    const uintptr_t any = reinterpret_cast<uintptr_t>(g) |
                          reinterpret_cast<uintptr_t>(p) |
                          reinterpret_cast<uintptr_t>(m) |
                          reinterpret_cast<uintptr_t>(v);
    if ((any & 15) == 0) {
      const float4* g4 = reinterpret_cast<const float4*>(g);
      float4* p4 = reinterpret_cast<float4*>(p);
      float4* m4 = reinterpret_cast<float4*>(m);
      float4* v4 = reinterpret_cast<float4*>(v);
      const int vecs = count >> 2;
      for (int k = threadIdx.x; k < vecs; k += kThreads) {
        const float4 gk = __ldcs(g4 + k);
        float4 pk = __ldcs(p4 + k), mk = __ldcs(m4 + k), vk = __ldcs(v4 + k);
        adamw_step(gk.x, pk.x, mk.x, vk.x, scale, lr, bc1, bc2, h);
        adamw_step(gk.y, pk.y, mk.y, vk.y, scale, lr, bc1, bc2, h);
        adamw_step(gk.z, pk.z, mk.z, vk.z, scale, lr, bc1, bc2, h);
        adamw_step(gk.w, pk.w, mk.w, vk.w, scale, lr, bc1, bc2, h);
        __stcs(p4 + k, pk);
        __stcs(m4 + k, mk);
        __stcs(v4 + k, vk);
      }
      head = vecs << 2;
    }
    for (int k = head + threadIdx.x; k < count; k += kThreads) {
      float pk = p[k], mk = m[k], vk = v[k];
      adamw_step(g[k], pk, mk, vk, scale, lr, bc1, bc2, h);
      p[k] = pk;
      m[k] = mk;
      v[k] = vk;
    }
  }
}

// Blocks of a persistent grid over n_chunks chunks on the current device.
cudaError_t grid_for(int64_t n_chunks, unsigned int* grid) {
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int64_t most = static_cast<int64_t>(sms) * kBlocksPerSm;
  *grid = static_cast<unsigned int>(n_chunks < most ? n_chunks : most);
  return cudaSuccess;
}

}  // namespace

// Elements a chunk; the wrapper builds its table with the same number.
extern "C" int64_t adamw_chunk_elements() { return kChunk; }

// Per-leaf sums of squares of g into out[n_leaves] (float32): two launches.
// table: n_leaves Leaf records (p, m and v unused) then n_leaves + 1 chunk
// prefixes, first[n_leaves] == n_chunks > 0; partials: n_chunks doubles.
extern "C" int adamw_sq_norms_launch(const void* table, int n_leaves,
                                     int64_t n_chunks, void* partials,
                                     void* out, void* stream) {
  unsigned int grid = 0;
  cudaError_t err = grid_for(n_chunks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int64_t* t = static_cast<const int64_t*>(table);
  adamw_sq_partials<<<grid, kThreads, 0, s>>>(t, n_leaves, n_chunks, static_cast<double*>(partials));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned int blocks = static_cast<unsigned int>((n_leaves + kWarps - 1) / kWarps);
  adamw_leaf_sums<<<blocks, kThreads, 0, s>>>(t, n_leaves, static_cast<const double*>(partials), static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// The update of every leaf in place: one launch.  scalars: float32 [4]
// (clip scale, lr, 1 - b1^t, 1 - b2^t) on the device.
extern "C" int adamw_update_launch(const void* table, int n_leaves,
                                   int64_t n_chunks, const void* scalars,
                                   float b1, float b2, float c1, float c2,
                                   float eps, float wd, void* stream) {
  unsigned int grid = 0;
  const cudaError_t err = grid_for(n_chunks, &grid);
  if (err != cudaSuccess) return static_cast<int>(err);
  const Hyper h{b1, b2, c1, c2, eps, wd};
  adamw_update_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(static_cast<const int64_t*>(table), n_leaves, n_chunks, static_cast<const float*>(scalars), h);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* adamw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
