// GroupNorm(+SiLU) forward for Hopper (sm_90a): the sums (K3) and the
// normalize pass (K3a) of ops/groupnorm.py as one persistent launch, and
// the same kernel template in a sums-only and a normalize-only mode.
//
// Replaces humangaussian_tpu/ops/groupnorm.py::_fwd_stats_kernel (:70,
// launched by _fwd_stats :86) and the elementwise XLA code that follows
// it in _gn_fwd (:190, lines :206-213, with _group_stats :153-165). For
// x[N, R, C] (channel-minor, bf16 or f32), gamma, beta [C] f32:
//
//   sums[n, 0, c] = sum_r x,  sums[n, 1, c] = sum_r x^2          (f32)
//   per (n, group of C / G channels), m = R C / G:
//     mean = sum_g / m,  var = max(sumsq_g / m - mean^2, 0),
//     rstd = 1 / sqrt(var + eps)                 (groupnorm_group.cuh)
//   per (n, c):  a = gamma rstd,  b = beta - (mean gamma) rstd
//   y = x a + b,  then y sigmoid(y) when SiLU is fused,  cast to x's type.
//
// Bound by bytes: the work needs x read once and y written once (2 x 63 MB
// at [24, 4096, 320] bf16, 0.0376 ms at 3.35 TB/s); about 13 f32
// operations and one exp per element stay under the card's 20 operations
// per byte. The old design was K3, a zero-fill and K3a, three launches, K3
// with one 4-byte load a thread per row and its partial sums meeting
// through atomicAdd. This one:
//
// - One cooperative launch of three blocks an SM (every block resident, so
//   a block may wait on others without deadlock) walks two kinds of tile,
//   sums and normalize, with flags between them: no zero-fill, no
//   atomics, one launch instead of three. (Three blocks of 256 threads an
//   SM with 8 rows in flight a thread measured faster than two or four
//   blocks, or 4 rows; the few registers that spill at three cost less.)
// - Sums tiles: (sample, channel block, row split). A thread owns 16 bytes
//   of neighbouring channels (8 bf16 or 4 f32) and issues the loads of 8
//   rows before it uses any (K5's recipe); the block's rows meet
//   through warp shuffles and shared memory in a fixed order and go to a
//   scratch buffer of per-split partials, [N, splits, 2, C]. The host picks
//   the widths and the splits (ops/groupnorm.py): blocks 32 to 64 vectors
//   wide, the width that leaves the fewest threads idle, and the splits as
//   few as keep the blocks 95% busy; the kernel checks what it is given.
// - Normalize tiles: the block's sums tiles again. A block first issues
//   the loads of its first 8 rows of x, then waits for the sums tiles of
//   its groups' channels and adds their partials over the splits in a
//   fixed order into shared memory (every tile that adds a channel gets
//   the same bits; the tile of split 0 writes its channels' to the [N, 2,
//   C] sums that the backward, K5 and K5a, reads: bit-equal from run to
//   run). It forms each group's mean and rstd with group_moments (so K5
//   and K5a, which call it on the same sums, see the forward's values bit
//   for bit) and its channels' (a, b) in registers with K3a's arithmetic,
//   then streams its rows 8 vectors in flight a thread, without a modulo
//   per vector, y with streaming (evict-first) stores. (A separate combine
//   step before the normalize tiles cost one more wait.) The sums-only
//   mode (K3) ends with one finish tile a (sample, channel block) that
//   adds the partials the same way.
// - The second read of x was meant to come from L2. Whether it does is not
//   known: no L2 hit rate was read (PERF.md §7). At the VAE's large shapes
//   the launch takes about as long as the sums-only and the normalize-only
//   modes one after the other, which fits a read from device memory; at
//   the small shapes all three are bound by latency. A walk in L2-sized
//   stages (each stage summing a third of the L2's worth of x while it
//   normalizes the stage before) measured slower at every shape and was
//   taken out, so one launch walks the whole tensor.
// - Readiness without memsets: a tile publishes its work by storing the
//   launch's epoch into its flag (release), waiters compare with that
//   epoch (acquire). The epoch is one more than a generation word in the
//   same buffer, which block 0 advances at the end, once every block has
//   read it (groupnorm_sync.cuh, shared with K5); so eager launches on one
//   stream share one buffer that is never reset. Under stream capture the
//   wrapper gives each launch its own words, zeroed in the graph.
//
// A channel count that the vector width does not divide, or a pointer off
// 16 bytes, takes the same tiles one channel a thread.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "groupnorm_group.cuh"
#include "groupnorm_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;           // rows a thread loads before it uses them
constexpr int kMaxBlockVectors = 64;  // vectors across a channel block
constexpr int kWarps = kThreads / 32;

enum Mode { kFused = 0, kSumsOnly = 1, kApplyOnly = 2 };

// The launch's shape (geometry()).
struct Geometry {
  int samples, rows, channels, groups;
  int vectors;         // channels / width
  int channel_blocks;  // channel blocks across C
  int block_vectors;   // vectors across a channel block (the last may be narrower)
  int deep;            // rows a block covers at once: kThreads / block_vectors
  int splits;          // row splits per (sample, channel block)
  int rows_per_split;
  int sums_tiles;      // samples * channel_blocks * splits, one flag each
};

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// kWidth neighbouring channels of one row: one 16-byte vector, or one
// element when kWidth is 1.
template <typename T, int kWidth>
struct Pack {
  static_assert(kWidth == 1 || sizeof(T) * kWidth == 16, "16-byte packs");
  using Raw = typename std::conditional<kWidth == 1, T, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ void store_streaming(T* p) const {
    if constexpr (kWidth == 1) {
      *p = raw;
    } else {
      __stcs(reinterpret_cast<uint4*>(p), raw);
    }
  }
  __device__ __forceinline__ float get(int e) const {
    return to_f32(reinterpret_cast<const T*>(&raw)[e]);
  }
  __device__ __forceinline__ void set(int e, float v) {
    from_f32(v, reinterpret_cast<T*>(&raw) + e);
  }
};

// K3a's normalize arithmetic (no contraction into fused multiply-adds).
template <bool kSilu>
__device__ __forceinline__ float apply(float x, float a, float b) {
  float y = __fadd_rn(__fmul_rn(x, a), b);
  if (kSilu) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-y))));
  return y;
}

// A channel block: channels [c_lo, c_lo + vectors * kWidth).
struct Block {
  int c_lo, vectors;
};

template <int kWidth>
__device__ __forceinline__ Block channel_block(const Geometry& g, int cb) {
  Block b;
  const int v0 = cb * g.block_vectors;
  b.vectors = min(g.block_vectors, g.vectors - v0);
  b.c_lo = v0 * kWidth;
  return b;
}

// Sums tile: partials[n, split, 0/1, block's channels] over the split's rows.
template <typename T, int kWidth>
__device__ void sums_tile(const T* __restrict__ x, const Geometry& g, int n,
                          int cb, int split, float* __restrict__ partials,
                          float* smem) {
  const Block blk = channel_block<kWidth>(g, cb);
  const int cbv = g.block_vectors;
  const int t = threadIdx.x, tx = t % cbv, ty = t / cbv;
  const int r0 = split * g.rows_per_split;
  const int r1 = min(g.rows, r0 + g.rows_per_split);
  float s1[kWidth], s2[kWidth];
#pragma unroll
  for (int e = 0; e < kWidth; ++e) s1[e] = s2[e] = 0.0f;
  if (ty < g.deep && tx < blk.vectors) {
    const T* p = x + (size_t)n * g.rows * g.channels + blk.c_lo + tx * kWidth;
    const int step = g.deep;
    for (int r = r0 + ty; r < r1; r += step * kUnroll) {
      Pack<T, kWidth> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * step;
        if (row < r1) v[u].load(p + (size_t)row * g.channels);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (r + u * step < r1) {
#pragma unroll
          for (int e = 0; e < kWidth; ++e) {
            const float f = v[u].get(e);
            s1[e] += f;
            s2[e] += f * f;
          }
        }
      }
    }
  }
  // rows meet in a fixed order: first the lanes of a warp that share tx
  // (a power-of-two block narrower than a warp), then the block's slots
  // in shared memory, slot by slot
  int slots = g.deep;
  if (cbv <= 32) {
    for (int off = cbv; off < 32; off <<= 1) {
#pragma unroll
      for (int e = 0; e < kWidth; ++e) {
        s1[e] += __shfl_xor_sync(0xffffffffu, s1[e], off);
        s2[e] += __shfl_xor_sync(0xffffffffu, s2[e], off);
      }
    }
    slots = kWarps;
  }
  const int lane = t % 32, warp = t / 32;
  const bool writes = cbv <= 32 ? lane < cbv : ty < g.deep;
  const int slot = cbv <= 32 ? warp * cbv + lane : t;  // (row, tx) row-major
  if (writes) {
#pragma unroll
    for (int e = 0; e < kWidth; ++e) {
      smem[slot * 2 * kWidth + e] = s1[e];
      smem[slot * 2 * kWidth + kWidth + e] = s2[e];
    }
  }
  __syncthreads();
  const int width = blk.vectors * kWidth;
  float* out = partials + ((size_t)n * g.splits + split) * 2 * g.channels
               + blk.c_lo;
  for (int i = t; i < 2 * width; i += kThreads) {
    const int w = i / width, j = i % width;
    const int jx = j / kWidth, e = j % kWidth;
    float acc = 0.0f;
    for (int y = 0; y < slots; ++y)
      acc += smem[(y * cbv + jx) * 2 * kWidth + w * kWidth + e];
    out[(size_t)w * g.channels + j] = acc;
  }
}

// out[w * width + j] = the partials of channel c_lo + j, sum w, added over
// the splits in order (one thread a sum, its loads in flight 8 at a time):
// every tile that gathers a channel gets the same bits.
__device__ void gather_sums(const Geometry& g,
                            const float* __restrict__ partials, int n,
                            int c_lo, int width, float* out) {
  const int S = g.splits;
  const size_t stride = 2 * (size_t)g.channels;
  for (int i = threadIdx.x; i < 2 * width; i += kThreads) {
    const int w = i / width, j = i % width;
    const float* src = partials + (size_t)n * S * stride
                       + (size_t)w * g.channels + c_lo + j;
    float v = 0.0f;
    int s = 0;
    for (; s + 8 <= S; s += 8) {
      float r[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) r[k] = __ldcg(src + (s + k) * stride);
#pragma unroll
      for (int k = 0; k < 8; ++k) v += r[k];
    }
    for (; s < S; ++s) v += __ldcg(src + s * stride);
    out[i] = v;
  }
}

// Normalize tile: y over the split's rows of the block's channels. The
// sums of the groups its channels touch come from `partials` (the fused
// forward: the tile adds them up itself once `wait_count` flags at `wait`
// hold `epoch`, and the tile of split 0 writes its own channels' to
// `sums_out`) or, without partials, from `sums_in`. The tile's first rows
// of x are loaded before the wait, so that the wait and the statistics
// hide behind those loads.
template <typename T, int kWidth, bool kSilu>
__device__ void normalize_tile(const T* __restrict__ x,
                               const float* __restrict__ sums_in,
                               const float* __restrict__ partials,
                               float* __restrict__ sums_out,
                               const float* __restrict__ gamma,
                               const float* __restrict__ beta, float eps,
                               const Geometry& g, int n, int cb, int split,
                               T* __restrict__ y, float* smem,
                               const unsigned* wait, int wait_count,
                               unsigned epoch) {
  const Block blk = channel_block<kWidth>(g, cb);
  const int cbv = g.block_vectors;
  const int t = threadIdx.x, tx = t % cbv, ty = t / cbv;
  const bool active = ty < g.deep && tx < blk.vectors;
  const int c0 = blk.c_lo + tx * kWidth;
  const size_t base = (size_t)n * g.rows * g.channels + c0;
  const T* xs = x + base;
  T* ys = y + base;
  const int r0 = split * g.rows_per_split;
  const int r1 = min(g.rows, r0 + g.rows_per_split);
  const int step = g.deep;
  int r = r0 + ty;
  Pack<T, kWidth> v[kUnroll];
  if (active) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int row = r + u * step;
      if (row < r1) v[u].load(xs + (size_t)row * g.channels);
    }
  }
  if (wait_count > 0) wait_flags(wait, wait_count, epoch);

  const int cg = g.channels / g.groups;
  const int g0 = blk.c_lo / cg;
  const int g1 = (blk.c_lo + blk.vectors * kWidth - 1) / cg + 1;
  const int span = (g1 - g0) * cg;  // channels of the groups touched
  float* sm1 = smem;
  float* sm2 = smem + span;
  float* gmean = smem + 2 * span;
  float* grstd = gmean + (g1 - g0);
  if (partials != nullptr) {
    gather_sums(g, partials, n, g0 * cg, span, smem);
    __syncthreads();
    if (split == 0) {
      const int width = blk.vectors * kWidth, off = blk.c_lo - g0 * cg;
      for (int i = t; i < 2 * width; i += kThreads) {
        const int w = i / width, j = i % width;
        sums_out[((size_t)n * 2 + w) * g.channels + blk.c_lo + j] =
            smem[w * span + off + j];
      }
    }
  } else {
    const float* src = sums_in + (size_t)n * 2 * g.channels + g0 * cg;
    for (int i = t; i < 2 * span; i += kThreads)
      smem[i] = src[i < span ? i : g.channels + i - span];
    __syncthreads();
  }
  const float m = static_cast<float>(g.rows) * static_cast<float>(cg);
  const int lane = t % 32, warp = t / 32;
  for (int gi = warp; gi < g1 - g0; gi += kWarps) {
    float mean, rstd;
    group_moments(sm1 + gi * cg, sm2 + gi * cg, 0, cg, m, eps, mean, rstd);
    if (lane == 0) {
      gmean[gi] = mean;
      grstd[gi] = rstd;
    }
  }
  __syncthreads();

  if (active) {
    float a[kWidth], b[kWidth];
#pragma unroll
    for (int e = 0; e < kWidth; ++e) {
      const int gi = (c0 + e) / cg - g0;
      const float mean = gmean[gi], rstd = grstd[gi];
      const float gm = gamma[c0 + e];
      a[e] = __fmul_rn(gm, rstd);
      b[e] = __fsub_rn(beta[c0 + e], __fmul_rn(__fmul_rn(mean, gm), rstd));
    }
    for (bool first = true; r < r1; r += step * kUnroll, first = false) {
      if (!first) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int row = r + u * step;
          if (row < r1) v[u].load(xs + (size_t)row * g.channels);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int row = r + u * step;
        if (row < r1) {
#pragma unroll
          for (int e = 0; e < kWidth; ++e)
            v[u].set(e, apply<kSilu>(v[u].get(e), a[e], b[e]));
          v[u].store_streaming(ys + (size_t)row * g.channels);
        }
      }
    }
  }
  __syncthreads();  // the next tile reuses shared memory
}

// Everything a tile loop needs: the kernel's arguments and where the flags
// live in the persistent buffer.
template <typename T>
struct Args {
  const T* x;
  const float* sums_in;
  const float* gamma;
  const float* beta;
  float eps;
  T* y;
  float* sums_out;
  float* partials;
  unsigned* sums_flags;  // one a sums tile, in tile order
  unsigned epoch;
};

// Tile i of a phase is (sample, channel block, row split), split fastest;
// block b of P takes tiles b, b + P, ...

// The sums tiles.
template <typename T, int kWidth>
__device__ void sums_tiles(const Geometry& g, const Args<T>& a, int b, int P,
                           float* smem) {
  const int nbc = g.channel_blocks, S = g.splits;
  for (int i = b; i < g.sums_tiles; i += P) {
    sums_tile<T, kWidth>(a.x, g, i / (nbc * S), (i / S) % nbc, i % S,
                         a.partials, smem);
    publish(a.sums_flags + i, a.epoch);
  }
}

// The normalize tiles (the same tiles as the sums tiles); with `fused`,
// each first waits for the sums tiles of every channel block its groups
// touch and adds their partials itself.
template <typename T, int kWidth, bool kSilu>
__device__ void normalize_tiles(const Geometry& g, const Args<T>& a, int b,
                                int P, float* smem, bool fused) {
  const int nbc = g.channel_blocks, S = g.splits;
  const int cg = g.channels / g.groups, bw = g.block_vectors * kWidth;
  for (int i = b; i < g.sums_tiles; i += P) {
    const int n = i / (nbc * S), cb = (i / S) % nbc, split = i % S;
    const unsigned* flags = nullptr;
    int count = 0;
    if (fused) {
      // the channels [lo, hi) of the groups this block's channels touch,
      // and the channel blocks that hold them
      const Block blk = channel_block<kWidth>(g, cb);
      const int lo = blk.c_lo / cg * cg;
      const int hi = ((blk.c_lo + blk.vectors * kWidth - 1) / cg + 1) * cg;
      const int first = lo / bw, last = (hi - 1) / bw;
      flags = a.sums_flags + ((size_t)n * nbc + first) * S;
      count = (last - first + 1) * S;
    }
    normalize_tile<T, kWidth, kSilu>(
        a.x, a.sums_in, fused ? a.partials : nullptr, a.sums_out, a.gamma,
        a.beta, a.eps, g, n, cb, split, a.y, smem, flags, count, a.epoch);
  }
}

// The finish tiles of the sums alone: one a (sample, channel block),
// adding the block's partials over the splits into `sums_out` once its
// sums tiles are done. They start half the grid away, at the blocks that
// took no sums tile in the last round.
template <typename T, int kWidth>
__device__ void finish_tiles(const Geometry& g, const Args<T>& a, int b,
                             int P, float* smem) {
  const int nbc = g.channel_blocks, S = g.splits;
  for (int i = (b + P - P / 2) % P; i < g.samples * nbc; i += P) {
    const int n = i / nbc;
    wait_flags(a.sums_flags + (size_t)i * S, S, a.epoch);
    const Block blk = channel_block<kWidth>(g, i % nbc);
    const int width = blk.vectors * kWidth;
    gather_sums(g, a.partials, n, blk.c_lo, width, smem);
    __syncthreads();
    for (int j = threadIdx.x; j < 2 * width; j += kThreads)
      a.sums_out[((size_t)n * 2 + j / width) * g.channels + blk.c_lo
                 + j % width] = smem[j];
    __syncthreads();
  }
}

template <typename T, int kWidth, bool kSilu, int kMode>
__global__ void __launch_bounds__(kThreads, 3)
groupnorm_fwd_kernel(const T* __restrict__ x,
                     const float* __restrict__ sums_in,
                     const float* __restrict__ gamma,
                     const float* __restrict__ beta, float eps, Geometry g,
                     T* __restrict__ y, float* __restrict__ sums_out,
                     float* __restrict__ partials, unsigned* sync) {
  extern __shared__ __align__(16) float smem[];
  constexpr bool kSums = kMode != kApplyOnly;
  const int P = gridDim.x, b = blockIdx.x;
  // sync: [generation, arrive[P], sums flags] (groupnorm_sync.cuh)
  const unsigned epoch = kSums ? begin_launch(sync) : 0u;
  Args<T> a;
  a.x = x;
  a.sums_in = sums_in;
  a.gamma = gamma;
  a.beta = beta;
  a.eps = eps;
  a.y = y;
  a.sums_out = sums_out;
  a.partials = partials;
  a.sums_flags = sync + 1 + P;
  a.epoch = epoch;

  if (kSums) sums_tiles<T, kWidth>(g, a, b, P, smem);
  if (kMode == kSumsOnly)
    finish_tiles<T, kWidth>(g, a, b, P, smem);
  else
    normalize_tiles<T, kWidth, kSilu>(g, a, b, P, smem, kMode == kFused);
  if (kSums) end_launch(sync, epoch);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

// The launch's shape from the host's choice of channel block
// (ops/groupnorm.py::fwd_block_vectors) and row splits; false for numbers
// the kernel does not take.
bool geometry(int samples, int rows, int channels, int groups,
              int block_vectors, int splits, int width, Geometry* g) {
  if (samples <= 0 || rows <= 0 || channels <= 0 || groups <= 0
      || channels % groups || channels % width || splits <= 0
      || splits > rows || block_vectors <= 0
      || block_vectors > kMaxBlockVectors
      // a block narrower than a warp meets its rows through shuffles
      || (block_vectors < 32 && (block_vectors & (block_vectors - 1))))
    return false;
  g->samples = samples;
  g->rows = rows;
  g->channels = channels;
  g->groups = groups;
  g->vectors = channels / width;
  g->block_vectors = block_vectors;
  g->channel_blocks = ceil_div(g->vectors, block_vectors);
  g->deep = kThreads / block_vectors;
  g->splits = splits;
  g->rows_per_split = ceil_div(rows, splits);
  const long long tiles =
      static_cast<long long>(samples) * g->channel_blocks * splits;
  if (tiles > (1ll << 30)) return false;
  g->sums_tiles = static_cast<int>(tiles);
  return true;
}

// Shared memory a block needs: the sums tiles' slots, a finish tile's
// sums, and the normalize tiles' group sums and moments.
size_t smem_bytes(const Geometry& g, int width) {
  const int cg = g.channels / g.groups;
  const int bw = g.block_vectors * width;
  // channels of the groups one channel block touches
  int span = ((bw + cg - 1) / cg + 1) * cg;
  if (span > g.channels) span = g.channels;
  const size_t normalize = (2 * (size_t)span + 2 * (span / cg + 1)) * 4;
  size_t bytes = (size_t)kThreads * 2 * width * 4;
  if ((size_t)2 * bw * 4 > bytes) bytes = (size_t)2 * bw * 4;
  if (normalize > bytes) bytes = normalize;
  return bytes;
}

template <typename T, int kWidth, bool kSilu, int kMode>
cudaError_t launch(const void* x, const void* sums_in, const void* gamma,
                   const void* beta, float eps, const Geometry& g, int blocks,
                   void* y, void* sums_out, void* partials, void* sync,
                   cudaStream_t stream) {
  auto kernel = groupnorm_fwd_kernel<T, kWidth, kSilu, kMode>;
  const size_t smem = smem_bytes(g, kWidth);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const T* xp = static_cast<const T*>(x);
  const float* sp = static_cast<const float*>(sums_in);
  const float* gp = static_cast<const float*>(gamma);
  const float* bp = static_cast<const float*>(beta);
  Geometry geo = g;
  T* yp = static_cast<T*>(y);
  float* so = static_cast<float*>(sums_out);
  float* pp = static_cast<float*>(partials);
  unsigned* sy = static_cast<unsigned*>(sync);
  void* args[] = {&xp, &sp, &gp, &bp, &eps, &geo, &yp, &so, &pp, &sy};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kThreads), args, smem,
                                     stream);
}

template <typename T, int kWidth>
cudaError_t dispatch(int mode, bool silu, const void* x, const void* sums_in,
                     const void* gamma, const void* beta, float eps,
                     const Geometry& g, int blocks, void* y, void* sums_out,
                     void* partials, void* sync, cudaStream_t stream) {
#define HG_LAUNCH(SILU, MODE)                                              \
  return launch<T, kWidth, SILU, MODE>(x, sums_in, gamma, beta, eps, g,    \
                                       blocks, y, sums_out, partials,      \
                                       sync, stream)
  if (mode == kSumsOnly) HG_LAUNCH(false, kSumsOnly);
  if (mode == kFused) {
    if (silu) HG_LAUNCH(true, kFused);
    HG_LAUNCH(false, kFused);
  }
  if (silu) HG_LAUNCH(true, kApplyOnly);
  HG_LAUNCH(false, kApplyOnly);
#undef HG_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes).
//
// hg_groupnorm_fwd: x and y [samples, rows, channels] contiguous device
// arrays of one type (`is_bf16`, else f32); gamma, beta [channels] f32;
// sums [samples, 2, channels] f32 (written in modes 0 and 1 as `sums_out`,
// read in mode 2 as `sums_in`). `mode`: 0 the fused forward (sums and y),
// 1 the sums alone, 2 y from given sums. The host's numbers: vectors
// across a channel block (1 to 64, a power of two below 32), row splits,
// persistent blocks (at most what the card holds resident), `vector` for
// 16-byte vectors. Scratch: `partials` [samples, splits, 2, channels] f32
// (`partial_floats` long) and `sync`, `sync_words` 32-bit words (at least
// 1 + blocks + samples * channel blocks * splits) that persist between
// launches on one stream (zeroed when allocated). Launches on `stream`
// (cooperatively), does not synchronize, and returns cudaGetLastError()
// (0 = launched) or cudaErrorInvalidValue for arguments it does not take.
extern "C" int hg_groupnorm_fwd(const void* x, const void* sums_in,
                                const void* gamma, const void* beta,
                                int samples, int rows, int channels,
                                int groups, float eps, int is_bf16, int silu,
                                int mode, int block_vectors, int splits,
                                int blocks, int vector, void* y,
                                void* sums_out, void* partials,
                                long long partial_floats, void* sync,
                                long long sync_words, void* stream) {
  const int width = vector ? (is_bf16 ? 8 : 4) : 1;
  Geometry g;
  if (mode < 0 || mode > 2 || blocks <= 0
      || !geometry(samples, rows, channels, groups, block_vectors, splits,
                   width, &g))
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && (reinterpret_cast<uintptr_t>(x) % 16
                 || (mode != kSumsOnly && reinterpret_cast<uintptr_t>(y) % 16)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (mode != kApplyOnly) {
    const long long words = 1 + blocks + static_cast<long long>(g.sums_tiles);
    const long long floats =
        static_cast<long long>(samples) * splits * 2 * channels;
    if (sync_words < words || partial_floats < floats)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
  if (is_bf16) {
    rc = vector ? dispatch<__nv_bfloat16, 8>(mode, silu != 0, x, sums_in,
                                             gamma, beta, eps, g, blocks, y,
                                             sums_out, partials, sync, st)
                : dispatch<__nv_bfloat16, 1>(mode, silu != 0, x, sums_in,
                                             gamma, beta, eps, g, blocks, y,
                                             sums_out, partials, sync, st);
  } else {
    rc = vector ? dispatch<float, 4>(mode, silu != 0, x, sums_in, gamma, beta,
                                     eps, g, blocks, y, sums_out, partials,
                                     sync, st)
                : dispatch<float, 1>(mode, silu != 0, x, sums_in, gamma, beta,
                                     eps, g, blocks, y, sums_out, partials,
                                     sync, st);
  }
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
