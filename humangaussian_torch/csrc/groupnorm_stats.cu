// GroupNorm backward sums for Hopper (sm_90a): kernel K5 of
// ops/groupnorm.py.
//
// Replaces humangaussian_tpu/ops/groupnorm.py::_bwd_stats_kernel (:102).
// Activations are channel-minor, x[N, R, C] (R = H*W rows of C channels),
// bf16 or f32. For every (sample, channel):
//
//   out[n, 0, c] = sum_r dy         out[n, 1, c] = sum_r dy * xhat
//   xhat = (x - mu[n, c]) * rstd[n, c], the forward's group mean and rstd
//          formed from its sums (groupnorm_group.cuh)
//   dy   = dz                                 (no activation)
//   dy   = dz * sig * (1 + y * (1 - sig))     (SiLU fused), with
//          y = xhat * gamma + beta, sig = 1 / (1 + exp(-y))
//
// all accumulated in f32. The dx pass of the backward is K5a
// (groupnorm_bwd_dx.cu); the forward's sums come from groupnorm_fwd.cu.
//
// Bound by bytes. An H100 does about 20 f32 operations in the time it moves
// one byte (67 TFLOP/s over 3.35 TB/s); the backward with SiLU does about
// 25 and one exp on the 4 bytes of an (x, dz) pair, under the line, so the
// design is about reading each element once, in full lines, from enough
// blocks, with enough bytes in flight.
//
// Design. The work is cut into sums tiles of (sample, 64 channels, row
// split), walked by one cooperative launch of persistent blocks, two an SM
// (every block resident, so a block may wait on others). A tile's block
// first forms the mean and rstd of the groups its 64 channels touch from
// the forward's sums (one warp a group, group_moments: the forward's
// values bit for bit), so the backward launches no torch code for them;
// per-channel mu, rstd, gamma and beta then sit in registers. A thread owns
// 8 bf16 (or 4 f32) neighbouring channels and loads them as one 16-byte
// vector; the 256 threads of a block are 8 (16) across the 64 channels and
// 32 (16) rows deep, and each thread issues the loads of 4 rows of x and 4
// of dz, 8 independent 16-byte loads, before it uses any. With the
// accurate exp and division the SiLU path was bound by issue slots, so it
// takes the fast ones (silu_grad). A channel count that the vector width
// does not divide, or a pointer off 16 bytes, takes the same loop one
// channel a thread (64 across, 4 rows deep).
//
// Every sum has a fixed order, so a launch repeats bit for bit (as the
// reference, whose grid steps add into their output block in order):
// - a thread adds its rows one after another (every 32nd, 16th or 4th row
//   of the split);
// - the block's row lanes meet in shared memory and one thread per (sum,
//   channel) adds them lane by lane, in order, into the tile's partial,
//   which goes to a scratch buffer [N, splits, 2, C] with a plain store;
// - a finish tile per (sample, 64 channels) waits for its splits' flags
//   (groupnorm_sync.cuh: the launch's epoch, no memset) and adds the
//   partials split by split, in order, into the [N, 2, C] output; with one
//   split a sums tile writes the output itself and no finish tile runs
//   (with one, [24, 64, 2560], 64 rows a sample, took 1.7x the atomics
//   design's time).
// No atomics and no zero-fill: the output is written once, so the op's
// backward can be captured in a CUDA graph. The host (ops/groupnorm.py,
// `_bwd_launch`) picks the row splits, as few as keep the blocks 90% busy
// over whole rounds of tiles (at [24, 4096, 320] two: 240 tiles on 264
// blocks), and the kernel checks what it is given. Before this design the
// tiles were blocks of a grid that added their sums into a zeroed output
// with atomicAdd, after a cudaMemsetAsync and an occupancy query each call;
// with more than one split the sums differed from run to run in the last
// bits.
//
// Redesigned once before that. Its first version loaded 4 bytes of x and
// of dz a thread per row with one row in flight a warp, so a thread kept
// two small loads outstanding and the kernel reached 43% of its bytes bound
// at [24, 4096, 320].
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "groupnorm_group.cuh"
#include "groupnorm_sync.cuh"

namespace {

constexpr int kChannelsPerBlock = 64;

__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }

// The SiLU derivative with the fast exp and division (about 2 ulp each):
// with the accurate ones the SiLU path was bound by issue slots, not bytes;
// the sums stay far inside the 1e-5 of their magnitude they are held to.
__device__ __forceinline__ float silu_grad(float dz, float y) {
  const float sig = __fdividef(1.0f, 1.0f + __expf(-y));
  return dz * sig * (1.0f + y * (1.0f - sig));
}

constexpr int kBwdThreads = 256;
constexpr int kBwdUnroll = 4;  // rows a thread loads before it uses them

// kWidth neighbouring channels of one row: one 16-byte load, or one
// element when kWidth is 1.
template <typename T, int kWidth>
struct Pack {
  static_assert(kWidth == 1 || sizeof(T) * kWidth == 16, "16-byte packs");
  using Raw = typename std::conditional<kWidth == 1, T, uint4>::type;
  Raw raw;
  __device__ __forceinline__ void load(const T* p) {
    raw = *reinterpret_cast<const Raw*>(p);
  }
  __device__ __forceinline__ float get(int e) const {
    return load1(reinterpret_cast<const T*>(&raw) + e);
  }
};

// The launch's shape: its tiles are (sample, channel block, row split),
// split fastest.
struct Shape {
  int samples, rows, channels, groups;
  int channel_blocks;  // 64 channels each (the last may be narrower)
  int splits, rows_per_split;
};

// One sums tile: partials[n, split, 0/1, the block's 64 channels] over the
// split's rows (with one split, out[n, 0/1, those channels]).
template <typename T, int kWidth, bool kSilu>
__device__ void sums_tile(const T* __restrict__ x, const T* __restrict__ dz,
                          const float* __restrict__ fwd_sums,
                          const float* __restrict__ gamma,
                          const float* __restrict__ beta, float eps,
                          const Shape& g, int n, int cblock, int split,
                          float* __restrict__ out,
                          float* __restrict__ partials) {
  // kTy rows deep, kBwdUnroll rows a thread: kTy * kBwdUnroll rows a step
  constexpr int kTx = kChannelsPerBlock / kWidth;  // threads across
  constexpr int kTy = kBwdThreads / kTx;            // rows deep
  __shared__ float part[kTy][2][kChannelsPerBlock];
  __shared__ float t_mu[kChannelsPerBlock], t_rs[kChannelsPerBlock];
  const int rows = g.rows, channels = g.channels;
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int cb = cblock * kChannelsPerBlock;
  const int c0 = cb + tx * kWidth;  // kWidth divides C: all in or all out
  const int r_begin = split * g.rows_per_split;
  const int r_end = min(rows, r_begin + g.rows_per_split);

  // the mean and rstd of the groups this block's channels touch
  {
    const int cg = channels / g.groups;
    const int c_last = min(channels, cb + kChannelsPerBlock) - 1;
    const float* s1 = fwd_sums + (size_t)n * 2 * channels;
    const float m = static_cast<float>(rows) * static_cast<float>(cg);
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    for (int gr = cb / cg + warp; gr <= c_last / cg;
         gr += kBwdThreads / 32) {
      float mean, rstd;
      group_moments(s1, s1 + channels, gr * cg, (gr + 1) * cg, m, eps, mean,
                    rstd);
      for (int c = max(gr * cg, cb) + lane; c < min((gr + 1) * cg, c_last + 1);
           c += 32) {
        t_mu[c - cb] = mean;
        t_rs[c - cb] = rstd;
      }
    }
  }
  __syncthreads();

  float s1[kWidth], s2[kWidth];
#pragma unroll
  for (int e = 0; e < kWidth; ++e) s1[e] = s2[e] = 0.0f;
  if (c0 < channels) {
    float m[kWidth], rs[kWidth], gm[kWidth], bt[kWidth];
#pragma unroll
    for (int e = 0; e < kWidth; ++e) {
      m[e] = t_mu[c0 - cb + e];
      rs[e] = t_rs[c0 - cb + e];
      gm[e] = gamma[c0 + e];
      bt[e] = beta[c0 + e];
    }
    const size_t base = (size_t)n * rows * channels + c0;
    const T* xb = x + base;
    const T* db = dz + base;
    for (int r = r_begin + ty; r < r_end; r += kTy * kBwdUnroll) {
      Pack<T, kWidth> xv[kBwdUnroll], dv[kBwdUnroll];
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        const int row = r + u * kTy;
        if (row < r_end) {
          xv[u].load(xb + (size_t)row * channels);
          dv[u].load(db + (size_t)row * channels);
        }
      }
#pragma unroll
      for (int u = 0; u < kBwdUnroll; ++u) {
        if (r + u * kTy < r_end) {
#pragma unroll
          for (int e = 0; e < kWidth; ++e) {
            const float xh = (xv[u].get(e) - m[e]) * rs[e];
            const float dy =
                kSilu ? silu_grad(dv[u].get(e), xh * gm[e] + bt[e])
                      : dv[u].get(e);
            s1[e] += dy;
            s2[e] += dy * xh;
          }
        }
      }
    }
  }
  // the block's kTy row lanes per (sum, channel) meet in shared memory
#pragma unroll
  for (int e = 0; e < kWidth; ++e) {
    part[ty][0][tx * kWidth + e] = s1[e];
    part[ty][1][tx * kWidth + e] = s2[e];
  }
  __syncthreads();
  // one split: the tile's sums are the output
  float* dst = g.splits == 1
                   ? out + (size_t)n * 2 * channels
                   : partials + ((size_t)n * g.splits + split) * 2 * channels;
  const int t = threadIdx.x;
  if (t < 2 * kChannelsPerBlock) {
    const int which = t / kChannelsPerBlock, ch = t % kChannelsPerBlock;
    if (cb + ch < channels) {
      float s = 0.0f;
#pragma unroll
      for (int y = 0; y < kTy; ++y) s += part[y][which][ch];
      dst[(size_t)which * channels + cb + ch] = s;
    }
  }
}

// One finish tile: out[n, 0/1, the block's 64 channels] = the partials of
// the (sample, channel block)'s splits added in split order, one thread a
// sum, 8 loads in flight.
__device__ void finish_tile(const Shape& g, const float* __restrict__ partials,
                            int n, int cblock, float* __restrict__ out) {
  const int t = threadIdx.x;
  const int c = cblock * kChannelsPerBlock + t % kChannelsPerBlock;
  if (t >= 2 * kChannelsPerBlock || c >= g.channels) return;
  const int which = t / kChannelsPerBlock, S = g.splits;
  const size_t stride = 2 * (size_t)g.channels;
  const float* src = partials + (size_t)n * S * stride
                     + (size_t)which * g.channels + c;
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
  out[((size_t)n * 2 + which) * g.channels + c] = v;
}

// Block b of P takes sums tiles b, b + P, ..., publishing each, then the
// finish tiles, which start half the grid away (at the blocks that took no
// sums tile in the last round).
template <typename T, int kWidth, bool kSilu>
__global__ void __launch_bounds__(kBwdThreads, 2)
groupnorm_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                           const float* __restrict__ fwd_sums,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, float eps,
                           Shape g, float* __restrict__ out,
                           float* __restrict__ partials, unsigned* sync) {
  // sync: [generation, arrive[P], sums flags] (groupnorm_sync.cuh)
  const unsigned epoch = begin_launch(sync);
  const int P = gridDim.x, b = blockIdx.x;
  unsigned* flags = sync + 1 + P;
  const int nbc = g.channel_blocks, S = g.splits;
  const int tiles = g.samples * nbc * S;
  for (int i = b; i < tiles; i += P) {
    sums_tile<T, kWidth, kSilu>(x, dz, fwd_sums, gamma, beta, eps, g,
                                i / (nbc * S), (i / S) % nbc, i % S, out,
                                partials);
    publish(flags + i, epoch);
  }
  for (int i = (b + P - P / 2) % P; S > 1 && i < g.samples * nbc; i += P) {
    wait_flags(flags + (size_t)i * S, S, epoch);
    finish_tile(g, partials, i / nbc, i % nbc, out);
  }
  end_launch(sync, epoch);
}

template <typename T, int kWidth, bool kSilu>
cudaError_t launch(const void* x, const void* dz, const float* fwd_sums,
                   const float* gamma, const float* beta, float eps,
                   const Shape& g, int blocks, float* out, float* partials,
                   unsigned* sync, cudaStream_t stream) {
  auto kernel = groupnorm_bwd_stats_kernel<T, kWidth, kSilu>;
  const T* xp = static_cast<const T*>(x);
  const T* dp = static_cast<const T*>(dz);
  Shape shape = g;
  void* args[] = {&xp,    &dp,  &fwd_sums, &gamma,    &beta,
                  &eps,   &shape, &out,    &partials, &sync};
  return cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                     dim3(blocks), dim3(kBwdThreads), args,
                                     0, stream);
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// `is_bf16` selects the activation type (bf16, else f32); x and dz are
// [N, R, C], the forward's sums and `out` [N, 2, C] f32, gamma and beta
// [C] f32, with channels a multiple of groups. The host's numbers: row
// `splits` per (sample, 64 channels) (1 to R), persistent `blocks` (at most
// two an SM), `vector` for 16-byte vectors (C a multiple of the width, x
// and dz 16-byte aligned). Scratch: `partials` [N, splits, 2, C] f32
// (`partial_floats` long) and `sync`, `sync_words` 32-bit words (at least
// 1 + blocks + N * ceil(C / 64) * splits) that persist between launches on
// one stream (zeroed when allocated; groupnorm_sync.cuh). Writes every
// element of `out`, launches on `stream` (cooperatively), does not
// synchronize, and returns the launch's error (0 = launched) or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int hg_groupnorm_bwd_stats(const void* x, const void* dz,
                                      const void* fwd_sums, const void* gamma,
                                      const void* beta, int samples, int rows,
                                      int channels, int groups, float eps,
                                      int is_bf16, int silu, int splits,
                                      int blocks, int vector, void* out,
                                      void* partials,
                                      long long partial_floats, void* sync,
                                      long long sync_words, void* stream) {
  const int width = vector ? (is_bf16 ? 8 : 4) : 1;
  if (samples <= 0 || rows <= 0 || channels <= 0 || groups <= 0
      || channels % groups || channels % width || splits <= 0
      || splits > rows || blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (vector && (reinterpret_cast<uintptr_t>(x) % 16
                 || reinterpret_cast<uintptr_t>(dz) % 16))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape g;
  g.samples = samples;
  g.rows = rows;
  g.channels = channels;
  g.groups = groups;
  g.channel_blocks = (channels + kChannelsPerBlock - 1) / kChannelsPerBlock;
  g.splits = splits;
  g.rows_per_split = (rows + splits - 1) / splits;
  const long long tiles =
      static_cast<long long>(samples) * g.channel_blocks * splits;
  if (tiles > (1ll << 30) || sync_words < 1 + blocks + tiles
      || partial_floats < static_cast<long long>(samples) * splits * 2
                              * channels)
    return static_cast<int>(cudaErrorInvalidValue);
  const float* fs = static_cast<const float*>(fwd_sums);
  const float* gm = static_cast<const float*>(gamma);
  const float* bt = static_cast<const float*>(beta);
  float* o = static_cast<float*>(out);
  float* pp = static_cast<float*>(partials);
  unsigned* sy = static_cast<unsigned*>(sync);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc;
#define HG_LAUNCH(T, W)                                                      \
  rc = silu ? launch<T, W, true>(x, dz, fs, gm, bt, eps, g, blocks, o, pp,   \
                                 sy, s)                                      \
            : launch<T, W, false>(x, dz, fs, gm, bt, eps, g, blocks, o, pp,  \
                                  sy, s)
  if (is_bf16) {
    if (vector) HG_LAUNCH(__nv_bfloat16, 8);
    else HG_LAUNCH(__nv_bfloat16, 1);
  } else {
    if (vector) HG_LAUNCH(float, 4);
    else HG_LAUNCH(float, 1);
  }
#undef HG_LAUNCH
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(cudaGetLastError());
}
