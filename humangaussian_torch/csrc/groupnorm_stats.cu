// GroupNorm statistics for Hopper (sm_90a): the forward sums (K3) and the
// backward sums (K5) of ops/groupnorm.py.
//
// Replaces humangaussian_tpu/ops/groupnorm.py::_fwd_stats_kernel (:70) and
// ::_bwd_stats_kernel (:102). Activations are channel-minor, x[N, R, C]
// (R = H*W rows of C channels), bf16 or f32. For every (sample, channel):
//
//   forward   out[n, 0, c] = sum_r x          out[n, 1, c] = sum_r x^2
//   backward  out[n, 0, c] = sum_r dy         out[n, 1, c] = sum_r dy * xhat
//             xhat = (x - mu[n, c]) * rstd[n, c], the forward's group
//             mean and rstd formed from its sums (groupnorm_group.cuh)
//             dy   = dz                                 (no activation)
//             dy   = dz * sig * (1 + y * (1 - sig))     (SiLU fused), with
//                    y = xhat * gamma + beta, sig = 1 / (1 + exp(-y))
//
// all accumulated in f32. The group combine and the normalize(+SiLU) pass
// of the forward are K3a (groupnorm_apply.cu), the dx pass of the backward
// K5a (groupnorm_bwd_dx.cu).
//
// Bound by bytes. An H100 does about 20 f32 operations in the time it moves
// one byte (67 TFLOP/s over 3.35 TB/s). The forward does 3 operations on each
// 2-byte element; the backward with SiLU about 25 and one exp on the 4 bytes
// of an (x, dz) pair. Both stay under the line, so the design is about
// reading each element once, in full lines, from enough blocks, with enough
// bytes in flight.
//
// Both kernels: blocks have no order here (the TPU kernel adds each grid
// step's sums into a revisited [2, C] output block), so a block takes 64
// channels of one sample and a slice of its rows, so that long rows at few
// channels ([24, 4096, 320]: 5 channel blocks x 24 samples) still fill the
// 132 SMs (K3: the wrapper aims at about a thousand blocks; K5: the entry
// point aims at whole waves of resident blocks). The block's partial sums meet in shared memory, and one thread
// per (sum, channel) adds the block's sum into the zeroed output with
// atomicAdd. With more than one slice per (sample, channel) the f32
// atomics add in no fixed order, so two launches on the same input may
// differ in the last bits (about 1e-7 of the sum); with one slice the
// result is deterministic.
//
// K3 (forward): a thread owns two neighbouring channels (one 4-byte bf16x2
// or 8-byte float2 load), a warp 64 channels, and the 8 warps of a block
// take every 8th row of the slice; an odd channel count takes scalar loads.
//
// K5 (backward), redesigned. Its first version had K3's shape: 4 bytes of x
// and of dz a thread per row and one row in flight a warp, so a thread kept
// two small loads outstanding and the kernel reached 43% of its bytes bound
// at [24, 4096, 320]. Now a thread owns 8 bf16 (or 4 f32) neighbouring
// channels and loads them as one 16-byte vector; the 256 threads of a block
// are 8 (16) across the 64 channels and 32 (16) rows deep, and each thread
// issues the loads of 4 rows of x and 4 of dz, 8 independent 16-byte loads,
// before it uses any. A block first forms the mean and rstd of the groups
// its 64 channels touch from the forward's sums (one warp a group, K3a's
// arithmetic: the forward's values bit for bit), so the backward launches
// no torch code for them; per-channel mu, rstd, gamma and beta then sit
// in registers. With the accurate exp and division the SiLU path was bound
// by issue slots, so it takes the fast ones (silu_grad). The entry point
// zeroes the output itself and sizes the row slices by the kernel's
// occupancy (at [24, 4096, 320] two slices: 240 blocks, under one wave at
// 2 blocks an SM, where the forward's split gives 1080 blocks, 4.1 waves
// with a short last one). A channel count that the vector width
// does not divide, or a pointer off 16 bytes, takes the same loop one
// channel a thread (64 across, 4 rows deep).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "groupnorm_group.cuh"

namespace {

constexpr int kLanes = 32;             // threads across channels (x2 channels)
constexpr int kRowsPerStep = 8;        // warps of a block, one row each
constexpr int kChannelsPerBlock = 2 * kLanes;

__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load1(const float* p) { return *p; }

// Two neighbouring channels of one row; channel c0 + 1 may lie past C when
// C is odd (then `pair` is false for the whole launch).
template <typename T>
__device__ __forceinline__ float2 load_pair(const T* row, int c0, int channels,
                                            bool pair) {
  if (pair) return load2(row + c0);
  float2 v;
  v.x = load1(row + c0);
  v.y = c0 + 1 < channels ? load1(row + c0 + 1) : 0.0f;
  return v;
}

// Sum the block's 8 per-warp partials and add them to out[n, 0/1, c].
__device__ __forceinline__ void flush(float2 s1, float2 s2, float* out, int n,
                                      int c0, int channels) {
  __shared__ float part[kRowsPerStep][2][kChannelsPerBlock];
  const int tx = threadIdx.x, ty = threadIdx.y;
  part[ty][0][2 * tx] = s1.x;
  part[ty][0][2 * tx + 1] = s1.y;
  part[ty][1][2 * tx] = s2.x;
  part[ty][1][2 * tx + 1] = s2.y;
  __syncthreads();
  // 256 threads, 128 (which, channel) sums: the first four warps add
  const int t = ty * kLanes + tx;
  if (t < 2 * kChannelsPerBlock) {
    const int which = t / kChannelsPerBlock, ch = t % kChannelsPerBlock;
    const int c = c0 - 2 * tx + ch;  // the block's first channel + ch
    if (c < channels) {
      float s = 0.0f;
#pragma unroll
      for (int w = 0; w < kRowsPerStep; ++w) s += part[w][which][ch];
      atomicAdd(out + ((size_t)n * 2 + which) * channels + c, s);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kLanes * kRowsPerStep)
groupnorm_fwd_stats_kernel(const T* __restrict__ x, int rows, int channels,
                           int rows_per_block, float* __restrict__ out) {
  const int n = blockIdx.z;
  const int c0 = (blockIdx.x * kLanes + threadIdx.x) * 2;
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  const bool pair = (channels & 1) == 0;
  float2 s1 = make_float2(0.0f, 0.0f), s2 = make_float2(0.0f, 0.0f);
  if (c0 < channels) {
    const T* base = x + (size_t)n * rows * channels;
    for (int r = r_begin + threadIdx.y; r < r_end; r += kRowsPerStep) {
      const float2 v = load_pair(base + (size_t)r * channels, c0, channels,
                                 pair);
      s1.x += v.x;
      s1.y += v.y;
      s2.x += v.x * v.x;
      s2.y += v.y * v.y;
    }
  }
  flush(s1, s2, out, n, c0, channels);
}

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

template <typename T, int kWidth, bool kSilu>
__global__ void __launch_bounds__(kBwdThreads)
groupnorm_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                           const float* __restrict__ fwd_sums,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, int rows,
                           int channels, int groups, float eps,
                           int rows_per_block, float* __restrict__ out) {
  // kTy rows deep, kBwdUnroll rows a thread: kTy * kBwdUnroll rows a step
  constexpr int kTx = kChannelsPerBlock / kWidth;  // threads across
  constexpr int kTy = kBwdThreads / kTx;            // rows deep
  __shared__ float part[kTy][2][kChannelsPerBlock];
  __shared__ float t_mu[kChannelsPerBlock], t_rs[kChannelsPerBlock];
  const int tx = threadIdx.x % kTx, ty = threadIdx.x / kTx;
  const int n = blockIdx.z;
  const int cb = blockIdx.x * kChannelsPerBlock;
  const int c0 = cb + tx * kWidth;  // kWidth divides C: all in or all out
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);

  // the mean and rstd of the groups this block's channels touch
  {
    const int cg = channels / groups;
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
    float m[kWidth], rs[kWidth], g[kWidth], b[kWidth];
#pragma unroll
    for (int e = 0; e < kWidth; ++e) {
      m[e] = t_mu[c0 - cb + e];
      rs[e] = t_rs[c0 - cb + e];
      g[e] = gamma[c0 + e];
      b[e] = beta[c0 + e];
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
            const float dy = kSilu ? silu_grad(dv[u].get(e), xh * g[e] + b[e])
                                   : dv[u].get(e);
            s1[e] += dy;
            s2[e] += dy * xh;
          }
        }
      }
    }
  }
  // the block's kTy partials per (sum, channel) meet in shared memory
#pragma unroll
  for (int e = 0; e < kWidth; ++e) {
    part[ty][0][tx * kWidth + e] = s1[e];
    part[ty][1][tx * kWidth + e] = s2[e];
  }
  __syncthreads();
  const int t = threadIdx.x;
  if (t < 2 * kChannelsPerBlock) {
    const int which = t / kChannelsPerBlock, ch = t % kChannelsPerBlock;
    if (cb + ch < channels) {
      float s = 0.0f;
#pragma unroll
      for (int y = 0; y < kTy; ++y) s += part[y][which][ch];
      atomicAdd(out + ((size_t)n * 2 + which) * channels + cb + ch, s);
    }
  }
}

dim3 grid_for(int samples, int rows, int channels, int rows_per_block) {
  return dim3((channels + kChannelsPerBlock - 1) / kChannelsPerBlock,
              (rows + rows_per_block - 1) / rows_per_block, samples);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// `is_bf16` selects the activation type (bf16, else f32); `out` is [N, 2, C]
// f32. The forward's `out` must be zeroed by the caller and its rows per
// block come from the caller; the backward zeroes `out` itself
// (cudaMemsetAsync on `stream`), picks its own rows per block
// (bwd_rows_per_block) and also takes the forward's sums [N, 2, C] f32 and
// gamma, beta [C] f32, with channels a multiple of groups (else
// cudaErrorInvalidValue). Each launches on `stream`, does not synchronize,
// and returns cudaGetLastError() (0 = launched).
extern "C" int hg_groupnorm_fwd_stats(const void* x, int samples, int rows,
                                      int channels, int rows_per_block,
                                      int is_bf16, void* out, void* stream) {
  if (samples > 0 && rows > 0 && channels > 0) {
    const dim3 grid = grid_for(samples, rows, channels, rows_per_block);
    const dim3 block(kLanes, kRowsPerStep);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (is_bf16) {
      groupnorm_fwd_stats_kernel<__nv_bfloat16><<<grid, block, 0, s>>>(
          static_cast<const __nv_bfloat16*>(x), rows, channels,
          rows_per_block, static_cast<float*>(out));
    } else {
      groupnorm_fwd_stats_kernel<float><<<grid, block, 0, s>>>(
          static_cast<const float*>(x), rows, channels, rows_per_block,
          static_cast<float*>(out));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

// K5's rows per block: the slices per (sample, 64-channel block) that make
// the grid closest to whole waves of resident blocks (at least 90% of the
// last wave busy, else the best fill), so that no short last wave runs
// alone; a slice keeps at least 4 steps of the block's rows.
template <typename T, int kWidth, bool kSilu>
int bwd_rows_per_block(int samples, int rows, int channels) {
  int per_sm = 0, device = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, groupnorm_bwd_stats_kernel<T, kWidth, kSilu>, kBwdThreads, 0);
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const long long resident = static_cast<long long>(per_sm > 0 ? per_sm : 1)
                             * (sms > 0 ? sms : 1);
  const long long base =
      static_cast<long long>(samples)
      * ((channels + kChannelsPerBlock - 1) / kChannelsPerBlock);
  const int step = kBwdThreads / (kChannelsPerBlock / kWidth) * kBwdUnroll;
  const int max_splits = rows / (4 * step) > 1 ? rows / (4 * step) : 1;
  int best = 1;
  double best_fill = 0.0;
  for (int s = 1; s <= max_splits && s <= 1024; ++s) {
    const long long blocks = base * s;
    const long long waves = (blocks + resident - 1) / resident;
    const double fill = static_cast<double>(blocks) / (waves * resident);
    if (fill > best_fill + 1e-9) {
      best = s;
      best_fill = fill;
    }
    if (fill >= 0.9) break;
  }
  return (rows + best - 1) / best;
}

extern "C" int hg_groupnorm_bwd_stats(const void* x, const void* dz,
                                      const void* fwd_sums, const void* gamma,
                                      const void* beta, int samples, int rows,
                                      int channels, int groups, float eps,
                                      int is_bf16, int silu, void* out,
                                      void* stream) {
  if (groups <= 0 || channels % groups != 0 || samples > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (samples > 0 && rows > 0 && channels > 0) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const cudaError_t rc = cudaMemsetAsync(
        out, 0, static_cast<size_t>(samples) * 2 * channels * sizeof(float),
        s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    const float* fs = static_cast<const float*>(fwd_sums);
    const float* g = static_cast<const float*>(gamma);
    const float* b = static_cast<const float*>(beta);
    float* o = static_cast<float*>(out);
    const int width = is_bf16 ? 8 : 4;
    const bool vector = channels % width == 0
                        && reinterpret_cast<uintptr_t>(x) % 16 == 0
                        && reinterpret_cast<uintptr_t>(dz) % 16 == 0;
#define HG_LAUNCH(T, W, SILU)                                                \
  do {                                                                       \
    const int rpb = bwd_rows_per_block<T, W, SILU>(samples, rows, channels); \
    groupnorm_bwd_stats_kernel<T, W, SILU>                                   \
        <<<grid_for(samples, rows, channels, rpb), kBwdThreads, 0, s>>>(     \
            static_cast<const T*>(x), static_cast<const T*>(dz), fs, g, b,   \
            rows, channels, groups, eps, rpb, o);                            \
  } while (0)
#define HG_SILU(T, W)                                                        \
  if (silu) HG_LAUNCH(T, W, true);                                           \
  else HG_LAUNCH(T, W, false)
    if (is_bf16) {
      if (vector) { HG_SILU(__nv_bfloat16, 8); }
      else { HG_SILU(__nv_bfloat16, 1); }
    } else {
      if (vector) { HG_SILU(float, 4); }
      else { HG_SILU(float, 1); }
    }
#undef HG_SILU
#undef HG_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
