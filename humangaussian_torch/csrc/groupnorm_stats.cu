// GroupNorm statistics for Hopper (sm_90a): the forward sums (K3) and the
// backward sums (K5) of ops/groupnorm.py.
//
// Replaces humangaussian_tpu/ops/groupnorm.py::_fwd_stats_kernel (:70) and
// ::_bwd_stats_kernel (:102). Activations are channel-minor, x[N, R, C]
// (R = H*W rows of C channels), bf16 or f32. For every (sample, channel):
//
//   forward   out[n, 0, c] = sum_r x          out[n, 1, c] = sum_r x^2
//   backward  out[n, 0, c] = sum_r dy         out[n, 1, c] = sum_r dy * xhat
//             xhat = (x - mu[n, c]) * rstd[n, c]
//             dy   = dz                                 (no activation)
//             dy   = dz * sig * (1 + y * (1 - sig))     (SiLU fused), with
//                    y = xhat * gamma + beta, sig = 1 / (1 + exp(-y))
//
// all accumulated in f32. The group combine, the normalize(+SiLU) pass and
// the dx formula are elementwise torch code in the wrapper, as they are
// plain XLA code beside the Pallas kernels.
//
// Bound by bytes. An H100 does about 20 f32 operations in the time it moves
// one byte (67 TFLOP/s over 3.35 TB/s). The forward does 3 operations on each
// 2-byte element; the backward with SiLU about 25 and one exp on the 4 bytes
// of an (x, dz) pair. Both stay under the line, so the design is about
// reading each element once, in full lines, from enough blocks.
//
// Design. The TPU kernel walks the rows in grid order and adds each block's
// sums into a revisited [2, C] output block. Blocks have no order here, so:
//  - a thread owns two neighbouring channels (one 4-byte bf16x2 or 8-byte
//    float2 load), a warp 64 channels (one coalesced 128- or 256-byte line
//    per row), and the 8 warps of a block take every 8th row of the block's
//    slice of rows;
//  - the 8 partial sums per channel meet in shared memory, and one thread
//    per channel adds the block's sum into the zeroed output with atomicAdd.
//    The wrapper picks the rows per block so that long rows at few channels
//    ([24, 4096, 320]: 5 channel blocks x 24 samples) still give the 132 SMs
//    about a thousand blocks. With more than one slice per (sample, channel)
//    the f32 atomics add in no fixed order, so two launches on the same
//    input may differ in the last bits (about 1e-7 of the sum); with one
//    slice the result is deterministic.
//  - an odd channel count (never at the shipped widths) takes scalar loads.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

__device__ __forceinline__ float silu_grad(float dz, float y) {
  const float sig = 1.0f / (1.0f + expf(-y));
  return dz * sig * (1.0f + y * (1.0f - sig));
}

template <typename T, bool kSilu>
__global__ void __launch_bounds__(kLanes * kRowsPerStep)
groupnorm_bwd_stats_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                           const float* __restrict__ mu,
                           const float* __restrict__ rstd,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, int rows,
                           int channels, int rows_per_block,
                           float* __restrict__ out) {
  const int n = blockIdx.z;
  const int c0 = (blockIdx.x * kLanes + threadIdx.x) * 2;
  const int c1 = min(c0 + 1, channels - 1);
  const int r_begin = blockIdx.y * rows_per_block;
  const int r_end = min(rows, r_begin + rows_per_block);
  const bool pair = (channels & 1) == 0;
  float2 s1 = make_float2(0.0f, 0.0f), s2 = make_float2(0.0f, 0.0f);
  if (c0 < channels) {
    const size_t nc = (size_t)n * channels;
    const float mu0 = mu[nc + c0], mu1 = mu[nc + c1];
    const float rs0 = rstd[nc + c0], rs1 = rstd[nc + c1];
    const float g0 = gamma[c0], g1 = gamma[c1];
    const float b0 = beta[c0], b1 = beta[c1];
    const bool second = c0 + 1 < channels;
    const T* xb = x + (size_t)n * rows * channels;
    const T* db = dz + (size_t)n * rows * channels;
    for (int r = r_begin + threadIdx.y; r < r_end; r += kRowsPerStep) {
      const float2 xv = load_pair(xb + (size_t)r * channels, c0, channels,
                                  pair);
      const float2 dv = load_pair(db + (size_t)r * channels, c0, channels,
                                  pair);
      const float xh0 = (xv.x - mu0) * rs0;
      const float xh1 = (xv.y - mu1) * rs1;
      float dy0 = dv.x, dy1 = dv.y;
      if (kSilu) {
        dy0 = silu_grad(dv.x, xh0 * g0 + b0);
        dy1 = silu_grad(dv.y, xh1 * g1 + b1);
      }
      if (!second) dy1 = 0.0f;
      s1.x += dy0;
      s1.y += dy1;
      s2.x += dy0 * xh0;
      s2.y += dy1 * xh1;
    }
  }
  flush(s1, s2, out, n, c0, channels);
}

dim3 grid_for(int samples, int rows, int channels, int rows_per_block) {
  return dim3((channels + kChannelsPerBlock - 1) / kChannelsPerBlock,
              (rows + rows_per_block - 1) / rows_per_block, samples);
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers;
// `is_bf16` selects the activation type (bf16, else f32); `out` is [N, 2, C]
// f32 and must be zeroed by the caller. Each launches on `stream`, does not
// synchronize, and returns cudaGetLastError() (0 = launched).
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

extern "C" int hg_groupnorm_bwd_stats(const void* x, const void* dz,
                                      const void* mu, const void* rstd,
                                      const void* gamma, const void* beta,
                                      int samples, int rows, int channels,
                                      int rows_per_block, int is_bf16,
                                      int silu, void* out, void* stream) {
  if (samples > 0 && rows > 0 && channels > 0) {
    const dim3 grid = grid_for(samples, rows, channels, rows_per_block);
    const dim3 block(kLanes, kRowsPerStep);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const float* m = static_cast<const float*>(mu);
    const float* rs = static_cast<const float*>(rstd);
    const float* g = static_cast<const float*>(gamma);
    const float* b = static_cast<const float*>(beta);
    float* o = static_cast<float*>(out);
#define HG_LAUNCH(T, SILU)                                                   \
  groupnorm_bwd_stats_kernel<T, SILU><<<grid, block, 0, s>>>(                \
      static_cast<const T*>(x), static_cast<const T*>(dz), m, rs, g, b,     \
      rows, channels, rows_per_block, o)
    if (is_bf16) {
      if (silu) HG_LAUNCH(__nv_bfloat16, true);
      else HG_LAUNCH(__nv_bfloat16, false);
    } else {
      if (silu) HG_LAUNCH(float, true);
      else HG_LAUNCH(float, false);
    }
#undef HG_LAUNCH
  }
  return static_cast<int>(cudaGetLastError());
}
