// GroupNorm(+SiLU) normalize pass for Hopper (sm_90a): K3a of the port.
//
// The forward of ops/groupnorm.py::group_norm_act after K3's sums. It
// replaces the elementwise XLA code that follows the Pallas statistics
// kernel in humangaussian_tpu/ops/groupnorm.py::_gn_fwd (:190, lines
// :206-213 after the sums, with _group_stats :153-165). For x[N, R, C]
// (channel-minor, bf16 or f32) and K3's sums[N, 2, C] (per (sample,
// channel) sum and sum of squares, f32):
//
//   per (n, group g of C / G channels), m = R C / G:
//     mean = sum_g / m,  var = max(sumsq_g / m - mean^2, 0),
//     rstd = 1 / sqrt(var + eps)
//   per (n, c):  a = gamma rstd,  b = beta - (mean gamma) rstd
//   y = x a + b,  then y sigmoid(y) when SiLU is fused,
//
// in f32, cast to x's type: the plain version's arithmetic (no contraction
// into fused multiply-adds), so the two differ only in exp and in the
// order of the group sums.
//
// Bound by bytes: x read once and y written once (2 x 63 MB at [24, 4096,
// 320] bf16, 0.038 ms at 3.35 TB/s); about 10 f32 operations and one exp
// per element stay under the card's 20 operations per byte.
//
// Design. A block serves one sample: it first forms the sample's group
// statistics and its per-channel (a, b) in shared memory (one warp per
// group), then walks its share of the sample's elements 16 bytes a thread
// (8 bf16 or 4 f32; C is a multiple of that width, so a vector never
// crosses a row and its channels are c0 .. c0 + width - 1). The launch
// picks the blocks per sample so that the grid is about 8 blocks per SM
// where the data allows and each thread takes at least 4 vectors (each
// block reads the sample's [2, C] sums once). A width that does not divide
// C, or a misaligned pointer, takes the scalar loop instead.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTargetBlocks = 132 * 8;
constexpr int kMinVectorsPerThread = 4;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

template <bool kSilu>
__device__ __forceinline__ float apply(float x, float a, float b) {
  float y = __fadd_rn(__fmul_rn(x, a), b);
  if (kSilu) y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-y))));
  return y;
}

template <typename T, bool kSilu, bool kVector>
__global__ void __launch_bounds__(kThreads)
groupnorm_fwd_apply_kernel(const T* __restrict__ x,
                           const float* __restrict__ sums,
                           const float* __restrict__ gamma,
                           const float* __restrict__ beta, int rows,
                           int channels, int groups, float eps,
                           T* __restrict__ out) {
  // a[C], b[C], mean[G], rstd[G]; C is a multiple of 4 on the vector
  // path, so b[] stays 16-byte aligned
  extern __shared__ __align__(16) float table[];
  float* ta = table;
  float* tb = table + channels;
  float* gmean = table + 2 * channels;
  float* grstd = gmean + groups;

  const int n = blockIdx.y;
  const int cg = channels / groups;
  const float m = static_cast<float>(rows) * static_cast<float>(cg);
  const float* s1 = sums + static_cast<size_t>(n) * 2 * channels;
  const float* s2 = s1 + channels;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < groups; g += kThreads / 32) {
    float a1 = 0.0f, a2 = 0.0f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      a1 += s1[c];
      a2 += s2[c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) {
      const float mean = __fdiv_rn(a1, m);
      const float var =
          fmaxf(__fsub_rn(__fdiv_rn(a2, m), __fmul_rn(mean, mean)), 0.0f);
      gmean[g] = mean;
      grstd[g] = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    const float mean = gmean[c / cg], rstd = grstd[c / cg];
    ta[c] = __fmul_rn(gamma[c], rstd);
    tb[c] = __fsub_rn(beta[c], __fmul_rn(__fmul_rn(mean, gamma[c]), rstd));
  }
  __syncthreads();

  // the entry point caps rows * channels below 2^31: 32-bit offsets
  const unsigned per_sample = static_cast<unsigned>(rows) * channels;
  const T* xs = x + static_cast<size_t>(n) * per_sample;
  T* ys = out + static_cast<size_t>(n) * per_sample;
  const unsigned stride = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  if (kVector) {
    constexpr int kWidth = 16 / sizeof(T);
    const unsigned vectors = per_sample / kWidth;
    for (unsigned i = first; i < vectors; i += stride) {
      uint4 raw = reinterpret_cast<const uint4*>(xs)[i];
      T* vals = reinterpret_cast<T*>(&raw);
      const unsigned c0 = (i * kWidth) % channels;
      float av[kWidth], bv[kWidth];
#pragma unroll
      for (int e = 0; e < kWidth; e += 4) {
        *reinterpret_cast<float4*>(av + e) =
            *reinterpret_cast<const float4*>(ta + c0 + e);
        *reinterpret_cast<float4*>(bv + e) =
            *reinterpret_cast<const float4*>(tb + c0 + e);
      }
#pragma unroll
      for (int e = 0; e < kWidth; ++e)
        from_f32(apply<kSilu>(to_f32(vals[e]), av[e], bv[e]), vals + e);
      reinterpret_cast<uint4*>(ys)[i] = raw;
    }
  } else {
    for (unsigned i = first; i < per_sample; i += stride) {
      const unsigned c = i % channels;
      from_f32(apply<kSilu>(to_f32(xs[i]), ta[c], tb[c]), ys + i);
    }
  }
}

template <typename T, bool kSilu, bool kVector>
cudaError_t launch(const void* x, const float* sums, const float* gamma,
                   const float* beta, int samples, int rows, int channels,
                   int groups, float eps, void* out, cudaStream_t stream) {
  auto kernel = groupnorm_fwd_apply_kernel<T, kSilu, kVector>;
  const size_t smem = (2 * static_cast<size_t>(channels) + 2 * groups)
                      * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  const size_t width = kVector ? 16 / sizeof(T) : 1;
  const size_t items = static_cast<size_t>(rows) * channels / width;
  const size_t by_work =
      (items + kThreads * kMinVectorsPerThread - 1)
      / (kThreads * kMinVectorsPerThread);
  const size_t by_card = (kTargetBlocks + samples - 1) / samples;
  size_t blocks = by_work < by_card ? by_work : by_card;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), samples);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), sums, gamma, beta, rows, channels, groups,
      eps, static_cast<T*>(out));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool silu, bool vector, const void* x, const float* sums,
                     const float* gamma, const float* beta, int samples,
                     int rows, int channels, int groups, float eps, void* out,
                     cudaStream_t stream) {
#define HG_LAUNCH(SILU, VEC)                                                \
  return launch<T, SILU, VEC>(x, sums, gamma, beta, samples, rows,         \
                              channels, groups, eps, out, stream)
  if (silu) {
    if (vector) HG_LAUNCH(true, true);
    HG_LAUNCH(true, false);
  }
  if (vector) HG_LAUNCH(false, true);
  HG_LAUNCH(false, false);
#undef HG_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). x and out: [samples, rows,
// channels] contiguous device arrays of one type (`is_bf16`, else f32);
// sums [samples, 2, channels], gamma and beta [channels], f32; channels a
// multiple of groups. Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() (0 = launched) or cudaErrorInvalidValue for
// arguments it does not take.
extern "C" int hg_groupnorm_fwd_apply(const void* x, const void* sums,
                                      const void* gamma, const void* beta,
                                      int samples, int rows, int channels,
                                      int groups, float eps, int is_bf16,
                                      int silu, void* out, void* stream) {
  if (samples <= 0 || rows <= 0 || channels <= 0 || groups <= 0
      || channels % groups != 0 || samples > 65535
      || static_cast<long long>(rows) * channels >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t width = is_bf16 ? 8 : 4;
  const bool vector = channels % width == 0
                      && reinterpret_cast<uintptr_t>(x) % 16 == 0
                      && reinterpret_cast<uintptr_t>(out) % 16 == 0;
  const float* s = static_cast<const float*>(sums);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      is_bf16 ? dispatch<__nv_bfloat16>(silu != 0, vector, x, s, g, b,
                                        samples, rows, channels, groups, eps,
                                        out, st)
              : dispatch<float>(silu != 0, vector, x, s, g, b, samples, rows,
                                channels, groups, eps, out, st);
  return static_cast<int>(rc);
}
