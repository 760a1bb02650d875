// GroupNorm(+SiLU) input-gradient pass for Hopper (sm_90a): K5a of the port.
//
// The backward of ops/groupnorm.py::group_norm_act after K5's sums. It
// replaces the elementwise XLA code that follows the Pallas backward
// statistics kernel in humangaussian_tpu/ops/groupnorm.py::_gn_bwd (:215,
// lines :251-268 after the sums). For x, dz[N, R, C] (channel-minor, bf16 or
// f32), the forward's sums[N, 2, C] (K3's) and K5's sums[N, 2, C] (S1 =
// sum_r dy, S2 = sum_r dy * xhat per (sample, channel), f32):
//
//   per (n, group g of C / G channels), m = R C / G:
//     mu, rstd as the forward formed them (groupnorm_group.cuh),
//     mean1 = sum_{c in g} gamma_c S1_c / m,  mean2 = sum_{c in g} gamma_c S2_c / m
//   per element:  xhat = (x - mu) rstd
//                 dy   = dz, or through the SiLU derivative:
//                        y = xhat gamma + beta,  sig = 1 / (1 + exp(-y)),
//                        dy = dz sig (1 + y (1 - sig))
//                 dx   = rstd (gamma dy - mean1 - xhat mean2)
//
// in f32, cast to x's type: the plain version's arithmetic in its order (no
// contraction into fused multiply-adds), so the two differ only in exp and
// in the order of the group sums.
//
// Bound by bytes: x and dz read once, dx written once (3 x 63 MB at [24,
// 4096, 320] bf16, 0.056 ms at 3.35 TB/s). About 25 f32 operations, one exp
// and one reciprocal per element with SiLU stay under the card's 20
// operations a byte of the 6 bytes an element moves.
//
// Design, as K3a's (groupnorm_apply.cu). A block serves one sample: it first
// forms the sample's group mean and rstd from the forward's sums and the
// group means of gamma S1 and gamma S2 (one warp per group), and lays out
// per channel mu, rstd, gamma, beta, mean1 and mean2 in shared memory; so
// the backward launches no torch code for its group statistics. Then it
// walks its share of the sample's elements 16 bytes a thread (8 bf16 or 4
// f32; C is a multiple of that width, so a vector never crosses a row and
// its channels are c0 .. c0 + width - 1), two vectors of x and two of dz
// loaded before either is used. The launch is one wave of resident blocks
// (by the kernel's occupancy) shared by the samples, fewer where a thread
// would take under 4 vectors: every block does the same work, so a grid of
// several waves would end in a short one. A width that does not divide C,
// or a pointer off 16 bytes, takes the scalar loop.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "groupnorm_group.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMinVectorsPerThread = 4;
constexpr int kTables = 6;  // mu, rstd, gamma, beta, mean1, mean2

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void from_f32(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void from_f32(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(v);
}

// dx of one element from its channel's six table entries
template <bool kSilu>
__device__ __forceinline__ float grad(float x, float dz, float mu, float rstd,
                                      float gamma, float beta, float mean1,
                                      float mean2) {
  const float xhat = __fmul_rn(__fsub_rn(x, mu), rstd);
  float dy = dz;
  if (kSilu) {
    const float y = __fadd_rn(__fmul_rn(xhat, gamma), beta);
    const float sig = __frcp_rn(__fadd_rn(1.0f, expf(-y)));
    dy = __fmul_rn(__fmul_rn(dz, sig),
                   __fadd_rn(1.0f, __fmul_rn(y, __fsub_rn(1.0f, sig))));
  }
  return __fmul_rn(rstd, __fsub_rn(__fsub_rn(__fmul_rn(gamma, dy), mean1),
                                   __fmul_rn(xhat, mean2)));
}

template <typename T, bool kSilu, bool kVector>
__global__ void __launch_bounds__(kThreads)
groupnorm_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ dz,
                        const float* __restrict__ fwd_sums,
                        const float* __restrict__ gamma,
                        const float* __restrict__ beta,
                        const float* __restrict__ sums, int rows,
                        int channels, int groups, float eps,
                        T* __restrict__ dx) {
  // six [C] tables, then per group mean1, mean2, mu, rstd; C is a
  // multiple of 4 on the vector path, so every table stays 16-byte
  // aligned
  extern __shared__ __align__(16) float table[];
  float* t_mu = table;
  float* t_rs = table + channels;
  float* t_g = table + 2 * channels;
  float* t_b = table + 3 * channels;
  float* t_m1 = table + 4 * channels;
  float* t_m2 = table + 5 * channels;
  float* g_m1 = table + kTables * channels;
  float* g_m2 = g_m1 + groups;
  float* g_mu = g_m2 + groups;
  float* g_rs = g_mu + groups;

  const int n = blockIdx.y;
  const int cg = channels / groups;
  const float m = static_cast<float>(rows) * static_cast<float>(cg);
  const float* s1 = sums + static_cast<size_t>(n) * 2 * channels;
  const float* s2 = s1 + channels;
  const float* f1 = fwd_sums + static_cast<size_t>(n) * 2 * channels;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int g = warp; g < groups; g += kThreads / 32) {
    float mean, rstd;
    group_moments(f1, f1 + channels, g * cg, (g + 1) * cg, m, eps, mean,
                  rstd);
    float a1 = 0.0f, a2 = 0.0f;
    for (int c = g * cg + lane; c < (g + 1) * cg; c += 32) {
      a1 = __fadd_rn(a1, __fmul_rn(gamma[c], s1[c]));
      a2 = __fadd_rn(a2, __fmul_rn(gamma[c], s2[c]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a1 += __shfl_xor_sync(0xffffffffu, a1, off);
      a2 += __shfl_xor_sync(0xffffffffu, a2, off);
    }
    if (lane == 0) {
      g_m1[g] = __fdiv_rn(a1, m);
      g_m2[g] = __fdiv_rn(a2, m);
      g_mu[g] = mean;
      g_rs[g] = rstd;
    }
  }
  __syncthreads();
  for (int c = threadIdx.x; c < channels; c += kThreads) {
    t_mu[c] = g_mu[c / cg];
    t_rs[c] = g_rs[c / cg];
    t_g[c] = gamma[c];
    t_b[c] = beta[c];
    t_m1[c] = g_m1[c / cg];
    t_m2[c] = g_m2[c / cg];
  }
  __syncthreads();

  // the entry point caps rows * channels below 2^31: 32-bit offsets
  const unsigned per_sample = static_cast<unsigned>(rows) * channels;
  const size_t offset = static_cast<size_t>(n) * per_sample;
  const T* xs = x + offset;
  const T* ds = dz + offset;
  T* out = dx + offset;
  const unsigned stride = gridDim.x * kThreads;
  const unsigned first = blockIdx.x * kThreads + threadIdx.x;
  if (kVector) {
    constexpr int kWidth = 16 / sizeof(T);
    const unsigned vectors = per_sample / kWidth;
    for (unsigned i = first; i < vectors; i += 2 * stride) {
      // two vectors of x and of dz in flight before either is used
      uint4 xr[2], dr[2];
      const bool has[2] = {true, i + stride < vectors};
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (has[v]) {
          xr[v] = reinterpret_cast<const uint4*>(xs)[i + v * stride];
          dr[v] = reinterpret_cast<const uint4*>(ds)[i + v * stride];
        }
      }
#pragma unroll
      for (int v = 0; v < 2; ++v) {
        if (!has[v]) continue;
        const unsigned j = i + v * stride;
        const T* xv = reinterpret_cast<const T*>(&xr[v]);
        const T* dv = reinterpret_cast<const T*>(&dr[v]);
        uint4 res;
        T* rv = reinterpret_cast<T*>(&res);
        const unsigned c0 = (j * kWidth) % channels;
#pragma unroll
        for (int e0 = 0; e0 < kWidth; e0 += 4) {
          const float4 pm = *reinterpret_cast<const float4*>(t_mu + c0 + e0);
          const float4 pr = *reinterpret_cast<const float4*>(t_rs + c0 + e0);
          const float4 pg = *reinterpret_cast<const float4*>(t_g + c0 + e0);
          const float4 pb = *reinterpret_cast<const float4*>(t_b + c0 + e0);
          const float4 p1 = *reinterpret_cast<const float4*>(t_m1 + c0 + e0);
          const float4 p2 = *reinterpret_cast<const float4*>(t_m2 + c0 + e0);
          const float am[4] = {pm.x, pm.y, pm.z, pm.w};
          const float ar[4] = {pr.x, pr.y, pr.z, pr.w};
          const float ag[4] = {pg.x, pg.y, pg.z, pg.w};
          const float ab[4] = {pb.x, pb.y, pb.z, pb.w};
          const float a1[4] = {p1.x, p1.y, p1.z, p1.w};
          const float a2[4] = {p2.x, p2.y, p2.z, p2.w};
#pragma unroll
          for (int e = 0; e < 4; ++e)
            from_f32(grad<kSilu>(to_f32(xv[e0 + e]), to_f32(dv[e0 + e]),
                                 am[e], ar[e], ag[e], ab[e], a1[e], a2[e]),
                     rv + e0 + e);
        }
        reinterpret_cast<uint4*>(out)[j] = res;
      }
    }
  } else {
    for (unsigned i = first; i < per_sample; i += stride) {
      const unsigned c = i % channels;
      from_f32(grad<kSilu>(to_f32(xs[i]), to_f32(ds[i]), t_mu[c], t_rs[c],
                           t_g[c], t_b[c], t_m1[c], t_m2[c]),
               out + i);
    }
  }
}

template <typename T, bool kSilu, bool kVector>
cudaError_t launch(const void* x, const void* dz, const float* fwd_sums,
                   const float* gamma, const float* beta, const float* sums,
                   int samples, int rows, int channels, int groups, float eps,
                   void* dx, cudaStream_t stream) {
  auto kernel = groupnorm_bwd_dx_kernel<T, kSilu, kVector>;
  const size_t smem =
      (static_cast<size_t>(kTables) * channels + 4 * groups) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t rc = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (rc != cudaSuccess) return rc;
  }
  // one wave of resident blocks, shared by the samples
  int per_sm = 0, device = 0, sms = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                smem);
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const size_t resident = static_cast<size_t>(per_sm > 0 ? per_sm : 1)
                          * (sms > 0 ? sms : 1);
  const size_t width = kVector ? 16 / sizeof(T) : 1;
  const size_t items = static_cast<size_t>(rows) * channels / width;
  const size_t by_work =
      (items + kThreads * kMinVectorsPerThread - 1)
      / (kThreads * kMinVectorsPerThread);
  const size_t by_card = resident / samples;
  size_t blocks = by_work < by_card ? by_work : by_card;
  if (blocks < 1) blocks = 1;
  const dim3 grid(static_cast<unsigned>(blocks), samples);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(dz), fwd_sums, gamma,
      beta, sums, rows, channels, groups, eps, static_cast<T*>(dx));
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(bool silu, bool vector, const void* x, const void* dz,
                     const float* fwd_sums, const float* gamma,
                     const float* beta, const float* sums, int samples,
                     int rows, int channels, int groups, float eps, void* dx,
                     cudaStream_t stream) {
#define HG_LAUNCH(SILU, VEC)                                                \
  return launch<T, SILU, VEC>(x, dz, fwd_sums, gamma, beta, sums, samples,  \
                              rows, channels, groups, eps, dx, stream)
  if (silu) {
    if (vector) HG_LAUNCH(true, true);
    HG_LAUNCH(true, false);
  }
  if (vector) HG_LAUNCH(false, true);
  HG_LAUNCH(false, false);
#undef HG_LAUNCH
}

}  // namespace

// Plain C entry point (loaded with ctypes). x, dz and dx: [samples, rows,
// channels] contiguous device arrays of one type (`is_bf16`, else f32); the
// forward's sums and K5's sums [samples, 2, channels], gamma and beta
// [channels], f32; channels a multiple of groups. Launches on `stream`, does
// not synchronize, and returns cudaGetLastError() (0 = launched) or
// cudaErrorInvalidValue for arguments it does not take.
extern "C" int hg_groupnorm_bwd_dx(const void* x, const void* dz,
                                   const void* fwd_sums, const void* gamma,
                                   const void* beta, const void* sums,
                                   int samples, int rows, int channels,
                                   int groups, float eps, int is_bf16,
                                   int silu, void* dx, void* stream) {
  if (samples <= 0 || rows <= 0 || channels <= 0 || groups <= 0
      || channels % groups != 0 || samples > 65535
      || static_cast<long long>(rows) * channels >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t width = is_bf16 ? 8 : 4;
  const bool vector = channels % width == 0
                      && reinterpret_cast<uintptr_t>(x) % 16 == 0
                      && reinterpret_cast<uintptr_t>(dz) % 16 == 0
                      && reinterpret_cast<uintptr_t>(dx) % 16 == 0;
  const float* fs = static_cast<const float*>(fwd_sums);
  const float* g = static_cast<const float*>(gamma);
  const float* b = static_cast<const float*>(beta);
  const float* s = static_cast<const float*>(sums);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t rc =
      is_bf16 ? dispatch<__nv_bfloat16>(silu != 0, vector, x, dz, fs, g, b, s,
                                        samples, rows, channels, groups, eps,
                                        dx, st)
              : dispatch<float>(silu != 0, vector, x, dz, fs, g, b, s, samples,
                                rows, channels, groups, eps, dx, st);
  return static_cast<int>(rc);
}
