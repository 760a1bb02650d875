// The group statistics of GroupNorm from its channel sums, shared by the
// forward (groupnorm_fwd.cu) and the backward kernels K5
// (groupnorm_stats.cu) and K5a (groupnorm_bwd_dx.cu).
//
// For one (sample, group) of m = R C / G elements, from the forward's
// per-channel sum s1 and sum of squares s2 (the forward's sums):
//
//   mean = sum_g s1 / m,  var = max(sum_g s2 / m - mean^2, 0),
//   rstd = 1 / sqrt(var + eps)
//
// with K3a's arithmetic (groupnorm_fwd.cu): one warp strides the group's
// channels by lane and adds the lanes with an xor butterfly, then the
// divisions and the square root round to nearest. So the backward sees
// bit for bit the mean and rstd that the forward normalized with.
#pragma once

#include <cuda_runtime.h>

// Called by all 32 lanes of a warp; every lane returns the same values.
__device__ __forceinline__ void group_moments(const float* __restrict__ s1,
                                              const float* __restrict__ s2,
                                              int c_begin, int c_end,
                                              float m, float eps,
                                              float& mean, float& rstd) {
  const int lane = threadIdx.x % 32;
  float a1 = 0.0f, a2 = 0.0f;
  for (int c = c_begin + lane; c < c_end; c += 32) {
    a1 += s1[c];
    a2 += s2[c];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a1 += __shfl_xor_sync(0xffffffffu, a1, off);
    a2 += __shfl_xor_sync(0xffffffffu, a2, off);
  }
  mean = __fdiv_rn(a1, m);
  const float var =
      fmaxf(__fsub_rn(__fdiv_rn(a2, m), __fmul_rn(mean, mean)), 0.0f);
  rstd = __frcp_rn(__fsqrt_rn(__fadd_rn(var, eps)));
}
