// Readiness flags without memsets, shared by the GroupNorm kernels that run
// as one cooperative launch: the forward (groupnorm_fwd.cu) and K5
// (groupnorm_stats.cu).
//
// A launch's 32-bit sync words are [generation, arrive[P], tile flags...]
// for P blocks. Each block reads the generation at its start and takes one
// more as the launch's epoch (begin_launch); a tile publishes its work by
// storing the epoch into its flag (release) and waiters compare with it
// (acquire). Block 0 advances the generation to the epoch at the end, once
// every block has read it (end_launch). So launches that share the words
// one after another on a stream never meet each other's flags, and the
// words are zeroed only when they are allocated.
#pragma once

#include <cuda_runtime.h>

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void store_release(unsigned* p, unsigned v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// Called by every thread of the block: returns once flags[0, count) all
// hold `epoch`.
__device__ __forceinline__ void wait_flags(const unsigned* flags, int count,
                                           unsigned epoch) {
  for (;;) {
    bool ready = true;
    for (int i = threadIdx.x; i < count; i += blockDim.x)
      ready &= load_acquire(flags + i) == epoch;
    if (__syncthreads_and(ready)) break;
    __nanosleep(128);
  }
  __threadfence();
}

// Called by every thread of the block once its writes for a tile are
// issued; also ends the tile's use of shared memory.
__device__ __forceinline__ void publish(unsigned* flag, unsigned epoch) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) store_release(flag, epoch);
}

// Called by every thread of every block first: the launch's epoch.
__device__ __forceinline__ unsigned begin_launch(unsigned* sync) {
  __shared__ unsigned s_epoch;
  if (threadIdx.x == 0) {
    s_epoch = load_acquire(sync) + 1;
    store_release(sync + 1 + blockIdx.x, s_epoch);
  }
  __syncthreads();
  return s_epoch;
}

// Called by every thread of every block last: block 0 advances the
// generation once every block has read it (the whole block reads the
// arrive flags at once).
__device__ __forceinline__ void end_launch(unsigned* sync, unsigned epoch) {
  if (blockIdx.x == 0) {
    wait_flags(sync + 1, gridDim.x, epoch);
    if (threadIdx.x == 0) store_release(sync, epoch);
  }
}
