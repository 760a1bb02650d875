// The bias add after a convolution, in place, for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package leaves convolution + bias to XLA,
// which fuses the add into the convolution's output. PyTorch's cuDNN path
// runs the convolution without its bias and then calls
// `out.add_(bias.view(1, C, 1, 1))`; on a `channels_last` bfloat16 output
// the broadcast bias keeps that add off TensorIterator's vectorised path,
// so it runs in the generic elementwise kernel with per-element offset
// arithmetic and 2-byte accesses. This kernel is that add for the VAE's
// convolutions (guidance/vae.py through ops/conv_bias.py).
//
// For y[B, C, H, W] (bf16 or f32, `channels_last` or contiguous) and
// bias[C] of y's type, per element:
//
//   y = round_to_type(float(y) + float(bias[c]))
//
// which is aten's `add_` with alpha 1 in its f32 opmath (alpha * b is b
// exactly, so its fused multiply-add rounds the same sum once), with the
// same conversion to bfloat16 (`__float2bfloat16`, round to nearest even):
// the output is bit for bit the library's.
//
// Bound by bytes: y read once and written once, 2 x 537 MB for a 512^2,
// 128-channel output at batch 8 in bf16 (0.32 ms at 3.35 TB/s); one add
// per element. Design for a pure stream: each thread loads four 16-byte
// vectors (8 bf16 or 4 f32) before it stores any, 256 threads a block, no
// shared memory; a block covers 16 KB, so a full SM keeps about 100 KB in
// flight. In a `channels_last` row of C channels a vector holds channels c0
// .. c0 + width - 1; where C divides a block's row of vectors (256 x width
// elements: every C up to 2048 that is a power of two), c0 is the same for
// every vector of a thread and the thread keeps its bias values in
// registers; otherwise each vector reads its channels through the read-only
// cache (the bias is at most a few KB). A contiguous tensor's vector lies in
// one channel where H W is a multiple of the width. A width that does not
// divide C (or H W), or a pointer off 16 bytes, takes the scalar path of
// the same entry point (the decoder's 3-channel `conv_out`).
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;

enum Mode { kRegisterBias = 0, kChannelsLast = 1, kChannelsFirst = 2 };

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float v, float* dst) { *dst = v; }
__device__ __forceinline__ void store(float v, __nv_bfloat16* dst) {
  *dst = __float2bfloat16(v);
}

// One 32-bit word of y plus its bias values: one f32, or two bf16 (the low
// half first, as they lie in memory).
__device__ __forceinline__ uint32_t add_word(uint32_t w, const float* b,
                                             float) {
  return __float_as_uint(__fadd_rn(__uint_as_float(w), b[0]));
}
__device__ __forceinline__ uint32_t add_word(uint32_t w, const float* b,
                                             __nv_bfloat16) {
  const float lo = __fadd_rn(__uint_as_float(w << 16), b[0]);
  const float hi = __fadd_rn(__uint_as_float(w & 0xffff0000u), b[1]);
  return static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(lo)))
         | (static_cast<uint32_t>(__bfloat16_as_ushort(__float2bfloat16(hi)))
            << 16);
}

template <typename T>
__device__ __forceinline__ uint4 add_vector(uint4 v, const float* b) {
  constexpr int kPerWord = 4 / sizeof(T);
  v.x = add_word(v.x, b, T());
  v.y = add_word(v.y, b + kPerWord, T());
  v.z = add_word(v.z, b + 2 * kPerWord, T());
  v.w = add_word(v.w, b + 3 * kPerWord, T());
  return v;
}

template <typename T>
__device__ __forceinline__ void load_bias(const T* __restrict__ bias, int c0,
                                          float* b) {
  constexpr int kWidth = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < kWidth; ++j) b[j] = to_f32(__ldg(bias + c0 + j));
}

// y as n_vec 16-byte vectors. kRegisterBias: channels_last with C dividing
// kThreads x width; kChannelsLast: channels_last with C a multiple of the
// width; kChannelsFirst: contiguous with `inner` = H W a multiple of it.
template <typename T, int kMode>
__global__ void __launch_bounds__(kThreads)
    bias_add_vector(uint4* __restrict__ y, const T* __restrict__ bias,
                    long long n_vec, int channels, long long inner) {
  constexpr int kWidth = 16 / sizeof(T);
  const long long first =
      static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  uint4 v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i < n_vec) v[k] = y[i];
  }
  float b[kWidth];
  if (kMode == kRegisterBias)
    load_bias(bias, static_cast<int>((threadIdx.x * kWidth) % channels), b);
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i >= n_vec) continue;
    if (kMode == kChannelsLast) {
      load_bias(bias, static_cast<int>((i * kWidth) % channels), b);
    } else if (kMode == kChannelsFirst) {
      const float c = to_f32(__ldg(bias + (i * kWidth / inner) % channels));
#pragma unroll
      for (int j = 0; j < kWidth; ++j) b[j] = c;
    }
    y[i] = add_vector<T>(v[k], b);
  }
}

// Any layout the wrapper takes, one element at a time: element i of the
// memory order is in channel (i / inner) % C.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    bias_add_scalar(T* __restrict__ y, const T* __restrict__ bias,
                    long long n, int channels, long long inner) {
  const long long first =
      static_cast<long long>(blockIdx.x) * (kThreads * kUnroll) + threadIdx.x;
  T v[kUnroll];
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i < n) v[k] = y[i];
  }
#pragma unroll
  for (int k = 0; k < kUnroll; ++k) {
    const long long i = first + static_cast<long long>(k) * kThreads;
    if (i >= n) continue;
    const float c = to_f32(__ldg(bias + (i / inner) % channels));
    store(__fadd_rn(to_f32(v[k]), c), y + i);
  }
}

unsigned blocks_for(long long items) {
  constexpr long long per_block = kThreads * kUnroll;
  return static_cast<unsigned>((items + per_block - 1) / per_block);
}

template <typename T>
cudaError_t dispatch(void* y, const void* bias, long long numel, int channels,
                     long long inner, cudaStream_t stream) {
  constexpr int kWidth = 16 / sizeof(T);
  const T* b = static_cast<const T*>(bias);
  const bool vector = reinterpret_cast<uintptr_t>(y) % 16 == 0
                      && (inner == 1 ? channels : inner) % kWidth == 0;
  if (!vector) {
    bias_add_scalar<T><<<blocks_for(numel), kThreads, 0, stream>>>(
        static_cast<T*>(y), b, numel, channels, inner);
    return cudaGetLastError();
  }
  const long long n_vec = numel / kWidth;
  uint4* yv = static_cast<uint4*>(y);
  const unsigned grid = blocks_for(n_vec);
  if (inner != 1)
    bias_add_vector<T, kChannelsFirst><<<grid, kThreads, 0, stream>>>(
        yv, b, n_vec, channels, inner);
  else if ((kThreads * kWidth) % channels == 0)
    bias_add_vector<T, kRegisterBias><<<grid, kThreads, 0, stream>>>(
        yv, b, n_vec, channels, inner);
  else
    bias_add_vector<T, kChannelsLast><<<grid, kThreads, 0, stream>>>(
        yv, b, n_vec, channels, inner);
  return cudaGetLastError();
}

}  // namespace

// y[numel] in place on card `device`: element i of the memory order gets
// bias[(i / inner) % channels] (inner 1 for channels_last, H W for
// contiguous [B, C, H, W]). The launch goes to `device` whatever the
// calling thread's current device, which is left as it was. Returns
// cudaGetLastError() after the launch; launches nothing for an empty y.
extern "C" int hg_conv_bias_add(void* y, const void* bias, long long numel,
                                int channels, long long inner, int is_bf16,
                                int device, void* stream) {
  if (numel < 0 || channels <= 0 || inner <= 0
      || numel % (static_cast<long long>(channels) * inner) != 0
      || (numel + kThreads * kUnroll - 1) / (kThreads * kUnroll)
             > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidValue);
  if (numel == 0) return 0;
  int current = 0;
  cudaError_t rc = cudaGetDevice(&current);
  if (rc == cudaSuccess && current != device) rc = cudaSetDevice(device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  rc = is_bf16 ? dispatch<__nv_bfloat16>(y, bias, numel, channels, inner, st)
               : dispatch<float>(y, bias, numel, channels, inner, st);
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (rc == cudaSuccess) rc = back;
  }
  return static_cast<int>(rc);
}
