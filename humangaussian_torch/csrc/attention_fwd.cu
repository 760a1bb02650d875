// Non-causal self-attention forward for Hopper (sm_90a): K4 of the port.
//
// Replaces humangaussian_tpu/ops/attention.py::_attn_kernel (:36). For every
// (batch, head) of q, k, v in [B, S, H, 64] bf16 (k, v may hold M != S rows):
//
//   logits = (q k^T) * scale                 f32
//   m      = rowmax(logits)
//   p      = exp(logits - m)                 f32
//   l      = rowsum(p)                       f32
//   out    = (bf16(p) v) / l                 f32 accumulation, cast to bf16
//
// which is the TPU kernel's arithmetic: p is rounded to bf16 before the PV
// product, l is summed from the f32 p, and the division is done on the
// [rows, 64] output.
//
// Bound by operations: 4 S M 64 flops per head against (2 S + 2 M) 64 2 bytes,
// hundreds of flops per byte at S = 4096, so the tensor cores are the limit.
//
// Design. The TPU kernel holds a whole [block_q, S] logits tile and all of K
// and V of a head in VMEM. A head's K and V at S = 4096 are 512 KB each, over
// a block's 227 KB of shared memory, so this kernel streams K/V tiles of 64
// keys and makes TWO PASSES over them instead of an online softmax:
//
//   pass 1  logits tile by tile, running row maximum only;
//   pass 2  logits again, p = exp(logits - m) with the FINAL maximum, l, and
//           the PV product accumulated in wmma fragments with no rescaling.
//
// Recomputing QK^T costs half as many tensor-core flops again (3 products
// instead of 2), and buys: p is rounded to bf16 relative to the final
// maximum exactly as in the TPU kernel and the plain version (an online
// softmax rounds relative to the running maximum), and the accumulator never
// needs a per-row rescale, which wmma's opaque fragment layout cannot
// express without a trip through shared memory.
//
// A block is 4 warps and owns 64 query rows of one head; warp w owns rows
// 16 w .. 16 w + 15 and keeps its Q operand in four wmma fragments for the
// whole kernel. Products are nvcuda::wmma 16x16x16 bf16 with f32
// accumulators. Logits go through a per-warp f32 tile in shared memory,
// where two lanes share a row (32 columns each) for the maximum, the exp
// and the row sum; p goes back through the warp's slice of the Q tile,
// which is free once the Q fragments are loaded. Tiles are padded (72 bf16
// / 68 f32 per row) against bank conflicts; 45,056 bytes of static shared
// memory, so several blocks share an SM and one block's loads overlap
// another's products. No cp.async / TMA / wgmma pipeline yet.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kD = 64;        // head dim
constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // keys per streamed tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kLdH = 72;      // row pitch of the bf16 tiles (144 B)
constexpr int kLdS = 68;      // row pitch of the f32 logits tile (272 B)

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragKt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragV = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

// 64 rows x 64 bf16 from global (row pitch `stride` elements) into a padded
// shared tile, 16 bytes a thread, 8 threads a row.
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* src,
                                          size_t stride, int tid) {
#pragma unroll
  for (int i = tid; i < 64 * 8; i += kThreads) {
    const int r = i >> 3, c = (i & 7) * 8;
    *reinterpret_cast<uint4*>(dst + r * kLdH + c) =
        *reinterpret_cast<const uint4*>(src + (size_t)r * stride + c);
  }
}

// The warp's [16, 64] logits of one key tile: S = Q K^T, into its f32 tile.
__device__ __forceinline__ void qk_tile(const FragA (&qf)[4], const bf16* sK,
                                        float* sSw) {
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) {
    FragC acc;
    wmma::fill_fragment(acc, 0.0f);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragKt kf;  // K^T [d, key]: column-major view of the K tile [key, d]
      wmma::load_matrix_sync(kf, sK + nf * 16 * kLdH + kk * 16, kLdH);
      wmma::mma_sync(acc, qf[kk], kf, acc);
    }
    wmma::store_matrix_sync(sSw + nf * 16, acc, kLdS, wmma::mem_row_major);
  }
}

__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v, bf16* __restrict__ out,
                     int seq_q, int seq_k, int heads, float scale) {
  __shared__ __align__(128) bf16 sQ[kBQ * kLdH];  // Q, then each warp's p
  __shared__ __align__(128) bf16 sK[kBK * kLdH];
  __shared__ __align__(128) bf16 sV[kBK * kLdH];
  __shared__ __align__(128) float sS[kWarps * 16 * kLdS];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const size_t stride = (size_t)heads * kD;  // elements between rows
  const size_t q_off = ((size_t)b * seq_q + (size_t)blockIdx.x * kBQ) * stride
                       + (size_t)h * kD;
  const bf16* kb = k + (size_t)b * seq_k * stride + (size_t)h * kD;
  const bf16* vb = v + (size_t)b * seq_k * stride + (size_t)h * kD;

  load_tile(sQ, q + q_off, stride, tid);
  __syncthreads();
  bf16* sP = sQ + warp * 16 * kLdH;   // the warp's Q rows, later its p tile
  float* sSw = sS + warp * 16 * kLdS;
  FragA qf[4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wmma::load_matrix_sync(qf[kk], sP + kk * 16, kLdH);

  // two lanes a row: lane 2r takes columns 4j, 4j+1, lane 2r+1 4j+2, 4j+3
  const int row = lane >> 1, col0 = (lane & 1) * 2;
  const float* s_row = sSw + row * kLdS + col0;

  // ---- pass 1: the row maximum of the scaled logits --------------------
  float m = -INFINITY;
  for (int t0 = 0; t0 < seq_k; t0 += kBK) {
    __syncthreads();  // every warp is done with the previous K tile
    load_tile(sK, kb + (size_t)t0 * stride, stride, tid);
    __syncthreads();
    qk_tile(qf, sK, sSw);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 s = *reinterpret_cast<const float2*>(s_row + 4 * j);
      m = fmaxf(m, fmaxf(__fmul_rn(s.x, scale), __fmul_rn(s.y, scale)));
    }
    __syncwarp();  // the tile is rewritten by the next qk_tile
  }
  m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1));

  // ---- pass 2: p, l and the PV product ----------------------------------
  FragC of[4];
#pragma unroll
  for (int nf = 0; nf < 4; ++nf) wmma::fill_fragment(of[nf], 0.0f);
  float l = 0.0f;
  bf16* p_row = sP + row * kLdH + col0;
  for (int t0 = 0; t0 < seq_k; t0 += kBK) {
    __syncthreads();
    load_tile(sK, kb + (size_t)t0 * stride, stride, tid);
    load_tile(sV, vb + (size_t)t0 * stride, stride, tid);
    __syncthreads();
    qk_tile(qf, sK, sSw);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      const float2 s = *reinterpret_cast<const float2*>(s_row + 4 * j);
      // the product is rounded before the subtraction, as in the plain
      // version (no fused multiply-add)
      const float p0 = expf(__fsub_rn(__fmul_rn(s.x, scale), m));
      const float p1 = expf(__fsub_rn(__fmul_rn(s.y, scale), m));
      l += p0 + p1;
      *reinterpret_cast<__nv_bfloat162*>(p_row + 4 * j) =
          __floats2bfloat162_rn(p0, p1);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      FragA pf;
      wmma::load_matrix_sync(pf, sP + kk * 16, kLdH);
#pragma unroll
      for (int nf = 0; nf < 4; ++nf) {
        FragV vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * kLdH + nf * 16, kLdH);
        wmma::mma_sync(of[nf], pf, vf, of[nf]);
      }
    }
    __syncwarp();  // p and the logits tile are rewritten next round
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);

  // ---- out = acc / l, 16 bytes a lane ------------------------------------
#pragma unroll
  for (int nf = 0; nf < 4; ++nf)
    wmma::store_matrix_sync(sSw + nf * 16, of[nf], kLdS, wmma::mem_row_major);
  __syncwarp();
  bf16* ob = out + q_off + (size_t)warp * 16 * stride;
#pragma unroll
  for (int it = 0; it < 4; ++it) {
    const int chunk = lane + 32 * it;  // 16 rows x 8 chunks of 8 columns
    const int r = chunk >> 3, c = (chunk & 7) * 8;
    const float lr = __shfl_sync(0xffffffffu, l, 2 * r);
    const float* src = sSw + r * kLdS + c;
    __align__(16) __nv_bfloat162 packed[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      packed[e] = __floats2bfloat162_rn(__fdiv_rn(src[2 * e], lr),
                                        __fdiv_rn(src[2 * e + 1], lr));
    *reinterpret_cast<uint4*>(ob + (size_t)r * stride + c) =
        *reinterpret_cast<const uint4*>(packed);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, out: [batch, seq_q, heads, 64]
// bf16; k, v: [batch, seq_k, heads, 64] bf16; all contiguous device
// pointers; seq_q and seq_k multiples of 64. Launches on `stream`, does not
// synchronize, and returns cudaGetLastError() (0 = launched).
extern "C" int hg_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int batch, int seq_q, int seq_k,
                                int heads, float scale, void* stream) {
  if (seq_q % kBQ != 0 || seq_k % kBK != 0 || batch * heads > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (batch > 0 && heads > 0 && seq_q > 0) {
    const dim3 grid(seq_q / kBQ, batch * heads);
    attention_fwd_kernel<<<grid, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const bf16*>(q), static_cast<const bf16*>(k),
        static_cast<const bf16*>(v), static_cast<bf16*>(out), seq_q, seq_k,
        heads, scale);
  }
  return static_cast<int>(cudaGetLastError());
}
