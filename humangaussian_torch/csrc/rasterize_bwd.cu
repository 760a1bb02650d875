// K2: backward of the tiled front-to-back compositing (analytic replay VJP).
//
// Replaces humangaussian_tpu/ops/rasterize_tiled.py::_bwd_kernel (launched
// by _bwd_call, routed by _render_core_bwd). Given the cotangents of K1's
// image, depth and alpha it produces the gradient of every per-Gaussian
// feature row [mean x, y, conic a, b, c, r, g, b, opacity, depth]. The
// plain PyTorch version is
// humangaussian_torch/ops/rasterize_tiled.py::composite_backward_plain.
//
// Per pixel, with F_i = [r, g, b, depth], cotangents g = [g_r, g_g, g_b,
// g_depth], phi_i = F_i . g, w_i = T_i alpha_i and P_i the inclusive prefix
// of w_j phi_j over the contributing pairs:
//   dL/dalpha_i = T_i phi_i - (S - P_i) / max(1 - alpha_i, 1e-6)
//   S = g_image . image + g_depth depth - T_fin g_alpha
// (S is sum_j w_j phi_j plus the cotangent that reaches the final
// transmittance through image = acc + T_fin bg and alpha = 1 - T_fin; the
// background terms cancel.) Then, as jax.grad of the reference gives:
//   dalpha_raw = dalpha        only where opa exp(power) < alpha_max
//   dpower     = dalpha_raw opa exp(power)   only where power < 0
//   dopacity   = sum_p dalpha_raw exp(power) (not gated by power < 0)
//   dmean_x = -(ca gx + cb gy), dmean_y = -(cc gy + cb gx),
//   dconic a, b, c = -1/2 sum dpow dx^2, -sum dpow dx dy, -1/2 sum dpow dy^2
//   with dx = mean_x - px, gx = sum_p dpow dx, gy = sum_p dpow dy;
//   drgb = sum_p g_rgb w, ddepth = sum_p g_depth w.
// Pairs that failed a gate, pairs at or after a pixel's done latch and pairs
// past the tile's capped count get exactly 0.
//
// Design. One block per (camera, 32x32 tile), 1024 threads of one pixel
// each, like K1. The walk is a front-to-back REPLAY with K1's arithmetic
// (the same round-to-nearest intrinsics in the same order, the accurate
// expf, product-form T), so K2 gates the very pairs K1 gated; K1's
// last-contributor index bounds each pixel's walk, each warp's and the
// block's, which is the early stop. A back-to-front walk that divides T_fin
// by (1 - alpha) would not reproduce K1's T_i bit for bit.
//
// The sum over pixels is the hard part on this card: each pair's ten
// partials must be added over up to 1024 threads. Each warp (one pixel row
// of the tile) reduces by shuffles only when one of its lanes contributes
// (__any_sync; most splats touch few rows), lane 0 adds the ten sums to the
// staged pair's slot in shared memory (shared-memory atomics, no block
// barrier per pair), and after each batch of 512 staged pairs the block
// flushes the non-zero sums to the Gaussian's row with one global atomicAdd
// per value (a Gaussian sits in several tiles and cameras, so rows are
// shared between blocks; the wrapper zeroes them). Atomics are unordered:
// results differ from run to run in the last bits.
//
// What bounds it: as K1, the fp32 instruction rate of the busy tiles' SMs
// (an avatar view fills fewer tiles than the card has SMs), plus the
// per-contribution gradient arithmetic and reduction. Batching several pairs
// per warp reduction is the next lever.
//
// Not carried over from the TPU kernel, which needed them for its hardware:
// the page buffers and pagestart, the candidate-key row and key-only blocks,
// the gather / sort routing of gradient rows, the tile-centred monomial
// matmul (the per-pixel products are formed directly), the lane rotate, the
// triangular-matmul cumsum and the DMA double buffers.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one pixel per thread
constexpr int kFeat = 10;
constexpr int kBatch = 512;  // pairs staged per round (42 KB shared)
constexpr unsigned kFull = 0xffffffffu;

// per-Gaussian feature row, as ops/rasterize_tiled.py::feature_matrix
enum { FX, FY, FCA, FCB, FCC, FR, FG, FB, FOPA, FDEPTH };

__global__ void __launch_bounds__(kThreads)
rasterize_bwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ gids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     int tiles_x, int tiles_y,
                     float alpha_min, float alpha_max, float t_eps,
                     const float* __restrict__ image,
                     const float* __restrict__ depth,
                     const float* __restrict__ final_t,
                     const int* __restrict__ n_contrib,
                     const float* __restrict__ g_image,
                     const float* __restrict__ g_depth,
                     const float* __restrict__ g_alpha,
                     float* __restrict__ dfeats) {
  __shared__ float s_feat[kBatch * kFeat];
  __shared__ float s_grad[kBatch * kFeat];
  __shared__ int s_gid[kBatch];
  __shared__ int s_last;

  const int block = blockIdx.x;  // camera * tiles + tile
  const int count = counts[block];
  if (count == 0) return;  // block-uniform
  const int tiles = tiles_x * tiles_y;
  const int cam = block / tiles;
  const int t = block - cam * tiles;
  const int width = tiles_x * kTile;
  const int height = tiles_y * kTile;
  const int tid = threadIdx.x;
  const int col = (t % tiles_x) * kTile + tid % kTile;
  const int row = (t / tiles_x) * kTile + tid / kTile;
  const float px = (float)col;
  const float py = (float)row;
  const size_t pix = ((size_t)cam * height + row) * width + col;

  const float gr = g_image[pix * 3 + 0];
  const float gg = g_image[pix * 3 + 1];
  const float gb = g_image[pix * 3 + 2];
  const float gd = g_depth[pix];
  const float S = gr * image[pix * 3 + 0] + gg * image[pix * 3 + 1] +
                  gb * image[pix * 3 + 2] + gd * depth[pix] -
                  final_t[pix] * g_alpha[pix];
  const int last = min(n_contrib[pix], count);

  // how far this warp and this block have to walk
  int warp_last = last;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    warp_last = max(warp_last, __shfl_xor_sync(kFull, warp_last, o));
  if (tid == 0) s_last = 0;
  __syncthreads();
  if ((tid & 31) == 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int block_last = s_last;

  float T = 1.0f;
  float P = 0.0f;  // inclusive prefix of w phi
  bool done = false;
  const int start = starts[block];

  for (int base = 0; base < block_last; base += kBatch) {
    const int n = min(kBatch, block_last - base);
    if (tid < n) {
      const int gid = gids[start + base + tid];
      const float* f = feats + (size_t)gid * kFeat;
      float* s = s_feat + tid * kFeat;
#pragma unroll
      for (int j = 0; j < kFeat; ++j) s[j] = f[j];
      s_gid[tid] = gid;
    }
    for (int i = tid; i < n * kFeat; i += kThreads) s_grad[i] = 0.0f;
    __syncthreads();

    const int kend = min(n, warp_last - base);  // warp-uniform, may be <= 0
    for (int k = 0; k < kend; ++k) {
      const float* f = s_feat + k * kFeat;
      bool contrib = false;
      float v0 = 0.0f, v1 = 0.0f, v2 = 0.0f, v3 = 0.0f, v4 = 0.0f;
      float v5 = 0.0f, v6 = 0.0f, v7 = 0.0f, v8 = 0.0f, v9 = 0.0f;
      if (!done && base + k < last) {
        // K1's arithmetic, operation for operation
        const float dx = __fsub_rn(f[FX], px);
        const float dy = __fsub_rn(f[FY], py);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(f[FCA], dx), dx),
                                     __fmul_rn(__fmul_rn(f[FCC], dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(f[FCB], dx), dy));
        if (!(power > 0.0f)) {
          const float e = expf(power);
          const float a_raw = __fmul_rn(f[FOPA], e);
          const float a = fminf(a_raw, alpha_max);
          if (!(a < alpha_min)) {
            const float test_t = __fmul_rn(T, __fsub_rn(1.0f, a));
            if (test_t < t_eps) {
              done = true;
            } else {
              contrib = true;
              const float w = __fmul_rn(a, T);
              const float phi =
                  f[FR] * gr + f[FG] * gg + f[FB] * gb + f[FDEPTH] * gd;
              P += w * phi;
              const float inv = 1.0f / fmaxf(1.0f - a, 1e-6f);
              const float dalpha = T * phi - (S - P) * inv;
              const float dalpha_raw = a_raw < alpha_max ? dalpha : 0.0f;
              const float dpow = power < 0.0f ? dalpha_raw * a_raw : 0.0f;
              v0 = dpow * dx;
              v1 = dpow * dy;
              v2 = v0 * dx;
              v3 = v0 * dy;
              v4 = v1 * dy;
              v5 = gr * w;
              v6 = gg * w;
              v7 = gb * w;
              v8 = dalpha_raw * e;
              v9 = gd * w;
              T = test_t;
            }
          }
        }
      }
      if (__any_sync(kFull, contrib)) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          v0 += __shfl_xor_sync(kFull, v0, o);
          v1 += __shfl_xor_sync(kFull, v1, o);
          v2 += __shfl_xor_sync(kFull, v2, o);
          v3 += __shfl_xor_sync(kFull, v3, o);
          v4 += __shfl_xor_sync(kFull, v4, o);
          v5 += __shfl_xor_sync(kFull, v5, o);
          v6 += __shfl_xor_sync(kFull, v6, o);
          v7 += __shfl_xor_sync(kFull, v7, o);
          v8 += __shfl_xor_sync(kFull, v8, o);
          v9 += __shfl_xor_sync(kFull, v9, o);
        }
        if ((tid & 31) == 0) {
          float* g = s_grad + k * kFeat;
          atomicAdd(g + 0, v0);
          atomicAdd(g + 1, v1);
          atomicAdd(g + 2, v2);
          atomicAdd(g + 3, v3);
          atomicAdd(g + 4, v4);
          atomicAdd(g + 5, v5);
          atomicAdd(g + 6, v6);
          atomicAdd(g + 7, v7);
          atomicAdd(g + 8, v8);
          atomicAdd(g + 9, v9);
        }
      }
    }
    __syncthreads();

    // flush the batch: raw sums -> feature-row gradients, non-zero only
    for (int i = tid; i < n * kFeat; i += kThreads) {
      const int k = i / kFeat;
      const int j = i - k * kFeat;
      const float* g = s_grad + k * kFeat;
      const float* f = s_feat + k * kFeat;
      float val;
      switch (j) {
        case FX: val = -(f[FCA] * g[0] + f[FCB] * g[1]); break;
        case FY: val = -(f[FCC] * g[1] + f[FCB] * g[0]); break;
        case FCA: val = -0.5f * g[2]; break;
        case FCB: val = -g[3]; break;
        case FCC: val = -0.5f * g[4]; break;
        default: val = g[j]; break;
      }
      if (val != 0.0f) atomicAdd(dfeats + (size_t)s_gid[k] * kFeat + j, val);
    }
    __syncthreads();  // the next round overwrites the staged batch
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// `num_blocks` = cameras x tiles_x x tiles_y; `dfeats` [M, 10] must be
// zeroed by the caller. Launches on `stream`, does not synchronize, and
// returns cudaGetLastError() (0 = launched).
extern "C" int hg_rasterize_bwd(const void* feats, const void* gids,
                                const void* starts, const void* counts,
                                int num_blocks, int tiles_x, int tiles_y,
                                float alpha_min, float alpha_max, float t_eps,
                                const void* image, const void* depth,
                                const void* final_t, const void* n_contrib,
                                const void* g_image, const void* g_depth,
                                const void* g_alpha, void* dfeats,
                                void* stream) {
  if (num_blocks > 0) {
    rasterize_bwd_kernel<<<num_blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const int*>(gids),
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        tiles_x, tiles_y, alpha_min, alpha_max, t_eps,
        static_cast<const float*>(image), static_cast<const float*>(depth),
        static_cast<const float*>(final_t),
        static_cast<const int*>(n_contrib),
        static_cast<const float*>(g_image),
        static_cast<const float*>(g_depth),
        static_cast<const float*>(g_alpha), static_cast<float*>(dfeats));
  }
  return static_cast<int>(cudaGetLastError());
}
