// K1: tiled front-to-back alpha compositing of 3D Gaussian splats (forward).
//
// Replaces humangaussian_tpu/ops/rasterize_tiled.py::_fwd_kernel (launched
// by _fwd_call), in the form of the upstream CUDA renderCUDA loop: one
// block per (camera, 32x32 pixel tile) over the whole camera batch in one
// launch; each block walks its tile's depth-sorted pair segment front to
// back. The plain PyTorch version is
// humangaussian_torch/ops/rasterize_tiled.py::composite_plain.
//
// Semantics per pixel (CUDA done-latch; the JAX log-transmittance form is
// the same recurrence):
//   power = -0.5 (ca dx^2 + cc dy^2) - cb dx dy, dx = mean_x - px at
//           integer pixel centers; skip the pair if power > 0
//   alpha = min(alpha_max, opa exp(power)); skip if alpha < alpha_min
//   test_T = T (1 - alpha); if test_T < t_eps the pixel is done and this
//           pair does not contribute
//   else w = T alpha accumulates rgb and depth, T = test_T
// Outputs, written straight into [B, H, W, .] layout: rgb + T bg, depth
// (not normalized), alpha = 1 - T, final T and the last contributor (one
// past the segment-local index of the last contributing pair; the
// backward kernel replays up to it).
//
// What bounds it on Hopper: fp32 ALU work per pair-pixel (about 20 flops
// plus one exp for every pair a pixel visits) and the pair bytes read from
// device memory (a 4-byte pair index plus a 40-byte feature row). The design
// answers both: the block's threads stage a batch of pairs (index gather
// and feature rows) in shared memory once, and every thread reuses each
// staged pair from there; the block stops at the first batch boundary
// where every pixel of the tile is saturated (__syncthreads_count), so
// deep pairs behind an opaque surface cost no ALU work and are never read.
//
// Thread layout: 1024 threads, one pixel each. On an avatar view only a
// few dozen of the 1024 tiles hold pairs, fewer than the card's 132 SMs,
// so the launch takes as long as the longest tile's walk down its
// segment, and that walk is latency-bound: each pair is a chain of
// dependent ops ending in an exp. 32 warps per busy tile hide that
// latency better than 8 warps of 4 pixels each (chip_smoke.py measured
// the 256 x 4 layout slower on the same view; PERF.md). A tile on the
// silhouette never saturates all its pixels and walks its whole segment;
// the early stop pays off only inside the body.
//
// The power term is evaluated with explicit round-to-nearest intrinsics
// (no FMA contraction) in the order the plain version uses, so the kernel
// and its plain version gate the same pairs; exp is the accurate expf.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;
constexpr int kThreads = kTile * kTile;  // one pixel per thread
constexpr int kFeat = 10;
constexpr int kBatch = kThreads;  // pairs staged per round

// per-Gaussian feature row, as ops/rasterize_tiled.py::feature_matrix
enum { FX, FY, FCA, FCB, FCC, FR, FG, FB, FOPA, FDEPTH };

__global__ void __launch_bounds__(kThreads)
rasterize_fwd_kernel(const float* __restrict__ feats,
                     const int* __restrict__ gids,
                     const int* __restrict__ starts,
                     const int* __restrict__ counts,
                     const float* __restrict__ background,
                     int tiles_x, int tiles_y,
                     float alpha_min, float alpha_max, float t_eps,
                     float* __restrict__ image, float* __restrict__ depth,
                     float* __restrict__ alpha_out,
                     float* __restrict__ final_t,
                     int* __restrict__ n_contrib) {
  __shared__ float s_feat[kBatch * kFeat];

  const int block = blockIdx.x;  // camera * tiles + tile
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

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int last = 0;
  bool done = false;

  const int start = starts[block];
  const int count = counts[block];

  for (int base = 0; base < count; base += kBatch) {
    // whole-tile early stop; the barrier also keeps the previous batch's
    // readers ahead of this batch's writers
    if (__syncthreads_count(done) == kThreads) break;
    const int n = min(kBatch, count - base);
    if (tid < n) {
      const float* f = feats + (size_t)gids[start + base + tid] * kFeat;
      float* s = s_feat + tid * kFeat;
#pragma unroll
      for (int j = 0; j < kFeat; ++j) s[j] = f[j];
    }
    __syncthreads();

    for (int k = 0; k < n && !done; ++k) {
      const float* f = s_feat + k * kFeat;
      const float dx = __fsub_rn(f[FX], px);
      const float dy = __fsub_rn(f[FY], py);
      const float quad = __fadd_rn(__fmul_rn(__fmul_rn(f[FCA], dx), dx),
                                   __fmul_rn(__fmul_rn(f[FCC], dy), dy));
      const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                    __fmul_rn(__fmul_rn(f[FCB], dx), dy));
      if (power > 0.0f) continue;
      const float a = fminf(__fmul_rn(f[FOPA], expf(power)), alpha_max);
      if (a < alpha_min) continue;
      const float test_t = __fmul_rn(T, __fsub_rn(1.0f, a));
      if (test_t < t_eps) {
        done = true;
        continue;
      }
      const float w = __fmul_rn(a, T);
      acc_r += f[FR] * w;
      acc_g += f[FG] * w;
      acc_b += f[FB] * w;
      acc_d += f[FDEPTH] * w;
      T = test_t;
      last = base + k + 1;
    }
  }

  const size_t pix = ((size_t)cam * height + row) * width + col;
  image[pix * 3 + 0] = acc_r + T * background[0];
  image[pix * 3 + 1] = acc_g + T * background[1];
  image[pix * 3 + 2] = acc_b + T * background[2];
  depth[pix] = acc_d;
  alpha_out[pix] = 1.0f - T;
  final_t[pix] = T;
  n_contrib[pix] = last;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers;
// `num_blocks` = cameras x tiles_x x tiles_y. Launches on `stream`, does
// not synchronize, and returns cudaGetLastError() (0 = launched).
extern "C" int hg_rasterize_fwd(const void* feats, const void* gids,
                                const void* starts, const void* counts,
                                const void* background, int num_blocks,
                                int tiles_x, int tiles_y, float alpha_min,
                                float alpha_max, float t_eps, void* image,
                                void* depth, void* alpha, void* final_t,
                                void* n_contrib, void* stream) {
  if (num_blocks > 0) {
    rasterize_fwd_kernel<<<num_blocks, kThreads, 0,
                           static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(feats), static_cast<const int*>(gids),
        static_cast<const int*>(starts), static_cast<const int*>(counts),
        static_cast<const float*>(background), tiles_x, tiles_y, alpha_min,
        alpha_max, t_eps, static_cast<float*>(image),
        static_cast<float*>(depth), static_cast<float*>(alpha),
        static_cast<float*>(final_t), static_cast<int*>(n_contrib));
  }
  return static_cast<int>(cudaGetLastError());
}
