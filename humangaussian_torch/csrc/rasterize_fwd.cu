// K1: tiled front-to-back alpha compositing of 3D Gaussian splats (forward).
//
// Replaces humangaussian_tpu/ops/rasterize_tiled.py::_fwd_kernel (launched
// by _fwd_call), in the form of the upstream CUDA renderCUDA loop over each
// tile's depth-sorted pair segment, for the whole camera batch in one
// launch. The plain PyTorch version is
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
// What bounds it on Hopper: the fp32 instruction rate (about 16 issued
// instructions and one exp for every pair a pixel visits, 9 more when the
// pair contributes), provided the work reaches every SM and the dependent
// chain of each visit is hidden by other warps.
//
// The design before this one served a 32x32 binning tile with one block of
// 1024 threads. On a 1024^2 avatar view only about 70 of the 1024 tiles
// hold pairs, fewer than the 132 SMs, so a launch lasted as long as the
// longest tile's serial walk down its segment (up to 4096 pairs); a tile
// on the silhouette never saturates and walks all of it. It measured 1.2446
// ms per avatar view, 30x a bound that counts every pair-pixel visit
// (chip_smoke.py, PERF.md).
//
// Design (rasterize_subtile.cuh): sixteen blocks of 8x8 pixels per tile,
// 64 threads of one pixel. Each block drops, per staged round, the pairs
// that cannot pass the alpha gate at any pixel of its sub-tile (binning's
// exact box bound over the sub-tile) and walks only the survivors, still
// in depth order and with their segment-local indices, so every output is
// what a walk of the whole segment writes. A busy tile becomes sixteen
// blocks (several per SM on an avatar view), a splat of a few pixels is
// walked by the few sub-tiles it touches instead of all 1024 pixels of
// its tile, and the whole-block early stop acts per sub-tile, so interior
// sub-tiles stop sooner. The next round's rows are gathered with cp.async
// while the threads walk the current one. On the card 8x8 blocks were
// faster than 16x16 ones at the avatar view and the guidance batch and
// tied at the training view, and rounds of 64 pairs beat rounds of 128 on
// the guidance batch (variants timed in turns on one card while the
// kernel was built): the finer skip removes more visits than the extra
// staging costs, and the smaller buffers keep more blocks resident.
//
// The power term is evaluated with explicit round-to-nearest intrinsics
// (no FMA contraction) in the order the plain version uses, so the kernel
// and its plain version gate the same pairs; exp is the accurate expf.
#include <cuda_runtime.h>

#include "rasterize_subtile.cuh"

namespace {

using namespace hg_subtile;

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
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
  __shared__ __align__(16) float s_raw[kBatch * kRow];
  __shared__ __align__(16) float s_walk[kBatch * kRow];
  __shared__ int s_wn[kWarps];

  const Block blk = locate(tiles_x, tiles_y);
  const int tid = threadIdx.x;
  const int col = blk.x0 + tid % kSub;
  const int row = blk.y0 + tid / kSub;
  const float px = (float)col;
  const float py = (float)row;
  const float x0 = (float)blk.x0;
  const float y0 = (float)blk.y0;
  const float gate = alpha_min * (1.0f - kSkipMargin);

  float T = 1.0f;
  float acc_r = 0.0f, acc_g = 0.0f, acc_b = 0.0f, acc_d = 0.0f;
  int last = 0;
  bool done = false;

  const int count = counts[blk.tile_block];
  if (count > 0) {  // block-uniform
    Stager st{feats, gids + starts[blk.tile_block], count, 0};
    auto nothing = [](int, int) {};
    st.load_gid(0, tid);
    st.issue(s_raw, 0, tid);
    st.load_gid(kBatch, tid);
    cp_async_wait_all();
    int n = compact(s_raw, s_walk, s_wn, 0, count, x0, y0, gate, tid,
                    nothing);
    for (int base = 0;; base += kBatch) {
      const int next = base + kBatch;
      st.issue(s_raw, next, tid);  // in flight during the walk
      st.load_gid(next + kBatch, tid);

      for (int k = 0; k < n && !done; ++k) {
        const float* f = s_walk + k * kRow;
        const float4 a = reinterpret_cast<const float4*>(f)[0];
        const float4 b = reinterpret_cast<const float4*>(f)[1];
        const float2 c = reinterpret_cast<const float2*>(f)[4];
        // a = x y ca cb, b = cc r g b, c = opa depth
        const float dx = __fsub_rn(a.x, px);
        const float dy = __fsub_rn(a.y, py);
        const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                                     __fmul_rn(__fmul_rn(b.x, dy), dy));
        const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                      __fmul_rn(__fmul_rn(a.w, dx), dy));
        if (power > 0.0f) continue;
        const float al = fminf(__fmul_rn(c.x, expf(power)), alpha_max);
        if (al < alpha_min) continue;
        const float test_t = __fmul_rn(T, __fsub_rn(1.0f, al));
        if (test_t < t_eps) {
          done = true;
          continue;
        }
        const float w = __fmul_rn(al, T);
        acc_r += b.y * w;
        acc_g += b.z * w;
        acc_b += b.w * w;
        acc_d += c.y * w;
        T = test_t;
        last = __float_as_int(f[FIDX]) + 1;
      }

      cp_async_wait_all();
      // whole-sub-tile early stop; the barrier also keeps this round's
      // readers of s_walk ahead of the next round's writers
      if (__syncthreads_count(done) == kThreads || next >= count) break;
      n = compact(s_raw, s_walk, s_wn, next, count, x0, y0, gate, tid,
                  nothing);
    }
  }

  const int width = tiles_x * kTile;
  const int height = tiles_y * kTile;
  const size_t pix = ((size_t)blk.cam * height + row) * width + col;
  image[pix * 3 + 0] = acc_r + T * background[0];
  image[pix * 3 + 1] = acc_g + T * background[1];
  image[pix * 3 + 2] = acc_b + T * background[2];
  depth[pix] = acc_d;
  alpha_out[pix] = 1.0f - T;
  final_t[pix] = T;
  n_contrib[pix] = last;
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// `feats` 8-byte aligned; `num_blocks` = cameras x tiles_x x tiles_y
// segments (the launch runs kSubs blocks per segment). Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() (0 =
// launched).
extern "C" int hg_rasterize_fwd(const void* feats, const void* gids,
                                const void* starts, const void* counts,
                                const void* background, int num_blocks,
                                int tiles_x, int tiles_y, float alpha_min,
                                float alpha_max, float t_eps, void* image,
                                void* depth, void* alpha, void* final_t,
                                void* n_contrib, void* stream) {
  if (num_blocks > 0) {
    rasterize_fwd_kernel<<<num_blocks * kSubs, kThreads, 0,
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
