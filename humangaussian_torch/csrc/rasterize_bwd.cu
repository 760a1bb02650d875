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
// The walk is a front-to-back REPLAY of K1 with K1's arithmetic (the same
// round-to-nearest intrinsics in the same order, the accurate expf,
// product-form T) over the same sub-tile blocks and the same skip rule
// (rasterize_subtile.cuh), so K2 gates the very pairs K1 gated; K1's
// last-contributor index bounds each pixel's walk, each warp's and each
// block's (the largest over the sub-tile), which is the early stop. A
// back-to-front walk that divides T_fin by (1 - alpha) would not reproduce
// K1's T_i bit for bit.
//
// What bounds it on Hopper: as K1, the fp32 instruction rate (the replayed
// visits plus about 40 instructions per contribution), and the sum over
// pixels of each pair's ten partials. The design before this one ran one
// 1024-thread block per 32x32 tile (about 70 busy tiles on 132 SMs at an
// avatar view) and reduced every contributing pair on its own: ten 5-step
// shuffle reductions (50 shuffles, 50 adds) per warp, then ten shared-
// memory atomics queued on lane 0, about twice the pair's own arithmetic
// when the warp is fully active. It measured 4.1156 ms at the first
// training view, 9.1x a bound that counts every replayed visit, and
// 1.6035 ms at an avatar view, 52x (chip_smoke.py, PERF.md).
//
// Design. Sixteen 8x8 sub-tile blocks per tile with the skip and the
// cp.async pipeline of K1. Each lane keeps the ten partials of up to three
// consecutive staged pairs in registers (30 values) and the warp sums them
// with one transposing butterfly reduce-scatter (31 shuffles, about 124
// instructions instead of 3 x 100) that leaves lane l holding the finished
// sum of value l; each lane adds that one sum to the pair's slot in shared
// memory, so the atomics no longer queue on lane 0, and a warp in which no
// lane contributed to any of the three pairs skips the reduction. After
// each round the block flushes the non-zero sums to the Gaussian's row
// with one global atomicAdd per value (a Gaussian sits in several
// sub-tiles, tiles and cameras; the wrapper zeroes the rows). Atomics are
// unordered: results differ from run to run in the last bits.
//
// Not carried over from the TPU kernel, which needed them for its hardware:
// the page buffers and pagestart, the candidate-key row and key-only blocks,
// the gather / sort routing of gradient rows, the tile-centred monomial
// matmul (the per-pixel products are formed directly), the lane rotate, the
// triangular-matmul cumsum and the DMA double buffers.
#include <cuda_runtime.h>

#include "rasterize_subtile.cuh"

namespace {

using namespace hg_subtile;

constexpr int kGroup = 3;  // staged pairs per warp reduction (the walk
                           // below is written out for three)
static_assert(kGroup * kFeat <= 32, "a group's partials fit one warp");

// One step of the reduce-scatter: a lane keeps the half of its first 2 O
// values whose index bit O matches its lane bit, adding the partner lane's
// copy of that half. O is a template argument so that every index is a
// constant and v stays in registers.
template <int O>
__device__ __forceinline__ void butterfly(float (&v)[32], int lane) {
  const bool upper = lane & O;
#pragma unroll
  for (int j = 0; j < O; ++j) {
    const float send = upper ? v[j] : v[j + O];
    const float keep = upper ? v[j + O] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// v[i] summed over the warp lands in lane i (31 shuffles in all)
__device__ __forceinline__ float reduce_scatter(float (&v)[32], int lane) {
  butterfly<16>(v, lane);
  butterfly<8>(v, lane);
  butterfly<4>(v, lane);
  butterfly<2>(v, lane);
  butterfly<1>(v, lane);
  return v[0];
}

// a pixel's replay state
struct Pixel {
  float px, py;          // pixel centre
  float gr, gg, gb, gd;  // cotangents of rgb and depth
  float S;               // see the header note
  float T;               // transmittance before the next pair
  float P;               // inclusive prefix of w phi
  int last;              // pairs at or past this segment index are not walked
  bool done;
};

// Replays one staged pair at the pixel with K1's arithmetic, operation for
// operation; when the pair contributes, writes its ten partials to out and
// returns true.
__device__ __forceinline__ bool replay(Pixel& q, const float* f,
                                       float alpha_min, float alpha_max,
                                       float t_eps, float* out) {
  if (q.done || __float_as_int(f[FIDX]) >= q.last) return false;
  const float4 a = reinterpret_cast<const float4*>(f)[0];  // x y ca cb
  const float4 b = reinterpret_cast<const float4*>(f)[1];  // cc r g b
  const float2 c = reinterpret_cast<const float2*>(f)[4];  // opa depth
  const float dx = __fsub_rn(a.x, q.px);
  const float dy = __fsub_rn(a.y, q.py);
  const float quad = __fadd_rn(__fmul_rn(__fmul_rn(a.z, dx), dx),
                               __fmul_rn(__fmul_rn(b.x, dy), dy));
  const float power = __fsub_rn(__fmul_rn(-0.5f, quad),
                                __fmul_rn(__fmul_rn(a.w, dx), dy));
  if (power > 0.0f) return false;
  const float e = expf(power);
  const float a_raw = __fmul_rn(c.x, e);
  const float al = fminf(a_raw, alpha_max);
  if (al < alpha_min) return false;
  const float test_t = __fmul_rn(q.T, __fsub_rn(1.0f, al));
  if (test_t < t_eps) {
    q.done = true;
    return false;
  }
  const float w = __fmul_rn(al, q.T);
  const float phi = b.y * q.gr + b.z * q.gg + b.w * q.gb + c.y * q.gd;
  q.P += w * phi;
  const float inv = 1.0f / fmaxf(1.0f - al, 1e-6f);
  const float dalpha = q.T * phi - (q.S - q.P) * inv;
  const float dalpha_raw = a_raw < alpha_max ? dalpha : 0.0f;
  const float dpow = power < 0.0f ? dalpha_raw * a_raw : 0.0f;
  out[0] = dpow * dx;
  out[1] = dpow * dy;
  out[2] = out[0] * dx;
  out[3] = out[0] * dy;
  out[4] = out[1] * dy;
  out[5] = q.gr * w;
  out[6] = q.gg * w;
  out[7] = q.gb * w;
  out[8] = dalpha_raw * e;
  out[9] = q.gd * w;
  q.T = test_t;
  return true;
}

// the ten partials of a pair this lane did not contribute to are stale
__device__ __forceinline__ void zero_unless(float* x, bool contributed) {
#pragma unroll
  for (int i = 0; i < kFeat; ++i) x[i] = contributed ? x[i] : 0.0f;
}

__global__ void __launch_bounds__(kThreads, 512 / kThreads)
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
  __shared__ __align__(16) float s_raw[kBatch * kRow];
  __shared__ __align__(16) float s_walk[kBatch * kRow];
  __shared__ float s_grad[kBatch * kFeat];
  __shared__ int s_wn[kWarps];
  __shared__ int s_last;

  const Block blk = locate(tiles_x, tiles_y);
  const int count = counts[blk.tile_block];
  if (count == 0) return;  // block-uniform
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int width = tiles_x * kTile;
  const int height = tiles_y * kTile;
  const int col = blk.x0 + tid % kSub;
  const int row = blk.y0 + tid / kSub;
  const size_t pix = ((size_t)blk.cam * height + row) * width + col;

  Pixel q;
  q.px = (float)col;
  q.py = (float)row;
  q.gr = g_image[pix * 3 + 0];
  q.gg = g_image[pix * 3 + 1];
  q.gb = g_image[pix * 3 + 2];
  q.gd = g_depth[pix];
  q.S = q.gr * image[pix * 3 + 0] + q.gg * image[pix * 3 + 1] +
        q.gb * image[pix * 3 + 2] + q.gd * depth[pix] -
        final_t[pix] * g_alpha[pix];
  q.T = 1.0f;
  q.P = 0.0f;
  q.last = min(n_contrib[pix], count);
  q.done = false;

  // how far this warp and this block have to walk
  const int warp_last = __reduce_max_sync(kFull, q.last);
  if (tid == 0) s_last = 0;
  __syncthreads();
  if (lane == 0) atomicMax(&s_last, warp_last);
  __syncthreads();
  const int block_last = s_last;
  if (block_last == 0) return;  // block-uniform

  const float x0 = (float)blk.x0;
  const float y0 = (float)blk.y0;
  const float gate = alpha_min * (1.0f - kSkipMargin);
  // a lane's partials of the current group of pairs; entries past
  // kGroup * kFeat stay 0 (the butterfly writes only the lower ones)
  float v[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) v[i] = 0.0f;
  float* grad_slots = s_grad;
  auto zero_slots = [grad_slots, tid](int total) {
    for (int i = tid; i < total * kFeat; i += kThreads) grad_slots[i] = 0.0f;
  };
  Stager st{feats, gids + starts[blk.tile_block], block_last, 0};
  st.load_gid(0, tid);
  st.issue(s_raw, 0, tid);
  st.load_gid(kBatch, tid);
  cp_async_wait_all();
  int n = compact(s_raw, s_walk, s_wn, 0, block_last, x0, y0, gate, tid,
                  zero_slots);
  for (int base = 0;; base += kBatch) {
    const int next = base + kBatch;
    st.issue(s_raw, next, tid);  // in flight during the walk
    st.load_gid(next + kBatch, tid);

    // this warp's staged pairs: segment index below warp_last (sorted)
    int kend = 0;
    for (int hi = n; kend < hi;) {
      const int mid = (kend + hi) >> 1;
      if (__float_as_int(s_walk[mid * kRow + FIDX]) < warp_last)
        kend = mid + 1;
      else
        hi = mid;
    }
    for (int k0 = 0; k0 < kend; k0 += kGroup) {  // warp-uniform
      const float* f = s_walk + k0 * kRow;
      const bool c0 = replay(q, f, alpha_min, alpha_max, t_eps, v);
      const bool c1 = k0 + 1 < kend &&
                      replay(q, f + kRow, alpha_min, alpha_max, t_eps,
                             v + kFeat);
      const bool c2 = k0 + 2 < kend &&
                      replay(q, f + 2 * kRow, alpha_min, alpha_max, t_eps,
                             v + 2 * kFeat);
      if (__any_sync(kFull, c0 || c1 || c2)) {
        zero_unless(v, c0);
        zero_unless(v + kFeat, c1);
        zero_unless(v + 2 * kFeat, c2);
        const float sum = reduce_scatter(v, lane);
        if (lane < kGroup * kFeat && sum != 0.0f)
          atomicAdd(s_grad + k0 * kFeat + lane, sum);
      }
    }

    cp_async_wait_all();
    __syncthreads();
    // flush the round: raw sums -> feature-row gradients, non-zero only
    for (int i = tid; i < n * kFeat; i += kThreads) {
      const int k = i / kFeat;
      const int j = i - k * kFeat;
      const float* g = s_grad + k * kFeat;
      const float* f = s_walk + k * kRow;
      float val;
      switch (j) {
        case FX: val = -(f[FCA] * g[0] + f[FCB] * g[1]); break;
        case FY: val = -(f[FCC] * g[1] + f[FCB] * g[0]); break;
        case FCA: val = -0.5f * g[2]; break;
        case FCB: val = -g[3]; break;
        case FCC: val = -0.5f * g[4]; break;
        default: val = g[j]; break;
      }
      if (val != 0.0f)
        atomicAdd(dfeats + (size_t)__float_as_int(f[FGID]) * kFeat + j, val);
    }
    if (next >= block_last) break;
    // the flush reads s_walk and s_grad before compact's first barrier;
    // their writes come after it
    n = compact(s_raw, s_walk, s_wn, next, block_last, x0, y0, gate, tid,
                zero_slots);
  }
}

}  // namespace

// Plain C entry point (loaded with ctypes). Pointers are device pointers,
// `feats` 8-byte aligned; `num_blocks` = cameras x tiles_x x tiles_y
// segments (the launch runs kSubs blocks per segment); `dfeats` [M, 10]
// must be zeroed by the caller. Launches on `stream`, does not synchronize,
// and returns cudaGetLastError() (0 = launched).
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
    rasterize_bwd_kernel<<<num_blocks * kSubs, kThreads, 0,
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
