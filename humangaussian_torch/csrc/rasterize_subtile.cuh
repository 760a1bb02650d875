// The sub-tile blocks that K1 (rasterize_fwd.cu) and K2 (rasterize_bwd.cu)
// share: which pixels a block serves, the pipelined staging of a tile's
// depth-sorted pairs, and the skip rule that drops the pairs which cannot
// pass the alpha gate anywhere in the block's sub-tile.
//
// Each 32x32 binning tile (ops/binning.py) is served by sixteen blocks of
// 8x8 pixels, one pixel a thread. Every block walks its tile's whole
// segment in rounds of 64 pairs, one a thread: the pair index and 40-byte
// feature row of round r + 1 are gathered into shared memory with cp.async
// while the threads walk round r (the rows are gathered by index, so TMA's
// tiled copies do not fit them). Then each thread tests the pair it staged
// against the sub-tile's pixel-centre box with the exact bound binning's
// cull uses (`tile_alpha_bound`, margin 1e-3), and a warp ballot with a
// prefix count compacts the survivors, in segment order, into the buffer
// the next walk reads. A staged row carries the Gaussian's feature row,
// its row index (gid) and its segment-local index, so every pixel still
// sees the pairs that can touch it in the same order and with the same
// indices as a walk of the whole segment. The plain version of the rule is
// humangaussian_torch/ops/rasterize_tiled.py::subtile_pair_mask.
#pragma once

#include <cuda_runtime.h>

namespace hg_subtile {

constexpr int kTile = 32;  // binning tile edge
constexpr int kSub = 8;    // sub-tile edge: one block, one pixel a thread
constexpr int kThreads = kSub * kSub;
constexpr int kWarps = kThreads / 32;
constexpr int kSubsPerEdge = kTile / kSub;
constexpr int kSubs = kSubsPerEdge * kSubsPerEdge;  // blocks per tile
constexpr int kBatch = kThreads;  // pairs per round, one a thread
constexpr int kFeat = 10;
constexpr int kRow = 12;  // staged row: 10 features, gid, segment index
constexpr float kSkipMargin = 1e-3f;  // binning's cull margin
constexpr unsigned kFull = 0xffffffffu;

// a staged row, as ops/rasterize_tiled.py::feature_matrix plus two slots
enum { FX, FY, FCA, FCB, FCC, FR, FG, FB, FOPA, FDEPTH, FGID, FIDX };

struct Block {
  int tile_block;  // camera * tiles + tile: the segment's index
  int cam;
  int x0, y0;  // the sub-tile's first pixel column and row
};

// blockIdx.x = tile_block * kSubs + sub-tile (row-major inside the tile)
__device__ __forceinline__ Block locate(int tiles_x, int tiles_y) {
  Block b;
  b.tile_block = blockIdx.x / kSubs;
  const int s = blockIdx.x - b.tile_block * kSubs;
  const int tiles = tiles_x * tiles_y;
  b.cam = b.tile_block / tiles;
  const int t = b.tile_block - b.cam * tiles;
  b.x0 = (t % tiles_x) * kTile + (s % kSubsPerEdge) * kSub;
  b.y0 = (t / tiles_x) * kTile + (s / kSubsPerEdge) * kSub;
  return b;
}

__device__ __forceinline__ void cp_async8(void* smem, const void* gmem) {
  const unsigned dst =
      static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// The staging of one segment, pairs [0, limit): thread tid stages pair
// base + tid of each round into raw slot tid, and only it reads that slot
// back (in compact), so the raw buffer needs no barrier of its own.
struct Stager {
  const float* feats;
  const int* seg;  // gids + the segment's start
  int limit;
  int gid;         // the gid of the pair whose row is copied next

  // the gid of this thread's pair of the round at `base`; the load stays in
  // flight until issue() reads it a round later
  __device__ __forceinline__ void load_gid(int base, int tid) {
    const int p = base + tid;
    gid = p < limit ? seg[p] : 0;
  }

  // cp.async the feature row of this thread's pair of the round at `base`
  // (its gid loaded)
  __device__ __forceinline__ void issue(float* s_raw, int base, int tid) {
    const int p = base + tid;
    if (p < limit) {
      float* dst = s_raw + tid * kRow;
      const float* src = feats + (size_t)gid * kFeat;
#pragma unroll
      for (int h = 0; h < kFeat; h += 2) cp_async8(dst + h, src + h);
      dst[FGID] = __int_as_float(gid);
      dst[FIDX] = __int_as_float(p);
    }
    cp_async_commit();
  }
};

// ca dx^2 + 2 cb dx dy + cc dy^2 in the order and rounding of the plain
// version's float32 torch expression (cb2 = 2 cb)
__device__ __forceinline__ float quad(float ca, float cb2, float cc, float dx,
                                      float dy) {
  return __fadd_rn(__fadd_rn(__fmul_rn(__fmul_rn(ca, dx), dx),
                             __fmul_rn(__fmul_rn(cb2, dx), dy)),
                   __fmul_rn(__fmul_rn(cc, dy), dy));
}

// binning's exact box bound (ops/binning.py::tile_alpha_bound) over the
// sub-tile's pixel centres and its cull: false when opa exp(-qmin / 2) is
// below `gate` = alpha_min (1 - 1e-3), so the pair fails the alpha gate at
// every pixel of the sub-tile. A conic that is not positive definite (the
// bound assumes a convex quadratic) is always kept.
__device__ __forceinline__ bool may_pass(const float* row, float x0, float y0,
                                         float gate) {
  const float4 a = reinterpret_cast<const float4*>(row)[0];  // x y ca cb
  const float4 b = reinterpret_cast<const float4*>(row)[1];  // cc r g b
  const float opa = row[FOPA];
  const float ca = a.z, cb = a.w, cc = b.x;
  if (!(ca > 0.0f && cc > 0.0f && __fmul_rn(ca, cc) > __fmul_rn(cb, cb)))
    return true;
  const float edge = static_cast<float>(kSub - 1);
  const float dx_hi = __fsub_rn(a.x, x0);
  const float dx_lo = __fsub_rn(dx_hi, edge);
  const float dy_hi = __fsub_rn(a.y, y0);
  const float dy_lo = __fsub_rn(dy_hi, edge);
  float qmin = 0.0f;
  if (!(dx_lo <= 0.0f && 0.0f <= dx_hi && dy_lo <= 0.0f && 0.0f <= dy_hi)) {
    const float ca_s = fmaxf(ca, 1e-12f);
    const float cc_s = fmaxf(cc, 1e-12f);
    const float cb2 = __fmul_rn(2.0f, cb);
    const float ncb = -cb;
    float q = 3.4e38f;
    // each edge's 1-D quadratic at its vertex, clamped to the edge
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cx = e ? dx_hi : dx_lo;
      const float dy =
          fminf(fmaxf(__fdiv_rn(__fmul_rn(ncb, cx), cc_s), dy_lo), dy_hi);
      q = fminf(q, quad(ca, cb2, cc, cx, dy));
      const float cy = e ? dy_hi : dy_lo;
      const float dx =
          fminf(fmaxf(__fdiv_rn(__fmul_rn(ncb, cy), ca_s), dx_lo), dx_hi);
      q = fminf(q, quad(ca, cb2, cc, dx, cy));
    }
    qmin = fmaxf(q, 0.0f);
  }
  return __fmul_rn(opa, expf(__fmul_rn(-0.5f, qmin))) >= gate;
}

// Compacts the raw round at `base`: the pairs below the stager's limit that
// may pass the gate in the sub-tile, in segment order, are copied to s_walk;
// returns how many. Each thread reads only the raw slot it staged. Two
// barriers; `between(total, dst)` runs between them, after every thread has
// passed the first, with `dst` the s_walk index of this thread's raw pair
// (-1 where it was dropped): K2 zeroes its gradient slots there and keeps
// where each raw pair went.
template <typename Between>
__device__ __forceinline__ int compact(const float* s_raw, float* s_walk,
                                       int* s_wn, int base, int limit,
                                       float x0, float y0, float gate,
                                       int tid, Between between) {
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const bool keep =
      base + tid < limit && may_pass(s_raw + tid * kRow, x0, y0, gate);
  const unsigned ballot = __ballot_sync(kFull, keep);
  if (lane == 0) s_wn[warp] = __popc(ballot);
  __syncthreads();
  int total = 0;
  int before = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int n = s_wn[w];
    before += w < warp ? n : 0;
    total += n;
  }
  const int dst = keep ? before + __popc(ballot & ((1u << lane) - 1u)) : -1;
  between(total, dst);
  if (keep) {
    const float4* src = reinterpret_cast<const float4*>(s_raw + tid * kRow);
    float4* out = reinterpret_cast<float4*>(s_walk + dst * kRow);
    out[0] = src[0];
    out[1] = src[1];
    out[2] = src[2];
  }
  __syncthreads();
  return total;
}

}  // namespace hg_subtile
