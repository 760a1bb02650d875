// K2: backward of the tiled front-to-back compositing (analytic replay VJP),
// and K2b, which adds each Gaussian's pair rows into its feature-row
// gradient.
//
// K2 replaces humangaussian_tpu/ops/rasterize_tiled.py::_bwd_kernel
// (launched by _bwd_call, routed by _render_core_bwd); K2b the XLA routing
// and sums after _bwd_call (rasterize_tiled.py:956-1000). Given the
// cotangents of K1's image, depth and alpha they produce the gradient of
// every per-Gaussian feature row [mean x, y, conic a, b, c, r, g, b,
// opacity, depth]. The plain PyTorch versions are
// humangaussian_torch/ops/rasterize_tiled.py::composite_backward_pairs_plain
// (K2) and feature_row_grads_plain (K2b).
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
// lane contributed to any of the three pairs skips the reduction.
//
// Every sum has a fixed order, so K2 + K2b repeat bit for bit:
// - a pixel's partials of a pair: one product each, no sum;
// - over the 32 pixels of a warp: the butterfly's fixed shuffle pattern;
// - over the two warps of a block: a shared-memory atomicAdd of at most one
//   value a warp into a zeroed slot, 0 + a + b, which float addition gives
//   the same bits in either order (kept: it is one instruction);
// - over the 16 sub-tile blocks of a tile, and over the pairs of a
//   Gaussian: after each round a block stores the sums of every pair it
//   walked as the pair's row for its sub-tile, with plain stores, in a
//   [P, 16, 10] buffer at the pair's candidate index (binning's
//   `pair_cand`: the pair's place in candidate order, feature row then
//   rect tile), and a byte of a [P, 16] mask that says whether the row
//   holds a non-zero sum (every pair below the tile's count gets its 16
//   bytes: 0 for a pair the block dropped, did not reach or that added
//   nothing). K2b then adds, for each Gaussian, its pairs in candidate
//   order (the reference's `pos2` gather route) and each pair's sub-tile
//   rows in sub-tile order 0 to 15; pairs cut by the tile's cap get no
//   mask and are never read (their `cand_pos` is -1).
// A row holds the ten raw sums [sum dpow dx, sum dpow dy, sum dpow dx^2,
// sum dpow dx dy, sum dpow dy^2, drgb, dopacity, ddepth]; K2b turns a
// Gaussian's sums into its feature-row gradient with its own conic (the
// transform is linear in the sums: the same function, applied once a row
// instead of once a pair and sub-tile).
//
// A design that added the 16 blocks' sums of each pair inside the kernel
// (the tile's blocks launched as one 16-block thread-block cluster, one
// cluster barrier a round, block r adding raw positions 4r to 4r + 3 over
// the blocks in distributed shared memory) held every block of a tile to
// the tile's slowest sub-tile round by round, while the skip leaves the
// sub-tiles very uneven work (it drops 88% of the pair x pixel slots at
// the guidance batch): it took 1.8x, 1.3x and 2.7x the atomics design's
// time at the avatar view, the first training view and the guidance batch
// (PERF.md, PR 14). Here the blocks stay independent, and the cost moves
// to the buffer: 1.4 to 6.9 sub-tile rows of 40 bytes a pair written and
// read, 16 mask bytes a pair.
//
// The buffer is laid out in candidate order, not in the sorted order K2
// walks, so that each feature row's pairs own one contiguous span of it:
// the random access sits in K2's stores (fire-and-forget, each 40-byte row
// in a line of its own either way) and K2b reads its spans in order.
//
// K2b is bound by bytes: the masked rows it reads (two 32-byte sectors for
// each 40-byte row), the masks, the conics and the gradient rows. A warp
// owns 32 consecutive feature rows and walks their span in chunks of up to
// 32 candidates. Its lanes read the chunk's `cand_pos` and 16-byte masks
// with coalesced loads (the next chunk's are loaded while this one is
// copied and added), a warp scan of the masked-row counts gives each
// masked sub-tile row a slot of a shared-memory stage in summation order
// (candidate, then sub-tile; the chunk ends before the stage would
// overflow), all lanes copy the rows into their slots with cp.async, and
// each row's lane adds its own slots in order. Where a row has 16 slots or
// more in a chunk (large splats), ten lanes add its ten sums instead, each
// in the same order, so that a long row does not hold the warp to one
// active lane. The gradient rows leave through shared memory as 16-byte
// stores. The design before it ran one thread a row through a chain of
// three dependent gathers a candidate (cand_pos, then the mask, then the
// rows, all at sorted positions scattered over the buffer): latency-bound
// at 20-40% of its bound and 1.5x `index_add_` of the same rows at the
// avatar view (PERF.md). Warps that each own an equal share of rows
// plus candidates (found by a search of row_starts) balanced the load of
// long rows but cost more round trips at the step's batch, and measured
// slower there (PERF.md).
//
// Not carried over from the TPU kernel, which needed them for its hardware:
// the page buffers and pagestart, the candidate-key row and key-only blocks,
// the sort route of gradient rows (K2b is the gather route: binning keeps
// its sort's permutation), the tile-centred monomial matmul (the per-pixel
// products are formed directly), the lane rotate, the triangular-matmul
// cumsum and the DMA double buffers.
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
                     const int* __restrict__ pair_cand,
                     float* __restrict__ rows,
                     unsigned char* __restrict__ mask) {
  __shared__ __align__(16) float s_raw[kBatch * kRow];
  __shared__ __align__(16) float s_walk[kBatch * kRow];
  __shared__ float s_grad[kBatch * kFeat];  // sums by s_walk index
  __shared__ int s_dst[kBatch];  // s_walk index of each raw pair, or -1
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

  // the segment's pair p is candidate c = seg_cand[p]: this sub-tile's
  // row of it is sub_rows[c * kSubs * kFeat], its mask byte
  // sub_mask[c * kSubs]
  const int seg = starts[blk.tile_block];
  const int sub = blockIdx.x % kSubs;
  const int* seg_cand = pair_cand + seg;
  float* sub_rows = rows + sub * kFeat;
  unsigned char* sub_mask = mask + sub;
  int covered = 0;  // pairs [0, covered) have their mask byte

  if (block_last > 0) {  // block-uniform
    const float x0 = (float)blk.x0;
    const float y0 = (float)blk.y0;
    const float gate = alpha_min * (1.0f - kSkipMargin);
    // a lane's partials of the current group of pairs; entries past
    // kGroup * kFeat stay 0 (the butterfly writes only the lower ones)
    float v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) v[i] = 0.0f;
    float* grad_slots = s_grad;
    int* dst_of = s_dst;
    auto prepare = [grad_slots, dst_of, tid](int total, int dst) {
      for (int i = tid; i < total * kFeat; i += kThreads)
        grad_slots[i] = 0.0f;
      dst_of[tid] = dst;
    };
    Stager st{feats, gids + seg, block_last, 0};
    st.load_gid(0, tid);
    st.issue(s_raw, 0, tid);
    st.load_gid(kBatch, tid);
    cp_async_wait_all();
    int n = compact(s_raw, s_walk, s_wn, 0, block_last, x0, y0, gate, tid,
                    prepare);
    for (int base = 0;; base += kBatch) {
      const int next = base + kBatch;
      st.issue(s_raw, next, tid);  // in flight during the walk
      st.load_gid(next + kBatch, tid);
      // where this thread flushes its pair of the round (the pair it
      // staged), loaded now and in flight during the walk
      const int p = base + tid;
      const int cand = p < count ? seg_cand[p] : 0;

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
      __syncthreads();  // the round's sums are in s_grad
      // flush the round: thread tid takes raw pair tid (it staged it):
      // the row and a mask byte of 1 where the block kept the pair and a
      // sum is non-zero, else a mask byte of 0, at the pair's candidate
      if (p < count) {
        const int d = s_dst[tid];
        bool any = false;
        if (d >= 0) {
          const float* g = s_grad + d * kFeat;
#pragma unroll
          for (int j = 0; j < kFeat; ++j) any |= g[j] != 0.0f;
          if (any) {
            float2* o = reinterpret_cast<float2*>(
                sub_rows + (size_t)cand * kSubs * kFeat);
#pragma unroll
            for (int h = 0; h < kFeat / 2; ++h)
              o[h] = make_float2(g[2 * h], g[2 * h + 1]);
          }
        }
        sub_mask[(size_t)cand * kSubs] = any ? 1 : 0;
      }
      if (next >= block_last) {
        covered = min(next, count);
        break;
      }
      // the flush reads s_grad and s_dst before compact's first barrier;
      // their writes come after it
      n = compact(s_raw, s_walk, s_wn, next, block_last, x0, y0, gate, tid,
                  prepare);
    }
  }
  // the pairs past this block's walk add nothing here
  for (int p = covered + tid; p < count; p += kThreads)
    sub_mask[(size_t)seg_cand[p] * kSubs] = 0;
}

constexpr int kRowWarps = 4;  // warps a block of K2b
constexpr int kStage = 128;   // staged sub-tile rows a warp's chunk
constexpr int kChainRows = 16;  // a row with this many slots in a chunk is
                                // added by ten lanes, one sum each
static_assert(kStage >= kSubs, "a candidate's rows fit one chunk");

// a high bit in each byte of w that is not 0
__device__ __forceinline__ unsigned nonzero_bytes(unsigned w) {
  return (((w & 0x7f7f7f7fu) + 0x7f7f7f7fu) | w) & 0x80808080u;
}

// bit s set where mask byte s (sub-tile s) of a candidate is not 0
__device__ __forceinline__ unsigned sub_bits(uint4 m) {
  const unsigned words[4] = {m.x, m.y, m.z, m.w};
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const unsigned nz = nonzero_bytes(words[i]);
    bits |= (((nz >> 7) & 1u) | ((nz >> 14) & 2u) | ((nz >> 21) & 4u) |
             ((nz >> 28) & 8u))
            << (4 * i);
  }
  return bits;
}

// K2b: dfeats[i] = the feature-row gradient of row i: its candidates
// [row_starts[i], row_starts[i + 1]) in order, skipping those the tile's
// cap cut (cand_pos -1), each candidate's sub-tile rows in sub-tile order
// where its mask byte is set, added from 0, then turned into the row's
// gradient with its conic; a row without such a row gets zeros. The
// arithmetic of feature_row_grads_plain, operation for operation. Warp w
// owns rows 32 w to 32 w + 31, lane l row 32 w + l; the rows' candidates
// (and their rows and mask, stored at candidate index) form one span,
// walked in chunks staged in shared memory (the header note). Sixty-four
// registers a thread keep eight blocks (32 warps) on an SM.
__global__ void __launch_bounds__(kRowWarps * 32, 8)
rasterize_bwd_rows_kernel(const float* __restrict__ rows,
                          const unsigned char* __restrict__ mask,
                          const int* __restrict__ cand_pos,
                          const int* __restrict__ row_starts,
                          const float* __restrict__ feats, int n_rows,
                          float* __restrict__ dfeats) {
  __shared__ __align__(16) float s_stage[kRowWarps][kStage * kFeat];
  __shared__ int s_src[kRowWarps][kStage];  // slot -> candidate * 16 + sub
  __shared__ int s_end[kRowWarps][33];  // [j + 1]: past chunk candidate j
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int r0 = (blockIdx.x * kRowWarps + warp) * 32;
  if (r0 >= n_rows) return;  // warp-uniform; the block never syncs
  const int nr = min(32, n_rows - r0);
  float* stage = s_stage[warp];
  int* src = s_src[warp];
  int* end = s_end[warp];
  const bool mine = lane < nr;
  const int i = r0 + lane;
  const int rs = mine ? row_starts[i] : 0;
  const int re = mine ? row_starts[i + 1] : 0;
  // the row's conic, in flight during the walk
  float ca = 0.0f, cb = 0.0f, cc = 0.0f;
  if (re > rs) {
    const float* f = feats + (size_t)i * kFeat;
    ca = f[FCA];
    cb = f[FCB];
    cc = f[FCC];
  }
  const int kb = __shfl_sync(kFull, rs, 0);
  const int ke = __shfl_sync(kFull, re, nr - 1);
  if (lane == 0) end[0] = 0;
  const uint4* mask4 = reinterpret_cast<const uint4*>(mask);
  const uint4 none = make_uint4(0u, 0u, 0u, 0u);

  float s[kFeat];
#pragma unroll
  for (int j = 0; j < kFeat; ++j) s[j] = 0.0f;
  bool any = false;
  // this lane's candidate of the chunk at kc: its cand_pos and mask
  int cp = kb + lane < ke ? cand_pos[kb + lane] : -1;
  uint4 m = kb + lane < ke ? mask4[kb + lane] : none;
  for (int kc = kb; kc < ke;) {  // warp-uniform
    // slots in summation order: an inclusive scan of the masked-row counts
    unsigned bits = cp >= 0 ? sub_bits(m) : 0u;
    const int n = __popc(bits);
    int incl = n;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int t = __shfl_up_sync(kFull, incl, o);
      if (lane >= o) incl += t;
    }
    // the chunk: the leading candidates whose rows fit the stage (at least
    // one: a candidate has at most kSubs rows)
    const int fit =
        min(ke - kc, __popc(__ballot_sync(kFull, incl <= kStage)));
    const int total = __shfl_sync(kFull, incl, fit - 1);
    // the next chunk's candidates, in flight during this one's copy and sums
    const int kn = kc + fit;
    const int cp_next = kn + lane < ke ? cand_pos[kn + lane] : -1;
    const uint4 m_next = kn + lane < ke ? mask4[kn + lane] : none;
    if (lane < fit) {
      int slot = incl - n;
      const int base = (kc + lane) * kSubs;
      for (; bits; bits &= bits - 1) src[slot++] = base + __ffs(bits) - 1;
    }
    end[lane + 1] = incl;
    __syncwarp();
    // every lane copies: 8 bytes of a slot's row each
    for (int j = lane; j < total * (kFeat / 2); j += 32) {
      const int slot = j / (kFeat / 2);
      const int h = j - slot * (kFeat / 2);
      cp_async8(stage + slot * kFeat + 2 * h,
                rows + (size_t)src[slot] * kFeat + 2 * h);
    }
    cp_async_commit();
    cp_async_wait_all();
    __syncwarp();
    // each row adds its slots, its candidates of the chunk, in order
    const int a = min(max(rs - kc, 0), fit);
    const int b = min(max(re - kc, 0), fit);
    const int t0 = a < b ? end[a] : 0;
    const int t1 = a < b ? end[b] : 0;
    any |= t1 > t0;
    if (__reduce_max_sync(kFull, t1 - t0) >= kChainRows) {
      // a long row: its ten sums (chains) are split over lanes, each chain
      // taken from the row's lane and handed back by shuffles
      const unsigned act = __ballot_sync(kFull, t1 > t0);
      const int q = __popc(act & ((1u << lane) - 1u));  // this row's rank
      const int n_chains = __popc(act) * kFeat;
      for (int c0 = 0; c0 < n_chains; c0 += 32) {  // warp-uniform
        const int c = c0 + lane;
        const int nth = c / kFeat;
        const int f = c - nth * kFeat;
        const int r = (int)(__fns(act, 0, nth + 1) & 31u);
        const int u0 = __shfl_sync(kFull, t0, r);
        const int u1 = __shfl_sync(kFull, t1, r);
        float x = 0.0f;
#pragma unroll
        for (int j = 0; j < kFeat; ++j) {
          const float v = __shfl_sync(kFull, s[j], r);
          if (f == j) x = v;
        }
        if (c < n_chains) {
#pragma unroll 4
          for (int t = u0; t < u1; ++t)
            x = __fadd_rn(x, stage[t * kFeat + f]);
        }
#pragma unroll
        for (int j = 0; j < kFeat; ++j) {
          const int from = q * kFeat + j - c0;
          const float v = __shfl_sync(kFull, x, from & 31);
          if (t1 > t0 && from >= 0 && from < 32) s[j] = v;
        }
      }
    } else {
      const float2* st = reinterpret_cast<const float2*>(stage);
#pragma unroll 4
      for (int t = t0; t < t1; ++t) {
#pragma unroll
        for (int h = 0; h < kFeat / 2; ++h) {
          const float2 x = st[t * (kFeat / 2) + h];
          s[2 * h] = __fadd_rn(s[2 * h], x.x);
          s[2 * h + 1] = __fadd_rn(s[2 * h + 1], x.y);
        }
      }
    }
    __syncwarp();  // the stage is refilled next
    kc = kn;
    cp = cp_next;
    m = m_next;
  }

  // the rows' gradients, staged so that the warp stores its nr rows (nr *
  // 40 contiguous bytes) with coalesced 16-byte stores (8-byte at the end)
  if (mine) {
    float2* o = reinterpret_cast<float2*>(stage) + lane * (kFeat / 2);
    if (any) {
      o[0] = make_float2(-__fadd_rn(__fmul_rn(ca, s[0]), __fmul_rn(cb, s[1])),
                         -__fadd_rn(__fmul_rn(cc, s[1]), __fmul_rn(cb, s[0])));
      o[1] = make_float2(__fmul_rn(-0.5f, s[2]), -s[3]);
      o[2] = make_float2(__fmul_rn(-0.5f, s[4]), s[5]);
      o[3] = make_float2(s[6], s[7]);
      o[4] = make_float2(s[8], s[9]);
    } else {
#pragma unroll
      for (int h = 0; h < kFeat / 2; ++h) o[h] = make_float2(0.0f, 0.0f);
    }
  }
  __syncwarp();
  float* dst = dfeats + (size_t)r0 * kFeat;  // 16-byte aligned: r0 % 32 == 0
  const int n_out = nr * kFeat;  // even: a float2 at the end at most
  for (int v = lane; v < n_out / 4; v += 32)
    reinterpret_cast<float4*>(dst)[v] =
        reinterpret_cast<const float4*>(stage)[v];
  if (n_out % 4 && lane == 0)
    reinterpret_cast<float2*>(dst)[n_out / 2 - 1] =
        reinterpret_cast<const float2*>(stage)[n_out / 2 - 1];
}

}  // namespace

// Plain C entry points (loaded with ctypes). Pointers are device pointers.
// Each launches on `stream`, does not synchronize, and returns
// cudaGetLastError() (0 = launched).
//
// hg_rasterize_bwd (K2): `feats` 8-byte aligned; `num_blocks` = cameras x
// tiles_x x tiles_y segments (the launch runs kSubs blocks per segment);
// `pair_cand` [P] int32, each sorted pair's candidate index; `rows` [P, 16,
// 10] f32 and `mask` [P, 16] uint8, P = the length of `gids`: every pair
// below its segment's count gets its 16 mask bytes and a row where its
// byte is 1, at its candidate index; nothing else is written.
extern "C" int hg_rasterize_bwd(const void* feats, const void* gids,
                                const void* starts, const void* counts,
                                int num_blocks, int tiles_x, int tiles_y,
                                float alpha_min, float alpha_max, float t_eps,
                                const void* image, const void* depth,
                                const void* final_t, const void* n_contrib,
                                const void* g_image, const void* g_depth,
                                const void* g_alpha, const void* pair_cand,
                                void* rows, void* mask, void* stream) {
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
        static_cast<const float*>(g_alpha),
        static_cast<const int*>(pair_cand), static_cast<float*>(rows),
        static_cast<unsigned char*>(mask));
  }
  return static_cast<int>(cudaGetLastError());
}

// hg_rasterize_bwd_rows (K2b): K2's `rows` [P, 16, 10] f32 (8-byte
// aligned) and `mask` [P, 16] uint8 (16-byte aligned) at candidate index,
// P < 2^27, `cand_pos` [P] int32 (-1 where the cap cut the
// candidate), `row_starts` [n_rows + 1] int32, `feats` [n_rows, 10] f32;
// writes every row of `dfeats` [n_rows, 10] f32 (16-byte aligned).
extern "C" int hg_rasterize_bwd_rows(const void* rows, const void* mask,
                                     const void* cand_pos,
                                     const void* row_starts,
                                     const void* feats, int n_rows,
                                     void* dfeats, void* stream) {
  if (n_rows > 0) {
    constexpr int kRowsBlock = kRowWarps * 32;
    rasterize_bwd_rows_kernel<<<(n_rows + kRowsBlock - 1) / kRowsBlock,
                                kRowsBlock, 0,
                                static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(rows),
        static_cast<const unsigned char*>(mask),
        static_cast<const int*>(cand_pos),
        static_cast<const int*>(row_starts),
        static_cast<const float*>(feats), n_rows,
        static_cast<float*>(dfeats));
  }
  return static_cast<int>(cudaGetLastError());
}
