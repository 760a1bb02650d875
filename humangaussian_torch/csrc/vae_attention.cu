// Single-head attention of width 512 for Hopper (sm_90a): the VAE mid
// block's attention (guidance/vae.py::AttnBlock), its forward and the
// logits pass of its backward.
//
// Replaces no Pallas kernel: humangaussian_tpu/guidance/vae.py:85-87 leaves
// it to XLA einsums (bf16 q and k with float32 accumulation, a float32
// softmax, the probabilities rounded to bf16 before the PV product). For q,
// k, v [B, n, 512] bf16 and scale = 1 / sqrt(512):
//
//   out = softmax(q k^T * scale) v        float32 accumulation, bf16 out
//   lse = log sum exp(q k^T * scale)      float32, one per row
//
// and, for the backward, with D = rowsum(dout * out) and
// P = exp(q k^T * scale - lse):
//
//   P  (bf16)                             for dv = P^T dout
//   dS = P * (dout v^T - D) * scale (bf16)  for dq = dS k, dk = dS^T q
//
// Bound by operations: 4 n^2 512 flops per row block against 2 KB of k and
// v per key, so the tensor cores (989 TFLOP/s bf16) are the limit at n =
// 4096 and 16,384. The head is wide: one 64-row block's float32 output is
// 128 KB, half the register file, and its q is 64 KB, over a quarter of the
// shared memory. So a block holds only 64 query rows, and every block
// streams all of its batch entry's k and v (64 flops a byte), through rings
// of two or three 32-key tiles: all the shared memory leaves. At (8, 16384)
// both kernels move 69 GB of k and v (5.6-6.2 TB/s) and run at 37-40% of
// the tensor cores' rate. Measured on an H100, none of these moved them:
// dropping the backward's stores (-7%), removing ptxas's wgmma
// serialization, and halving the L2 traffic by loading each tile once for
// two blocks of a cluster (TMA multicast: about 1.3-2x slower, the pair's
// rings in lock-step).
//
// Forward design. A block owns 64 query rows of one batch entry and is three
// warpgroups: a producer (setmaxnreg 24) whose one thread issues TMA loads,
// and two consumers (setmaxnreg 240) that split the 512 channels into
// halves. q stays in shared memory (8 spans of 64 channels, the 128-byte
// swizzle TMA writes and wgmma reads); k and v stream in tiles of 32 keys
// through two-slot rings (a tile is 8 spans, 32 KB), each slot guarded by a
// "full" and an "empty" mbarrier.
//  - Each consumer computes the tile's logits over its own 256 channels
//    (16 wgmma m64n32k16, both operands in shared memory) and writes that
//    partial to shared memory; after a named barrier it adds the other
//    half's partial (own + other: the same float32 sum in both, since
//    addition commutes), so both hold the same [64 x 32] logits and run the
//    same online softmax (running row maximum, l from the float32 p, p
//    rounded to bf16 against the running maximum, as K4 does). No product
//    is computed twice; only the exps are.
//  - Each consumer accumulates its 256 output channels, O += P V: the p
//    registers are the A operand (the float32 accumulator layout of the
//    logits is the bf16 A-fragment layout) and each v span an MN-major B,
//    eight wgmma m64n64k16 a tile. O is 128 registers a thread.
//  - The logits of tile t are issued, O is rescaled and O += P(t-1) V(t-1)
//    issued behind them, and the exchange and softmax of tile t run while
//    the PV product still does.
//  - Partials are double-buffered by tile parity (32 KB), so one named
//    barrier a tile is enough. Shared memory: q 64 KB, rings 128 KB.
//  - Epilogue: O / l in float32, cast to bf16, staged over q, stored with
//    16-byte stores; lse = (m + log2 l) ln 2.
//
// Backward logits pass. The backward's accumulators do not fit: dk and dv of
// 64 keys are 256 KB of float32, the whole register file, and a block that
// holds 32 keys' dk and dv (128 KB) needs q and dout of its query tile twice
// each, past the shared memory. So this pass writes P and dS in bf16 (the
// wrapper runs it over as many batch entries as 1 GiB of them takes) and
// the three products that reduce over rows are the library's bf16 GEMMs.
// A block owns 64 query rows; one consumer holds q as the A fragments of its
// 32 k-steps in registers (128 registers a thread) and computes the logits of
// each 32-key tile (32 wgmma m64n32k16, B = k spans), the other holds dout and
// computes dP = dout v^T; k and v stream through three-slot rings. The
// logits side forms P = exp2(s c - lse log2 e) in float32, hands it to the
// dP side through a two-slot mbarrier ring in shared memory and stores P in
// bf16; the dP side forms dS from the float32 P and dP and stores it. D is
// summed once per block from the dout and out fragments. Each side keeps two
// accumulators and issues the next tile's product before the elementwise
// work on the current one.
//
// Numerics: the logits are bf16 x bf16 products summed in float32 (exact
// products, another order of sums than the library's); exp is exp2 of an
// fma with scale log2(e) folded in, which needs scale > 0.
#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kC = 512;                        // channels: the head width
constexpr int kSpan = 64;                      // channels of a 128-byte row
constexpr int kSpans = kC / kSpan;             // 8
constexpr int kRowBytes = kSpan * 2;           // 128: one swizzle span
constexpr int kRows = 64;                      // query rows a block (wgmma M)
constexpr int kBK = 32;                        // keys a tile
constexpr int kThreads = 384;                  // producer + two consumers
constexpr int kQSpanBytes = kRows * kRowBytes;      // 8 KB
constexpr int kKVSpanBytes = kBK * kRowBytes;       // 4 KB
constexpr int kQBytes = kSpans * kQSpanBytes;       // 64 KB
constexpr int kTileBytes = kSpans * kKVSpanBytes;   // 32 KB
constexpr int kHalfSpans = kSpans / 2;         // spans of a consumer's half
constexpr int kFwdStages = 2;
constexpr int kBwdStages = 3;
constexpr int kOPitch = kC + 8;                // bf16 a staged output row
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct FwdSmem {
  alignas(1024) uint8_t q[kSpans][kQSpanBytes];
  alignas(1024) uint8_t k[kFwdStages][kSpans][kKVSpanBytes];
  alignas(1024) uint8_t v[kFwdStages][kSpans][kKVSpanBytes];
  float4 part[2][2][4][128];  // tile parity, half, float4 index, thread
  uint64_t q_full;
  uint64_t k_full[kFwdStages], k_empty[kFwdStages];
  uint64_t v_full[kFwdStages], v_empty[kFwdStages];
};
// the staged output overlays q and the first k slot
static_assert(kRows * kOPitch * 2 <= kQBytes + kTileBytes, "staging");

struct BwdSmem {
  alignas(1024) uint8_t k[kBwdStages][kSpans][kKVSpanBytes];
  alignas(1024) uint8_t v[kBwdStages][kSpans][kKVSpanBytes];
  float4 p[2][4][128];  // slot, float4 index, thread: float32 P
  uint64_t k_full[kBwdStages], k_empty[kBwdStages];
  uint64_t v_full[kBwdStages], v_empty[kBwdStages];
  uint64_t p_full[2], p_empty[2];
};
// the dynamic allocation is aligned to 1024 bytes by hand
constexpr int kFwdSmemBytes = sizeof(FwdSmem) + 1024;
constexpr int kBwdSmemBytes = sizeof(BwdSmem) + 1024;
static_assert(kFwdSmemBytes <= 232448 && kBwdSmemBytes <= 232448, "smem");

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers --------------------------------------------------------
__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" :: "r"(smem_u32(bar)), "r"(parity) : "memory");
}

// ---- TMA --------------------------------------------------------------
// One box of a [rows, 512] bf16 map: 64 channels from `col`, rows from `row`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(col), "r"(row)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------
// Shared-memory matrix descriptor of a span of 128-byte rows written by TMA
// with the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO = 64 in
// 16-byte units); LBO is unused (one swizzle span along the contiguous
// dimension).
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return static_cast<uint64_t>((smem_u32(tile) & 0x3FFFF) >> 4)
         | (static_cast<uint64_t>(1) << 16)
         | (static_cast<uint64_t>(64) << 32)
         | (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmma and its wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i]) :: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_ss32(float (&d)[16], uint64_t da,
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] B[16 x 32]; A (bf16 pairs) in registers, B
// K-major in shared memory.
__device__ __forceinline__ void wgmma_rs32(float (&d)[16],
                                           const uint32_t (&a)[4],
                                           uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A (bf16 pairs) in registers, B in
// shared memory MN-major (its rows hold the 64 output channels).
__device__ __forceinline__ void wgmma_pv(float (&d)[32], uint32_t a0,
                                         uint32_t a1, uint32_t a2,
                                         uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}

// ---- forward ------------------------------------------------------------
// Ring slot and phase parity of tile t in a two-slot ring.
__device__ __forceinline__ int slot2(int t) { return t & 1; }
__device__ __forceinline__ uint32_t parity2(int t) { return (t >> 1) & 1; }

// Issue this half's partial logits of one tile: its 4 spans x 4 k-steps of
// 16 channels (32 bytes along the swizzled rows); one commit group.
__device__ __forceinline__ void issue_logits(float (&s)[16],
                                             const FwdSmem& sm, int tile_slot,
                                             int half) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kHalfSpans; ++j) {
    const int span = half * kHalfSpans + j;
    const uint64_t qd = desc_sw128(sm.q[span]);
    const uint64_t kd = desc_sw128(sm.k[tile_slot][span]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_ss32(s, qd + 2 * kk, kd + 2 * kk, (j | kk) != 0);
  }
  wgmma_commit();
}

// Issue O += P V for this half's 4 spans of one tile: two k-steps of 16
// keys each (the A fragment of keys 16 kk .. 16 kk + 15 is p[4 kk .. 4 kk +
// 3]; the descriptor moves 16 rows, 2048 bytes, a step). One commit group;
// p and o must not change until it is waited for.
__device__ __forceinline__ void issue_pv(float (&o)[kHalfSpans][32],
                                         uint32_t (&p)[8], const FwdSmem& sm,
                                         int tile_slot, int half) {
  wgmma_fence();
#pragma unroll
  for (int j = 0; j < kHalfSpans; ++j) {
    const uint64_t vd = desc_sw128(sm.v[tile_slot][half * kHalfSpans + j]);
#pragma unroll
    for (int kk = 0; kk < 2; ++kk)
      wgmma_pv(o[j], p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
               vd + 128 * kk);
  }
  wgmma_commit();
  fence_regs(p);
}

// Add the other half's partial logits to this half's: write ours, meet at
// named barrier 1 (both consumers), read theirs. Own + other is the same
// float32 sum in both halves.
__device__ __forceinline__ void exchange(float (&s)[16],
                                         float4 (&part)[2][4][128], int half,
                                         int tid) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    part[half][j][tid] =
        make_float4(s[4 * j], s[4 * j + 1], s[4 * j + 2], s[4 * j + 3]);
  named_barrier(1, 256);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float4 x = part[half ^ 1][j][tid];
    s[4 * j] += x.x;
    s[4 * j + 1] += x.y;
    s[4 * j + 2] += x.z;
    s[4 * j + 3] += x.w;
  }
}

// Online softmax of one tile of raw logits s (s[4 j + 0/1] row r0,
// s[4 j + 2/3] row r1, columns 8 j + c0 + 0/1): the new running maxima m0,
// m1 (log2 units), the factors alpha = exp(m_old - m) that l (here) and O
// (later) are rescaled by, and p = exp(logit - m) in float32, in place of s;
// l adds the float32 p. A row lives in one quad of lanes.
__device__ __forceinline__ void online_softmax(float (&s)[16], float c,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& alpha0,
                                               float& alpha1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    mx0 = fmaxf(mx0, fmaxf(s[4 * j + 0], s[4 * j + 1]));
    mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  // c > 0, so the maximum of the scaled logits is c times the raw one
  const float n0 = fmaxf(m0, mx0 * c), n1 = fmaxf(m1, mx1 * c);
  alpha0 = ex2(m0 - n0);
  alpha1 = ex2(m1 - n1);
  m0 = n0;
  m1 = n1;
  float sum0 = 0.0f, sum1 = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[4 * j + 0] = ex2(fmaf(s[4 * j + 0], c, -n0));
    s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], c, -n0));
    s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], c, -n1));
    s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], c, -n1));
    sum0 += s[4 * j + 0] + s[4 * j + 1];
    sum1 += s[4 * j + 2] + s[4 * j + 3];
  }
  l0 = l0 * alpha0 + sum0;
  l1 = l1 * alpha1 + sum1;
}

// p in bf16 pairs for the PV product: p[2 j] row r0, p[2 j + 1] row r1,
// columns 8 j + c0 + 0/1.
__device__ __forceinline__ void pack_p(const float (&s)[16],
                                       uint32_t (&p)[8]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    p[2 * j] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[kHalfSpans][32],
                                        float alpha0, float alpha1) {
#pragma unroll
  for (int i = 0; i < kHalfSpans; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      o[i][4 * j + 0] *= alpha0;
      o[i][4 * j + 1] *= alpha0;
      o[i][4 * j + 2] *= alpha1;
      o[i][4 * j + 3] *= alpha1;
    }
}

__global__ void __launch_bounds__(kThreads, 1)
vae_attn_forward(const __grid_constant__ CUtensorMap q_map,
                         const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         bf16* __restrict__ out, float* __restrict__ lse,
                         int n, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  FwdSmem& sm = *reinterpret_cast<FwdSmem*>(smem_raw + pad);

  const int row0 = blockIdx.y * n;            // this batch entry's first row
  const int q0 = blockIdx.x * kRows;
  const int tiles = n / kBK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kFwdStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 256);
      mbar_init(&sm.v_empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread keeps the rings of k and v tiles filled ---
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kQBytes);
      for (int j = 0; j < kSpans; ++j)
        tma_load(sm.q[j], &q_map, &sm.q_full, j * kSpan, row0 + q0);
      for (int t = 0; t < tiles; ++t) {
        const int row = row0 + t * kBK, s = slot2(t);
        mbar_wait(&sm.k_empty[s], parity2(t) ^ 1);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        for (int j = 0; j < kSpans; ++j)
          tma_load(sm.k[s][j], &k_map, &sm.k_full[s], j * kSpan, row);
        mbar_wait(&sm.v_empty[s], parity2(t) ^ 1);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        for (int j = 0; j < kSpans; ++j)
          tma_load(sm.v[s][j], &v_map, &sm.v_full[s], j * kSpan, row);
      }
    }
  } else {
    // ---- consumers: one half of the channels each ------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int half = warpgroup - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's two rows of the block's 64 and its column offset inside
    // every 8-column block of an accumulator
    const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
    const int c0 = 2 * (lane % 4);

    float o[kHalfSpans][32];
#pragma unroll
    for (int i = 0; i < kHalfSpans; ++i)
#pragma unroll
      for (int j = 0; j < 32; ++j) o[i][j] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
    float l0 = 0.0f, l1 = 0.0f;            // this thread's partial row sums
    float alpha0, alpha1;                  // O's pending rescale
    float s[16];
    uint32_t p[8];

    mbar_wait(&sm.q_full, 0);

    // tile 0: logits, softmax, P (O is zero, so its rescale does not matter)
    mbar_wait(&sm.k_full[0], 0);
    issue_logits(s, sm, 0, half);
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&sm.k_empty[0]);
    exchange(s, sm.part[0], half, tid);
    online_softmax(s, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    pack_p(s, p);

    for (int t = 1; t < tiles; ++t) {
      mbar_wait(&sm.k_full[slot2(t)], parity2(t));
      issue_logits(s, sm, slot2(t), half);
      rescale(o, alpha0, alpha1);
      mbar_wait(&sm.v_full[slot2(t - 1)], parity2(t - 1));
      issue_pv(o, p, sm, slot2(t - 1), half);
      wgmma_wait<1>();  // the logits are done, the PV product may still run
      fence_regs(s);
      mbar_arrive(&sm.k_empty[slot2(t)]);
      exchange(s, sm.part[t & 1], half, tid);
      online_softmax(s, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < kHalfSpans; ++i) fence_regs(o[i]);
      fence_regs(s);  // p is rewritten only after the PV product is done
      mbar_arrive(&sm.v_empty[slot2(t - 1)]);
      pack_p(s, p);
    }
    rescale(o, alpha0, alpha1);
    const int last = tiles - 1;
    mbar_wait(&sm.v_full[slot2(last)], parity2(last));
    issue_pv(o, p, sm, slot2(last), half);
    wgmma_wait<0>();
#pragma unroll
    for (int i = 0; i < kHalfSpans; ++i) fence_regs(o[i]);

    // ---- epilogue: out = O / l, staged over q, 16 bytes a store ----------
    // (both halves finished their last logits before the last exchange, so
    // q and the k ring are no longer read)
    l0 = quad_sum(l0);
    l1 = quad_sum(l1);
    bf16* so = reinterpret_cast<bf16*>(&sm.q[0][0]);
#pragma unroll
    for (int i = 0; i < kHalfSpans; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = (half * kHalfSpans + i) * kSpan + 8 * j + c0;
        *reinterpret_cast<__nv_bfloat162*>(so + r0 * kOPitch + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[i][4 * j + 0], l0),
                                  __fdiv_rn(o[i][4 * j + 1], l0));
        *reinterpret_cast<__nv_bfloat162*>(so + r1 * kOPitch + col) =
            __floats2bfloat162_rn(__fdiv_rn(o[i][4 * j + 2], l1),
                                  __fdiv_rn(o[i][4 * j + 3], l1));
      }
    // this half's 128 threads only (named barrier 2 or 3)
    named_barrier(2 + half, 128);
    const int col0 = half * (kC / 2);
    bf16* ob = out + static_cast<size_t>(row0 + q0) * kC + col0;
#pragma unroll
    for (int it = 0; it < 16; ++it) {
      const int chunk = tid + 128 * it;  // 64 rows x 32 chunks of 8 bf16
      const int r = chunk / 32, c = (chunk % 32) * 8;
      *reinterpret_cast<uint4*>(ob + static_cast<size_t>(r) * kC + c) =
          *reinterpret_cast<const uint4*>(so + r * kOPitch + col0 + c);
    }
    if (half == 0 && (lane & 3) == 0) {
      lse[row0 + q0 + r0] = (m0 + log2f(l0)) * kLn2;
      lse[row0 + q0 + r1] = (m1 + log2f(l1)) * kLn2;
    }
  }
}

// ---- backward logits pass -------------------------------------------------
__device__ __forceinline__ int slot3(int t) { return t % kBwdStages; }
__device__ __forceinline__ uint32_t parity3(int t) {
  return (t / kBwdStages) & 1;
}

__device__ __forceinline__ uint32_t load_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
// The two bf16 of a pair (low half first) as float32.
__device__ __forceinline__ float bf16_lo(uint32_t x) {
  return __uint_as_float(x << 16);
}
__device__ __forceinline__ float bf16_hi(uint32_t x) {
  return __uint_as_float(x & 0xffff0000u);
}

// The A fragments of one consumer's 64 rows x 512 channels of x ([rows,
// 512] bf16 from `rows`): for k-step kk, a[kk][0] row r0 and a[kk][1] row
// r1 at channels 16 kk + c0 + 0/1, a[kk][2] and a[kk][3] eight channels on.
__device__ __forceinline__ void load_fragments(uint32_t (&a)[32][4],
                                               const bf16* x, int r0, int r1,
                                               int c0) {
  const bf16* x0 = x + static_cast<size_t>(r0) * kC + c0;
  const bf16* x1 = x + static_cast<size_t>(r1) * kC + c0;
#pragma unroll
  for (int kk = 0; kk < 32; ++kk) {
    a[kk][0] = load_pair(x0 + 16 * kk);
    a[kk][1] = load_pair(x1 + 16 * kk);
    a[kk][2] = load_pair(x0 + 16 * kk + 8);
    a[kk][3] = load_pair(x1 + 16 * kk + 8);
  }
}

// Issue x k^T (or dout v^T) of one tile: 32 k-steps of 16 channels, the B
// span moving every 4 steps; one commit group.
__device__ __forceinline__ void issue_rows(float (&s)[16],
                                           const uint32_t (&a)[32][4],
                                           const uint8_t (&tile)[kSpans]
                                                                [kKVSpanBytes]) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 32; ++kk)
    wgmma_rs32(s, a[kk], desc_sw128(tile[kk / 4]) + 2 * (kk % 4), kk != 0);
  wgmma_commit();
}

// Store one [64 x 32] tile of bf16 values of this thread's accumulator
// layout (rows r0 and r1, columns 8 j + c0 + 0/1) into columns from `col`
// of a [rows, n] matrix from `base`. (Staging the tile in shared memory for
// 16-byte stores measured no faster.)
__device__ __forceinline__ void store_tile(bf16* base, size_t pitch, int r0,
                                           int r1, int col,
                                           const float (&x)[16]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    *reinterpret_cast<uint32_t*>(base + r0 * pitch + col + 8 * j) =
        pack_bf16(x[4 * j], x[4 * j + 1]);
    *reinterpret_cast<uint32_t*>(base + r1 * pitch + col + 8 * j) =
        pack_bf16(x[4 * j + 2], x[4 * j + 3]);
  }
}

// One consumer of the backward logits pass, for its block's 64 rows: the
// logits side (kLogits: x = q, forms P from lse and hands it over) or the
// dP side (x = dout, forms dS from P, dP and D). Tile t's product is waited
// for, copied out and the next tile's issued before the elementwise work on
// tile t. `x`, `lse` (logits side), `out` (dP side) and `dst` point at the
// block's first row.
template <bool kLogits>
__device__ __forceinline__ void bwd_consumer(BwdSmem& sm, const bf16* x,
                                             const float* lse,
                                             const bf16* out, bf16* dst,
                                             int n, int tiles, float scale,
                                             float scale_log2) {
  const int tid = threadIdx.x % 128;
  const int warp = tid / 32, lane = tid % 32;
  const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
  const int c0 = 2 * (lane % 4);
  const size_t pitch = static_cast<size_t>(n);

  uint32_t a[32][4];
  float s[16], v[16];
  float row_a, row_b;  // -lse log2(e) (logits side) or D (dP side), r0 / r1
  load_fragments(a, x, r0, r1, c0);
  if (kLogits) {
    row_a = -lse[r0] * kLog2e;
    row_b = -lse[r1] * kLog2e;
  } else {
    // D = rowsum(dout * out) over this thread's 128 channels of each row,
    // then over the quad: a fixed order
    const bf16* o0 = out + static_cast<size_t>(r0) * kC + c0;
    const bf16* o1 = out + static_cast<size_t>(r1) * kC + c0;
    float d0 = 0.0f, d1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 32; ++kk) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint32_t ov0 = load_pair(o0 + 16 * kk + 8 * h);
        const uint32_t ov1 = load_pair(o1 + 16 * kk + 8 * h);
        const uint32_t g0 = a[kk][2 * h], g1 = a[kk][2 * h + 1];
        d0 = fmaf(bf16_hi(g0), bf16_hi(ov0),
                  fmaf(bf16_lo(g0), bf16_lo(ov0), d0));
        d1 = fmaf(bf16_hi(g1), bf16_hi(ov1),
                  fmaf(bf16_lo(g1), bf16_lo(ov1), d1));
      }
    }
    row_a = quad_sum(d0);
    row_b = quad_sum(d1);
  }

  uint64_t* const full = kLogits ? sm.k_full : sm.v_full;
  uint64_t* const empty = kLogits ? sm.k_empty : sm.v_empty;
  uint8_t (*const ring)[kSpans][kKVSpanBytes] = kLogits ? sm.k : sm.v;

  // tile t's product (in `x`) is done: release its slot
  auto take = [&](int t, float (&x)[16]) {
    wgmma_wait<0>();
    fence_regs(x);
    mbar_arrive(&empty[slot3(t)]);
  };
  // the elementwise work on tile t's product, in place, and its store
  auto finish = [&](int t, float (&x)[16]) {
    const int ps = t & 1;
    const uint32_t pp = (t >> 1) & 1;
    if (kLogits) {
      // P = exp2(s c - lse log2 e), float32 to the dP side, bf16 out
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        x[4 * j + 0] = ex2(fmaf(x[4 * j + 0], scale_log2, row_a));
        x[4 * j + 1] = ex2(fmaf(x[4 * j + 1], scale_log2, row_a));
        x[4 * j + 2] = ex2(fmaf(x[4 * j + 2], scale_log2, row_b));
        x[4 * j + 3] = ex2(fmaf(x[4 * j + 3], scale_log2, row_b));
      }
      mbar_wait(&sm.p_empty[ps], pp ^ 1);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sm.p[ps][j][tid] = make_float4(x[4 * j], x[4 * j + 1], x[4 * j + 2],
                                       x[4 * j + 3]);
      mbar_arrive(&sm.p_full[ps]);
    } else {
      // dS = P (dP - D) scale
      mbar_wait(&sm.p_full[ps], pp);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float4 pv = sm.p[ps][j][tid];
        x[4 * j + 0] = pv.x * (x[4 * j + 0] - row_a) * scale;
        x[4 * j + 1] = pv.y * (x[4 * j + 1] - row_a) * scale;
        x[4 * j + 2] = pv.z * (x[4 * j + 2] - row_b) * scale;
        x[4 * j + 3] = pv.w * (x[4 * j + 3] - row_b) * scale;
      }
      mbar_arrive(&sm.p_empty[ps]);
    }
    store_tile(dst, pitch, r0, r1, t * kBK + c0, x);
  };
  auto issue = [&](int t, float (&x)[16]) {
    mbar_wait(&full[slot3(t)], parity3(t));
    issue_rows(x, a, ring[slot3(t)]);
  };

  // two accumulators in turn: the next tile's product runs while this
  // one's elementwise work does (tiles is even: n is a multiple of 64)
  issue(0, s);
  for (int t = 0; t + 2 < tiles; t += 2) {
    take(t, s);
    issue(t + 1, v);
    finish(t, s);
    take(t + 1, v);
    issue(t + 2, s);
    finish(t + 1, v);
  }
  take(tiles - 2, s);
  issue(tiles - 1, v);
  finish(tiles - 2, s);
  take(tiles - 1, v);
  finish(tiles - 1, v);
}

__global__ void __launch_bounds__(kThreads, 1)
vae_attn_backward_logits(const __grid_constant__ CUtensorMap k_map,
                         const __grid_constant__ CUtensorMap v_map,
                         const bf16* __restrict__ q,
                         const bf16* __restrict__ out,
                         const bf16* __restrict__ dout,
                         const float* __restrict__ lse,
                         bf16* __restrict__ p_out, bf16* __restrict__ ds_out,
                         int n, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  BwdSmem& sm = *reinterpret_cast<BwdSmem*>(smem_raw + pad);

  const int row0 = blockIdx.y * n;
  const int q0 = blockIdx.x * kRows;
  const int tiles = n / kBK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kBwdStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 128);
      mbar_init(&sm.v_empty[s], 128);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&sm.p_full[s], 128);
      mbar_init(&sm.p_empty[s], 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      for (int t = 0; t < tiles; ++t) {
        const int row = row0 + t * kBK, s = slot3(t);
        mbar_wait(&sm.k_empty[s], parity3(t) ^ 1);
        mbar_expect_tx(&sm.k_full[s], kTileBytes);
        for (int j = 0; j < kSpans; ++j)
          tma_load(sm.k[s][j], &k_map, &sm.k_full[s], j * kSpan, row);
        mbar_wait(&sm.v_empty[s], parity3(t) ^ 1);
        mbar_expect_tx(&sm.v_full[s], kTileBytes);
        for (int j = 0; j < kSpans; ++j)
          tma_load(sm.v[s][j], &v_map, &sm.v_full[s], j * kSpan, row);
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const size_t first = static_cast<size_t>(row0 + q0);
  if (warpgroup == 1)
    bwd_consumer<true>(sm, q + first * kC, lse + first, nullptr,
                       p_out + first * n, n, tiles, scale, scale_log2);
  else
    bwd_consumer<false>(sm, dout + first * kC, nullptr, out + first * kC,
                        ds_out + first * n, n, tiles, scale, scale_log2);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [rows, 512] bf16 map read in boxes of 64 channels x box_rows rows.
bool make_map(CUtensorMap* map, const void* base, long long rows,
              int box_rows) {
  const cuuint64_t dims[2] = {kC, static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {kC * 2};
  const cuuint32_t box[2] = {kSpan, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t elem[2] = {1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

bool bad_shape(int batch, int n, float scale) {
  return batch <= 0 || batch > 65535 || n <= 0 || n % kRows != 0
         || static_cast<long long>(batch) * n > (1LL << 31) - 1
         || !(scale > 0.0f);
}

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& done) {
  if (done) return cudaSuccess;
  const cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = rc == cudaSuccess;
  return rc;
}

}  // namespace

// Plain C entry points (loaded with ctypes). q, k, v, out, dout: [batch, n,
// 512] bf16; lse: [batch, n] float32; p, ds: [batch, n, n] bf16; all
// contiguous device pointers, 16-byte aligned; n a positive multiple of 64;
// scale > 0. Each launches on `stream`, does not synchronize, and returns
// cudaGetLastError() after the launch (0 = launched), or
// cudaErrorInvalidValue for arguments it does not take and
// cudaErrorNotSupported when the driver has no tensor-map encoder.

// out = softmax(q k^T scale) v and its lse.
extern "C" int hg_vae_attention_fwd(const void* q, const void* k,
                                    const void* v, void* out, void* lse,
                                    int batch, int n, float scale,
                                    void* stream) {
  if (bad_shape(batch, n, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const long long rows = static_cast<long long>(batch) * n;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, rows, kRows) || !make_map(&k_map, k, rows, kBK)
      || !make_map(&v_map, v, rows, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  const cudaError_t rc =
      allow_smem(vae_attn_forward, kFwdSmemBytes, configured);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(n / kRows, batch);
  vae_attn_forward<<<grid, kThreads, kFwdSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), static_cast<float*>(lse),
      n, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// P and dS of the backward from q, k, v, out, dout and the forward's lse.
extern "C" int hg_vae_attention_bwd(const void* q, const void* k,
                                    const void* v, const void* out,
                                    const void* dout, const void* lse,
                                    void* p, void* ds, int batch, int n,
                                    float scale, void* stream) {
  if (bad_shape(batch, n, scale))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  const long long rows = static_cast<long long>(batch) * n;
  CUtensorMap k_map, v_map;
  if (!make_map(&k_map, k, rows, kBK) || !make_map(&v_map, v, rows, kBK))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  const cudaError_t rc =
      allow_smem(vae_attn_backward_logits, kBwdSmemBytes, configured);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  const dim3 grid(n / kRows, batch);
  vae_attn_backward_logits<<<grid, kThreads, kBwdSmemBytes,
                             static_cast<cudaStream_t>(stream)>>>(
      k_map, v_map, static_cast<const bf16*>(q),
      static_cast<const bf16*>(out), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<bf16*>(p),
      static_cast<bf16*>(ds), n, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread at launch (before setmaxnreg) and dynamic shared
// memory per block of the two kernels, for reports; returns a cudaError_t.
extern "C" int hg_vae_attention_info(int* fwd_registers, int* fwd_smem,
                                     int* bwd_registers, int* bwd_smem) {
  cudaFuncAttributes attr;
  cudaError_t rc = cudaFuncGetAttributes(&attr, vae_attn_forward);
  *fwd_registers = attr.numRegs;
  *fwd_smem = kFwdSmemBytes;
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaFuncGetAttributes(&attr, vae_attn_backward_logits);
  *bwd_registers = attr.numRegs;
  *bwd_smem = kBwdSmemBytes;
  return static_cast<int>(rc);
}
