// Non-causal self-attention forward for Hopper (sm_90a): K4 of the port.
//
// Replaces humangaussian_tpu/ops/attention.py::_attn_kernel (:36). For every
// (batch, head) of q [B, S, H, 64] and k, v [B, M, H, 64], bf16:
//
//   out = softmax(q k^T * scale) v          f32 accumulation, cast to bf16
//
// with the TPU kernel's rounding points: p = exp(logit - max) is rounded to
// bf16 before the PV product, l is summed from the f32 p, and the 1/l
// division is done on the [rows, 64] output.
//
// Bound by operations: 4 S M 64 flops per head against (2 S + 2 M) 64 2
// bytes, hundreds of flops per byte at S = 4096, so the tensor cores (989
// TFLOP/s bf16) are the limit; at D = 64 the exp of every logit (one MUFU
// op per 256 flops) comes close to it too.
//
// Design. The TPU kernel holds a [block_q, S] logits tile and a whole
// head's K and V in VMEM. A head's K and V at S = 4096 are 512 KB each,
// over a block's 227 KB of shared memory, so this kernel streams them once,
// in 128-key tiles, with an online softmax:
//
//  - A block is three warpgroups and owns 128 query rows of one head.
//    Warpgroup 0 is the producer: it gives up registers (setmaxnreg 24) and
//    one thread issues TMA loads: Q once, then per tile a K and a V tile
//    into two-slot rings, each slot guarded by a "full" and an "empty"
//    mbarrier (K and V apart, so that a K slot is refilled as soon as its
//    QK^T is done). Warpgroups 1 and 2 are consumers (setmaxnreg 240), 64
//    query rows each.
//  - The tensor maps are 3-D over [B*S, H, 64] (inner box 64 bf16 = 128
//    bytes, one 128-byte swizzle span), so TMA reads the [B, S, H, 64]
//    strides directly and writes the swizzled layout that the wgmma
//    descriptors read: Q and K tiles as K-major operands (D contiguous), the
//    V tile as an MN-major (transposed) B operand.
//  - S = Q K^T of a tile is four wgmma m64n128k16 (bf16 in, f32 out in
//    registers). The accumulator's layout is known: a thread holds two
//    rows, 32 columns each, and a row lives in one quad of lanes, so the
//    running row maximum takes two shuffles. With m the new maximum, l is
//    rescaled by exp(m_old - m) in f32, p = exp(logit - m) is formed in
//    f32 (l adds the f32 p) and packed to bf16 straight into the register
//    A operand of eight wgmma m64n64k16 for O += P V: the f32 accumulator
//    layout of S is the bf16 A-fragment layout, so p never leaves
//    registers. O is rescaled by the same factor just before its next PV
//    product.
//  - The products of a warpgroup overlap its softmax: S(t) = Q K(t)^T is
//    issued, O is rescaled and O += P(t-1) V(t-1) issued behind it; once
//    S(t) is done its softmax runs while the PV product still does. The
//    two consumer warpgroups interleave on the SM as well.
//  - Epilogue: O / l in f32, cast to bf16, staged in shared memory, stored
//    with 16-byte stores.
//
// Numerics: each p is rounded to bf16 once, relative to the running maximum
// rather than the final one (relative error at most 2^-8 either way); the
// rescale is f32. exp is exp2 of fma(logit, scale log2(e), -m), which needs
// scale > 0 (the row maximum of the scaled logits is taken on the raw
// ones).
#include <cuda.h>  // CUtensorMap and the encoder's types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kD = 64;                         // head dim
constexpr int kRowBytes = kD * 2;              // 128: one swizzle span
constexpr int kRowsPerConsumer = 64;           // wgmma M
constexpr int kConsumers = 2;
constexpr int kBQ = kRowsPerConsumer * kConsumers;  // query rows per block
constexpr int kBK = 128;                       // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileBytes = kBK * kRowBytes;    // 16 KB
constexpr int kQBytes = kBQ * kRowBytes;       // 16 KB
constexpr int kOPitch = kD + 8;                // bf16 per staged output row

struct Smem {
  alignas(1024) uint8_t q[kQBytes];
  alignas(1024) uint8_t k[kStages][kTileBytes];
  alignas(1024) uint8_t v[kStages][kTileBytes];
  alignas(16) bf16 o[kConsumers][kRowsPerConsumer * kOPitch];
  uint64_t q_full;
  uint64_t k_full[kStages], k_empty[kStages];
  uint64_t v_full[kStages], v_empty[kStages];
};
// the dynamic allocation is aligned to 1024 bytes by hand
constexpr int kSmemBytes = sizeof(Smem) + 1024;

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
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int row, int head) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(0), "r"(head), "r"(row)
      : "memory");
}

// ---- wgmma ------------------------------------------------------------
// Shared-memory matrix descriptor of a tile of 128-byte rows written by TMA
// with the 128-byte swizzle: 8-row groups 1024 bytes apart (SBO = 64 in
// 16-byte units); LBO is unused for these shapes (one swizzle span along
// the contiguous dimension).
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

// d[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B K-major in shared memory.
__device__ __forceinline__ void wgmma_qk(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] B[16 x 64]; A (bf16 pairs) in registers, B in
// shared memory MN-major (its rows hold the 64 output columns).
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

// Ring slot and phase parity of K/V tile t (two slots each for K and V).
__device__ __forceinline__ int slot(int t) { return t & 1; }
__device__ __forceinline__ uint32_t parity(int t) { return (t >> 1) & 1; }

// Issue S = Q K^T for one 128-key tile (D = 64: four k-steps of 16, 32
// bytes along the swizzled rows); asynchronous, one commit group.
__device__ __forceinline__ void issue_qk(float (&s)[64], uint64_t q_desc,
                                        uint64_t k_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    wgmma_qk(s, q_desc + 2 * kk, k_desc + 2 * kk, kk);
  wgmma_commit();
}

// Issue O += P V for one tile: eight k-steps of 16 keys; the A fragment of
// keys 16 kk .. 16 kk + 15 is p[4 kk .. 4 kk + 3]; the V descriptor moves
// 16 rows (2048 bytes) a step. Asynchronous, one commit group; p and o
// must not change until it is waited for.
__device__ __forceinline__ void issue_pv(float (&o)[32], uint32_t (&p)[32],
                                        uint64_t v_desc) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < 8; ++kk)
    wgmma_pv(o, p[4 * kk], p[4 * kk + 1], p[4 * kk + 2], p[4 * kk + 3],
             v_desc + 128 * kk);
  wgmma_commit();
  fence_regs(p);
}

// Online softmax of one tile of raw logits s (s[4 j + 0/1] row r0,
// s[4 j + 2/3] row r1): the new running maxima m0, m1 (log2 units), the
// factors alpha0, alpha1 = exp(m_old - m) that l (here) and O (later) are
// rescaled by, and p = exp(logit - m) in f32, in place of s; l adds the
// f32 p. A row lives in one quad of lanes.
__device__ __forceinline__ void online_softmax(float (&s)[64], float c,
                                               float& m0, float& m1,
                                               float& l0, float& l1,
                                               float& alpha0,
                                               float& alpha1) {
  float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
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
  for (int j = 0; j < 16; ++j) {
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
// columns 8 j + c0 + 0/1 (the f32 accumulator layout of S is the A
// fragment layout of the PV product).
__device__ __forceinline__ void pack_p(const float (&s)[64],
                                       uint32_t (&p)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    p[2 * j] = pack_bf16(s[4 * j + 0], s[4 * j + 1]);
    p[2 * j + 1] = pack_bf16(s[4 * j + 2], s[4 * j + 3]);
  }
}

__device__ __forceinline__ void rescale(float (&o)[32], float alpha0,
                                        float alpha1) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    o[4 * j + 0] *= alpha0;
    o[4 * j + 1] *= alpha0;
    o[4 * j + 2] *= alpha1;
    o[4 * j + 3] *= alpha1;
  }
}

__global__ void __launch_bounds__(kThreads, 1)
attention_fwd_kernel(const __grid_constant__ CUtensorMap q_map,
                     const __grid_constant__ CUtensorMap k_map,
                     const __grid_constant__ CUtensorMap v_map,
                     bf16* __restrict__ out, int seq_q, int seq_k, int heads,
                     float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t pad = (1024 - (smem_u32(smem_raw) & 1023)) & 1023;
  Smem& sm = *reinterpret_cast<Smem*>(smem_raw + pad);

  const int b = blockIdx.y / heads, h = blockIdx.y % heads;
  const int q0 = blockIdx.x * kBQ;
  const int tiles = seq_k / kBK;
  const int warpgroup = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.k_empty[s], 128 * kConsumers);
      mbar_init(&sm.v_empty[s], 128 * kConsumers);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warpgroup == 0) {
    // ---- producer: one thread keeps the ring of K/V tiles filled -------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (threadIdx.x == 0) {
      mbar_expect_tx(&sm.q_full, kQBytes);
      tma_load(sm.q, &q_map, &sm.q_full, b * seq_q + q0, h);
      for (int t = 0; t < tiles; ++t) {
        const int row = b * seq_k + t * kBK;
        mbar_wait(&sm.k_empty[slot(t)], parity(t) ^ 1);
        mbar_expect_tx(&sm.k_full[slot(t)], kTileBytes);
        tma_load(sm.k[slot(t)], &k_map, &sm.k_full[slot(t)], row, h);
        mbar_wait(&sm.v_empty[slot(t)], parity(t) ^ 1);
        mbar_expect_tx(&sm.v_full[slot(t)], kTileBytes);
        tma_load(sm.v[slot(t)], &v_map, &sm.v_full[slot(t)], row, h);
      }
    }
  } else {
    // ---- consumers: 64 query rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = warpgroup - 1;
    const int tid = threadIdx.x % 128;
    const int warp = tid / 32, lane = tid % 32;
    // this thread's two rows of the warpgroup's 64 and its column offset
    // inside every 8-column block of an accumulator
    const int r0 = 16 * warp + lane / 4, r1 = r0 + 8;
    const int c0 = 2 * (lane % 4);

    float o[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) o[i] = 0.0f;
    float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 units
    float l0 = 0.0f, l1 = 0.0f;            // this thread's partial row sums
    float alpha0, alpha1;                  // O's pending rescale
    float s[64];
    uint32_t p[32];

    const uint64_t q_desc =
        desc_sw128(sm.q + wg * kRowsPerConsumer * kRowBytes);
    mbar_wait(&sm.q_full, 0);

    // tile 0: S, softmax, P (O is zero, so its rescale does not matter)
    mbar_wait(&sm.k_full[0], 0);
    issue_qk(s, q_desc, desc_sw128(sm.k[0]));
    wgmma_wait<0>();
    fence_regs(s);
    mbar_arrive(&sm.k_empty[0]);
    online_softmax(s, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
    pack_p(s, p);

    // tile t: S(t) = Q K(t)^T runs on the tensor cores while O is rescaled
    // and O += P(t-1) V(t-1) is issued; the softmax of S(t) runs while the
    // PV product does
    for (int t = 1; t < tiles; ++t) {
      mbar_wait(&sm.k_full[slot(t)], parity(t));
      issue_qk(s, q_desc, desc_sw128(sm.k[slot(t)]));
      rescale(o, alpha0, alpha1);
      mbar_wait(&sm.v_full[slot(t - 1)], parity(t - 1));
      issue_pv(o, p, desc_sw128(sm.v[slot(t - 1)]));
      wgmma_wait<1>();  // S(t) is done, the PV product may still run
      fence_regs(s);
      mbar_arrive(&sm.k_empty[slot(t)]);
      online_softmax(s, scale_log2, m0, m1, l0, l1, alpha0, alpha1);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(s);  // p is rewritten only after the PV product is done
      mbar_arrive(&sm.v_empty[slot(t - 1)]);
      pack_p(s, p);
    }
    rescale(o, alpha0, alpha1);
    const int last = tiles - 1;
    mbar_wait(&sm.v_full[slot(last)], parity(last));
    issue_pv(o, p, desc_sw128(sm.v[slot(last)]));
    wgmma_wait<0>();
    fence_regs(o);

    // ---- epilogue: out = O / l, staged, 16 bytes a store ---------------
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    bf16* so = sm.o[wg];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + c0;
      *reinterpret_cast<__nv_bfloat162*>(so + r0 * kOPitch + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 0], l0),
                                __fdiv_rn(o[4 * j + 1], l0));
      *reinterpret_cast<__nv_bfloat162*>(so + r1 * kOPitch + col) =
          __floats2bfloat162_rn(__fdiv_rn(o[4 * j + 2], l1),
                                __fdiv_rn(o[4 * j + 3], l1));
    }
    // the warpgroup's 128 threads only (named barrier 1 or 2)
    asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
    const size_t stride = static_cast<size_t>(heads) * kD;
    bf16* ob = out + (static_cast<size_t>(b) * seq_q + q0
                      + wg * kRowsPerConsumer) * stride
               + static_cast<size_t>(h) * kD;
#pragma unroll
    for (int it = 0; it < 4; ++it) {
      const int chunk = tid + 128 * it;  // 64 rows x 8 chunks of 8 bf16
      const int r = chunk / 8, c = (chunk % 8) * 8;
      *reinterpret_cast<uint4*>(ob + r * stride + c) =
          *reinterpret_cast<const uint4*>(so + r * kOPitch + c);
    }
  }
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

// A [rows, heads, 64] bf16 view of [B, S, H, 64] with 128-key boxes.
bool make_map(CUtensorMap* map, const void* base, int rows, int heads) {
  const cuuint64_t dims[3] = {kD, static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[2] = {kRowBytes,
                                 static_cast<cuuint64_t>(heads) * kRowBytes};
  const cuuint32_t box[3] = {kD, 1, kBK};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(base), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

// Plain C entry point (loaded with ctypes). q, out: [batch, seq_q, heads, 64]
// bf16; k, v: [batch, seq_k, heads, 64] bf16; all contiguous device pointers,
// 16-byte aligned; seq_q and seq_k positive multiples of 128; scale > 0.
// Launches on
// `stream`, does not synchronize, and returns cudaGetLastError() after the
// launch (0 = launched), or cudaErrorInvalidValue for arguments it does not
// take and cudaErrorNotSupported when the driver has no tensor-map encoder.
extern "C" int hg_attention_fwd(const void* q, const void* k, const void* v,
                                void* out, int batch, int seq_q, int seq_k,
                                int heads, float scale, void* stream) {
  if (batch <= 0 || heads <= 0 || seq_q <= 0 || seq_k <= 0
      || seq_q % kBQ != 0 || seq_k % kBK != 0 || batch * heads > 65535
      || !(scale > 0.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  if (encode_tiled() == nullptr)
    return static_cast<int>(cudaErrorNotSupported);
  CUtensorMap q_map, k_map, v_map;
  if (!make_map(&q_map, q, batch * seq_q, heads)
      || !make_map(&k_map, k, batch * seq_k, heads)
      || !make_map(&v_map, v, batch * seq_k, heads))
    return static_cast<int>(cudaErrorInvalidValue);
  static bool configured = false;
  if (!configured) {
    const cudaError_t rc = cudaFuncSetAttribute(
        attention_fwd_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    configured = true;
  }
  const dim3 grid(seq_q / kBQ, batch * heads);
  attention_fwd_kernel<<<grid, kThreads, kSmemBytes,
                         static_cast<cudaStream_t>(stream)>>>(
      q_map, k_map, v_map, static_cast<bf16*>(out), seq_q, seq_k, heads,
      scale * 1.4426950408889634f);
  return static_cast<int>(cudaGetLastError());
}

// Registers per thread at launch (before setmaxnreg) and dynamic shared
// memory per block of the kernel, for reports; returns a cudaError_t.
extern "C" int hg_attention_fwd_info(int* registers, int* smem_bytes) {
  cudaFuncAttributes attr;
  const cudaError_t rc = cudaFuncGetAttributes(&attr, attention_fwd_kernel);
  *registers = attr.numRegs;
  *smem_bytes = kSmemBytes;
  return static_cast<int>(rc);
}
