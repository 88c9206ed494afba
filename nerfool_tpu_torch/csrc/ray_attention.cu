// GNT ray attention for Hopper (sm_90a), forward and backward, bound to
// PyTorch through ctypes.
//
// Replaces the TPU kernels fused_ray_attention (forward, body _ra_kernel) and
// _ra_bwd (backward, body _ra_bwd_kernel) of nerfool_tpu/ops/ra_kernel.py.
// Per ray, with S samples, width D = 64 and NH = 4 heads of HD = 16:
//
//   qkv = x @ Wqkv                                  [S, 3D]
//   per head h: p_h = softmax(q_h k_h^T / sqrt(HD)) [S, S]
//               o_h = p_h v_h                       [S, HD]
//   out   = concat_h(o_h) @ Wo + bo                 [S, D]
//   attn0 = mean_h p_h[0, :]                        [S]
//
// and, from the cotangents gout [S, D] and gattn0 [S], the backward gives dx
// [S, D] and per-block partial sums of dWqkv [D, 3D] and dWo [D, D]. Nothing
// is saved by the forward but x and the weights: the backward recomputes qkv
// and the softmax.
//
// Design of the forward: one thread block per ray at a time, a persistent
// grid walks the rays (r = blockIdx.x + k * gridDim.x; at R = 800 on 132 SMs
// with two blocks each that is 3.03 rays a block, so the last round holds 8
// rays, each then alone on its SM). Every product runs on the tensor cores
// with mma.sync.m16n8k8, float32 computed as three TF32 products, a_hi b_hi +
// a_hi b_lo + a_lo b_hi. The weights are split on the card to nearest
// (ra_pack_kernel, pack_b_tf32's layout; ops/ray_attention.py keeps the
// packed copy while the weights are unchanged); every other operand is
// split in the kernel in two instructions (hi = x with its 13 low mantissa
// bits cleared, lo = x - hi read truncated by the tensor cores: ~2^-20 of
// x; cvt.rna for both halves measured 17-27% slower on an H100, for 9.0e-8
// of scale against float64 instead of 1.6e-7).
// The tensor cores add into their f32 accumulator truncating, which along
// a chain of 24 mma gave 3.3e-7 of scale against float64 (plain f32:
// 7.9e-8); so the three products of a k step (of two k steps in the k | v
// product) go through a zeroed accumulator and are added in f32, and p v
// accumulates per key step: 1.6e-7, for 3-8% more time on an H100. The
// softmax statistics, its running max and sum and every accumulator stay
// f32.
//  - phase 1, k | v = x [Wk | Wv]: a warp takes 32 rows (two m16 tiles, so
//    each 16-byte B fragment of the weights serves two tiles); the A
//    fragments are read from x in device memory, rows past S clamped to row
//    S - 1. K [Sp][72] and V [Sp][68] f32 go to shared memory once per ray,
//    Sp = S rounded up to the 32-key step: 564 B a sample with attn0's row,
//    108,288 B at S = 192, so two blocks fit an SM. The row strides make the
//    fragment loads of phase 2 conflict-free (K: 8-byte loads of two
//    neighbouring channels, 72 = 8 mod 32; V: two rows 2t, 2t + 1 apart,
//    2 * 68 = 8 mod 32).
//  - phase 2, flash form per 16-query tile: a warp takes a tile and walks
//    the four heads. q_h = x Wq_h is computed into registers (the Q third
//    of the qkv product, never stored) and scaled by log2(e) / sqrt(HD), so
//    the softmax runs on ex2; per 32-key step the scores q_h k_h^T (four
//    n-tiles), keys past S set to the fill -1e9 (not -inf), the online
//    softmax per query row (quad reductions; the row sum stays a per-lane
//    partial until the end), and o_h = o_h c + p v_h. The k index of each
//    step is permuted (logical columns t and t + 4 are channels 2t and
//    2t + 1 of the step), so the C fragments of one product are the A
//    fragments of the next as they are: q -> scores, p -> p v, o -> o Wo;
//    the weights are packed in the same order (hi and lo of two rows of a
//    column, one 16-byte __ldg per lane). q and p v alternate their k steps
//    between two accumulators (shorter chains of dependent mma). out =
//    sum_h o_h Wo_h + bo accumulates in 32 registers across the heads;
//    rows below S are stored.
//  - attn0: once a head's max and sum are final, a second pass over row 0's
//    scores on the CUDA cores (q row 0 broadcast from quad 0, a key per
//    lane) adds p_0j / NH into a shared [Sp] f32 row, written out after the
//    fourth head. Tile 0 goes to the last warp, which has the fewest tiles.
//  - two block barriers per ray (K and V written; K and V read). Rows past
//    S are computed on clamped inputs and never stored.
//  - 6 warps a block and two blocks an SM (168 registers, 64 bytes of
//    spills): at S = 192 each warp has two query tiles and one 32-row
//    group. 4 warps (no spills) and 8 warps (128 registers, 248 bytes of
//    spills) measured ~6% and ~20% slower on an H100.
// The weights' B fragments are read from device memory through L1 (packed
// Wqkv 96 KB and Wo 32 KB do not fit in shared memory beside K and V at two
// blocks per SM): 64 KB per 32 rows in phase 1 and 64 KB per 16-query tile
// in phase 2, ~1.2 MB of L2 reads per ray at S = 192.
// What bounds the forward: 15.7 MFLOP per ray (qkv, scores, AV 4.7 each,
// out 1.6) against 98 KB of compulsory traffic, so operations: three TF32
// products of each at 495 TFLOP/s plus the softmax at the f32 rate. Of its
// warps' clocks (a build with -DRA_FWD_STAMPS) the flash steps take ~42%,
// the k | v products ~31% and the q products ~14%: the flash steps run
// ~5 non-mma instructions per mma (the splits of K, P and V, ex2, the max
// and the rescale), and the products fed by the weights' L2 reads take ~2x
// the clocks per mma of the flash steps.
//
// Design of the backward: the forward's flash form again, on the tensor
// cores with the same building blocks (every product on mma.sync.m16n8k8
// as three TF32 products, each k step's products added in f32: dq, dk and
// dv sum over S = 192 keys or queries, the chain length at which the
// truncating tensor-core additions failed the attack gate in the forward).
// One block of 12 warps per ray on a persistent grid, one block per SM;
// a warp owns a 16-row tile (at S = 192 each warp one), as queries and as
// keys. Per head h, in three phases split by block barriers:
//  - A: q_h | k_h | v_h = x Wqkv_h and go_h = gout Wo_h^T of the warp's
//    rows into shared memory, [Sp][24] f32 each (a row stride of 24 floats
//    keeps the 8-byte fragment loads along a row conflict-free; the 4-byte
//    loads down a column conflict 2-way, and a swizzle that removed that
//    measured no faster on an H100: 0.975-0.979 ms against 0.972-0.988 at
//    R = 800), rows past S stored as zeros. The weights are the forward's B fragments plus those
//    of Wo^T and Wqkv^T, packed on the card once per value.
//  - B: per query tile, the forward's flash step over 32-key steps (scores
//    in log2 units, keys past S at -1e9, online max and sum, o_h = p v_h),
//    then delta_i = go_i . o_i, plus sum_j p_0j gattn0_j / NH on row 0
//    (an exp-weighted sum carried beside the row sum). The row's max, 1 /
//    sum and delta go to shared memory; rows past S get 0, 0, 0, which with
//    their zero q and go rows makes every p and ds of theirs exactly 0.
//  - C: per tile, as queries: p = ex2(s - m) / l, dp = go v^T (+ gattn0 /
//    NH on query row 0), ds = p (dp - delta) / sqrt(HD), dq = ds k; as keys,
//    the transposed scores k q^T, p^T and dp^T = v go^T from the queries'
//    statistics, dk = ds^T q, dv = p^T go. The C fragments of each product
//    are the A fragments of the next (the permuted k index of the
//    forward). The tile's [dq | dk | dv] [16, 48] then multiplies Wqkv_h^T
//    in registers and is added into the tile's rows of a [Sp][72] f32 dx
//    accumulator in shared memory; after the fourth head the rows below S
//    are written out. Each warp owns its rows, so no atomics; no device
//    scratch.
// 132,096 B of shared memory at S = 192 (688 B a sample), one block per SM
// of 384 threads. With the weight gradients (a second instantiation, DW;
// the attack freezes the weights, so its 160 launches take the route
// without them) phase B also keeps o_h [Sp][20] and phase C dq | dk | dv
// [Sp][52] in shared memory (976 B a sample, 187,392 B at S = 192, S <=
// 224), and after phase C's barrier a phase D adds head h's columns of
// dWqkv = x^T [dq | dk | dv] and its rows of dWo = o_h^T gout, on the
// tensor cores as the other products, into the block's partial sums in
// device memory ([blocks][D * 3D + D * D] f32, each warp its own tiles);
// the wrapper sums the partials over the blocks in one ordered sum.
// What bounds the backward: 39.3 MFLOP per ray without weight gradients
// (the four projections 6.3; the scores, p v, dp, dq, dk, dv and dx 4.7
// each; 45.6 with the weight gradients) against ~0.1 MB of compulsory
// traffic, so operations, as for the forward. This design does 53.5 MFLOP
// per ray (the scores three times, dp twice), as three TF32 products, in
// ~0.98 ms at R = 800 on an H100 (22% of that bound). Of its warps' clocks
// (a build with -DRA_BWD_STAMPS) dk and dv take ~31%, dq ~23%, the flash
// step ~19%, the projections ~16%, the dx product ~10%, the barriers ~1%;
// what limits it is mma.sync's rate: the same kernel with one TF32 product
// in place of three takes ~0.55 ms, without the exponentials of the keys'
// pass the same time. At R = 800 the grid's last round holds 8 rays
// (6.06 a block).

// x, gout, gattn0, out, attn0 and dx are float32 or bfloat16; all arithmetic
// is f32 (the products as split TF32, loading bf16 as f32 and rounding the
// outputs). Wqkv, Wo, Wo^T and Wqkv^T arrive packed as TF32 B fragments
// (pack_b_tf32, rounded to bf16 first on the bf16 route), bo as f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // netwidth
constexpr int NH = 4;        // heads
constexpr int HD = D / NH;   // head width
constexpr int D3 = 3 * D;    // q | k | v
constexpr float QSCALE = 0.25f * 1.4426950408889634f;  // log2(e) / sqrt(HD)

constexpr int FWD_WARPS = 6;
constexpr int FWD_THREADS = 32 * FWD_WARPS;
constexpr int FWD_MIN_BLOCKS = 2;  // blocks per SM asked of ptxas
constexpr int KV_FLUSH = 2;        // k steps of the k | v product per f32 add
static_assert((D / 8) % KV_FLUSH == 0, "KV_FLUSH must divide the k steps");
constexpr int KSTEP = 32;       // keys per online-softmax step
constexpr int LDK = D + 8;      // K row stride in shared memory, floats
constexpr int LDV = D + 4;      // V row stride
constexpr int NT = D / 8;       // n-tiles of a D-wide product
constexpr int QKV_NT = D3 / 8;  // n-tiles of packed Wqkv

constexpr int BWD_WARPS = 12;
constexpr int BWD_THREADS = 32 * BWD_WARPS;
constexpr int LDH = HD + 8;  // row stride of the backward's per-head buffers
constexpr int LDX = D + 8;   // row stride of its dx accumulator
// with the weight gradients, the row strides of a head's o_h [Sp][HD] and
// dq | dk | dv [Sp][3 HD] (8 t + g mod 32 over a fragment: conflict-free)
constexpr int LDO = HD + 4;
constexpr int LDG = 3 * HD + 4;
// the weight gradients' partial sums of one block, f32: dWqkv [D][3D], then
// dWo [D][D]
constexpr int DWP_FLOATS = D * D3 + D * D;
static_assert(BWD_WARPS == 12 && NT == 8, "phase D: 12 dWqkv and 8 dWo units");

// the packed weights (pack_b_tf32's layout, ra_pack_kernel), in floats:
// Wqkv [D][3D], Wo [D][D] (the forward's), then Wo^T and Wqkv^T [3D][D]
// (the backward's go = gout Wo^T and dx = gqkv Wqkv^T)
constexpr int PK_WO = 2 * D * D3;
constexpr int PK_WOT = PK_WO + 2 * D * D;
constexpr int PK_WQKVT = PK_WOT + 2 * D * D;
constexpr int PK_FLOATS = PK_WQKVT + 2 * D3 * D;
static_assert(PK_FLOATS == 4 * D * 4 * D, "ops/ray_attention.py sizes wpack");

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// ---- split TF32 on mma.sync.m16n8k8 ----

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (a TF32
// value), lo = x - hi is exact in f32 and read truncated to TF32 by the
// tensor cores, so x to ~2^-20 of itself in two instructions
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void split4(const float (&a)[4], uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) split(a[i], hi[i], lo[i]);
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products, small terms first; b = (hi0, hi1, lo0,
// lo1) as pack_b_tf32 lays a lane's B fragment out
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint4 b) {
  mma_tf32(c, al, b.x, b.y);
  mma_tf32(c, ah, b.z, b.w);
  mma_tf32(c, ah, b.x, b.y);
}

// the same with the B fragment (rows t and t + 4 of the logical step) split
// here
__device__ __forceinline__ void mma3(float (&c)[4], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], float b0,
                                     float b1) {
  uint4 b;
  split(b0, b.x, b.z);
  split(b1, b.y, b.w);
  mma3(c, ah, al, b);
}

// c += a b as mma3 does, the three products through a zeroed accumulator
// and added to c in f32. The tensor cores add into their f32 accumulator
// truncating, so along a chain of mma the error grows with its length; this
// keeps every chain at three.
template <typename... B>
__device__ __forceinline__ void mma3_acc(float (&c)[4],
                                         const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], B... b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, ah, al, b...);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// A fragment from the C fragment of the same 16 rows: logical columns t and
// t + 4 of the step are the C fragment's channels 2t and 2t + 1, times f
__device__ __forceinline__ void c_to_a(const float (&c)[4], float f,
                                       uint32_t (&ah)[4], uint32_t (&al)[4]) {
  const float a[4] = {c[0] * f, c[2] * f, c[1] * f, c[3] * f};
  split4(a, ah, al);
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return __ldg(reinterpret_cast<const float2*>(p));
}
__device__ __forceinline__ float2 ld2(const __nv_bfloat16* p) {
  const uint32_t u = __ldg(reinterpret_cast<const unsigned int*>(p));
  return make_float2(__uint_as_float(u << 16),
                     __uint_as_float(u & 0xffff0000u));
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void st2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// the split A fragment of x rows (r0, r1) at k step kt (channels 8 kt + 2t,
// 8 kt + 2t + 1)
template <typename T>
__device__ __forceinline__ void x_frag(const T* xr, int r0, int r1, int kt,
                                       int t, uint32_t (&ah)[4],
                                       uint32_t (&al)[4]) {
  const float2 u = ld2(xr + r0 * D + 8 * kt + 2 * t);
  const float2 w = ld2(xr + r1 * D + 8 * kt + 2 * t);
  const float a[4] = {u.x, w.x, u.y, w.y};
  split4(a, ah, al);
}

// the scores of one 32-key step for query rows (g, g + 8) of head h: s[nt]
// is the C fragment of keys j0 + 8 nt + (2t, 2t + 1); keys past S get -1e9
__device__ __forceinline__ void scores(float (&s)[4][4], const float* Ks,
                                       const uint32_t (&qh)[2][4],
                                       const uint32_t (&ql)[2][4], int h,
                                       int j0, int S, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const float* kr = Ks + (j0 + 8 * nt + g) * LDK + h * HD + 2 * t;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const float2 kv = *reinterpret_cast<const float2*>(kr + 8 * kt);
      mma3(s[nt], qh[kt], ql[kt], kv.x, kv.y);
    }
  }
  if (j0 + KSTEP > S) {
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (j0 + 8 * nt + 2 * t + (e & 1) >= S) s[nt][e] = -1e9f;
  }
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// f32 rounded to TF32 to nearest, ties away from zero (cvt.rna's rounding,
// in integer arithmetic as ops/view_attention.py tf32_round does it)
__device__ __forceinline__ float tf32_rna(float x) {
  return __uint_as_float((__float_as_uint(x) + 0x1000u) & 0xffffe000u);
}

// Packs the weights (f32, in x out) as B fragments in ops/view_attention.py
// pack_b_tf32's layout: Wqkv [D][3D], Wo [D][D], Wo^T [D][D] and Wqkv^T
// [3D][D], each [K/8][N/8][32][4] for its [K][N] matrix m, lane 4g + t of
// fragment (kt, nt) holding (hi, hi, lo, lo) of m(8 kt + 2t, 8 nt + g) and
// m(8 kt + 2t + 1, 8 nt + g). One thread per lane and fragment.
__global__ void ra_pack_kernel(const float* __restrict__ wqkv,
                               const float* __restrict__ wo,
                               float4* __restrict__ wp) {
  constexpr int F0 = (D / 8) * QKV_NT * 32, F1 = F0 + (D / 8) * NT * 32;
  constexpr int F2 = F1 + (D / 8) * NT * 32, F3 = F2 + QKV_NT * NT * 32;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= F3) return;
  const bool tr = i >= F1;  // the transposes: m(k, n) = w[n][k]
  const float* w = i < F0 || i >= F2 ? wqkv : wo;
  const int ldw = w == wqkv ? D3 : D;
  const int j = i - (i < F0 ? 0 : i < F1 ? F0 : i < F2 ? F1 : F2);
  const int ntot = i < F0 ? QKV_NT : NT;
  const int lane = j & 31, nt = (j >> 5) % ntot, kt = (j >> 5) / ntot;
  const int k = 8 * kt + 2 * (lane & 3), n = 8 * nt + (lane >> 2);
  const float w0 = tr ? w[n * ldw + k] : w[k * ldw + n];
  const float w1 = tr ? w[n * ldw + k + 1] : w[(k + 1) * ldw + n];
  const float h0 = tf32_rna(w0), h1 = tf32_rna(w1);
  wp[i] = make_float4(h0, h1, tf32_rna(w0 - h0), tf32_rna(w1 - h1));
}

// A build with -DRA_FWD_STAMPS adds, in block 0, each warp's clocks by
// stage of the forward to ra_fwd_cycles (profile_ray_attention.py reads
// them): k | v products, the wait at the first barrier, the q products, the
// flash steps, attn0's pass, the out product and stores, the wait at the
// second barrier.
#ifdef RA_FWD_STAMPS
constexpr int FWD_STAGES = 7;
__device__ unsigned long long ra_fwd_cycles[FWD_STAGES];
#define STAMP_INIT() long long stamp_ = clock64()
#define STAMP(i)                                                        \
  do {                                                                  \
    const long long now_ = clock64();                                   \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)                     \
      atomicAdd(&ra_fwd_cycles[i], (unsigned long long)(now_ - stamp_)); \
    stamp_ = now_;                                                      \
  } while (0)
#else
#define STAMP_INIT() \
  do {               \
  } while (0)
#define STAMP(i) \
  do {           \
  } while (0)
#endif

// Forward. grid: persistent, blockIdx.x walks rays r = blockIdx.x + k *
// gridDim.x. x [R, S, D]; wqkv_p packed Wqkv [D/8][3D/8][32][4] and wo_p
// packed Wo [D/8][D/8][32][4] (pack_b_tf32); bo [D]; out [R, S, D]; attn0
// [R, S]. Shared memory (fwd_smem_bytes): K [Sp][LDK], V [Sp][LDV], attn0's
// row [Sp], f32.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS, FWD_MIN_BLOCKS)
    ra_fwd_kernel(const T* __restrict__ x, const float* __restrict__ wqkv_p,
                  const float* __restrict__ wo_p,
                  const float* __restrict__ bo, T* __restrict__ out,
                  T* __restrict__ attn0, int R, int S) {
  extern __shared__ __align__(16) float smem[];
  const int sp = (S + KSTEP - 1) / KSTEP * KSTEP;
  float* Ks = smem;
  float* Vs = Ks + sp * LDK;
  float* a0s = Vs + sp * LDV;
  const uint4* Wq = reinterpret_cast<const uint4*>(wqkv_p);
  const uint4* Wo = reinterpret_cast<const uint4*>(wo_p);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int qtiles = (S + 15) / 16;
  const int shift = qtiles >= FWD_WARPS ? qtiles - FWD_WARPS + 1 : 0;
  STAMP_INIT();

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * S * D;

    // phase 1: k | v of 32 rows per warp step into shared memory
    for (int row0 = warp * 32; row0 < sp; row0 += FWD_WARPS * 32) {
      int rows[2][2];
#pragma unroll
      for (int m = 0; m < 2; ++m)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          rows[m][i] = min(row0 + 16 * m + 8 * i + g, S - 1);
#pragma unroll
      for (int half = 0; half < 2; ++half) {  // k, then v
        float acc[2][NT][4];
#pragma unroll
        for (int m = 0; m < 2; ++m)
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;
        // KV_FLUSH k steps at a time into a zeroed accumulator, added to
        // acc in f32
#pragma unroll 1
        for (int k0 = 0; k0 < D / 8; k0 += KV_FLUSH) {
          float tk[2][NT][4];
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) tk[m][nt][e] = 0.f;
#pragma unroll 2
          for (int kt = k0; kt < k0 + KV_FLUSH; ++kt) {
            uint32_t ah[2][4], al[2][4];
#pragma unroll
            for (int m = 0; m < 2; ++m)
              x_frag(xr, rows[m][0], rows[m][1], kt, t, ah[m], al[m]);
#pragma unroll
            for (int nt = 0; nt < NT; ++nt) {
              const uint4 b = __ldg(
                  Wq + ((kt * QKV_NT + NT * (1 + half) + nt) << 5) + lane);
              mma3(tk[0][nt], ah[0], al[0], b);
              mma3(tk[1][nt], ah[1], al[1], b);
            }
          }
#pragma unroll
          for (int m = 0; m < 2; ++m)
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e) acc[m][nt][e] += tk[m][nt][e];
        }
        float* dst = half ? Vs : Ks;
        const int ld = half ? LDV : LDK;
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          float* d0 = dst + (row0 + 16 * m + g) * ld + 2 * t;
#pragma unroll
          for (int nt = 0; nt < NT; ++nt) {
            st2(d0 + 8 * nt, acc[m][nt][0], acc[m][nt][1]);
            st2(d0 + 8 * ld + 8 * nt, acc[m][nt][2], acc[m][nt][3]);
          }
        }
      }
    }
    STAMP(0);
    __syncthreads();
    STAMP(1);

    // phase 2: flash attention per 16-query tile, all heads, then Wo. Tile
    // 0 (with attn0's extra pass) goes to the last warp, which has the
    // fewest tiles
    for (int idx = warp; idx < qtiles; idx += FWD_WARPS) {
      const int qt = (idx + shift) % qtiles;
      const int r0 = min(qt * 16 + g, S - 1), r1 = min(qt * 16 + g + 8, S - 1);
      float acc[NT][4];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;

#pragma unroll 1
      for (int h = 0; h < NH; ++h) {
        // q_h = x Wq_h; the k steps alternate between two accumulators
        // (shorter mma chains)
        float q[2][2][4];
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) q[i][n][e] = 0.f;
#pragma unroll
        for (int kt = 0; kt < D / 8; ++kt) {
          uint32_t ah[4], al[4];
          x_frag(xr, r0, r1, kt, t, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma3_acc(q[kt & 1][n], ah, al,
                 __ldg(Wq + ((kt * QKV_NT + 2 * h + n) << 5) + lane));
        }
        // scores in log2 units: q / sqrt(HD) * log2(e)
        uint32_t qh[2][4], ql[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n) {
#pragma unroll
          for (int e = 0; e < 4; ++e) q[0][n][e] += q[1][n][e];
          c_to_a(q[0][n], QSCALE, qh[n], ql[n]);
        }
        STAMP(2);

        float o[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
#pragma unroll 1
        for (int j0 = 0; j0 < sp; j0 += KSTEP) {
          float s[4][4];
          scores(s, Ks, qh, ql, h, j0, S, g, t);
          float x0 = s[0][0], x1 = s[0][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
            x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
          }
          const float n0 = fmaxf(m0, quad_max(x0));
          const float n1 = fmaxf(m1, quad_max(x1));
          const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
          m0 = n0;
          m1 = n1;
          float p0 = 0.f, p1 = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            s[nt][0] = ex2(s[nt][0] - n0);
            s[nt][1] = ex2(s[nt][1] - n0);
            s[nt][2] = ex2(s[nt][2] - n1);
            s[nt][3] = ex2(s[nt][3] - n1);
            p0 += s[nt][0] + s[nt][1];
            p1 += s[nt][2] + s[nt][3];
          }
          l0 = fmaf(l0, c0, p0);
          l1 = fmaf(l1, c1, p1);
          // this step's p v (key step kk of P is the scores' n-tile kk),
          // the even and odd kk in two accumulators, then o = o c + p v in
          // f32
          float pv[2][2][4];
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int n = 0; n < 2; ++n)
#pragma unroll
              for (int e = 0; e < 4; ++e) pv[i][n][e] = 0.f;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            uint32_t ph[4], pl[4];
            c_to_a(s[kk], 1.f, ph, pl);
            const float* vr = Vs + (j0 + 8 * kk + 2 * t) * LDV + h * HD + g;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma3(pv[kk & 1][n], ph, pl, vr[8 * n], vr[LDV + 8 * n]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            o[n][0] = fmaf(o[n][0], c0, pv[0][n][0] + pv[1][n][0]);
            o[n][1] = fmaf(o[n][1], c0, pv[0][n][1] + pv[1][n][1]);
            o[n][2] = fmaf(o[n][2], c1, pv[0][n][2] + pv[1][n][2]);
            o[n][3] = fmaf(o[n][3], c1, pv[0][n][3] + pv[1][n][3]);
          }
        }
        STAMP(3);
        const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);

        if (qt == 0) {
          // attn0: a second pass over row 0's scores of this head, now that
          // its max and sum are final, on the CUDA cores: q row 0 (lanes
          // t of quad 0 hold its channels 2t, 2t + 1 of each n-tile) to
          // every lane, a key per lane, p / NH added into the shared row
          float q0[HD];
#pragma unroll
          for (int c = 0; c < HD; ++c)
            q0[c] = __shfl_sync(0xffffffffu, QSCALE * q[0][c >> 3][c & 1],
                                (c & 7) >> 1);
          const float mr = __shfl_sync(0xffffffffu, m0, 0);
          const float ir = __shfl_sync(0xffffffffu, i0, 0) * (1.f / NH);
          for (int j = lane; j < S; j += 32) {
            const float4* kr =
                reinterpret_cast<const float4*>(Ks + j * LDK + h * HD);
            float sv = 0.f;
#pragma unroll
            for (int c4 = 0; c4 < HD / 4; ++c4) {
              const float4 kv = kr[c4];
              sv = fmaf(q0[4 * c4], kv.x, sv);
              sv = fmaf(q0[4 * c4 + 1], kv.y, sv);
              sv = fmaf(q0[4 * c4 + 2], kv.z, sv);
              sv = fmaf(q0[4 * c4 + 3], kv.w, sv);
            }
            const float p = ex2(sv - mr) * ir;
            a0s[j] = h == 0 ? p : a0s[j] + p;
          }
        }
        STAMP(4);

        // out += o_h Wo_h: k step 2h + n of Wo is o's n-tile n
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float on[4] = {o[n][0] * i0, o[n][1] * i0, o[n][2] * i1,
                               o[n][3] * i1};
          uint32_t ah[4], al[4];
          c_to_a(on, 1.f, ah, al);
#pragma unroll
          for (int nt = 0; nt < NT; ++nt)
            mma3_acc(acc[nt], ah, al,
                 __ldg(Wo + (((2 * h + n) * NT + nt) << 5) + lane));
        }
        STAMP(5);
      }

      T* outr = out + (size_t)r * S * D;
      const int row = qt * 16 + g;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int c = 8 * nt + 2 * t;
        const float b0 = __ldg(bo + c), b1 = __ldg(bo + c + 1);
        if (row < S) st2(outr + row * D + c, acc[nt][0] + b0, acc[nt][1] + b1);
        if (row + 8 < S)
          st2(outr + (row + 8) * D + c, acc[nt][2] + b0, acc[nt][3] + b1);
      }
      if (qt == 0) {
        __syncwarp();
        for (int j = lane; j < S; j += 32)
          st(attn0 + (size_t)r * S + j, a0s[j]);
      }
      STAMP(5);
    }
    __syncthreads();
    STAMP(6);
  }
}

// A build with -DRA_BWD_STAMPS adds, in block 0, each warp's clocks by
// stage of the backward to ra_bwd_cycles (profile_ray_attention.py reads
// them): phase A (the projections), its barrier, phase B (the flash step),
// its barrier, dq, dk and dv, the dx product and stores, the last barrier
// (with the weight gradients, phase D counts in the first stage).
#ifdef RA_BWD_STAMPS
constexpr int BWD_STAGES = 8;
__device__ unsigned long long ra_bwd_cycles[BWD_STAGES];
#define BSTAMP_INIT() long long bstamp_ = clock64()
#define BSTAMP(i)                                                          \
  do {                                                                     \
    const long long now_ = clock64();                                      \
    if (blockIdx.x == 0 && (threadIdx.x & 31) == 0)                        \
      atomicAdd(&ra_bwd_cycles[i], (unsigned long long)(now_ - bstamp_));  \
    bstamp_ = now_;                                                        \
  } while (0)
#else
#define BSTAMP_INIT() \
  do {                \
  } while (0)
#define BSTAMP(i) \
  do {            \
  } while (0)
#endif

// ---- backward helpers ----

// the split A fragments of rows (r, r + 8) of a per-head buffer ([Sp][LDH]
// f32 in shared memory), both k steps, times f
__device__ __forceinline__ void head_frags(const float* M, int r, int t,
                                           float f, uint32_t (&ah)[2][4],
                                           uint32_t (&al)[2][4]) {
#pragma unroll
  for (int kt = 0; kt < 2; ++kt) {
    const float2 u = *reinterpret_cast<const float2*>(M + r * LDH + 8 * kt +
                                                      2 * t);
    const float2 w = *reinterpret_cast<const float2*>(M + (r + 8) * LDH +
                                                      8 * kt + 2 * t);
    const float a[4] = {u.x * f, w.x * f, u.y * f, w.y * f};
    split4(a, ah[kt], al[kt]);
  }
}

// c[nt] = a M_j^T over the 32 rows j0 + 8 nt + g of a per-head buffer:
// the scores q k^T (M = K), dp = go v^T (M = V) and, transposed, k q^T
// (M = Q, times f) and v go^T (M = GO); B read as 8-byte pairs of a row
__device__ __forceinline__ void prod_rows(float (&c)[4][4], const float* M,
                                          const uint32_t (&ah)[2][4],
                                          const uint32_t (&al)[2][4], int j0,
                                          int g, int t, float f) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) c[nt][e] = 0.f;
    const float* mr = M + (j0 + 8 * nt + g) * LDH + 2 * t;
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const float2 v = *reinterpret_cast<const float2*>(mr + 8 * kt);
      mma3(c[nt], ah[kt], al[kt], v.x * f, v.y * f);
    }
  }
}

// acc += a M over a 32-row step: a [16, 32] the C fragments of a product
// over rows j0.. (as A through c_to_a), M rows j0 + 8 kk + 2t and + 1,
// channels 8n + g: dq = ds k, dk = ds^T q, dv = p^T go, p v. Even and odd
// kk in two zeroed accumulators, added to acc in f32
__device__ __forceinline__ void prod_cols(float (&acc)[2][4],
                                          const float (&a)[4][4],
                                          const float* M, int j0, int g,
                                          int t) {
  float tk[2][2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) tk[i][n][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t ah[4], al[4];
    c_to_a(a[kk], 1.f, ah, al);
    const float* mr = M + (j0 + 8 * kk + 2 * t) * LDH + g;
#pragma unroll
    for (int n = 0; n < 2; ++n)
      mma3(tk[kk & 1][n], ah, al, mr[8 * n], mr[LDH + 8 * n]);
  }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] += tk[0][n][e] + tk[1][n][e];
}

// Backward. x, gout, dx [R, S, D]; gattn0 [R, S]; wpack the packed weights
// (PK_* offsets); with DW, dwp the blocks' partial sums of the weight
// gradients [gridDim.x][DWP_FLOATS], zeroed by the caller. Shared memory
// (bwd_smem_bytes): Q, K, V, GO [Sp][LDH], dx [Sp][LDX], the rows' max, 1 /
// sum and delta and gattn0 / NH [Sp] each, and with DW o_h [Sp][LDO] and dq
// | dk | dv [Sp][LDG], f32.
template <typename T, bool DW>
__global__ void __launch_bounds__(BWD_THREADS, 1)
    ra_bwd_kernel(const T* __restrict__ x, const float* __restrict__ wpack,
                  const T* __restrict__ gout, const T* __restrict__ gattn0,
                  T* __restrict__ dx, float* __restrict__ dwp, int R, int S) {
  extern __shared__ __align__(16) float smem[];
  const int sp = (S + KSTEP - 1) / KSTEP * KSTEP;
  float* Qs = smem;
  float* Ks = Qs + sp * LDH;
  float* Vs = Ks + sp * LDH;
  float* Gs = Vs + sp * LDH;
  float* DXs = Gs + sp * LDH;
  float* Ms = DXs + sp * LDX;
  float* Ls = Ms + sp;
  float* Ds = Ls + sp;
  float* A0s = Ds + sp;
  float* Os = A0s + sp;        // with DW only
  float* GQs = Os + sp * LDO;  // with DW only
  const uint4* Wq = reinterpret_cast<const uint4*>(wpack);
  const uint4* WoT = reinterpret_cast<const uint4*>(wpack + PK_WOT);
  const uint4* WqT = reinterpret_cast<const uint4*>(wpack + PK_WQKVT);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int tiles = sp / 16;
  BSTAMP_INIT();

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * S * D;
    const T* gr = gout + (size_t)r * S * D;
    for (int j = threadIdx.x; j < sp; j += BWD_THREADS)
      A0s[j] = j < S ? ld(gattn0 + (size_t)r * S + j) * (1.f / NH) : 0.f;

#pragma unroll 1
    for (int h = 0; h < NH; ++h) {
      // A: q_h | k_h | v_h = x Wqkv_h and go_h = gout Wo_h^T of the warp's
      // rows; rows past S are read clamped and stored as zeros
      for (int tile = warp; tile < tiles; tile += BWD_WARPS) {
        const int ra = 16 * tile + g, rb = ra + 8;
        const int ca = min(ra, S - 1), cb = min(rb, S - 1);
        float acc[8][4];  // q, k, v, go: two n-tiles each
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 2
        for (int kt = 0; kt < D / 8; ++kt) {
          uint32_t ah[4], al[4];
          x_frag(xr, ca, cb, kt, t, ah, al);
#pragma unroll
          for (int n = 0; n < 6; ++n)
            mma3_acc(acc[n], ah, al,
                     __ldg(Wq + ((kt * QKV_NT + NT * (n >> 1) + 2 * h +
                                  (n & 1)) << 5) + lane));
          x_frag(gr, ca, cb, kt, t, ah, al);
#pragma unroll
          for (int n = 0; n < 2; ++n)
            mma3_acc(acc[6 + n], ah, al,
                     __ldg(WoT + ((kt * NT + 2 * h + n) << 5) + lane));
        }
        const float fa = ra < S ? 1.f : 0.f, fb = rb < S ? 1.f : 0.f;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          float* buf = n < 2 ? Qs : n < 4 ? Ks : n < 6 ? Vs : Gs;
          float* d0 = buf + ra * LDH + 8 * (n & 1) + 2 * t;
          st2(d0, acc[n][0] * fa, acc[n][1] * fa);
          st2(d0 + 8 * LDH, acc[n][2] * fb, acc[n][3] * fb);
        }
      }
      BSTAMP(0);
      __syncthreads();
      BSTAMP(1);

      // B: per query tile, the flash step for the rows' max and sum, o_h
      // and delta = go . o (+ row 0's attn0 term)
      for (int tile = warp; tile < tiles; tile += BWD_WARPS) {
        const int ra = 16 * tile + g, rb = ra + 8;
        uint32_t qh[2][4], ql[2][4];
        head_frags(Qs, ra, t, QSCALE, qh, ql);
        float o[2][4];
#pragma unroll
        for (int n = 0; n < 2; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
        float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, e0 = 0.f;
#pragma unroll 1
        for (int j0 = 0; j0 < sp; j0 += KSTEP) {
          float s[4][4];
          prod_rows(s, Ks, qh, ql, j0, g, t, 1.f);
          if (j0 + KSTEP > S) {
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int e = 0; e < 4; ++e)
                if (j0 + 8 * nt + 2 * t + (e & 1) >= S) s[nt][e] = -1e9f;
          }
          float x0 = s[0][0], x1 = s[0][2];
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            x0 = fmaxf(x0, fmaxf(s[nt][0], s[nt][1]));
            x1 = fmaxf(x1, fmaxf(s[nt][2], s[nt][3]));
          }
          const float n0 = fmaxf(m0, quad_max(x0));
          const float n1 = fmaxf(m1, quad_max(x1));
          const float c0 = ex2(m0 - n0), c1 = ex2(m1 - n1);
          m0 = n0;
          m1 = n1;
          float p0 = 0.f, p1 = 0.f, a0 = 0.f;
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) {
            s[nt][0] = ex2(s[nt][0] - n0);
            s[nt][1] = ex2(s[nt][1] - n0);
            s[nt][2] = ex2(s[nt][2] - n1);
            s[nt][3] = ex2(s[nt][3] - n1);
            p0 += s[nt][0] + s[nt][1];
            p1 += s[nt][2] + s[nt][3];
            const float2 w =
                *reinterpret_cast<const float2*>(A0s + j0 + 8 * nt + 2 * t);
            a0 = fmaf(s[nt][0], w.x, fmaf(s[nt][1], w.y, a0));
          }
          l0 = fmaf(l0, c0, p0);
          l1 = fmaf(l1, c1, p1);
          e0 = fmaf(e0, c0, a0);
          float pv[2][4];
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) pv[n][e] = 0.f;
          prod_cols(pv, s, Vs, j0, g, t);
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            o[n][0] = fmaf(o[n][0], c0, pv[n][0]);
            o[n][1] = fmaf(o[n][1], c0, pv[n][1]);
            o[n][2] = fmaf(o[n][2], c1, pv[n][2]);
            o[n][3] = fmaf(o[n][3], c1, pv[n][3]);
          }
        }
        const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
        float d0 = 0.f, d1 = 0.f;
#pragma unroll
        for (int n = 0; n < 2; ++n) {
          const float2 ga = *reinterpret_cast<const float2*>(
              Gs + ra * LDH + 8 * n + 2 * t);
          const float2 gb = *reinterpret_cast<const float2*>(
              Gs + rb * LDH + 8 * n + 2 * t);
          o[n][0] *= i0;
          o[n][1] *= i0;
          o[n][2] *= i1;
          o[n][3] *= i1;
          d0 = fmaf(ga.x, o[n][0], fmaf(ga.y, o[n][1], d0));
          d1 = fmaf(gb.x, o[n][2], fmaf(gb.y, o[n][3], d1));
        }
        d0 = quad_sum(d0);
        d1 = quad_sum(d1);
        e0 = quad_sum(e0) * i0;
        if (ra == 0) d0 += e0;
        if (t == 0) {
          Ms[ra] = ra < S ? m0 : 0.f;
          Ls[ra] = ra < S ? i0 : 0.f;
          Ds[ra] = ra < S ? d0 : 0.f;
          Ms[rb] = rb < S ? m1 : 0.f;
          Ls[rb] = rb < S ? i1 : 0.f;
          Ds[rb] = rb < S ? d1 : 0.f;
        }
        if constexpr (DW) {  // o_h for dWo, rows past S as zeros
          const float fa = ra < S ? 1.f : 0.f, fb = rb < S ? 1.f : 0.f;
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float* d = Os + ra * LDO + 8 * n + 2 * t;
            st2(d, o[n][0] * fa, o[n][1] * fa);
            st2(d + 8 * LDO, o[n][2] * fb, o[n][3] * fb);
          }
        }
      }
      BSTAMP(2);
      __syncthreads();
      BSTAMP(3);

      // C: per tile, dq as queries, dk and dv as keys, then dx += [dq | dk
      // | dv] Wqkv_h^T into the tile's rows
      for (int tile = warp; tile < tiles; tile += BWD_WARPS) {
        const int ra = 16 * tile + g, rb = ra + 8;
        float gq[3][2][4];  // dq, dk, dv: two n-tiles each
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
          for (int n = 0; n < 2; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e) gq[b][n][e] = 0.f;
        {
          uint32_t qh[2][4], ql[2][4], gh[2][4], gl[2][4];
          head_frags(Qs, ra, t, QSCALE, qh, ql);
          head_frags(Gs, ra, t, 1.f, gh, gl);
          const float ma = Ms[ra], mb = Ms[rb], ia = Ls[ra], ib = Ls[rb];
          const float da = Ds[ra], db = Ds[rb];
#pragma unroll 1
          for (int j0 = 0; j0 < sp; j0 += KSTEP) {
            float s[4][4], dp[4][4];
            prod_rows(s, Ks, qh, ql, j0, g, t, 1.f);
            prod_rows(dp, Vs, gh, gl, j0, g, t, 1.f);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int j = j0 + 8 * nt + 2 * t;
              if (ra == 0) {
                const float2 w = *reinterpret_cast<const float2*>(A0s + j);
                dp[nt][0] += w.x;
                dp[nt][1] += w.y;
              }
              const bool v0 = j < S, v1 = j + 1 < S;
              s[nt][0] = v0 ? ex2(s[nt][0] - ma) * ia * (dp[nt][0] - da) *
                                  0.25f : 0.f;
              s[nt][1] = v1 ? ex2(s[nt][1] - ma) * ia * (dp[nt][1] - da) *
                                  0.25f : 0.f;
              s[nt][2] = v0 ? ex2(s[nt][2] - mb) * ib * (dp[nt][2] - db) *
                                  0.25f : 0.f;
              s[nt][3] = v1 ? ex2(s[nt][3] - mb) * ib * (dp[nt][3] - db) *
                                  0.25f : 0.f;
            }
            prod_cols(gq[0], s, Ks, j0, g, t);
          }
        }
        BSTAMP(4);
        {
          uint32_t kh[2][4], kl[2][4], vh[2][4], vl[2][4];
          head_frags(Ks, ra, t, 1.f, kh, kl);
          head_frags(Vs, ra, t, 1.f, vh, vl);
          // keys past S: p = 0
          const bool va = ra < S, vb = rb < S;
#pragma unroll 1
          for (int i0 = 0; i0 < sp; i0 += KSTEP) {
            float p[4][4], ds[4][4];
            prod_rows(p, Qs, kh, kl, i0, g, t, QSCALE);
            prod_rows(ds, Gs, vh, vl, i0, g, t, 1.f);
            if (i0 == 0 && t == 0) {
              ds[0][0] += A0s[ra];
              ds[0][2] += A0s[rb];
            }
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const int i = i0 + 8 * nt + 2 * t;
              const float2 m = *reinterpret_cast<const float2*>(Ms + i);
              const float2 l = *reinterpret_cast<const float2*>(Ls + i);
              const float2 d = *reinterpret_cast<const float2*>(Ds + i);
              p[nt][0] = va ? ex2(p[nt][0] - m.x) * l.x : 0.f;
              p[nt][1] = va ? ex2(p[nt][1] - m.y) * l.y : 0.f;
              p[nt][2] = vb ? ex2(p[nt][2] - m.x) * l.x : 0.f;
              p[nt][3] = vb ? ex2(p[nt][3] - m.y) * l.y : 0.f;
              ds[nt][0] = p[nt][0] * (ds[nt][0] - d.x) * 0.25f;
              ds[nt][1] = p[nt][1] * (ds[nt][1] - d.y) * 0.25f;
              ds[nt][2] = p[nt][2] * (ds[nt][2] - d.x) * 0.25f;
              ds[nt][3] = p[nt][3] * (ds[nt][3] - d.y) * 0.25f;
            }
            prod_cols(gq[1], ds, Qs, i0, g, t);
            prod_cols(gq[2], p, Gs, i0, g, t);
          }
        }
        BSTAMP(5);
        float acc[NT][4];
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
#pragma unroll
        for (int b = 0; b < 3; ++b)
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            uint32_t ah[4], al[4];
            c_to_a(gq[b][n], 1.f, ah, al);
            const int kt = NT * b + 2 * h + n;  // rows of Wqkv^T
#pragma unroll
            for (int nt = 0; nt < NT; ++nt)
              mma3_acc(acc[nt], ah, al, __ldg(WqT + ((kt * NT + nt) << 5) +
                                              lane));
          }
        if constexpr (DW) {  // dq | dk | dv for dWqkv, rows past S as zeros
          const bool va = ra < S, vb = rb < S;
#pragma unroll
          for (int b = 0; b < 3; ++b)
#pragma unroll
            for (int n = 0; n < 2; ++n) {
              float* d = GQs + ra * LDG + b * HD + 8 * n + 2 * t;
              st2(d, va ? gq[b][n][0] : 0.f, va ? gq[b][n][1] : 0.f);
              st2(d + 8 * LDG, vb ? gq[b][n][2] : 0.f,
                  vb ? gq[b][n][3] : 0.f);
            }
        }
        T* dxr = dx + (size_t)r * S * D;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) {
          float* xa = DXs + ra * LDX + 8 * nt + 2 * t;
          float* xb = xa + 8 * LDX;
          if (h > 0) {
            const float2 u = *reinterpret_cast<const float2*>(xa);
            const float2 w = *reinterpret_cast<const float2*>(xb);
            acc[nt][0] += u.x;
            acc[nt][1] += u.y;
            acc[nt][2] += w.x;
            acc[nt][3] += w.y;
          }
          if (h < NH - 1) {
            st2(xa, acc[nt][0], acc[nt][1]);
            st2(xb, acc[nt][2], acc[nt][3]);
          } else {
            const int c = 8 * nt + 2 * t;
            if (ra < S) st2(dxr + ra * D + c, acc[nt][0], acc[nt][1]);
            if (rb < S) st2(dxr + rb * D + c, acc[nt][2], acc[nt][3]);
          }
        }
        BSTAMP(6);
      }
      __syncthreads();
      BSTAMP(7);

      // D, with the weight gradients: head h's columns of dWqkv += x^T [dq
      // | dk | dv] and its rows of dWo += o_h^T gout, summed over the ray's
      // rows (8 a k step, the permuted k index) into the block's partials.
      // Warp w takes x's channels 16 (w % 4).. and the q, k or v third w /
      // 4 of dWqkv; warps 0-7 the columns 8 w.. of dWo. Each warp owns its
      // tiles of the partials, so no atomics. It reads o_h and dq | dk | dv
      // of every row, written before the barrier above, and the next writes
      // to them come after the next head's phase A barrier.
      if constexpr (DW) {
        float* part = dwp + (size_t)blockIdx.x * DWP_FLOATS;
        const int ks = (S + 7) / 8;
        {
          const int m0 = 16 * (warp & 3), b = warp >> 2;
          float2* pa[2];  // rows m0 + g and m0 + g + 8 (+ 4 D3 float2s)
          float2 old[2][2];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            pa[n] = reinterpret_cast<float2*>(
                part + (m0 + g) * D3 + b * D + h * HD + 8 * n + 2 * t);
            old[n][0] = pa[n][0];
            old[n][1] = pa[n][4 * D3];
          }
          float acc[2][4] = {};
#pragma unroll 4
          for (int kk = 0; kk < ks; ++kk) {
            const int r0 = 8 * kk + 2 * t;
            const T* x0 = xr + min(r0, S - 1) * D + m0 + g;
            const T* x1 = xr + min(r0 + 1, S - 1) * D + m0 + g;
            const float a[4] = {ld(x0), ld(x0 + 8), ld(x1), ld(x1 + 8)};
            uint32_t ah[4], al[4];
            split4(a, ah, al);
            const float* gp = GQs + r0 * LDG + b * HD + g;
#pragma unroll
            for (int n = 0; n < 2; ++n)
              mma3_acc(acc[n], ah, al, gp[8 * n], gp[LDG + 8 * n]);
          }
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            pa[n][0] = make_float2(old[n][0].x + acc[n][0],
                                   old[n][0].y + acc[n][1]);
            pa[n][4 * D3] = make_float2(old[n][1].x + acc[n][2],
                                        old[n][1].y + acc[n][3]);
          }
        }
        if (warp < NT) {
          float2* pa = reinterpret_cast<float2*>(
              part + D * D3 + (h * HD + g) * D + 8 * warp + 2 * t);
          const float2 old0 = pa[0], old1 = pa[4 * D];  // rows + 0, + 8
          float acc[4] = {};
#pragma unroll 4
          for (int kk = 0; kk < ks; ++kk) {
            const int r0 = 8 * kk + 2 * t;
            const float* o0 = Os + r0 * LDO + g;
            const float a[4] = {o0[0], o0[8], o0[LDO], o0[LDO + 8]};
            uint32_t ah[4], al[4];
            split4(a, ah, al);
            mma3_acc(acc, ah, al,
                     ld(gr + min(r0, S - 1) * D + 8 * warp + g),
                     ld(gr + min(r0 + 1, S - 1) * D + 8 * warp + g));
          }
          pa[0] = make_float2(old0.x + acc[0], old0.y + acc[1]);
          pa[4 * D] = make_float2(old1.x + acc[2], old1.y + acc[3]);
        }
      }
    }
  }
}

// the backward's dynamic shared memory, with the weight gradients or not
size_t bwd_smem_bytes(int S, bool dw) {
  const size_t sp = (size_t)(S + KSTEP - 1) / KSTEP * KSTEP;
  return sizeof(float) * sp * (4 * LDH + LDX + 4 + (dw ? LDO + LDG : 0));
}

// the forward's: K, V and attn0's row for S rounded up to the key step
size_t fwd_smem_bytes(int S) {
  const size_t sp = (size_t)(S + KSTEP - 1) / KSTEP * KSTEP;
  return sizeof(float) * sp * (LDK + LDV + 1);
}

template <typename T>
int launch_fwd(const void* x, const void* wqkv, const void* wo,
               const void* bo, void* out, void* attn0, int R, int S,
               int blocks, cudaStream_t stream) {
  const size_t smem = fwd_smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      ra_fwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ra_fwd_kernel<T><<<blocks, FWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wqkv),
      static_cast<const float*>(wo), static_cast<const float*>(bo),
      static_cast<T*>(out), static_cast<T*>(attn0), R, S);
  return (int)cudaGetLastError();
}

template <typename T, bool DW>
int launch_bwd(const void* x, const void* wpack, const void* gout,
               const void* gattn0, void* dx, void* dwp, int R, int S,
               int blocks, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes(S, DW);
  cudaError_t err = cudaFuncSetAttribute(
      ra_bwd_kernel<T, DW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ra_bwd_kernel<T, DW><<<blocks, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wpack),
      static_cast<const T*>(gout), static_cast<const T*>(gattn0),
      static_cast<T*>(dx), static_cast<float*>(dwp), R, S);
  return (int)cudaGetLastError();
}

// the kernel of a (backward, dtype) pair of the C entries
template <typename F>
int with_kernel(int backward, int dtype, F f) {
  if (backward == 0)
    return dtype == 0 ? f(ra_fwd_kernel<float>, FWD_THREADS)
                      : f(ra_fwd_kernel<__nv_bfloat16>, FWD_THREADS);
  if (backward == 1)
    return dtype == 0 ? f(ra_bwd_kernel<float, false>, BWD_THREADS)
                      : f(ra_bwd_kernel<__nv_bfloat16, false>, BWD_THREADS);
  return dtype == 0 ? f(ra_bwd_kernel<float, true>, BWD_THREADS)
                    : f(ra_bwd_kernel<__nv_bfloat16, true>, BWD_THREADS);
}

template <typename K>
int max_blocks(K kernel, int threads, size_t smem) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// The fixed widths the kernels were compiled for.
extern "C" int ray_attention_dims(int* d, int* n_heads) {
  *d = D;
  *n_heads = NH;
  return 0;
}

// In the three entries below, backward: 0 = forward kernel, 1 = backward
// kernel, 2 = backward kernel with the weight gradients; dtype: 0 =
// float32, 1 = bfloat16.

// Dynamic shared memory one block needs, in bytes.
extern "C" long long ray_attention_smem_bytes(int S, int backward) {
  return (long long)(backward ? bwd_smem_bytes(S, backward == 2)
                              : fwd_smem_bytes(S));
}

// How many blocks fit on the current device at once (SMs x blocks per SM),
// or 0 when one block does not fit.
extern "C" int ray_attention_max_blocks(int S, int backward, int dtype) {
  const size_t smem = backward ? bwd_smem_bytes(S, backward == 2)
                               : fwd_smem_bytes(S);
  return with_kernel(backward, dtype, [&](auto kernel, int threads) {
    return max_blocks(kernel, threads, smem);
  });
}

// What a built kernel takes: registers per thread, threads per block,
// local memory (spills) per thread.
extern "C" int ray_attention_resources(int backward, int dtype, int* regs,
                                       int* threads, int* local) {
  return with_kernel(backward, dtype, [&](auto kernel, int nthreads) {
    cudaFuncAttributes attr;
    const cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    *regs = attr.numRegs;
    *threads = nthreads;
    *local = (int)attr.localSizeBytes;
    return 0;
  });
}

#ifdef RA_FWD_STAMPS
// Reads (reset == 0) or zeroes the forward's clocks by stage of a stamped
// build.
extern "C" int ray_attention_fwd_stage_cycles(unsigned long long* out,
                                              int reset) {
  if (reset) {
    const unsigned long long z[FWD_STAGES] = {0};
    return (int)cudaMemcpyToSymbol(ra_fwd_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, ra_fwd_cycles,
                                   sizeof(unsigned long long) * FWD_STAGES);
}
#endif

#ifdef RA_BWD_STAMPS
// Reads (reset == 0) or zeroes the backward's clocks by stage of a stamped
// build.
extern "C" int ray_attention_bwd_stage_cycles(unsigned long long* out,
                                              int reset) {
  if (reset) {
    const unsigned long long z[BWD_STAGES] = {0};
    return (int)cudaMemcpyToSymbol(ra_bwd_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, ra_bwd_cycles,
                                   sizeof(unsigned long long) * BWD_STAGES);
}
#endif

// The weights packed on the card (ra_pack_kernel): wpack holds 4D * 4D
// floats, packed Wqkv, Wo, Wo^T and Wqkv^T.
extern "C" int ray_attention_pack_weights(const void* wqkv, const void* wo,
                                          void* wpack, void* stream) {
  constexpr int n = PK_FLOATS / 4;  // one thread per lane and fragment
  ra_pack_kernel<<<(n + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wqkv), static_cast<const float*>(wo),
      static_cast<float4*>(wpack));
  return (int)cudaGetLastError();
}

// Plain C entries for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, out,
// attn0, gout, gattn0, dx); the weights packed as TF32 B fragments
// (ray_attention_pack_weights; the forward takes packed Wqkv and Wo, the
// backward the whole blob), bo and dwp float32. Each returns the
// cudaError_t of the launch (0 on success).
extern "C" int ray_attention_fwd(const void* x, const void* wqkv,
                                 const void* wo, const void* bo, void* out,
                                 void* attn0, int R, int S, int blocks,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || S < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_fwd<float>(x, wqkv, wo, bo, out, attn0, R, S, blocks, st);
  if (dtype == 1)
    return launch_fwd<__nv_bfloat16>(x, wqkv, wo, bo, out, attn0, R, S,
                                     blocks, st);
  return (int)cudaErrorInvalidValue;
}

// dwp: null (no weight gradients), or the blocks' partial sums of dWqkv
// and dWo, [blocks][D * 3D + D * D] f32, zeroed
extern "C" int ray_attention_bwd(const void* x, const void* wpack,
                                 const void* gout, const void* gattn0,
                                 void* dx, void* dwp, int R, int S,
                                 int blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || S < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  if (dwp != nullptr)
    return dtype == 0 ? launch_bwd<float, true>(x, wpack, gout, gattn0, dx,
                                                dwp, R, S, blocks, st)
                      : launch_bwd<__nv_bfloat16, true>(
                            x, wpack, gout, gattn0, dx, dwp, R, S, blocks,
                            st);
  return dtype == 0 ? launch_bwd<float, false>(x, wpack, gout, gattn0, dx,
                                               nullptr, R, S, blocks, st)
                    : launch_bwd<__nv_bfloat16, false>(
                          x, wpack, gout, gattn0, dx, nullptr, R, S, blocks,
                          st);
}
