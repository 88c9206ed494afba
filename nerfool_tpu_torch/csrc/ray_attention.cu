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
// Design of the backward: one block per ray, a persistent grid; x [S, D]
// and the per-head buffers in shared memory in f32 (S * 1 KB). A [S, S]
// probability matrix of one head (147 KB) does not fit, so it works head by
// head in the flash form with block-wide 4x4-register-tiled FMA products.
// Per head it recomputes q_h | k_h | v_h [S, 48] and go_h = gout @ Wo_h^T
// [S, 16]; pass 1 (a thread per query row) redoes the online softmax and
// keeps the row's max m_i, 1 / sum l_i, o_i, and delta_i = sum_j p_ij dp_ij;
// pass 2 (a thread per query row) sums dq_i = sum_j ds_ij k_j; pass 3 (a
// thread per key) sums dk_j = sum_i ds_ij q_i and dv_j = sum_i p_ij go_i,
// with dp_ij = go_i . v_j and ds_ij = p_ij (dp_ij - delta_i) / sqrt(HD). The
// attn0 cotangent adds gattn0 / NH to dp on query row 0 only. The head's
// dq | dk | dv go to a per-block f32 scratch in device memory (allocated by
// the wrapper, 147 KB per block, L2 resident); after the last head the
// scratch is read back over the dead per-head buffers and dx = gqkv @
// Wqkv^T and dWqkv += x^T gqkv run as two products. dWo += o_h^T gout runs
// per head. The weight gradients accumulate in the block's own [D, 3D] and
// [D, D] partials (zeroed by the wrapper), every element owned by one
// thread, so the sum over the partials outside is deterministic; there are
// no atomics. Its minimum is about 2.5x the forward's; the recompute in
// three passes makes it about 4x in the attention part, all on the CUDA
// cores in f32 FMA.
//
// x, gout, gattn0, out, attn0 and dx are float32 or bfloat16; all arithmetic
// is f32 (the forward's products as split TF32, loading bf16 as f32 and
// rounding its outputs). The forward's Wqkv and Wo arrive packed as TF32 B
// fragments (pack_b_tf32), bo as f32; the backward's weights as f32
// (bf16-valued on the bf16 route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;        // netwidth
constexpr int NH = 4;        // heads
constexpr int HD = D / NH;   // head width
constexpr int D3 = 3 * D;    // q | k | v
constexpr int H3 = 3 * HD;   // q_h | k_h | v_h
constexpr int BWD_THREADS = 256;

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

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// Block-wide product: epi(m, n, sum_k A[m * lda + k] * W[k * ldw + n]) for
// m < M, n < N. A is f32 in shared memory with 16-byte aligned rows
// (lda % 4 == 0); W is f32 in device memory with 16-byte aligned rows
// (ldw % 4 == 0); K % 4 == 0, N % 4 == 0. Each thread computes 4x4 output
// tiles; every (m, n) goes to one thread.
template <typename Epi>
__device__ __forceinline__ void block_mm(const float* A, int lda, int M,
                                         const float* __restrict__ W, int ldw,
                                         int K, int N, Epi epi) {
  const int ntn = N >> 2;
  const int tiles = ((M + 3) >> 2) * ntn;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int n0 = (t % ntn) << 2;
    const int m0 = (t / ntn) << 2;
    const float* a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A + min(m0 + i, M - 1) * lda;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; k += 4) {
      float4 w[4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        w[kk] = __ldg(reinterpret_cast<const float4*>(W + (k + kk) * ldw + n0));
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 av = *reinterpret_cast<const float4*>(a[i] + k);
        acc[i][0] = fmaf(av.x, w[0].x, fmaf(av.y, w[1].x,
                    fmaf(av.z, w[2].x, fmaf(av.w, w[3].x, acc[i][0]))));
        acc[i][1] = fmaf(av.x, w[0].y, fmaf(av.y, w[1].y,
                    fmaf(av.z, w[2].y, fmaf(av.w, w[3].y, acc[i][1]))));
        acc[i][2] = fmaf(av.x, w[0].z, fmaf(av.y, w[1].z,
                    fmaf(av.z, w[2].z, fmaf(av.w, w[3].z, acc[i][2]))));
        acc[i][3] = fmaf(av.x, w[0].w, fmaf(av.y, w[1].w,
                    fmaf(av.z, w[2].w, fmaf(av.w, w[3].w, acc[i][3]))));
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (m0 + i < M) {
#pragma unroll
        for (int j = 0; j < 4; ++j) epi(m0 + i, n0 + j, acc[i][j]);
      }
    }
  }
}

// Block-wide transposed product: epi(m, n, sum_k A[k * lda + m] *
// B[k * ldb + n]) for m < M, n < N, k < K. A and B are f32 in shared memory
// with 16-byte aligned rows; M % 4 == 0, N % 4 == 0. 4x4 tiles as above.
template <typename Epi>
__device__ __forceinline__ void block_mm_tn(const float* A, int lda, int M,
                                            const float* B, int ldb, int N,
                                            int K, Epi epi) {
  const int ntn = N >> 2;
  const int tiles = (M >> 2) * ntn;
  for (int t = threadIdx.x; t < tiles; t += blockDim.x) {
    const int n0 = (t % ntn) << 2;
    const int m0 = (t / ntn) << 2;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
    for (int k = 0; k < K; ++k) {
      const float4 a = *reinterpret_cast<const float4*>(A + k * lda + m0);
      const float4 b = *reinterpret_cast<const float4*>(B + k * ldb + n0);
      const float av[4] = {a.x, a.y, a.z, a.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] = fmaf(av[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(av[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(av[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(av[i], b.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(m0 + i, n0 + j, acc[i][j]);
  }
}

__device__ __forceinline__ float dot_hd(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// ---- forward helpers: split TF32 on mma.sync.m16n8k8 ----

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

// Packs wqkv [D][3D] and wo [D][D] (f32, in x out) as the forward's B
// fragments, in ops/view_attention.py pack_b_tf32's layout: wp [D/8][3D/8]
// [32][4] then [D/8][D/8][32][4], lane 4g + t of fragment (kt, nt) holding
// (hi, hi, lo, lo) of rows 8 kt + 2t and 8 kt + 2t + 1 of column 8 nt + g.
// One thread per lane and fragment.
__global__ void ra_pack_kernel(const float* __restrict__ wqkv,
                               const float* __restrict__ wo,
                               float4* __restrict__ wp) {
  constexpr int NQ = (D / 8) * QKV_NT * 32;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= NQ + (D / 8) * NT * 32) return;
  const bool is_o = i >= NQ;
  const int j = is_o ? i - NQ : i;
  const int ntot = is_o ? NT : QKV_NT;
  const int lane = j & 31, nt = (j >> 5) % ntot, kt = (j >> 5) / ntot;
  const int g = lane >> 2, t = lane & 3;
  const float* w =
      (is_o ? wo : wqkv) + (8 * kt + 2 * t) * 8 * ntot + 8 * nt + g;
  const float w0 = w[0], w1 = w[8 * ntot];
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
        constexpr float QSCALE = 0.25f * 1.4426950408889634f;
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

// Backward. x, gout, dx [R, S, D]; gattn0 [R, S]; wqkv_heads [NH][D][3 * HD]
// (q_h | k_h | v_h columns of Wqkv per head); wqkv_t [3D][D] = Wqkv^T; wo_t
// [D][D] = Wo^T; gscratch [gridDim.x][S][3D] f32; dwqkv_p [gridDim.x][D][3D]
// and dwo_p [gridDim.x][D][D] f32, zeroed by the caller and skipped when
// want_dw == 0. Shared memory: (S * D + S * 3D) floats.
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS) ra_bwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wqkv_heads,
    const float* __restrict__ wqkv_t, const float* __restrict__ wo_t,
    const T* __restrict__ gout, const T* __restrict__ gattn0,
    float* __restrict__ gscratch, T* __restrict__ dx,
    float* __restrict__ dwqkv_p, float* __restrict__ dwo_p, int R, int S,
    int want_dw) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;             // [S][D]
  float* u = xs + S * D;        // [S][3D]: the per-head buffers, then gqkv
  float* gs = u;                // [S][D]   gout
  float* hb = gs + S * D;       // [S][3HD] q_h | k_h | v_h
  float* goh = hb + S * H3;     // [S][HD]  gout @ Wo_h^T
  float* oh = goh + S * HD;     // [S][HD]  o_h
  float* mrow = oh + S * HD;    // [S] row max
  float* lrow = mrow + S;       // [S] 1 / row sum
  float* drow = lrow + S;       // [S] delta_i
  float* ga0 = drow + S;        // [S] gattn0 / NH
  const float scale = 1.f / sqrtf((float)HD);
  float* gq = gscratch + (size_t)blockIdx.x * S * D3;
  float* dwq = want_dw ? dwqkv_p + (size_t)blockIdx.x * D * D3 : nullptr;
  float* dwo = want_dw ? dwo_p + (size_t)blockIdx.x * D * D : nullptr;

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * S * D;
    const T* gr = gout + (size_t)r * S * D;
    for (int e = threadIdx.x; e < S * D; e += blockDim.x) {
      xs[e] = ld(xr + e);
      gs[e] = ld(gr + e);
    }
    for (int j = threadIdx.x; j < S; j += blockDim.x)
      ga0[j] = ld(gattn0 + (size_t)r * S + j) * (1.f / NH);
    __syncthreads();

    for (int h = 0; h < NH; ++h) {
      block_mm(xs, D, S, wqkv_heads + h * D * H3, H3, D, H3,
               [&](int m, int n, float v) { hb[m * H3 + n] = v; });
      block_mm(gs, D, S, wo_t + h * HD, D, D, HD,
               [&](int m, int n, float v) { goh[m * HD + n] = v; });
      __syncthreads();

      // pass 1, a thread per query row: m_i, 1 / l_i, o_i and delta_i =
      // go_i . o_i (+ sum_j p_0j ga0_j on row 0)
      for (int qi = threadIdx.x; qi < S; qi += blockDim.x) {
        float qv[HD], o[HD];
#pragma unroll
        for (int c = 0; c < HD; ++c) { qv[c] = hb[qi * H3 + c]; o[c] = 0.f; }
        float mx = -INFINITY, den = 0.f, ex = 0.f;
        for (int j = 0; j < S; ++j) {
          const float* kj = hb + j * H3 + HD;
          const float sv = dot_hd(qv, kj) * scale;
          const float mn = fmaxf(mx, sv);
          const float corr = expf(mx - mn);
          const float pj = expf(sv - mn);
          den = fmaf(den, corr, pj);
          ex = fmaf(ex, corr, pj * ga0[j]);
#pragma unroll
          for (int c = 0; c < HD; ++c) o[c] = fmaf(o[c], corr, pj * kj[HD + c]);
          mx = mn;
        }
        const float inv = 1.f / den;
        float dl = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          o[c] *= inv;
          oh[qi * HD + c] = o[c];
          dl = fmaf(goh[qi * HD + c], o[c], dl);
        }
        if (qi == 0) dl = fmaf(ex, inv, dl);
        mrow[qi] = mx;
        lrow[qi] = inv;
        drow[qi] = dl;
      }
      __syncthreads();

      // dWo[h * HD + a][n] += sum_s o_h[s][a] * gout[s][n]
      if (want_dw)
        block_mm_tn(oh, HD, HD, gs, D, D, S, [&](int m, int n, float v) {
          dwo[(h * HD + m) * D + n] += v;
        });

      // pass 2, a thread per query row: dq_i = sum_j ds_ij k_j
      for (int qi = threadIdx.x; qi < S; qi += blockDim.x) {
        float qv[HD], gv[HD], dq[HD];
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          qv[c] = hb[qi * H3 + c];
          gv[c] = goh[qi * HD + c];
          dq[c] = 0.f;
        }
        const float mx = mrow[qi], inv = lrow[qi], dl = drow[qi];
        const float g0 = qi == 0 ? 1.f : 0.f;
        for (int j = 0; j < S; ++j) {
          const float* kj = hb + j * H3 + HD;
          const float p = expf(dot_hd(qv, kj) * scale - mx) * inv;
          const float dp = fmaf(g0, ga0[j], dot_hd(gv, kj + HD));
          const float ds = p * (dp - dl) * scale;
#pragma unroll
          for (int c = 0; c < HD; ++c) dq[c] = fmaf(ds, kj[c], dq[c]);
        }
#pragma unroll
        for (int c = 0; c < HD; ++c) gq[qi * D3 + h * HD + c] = dq[c];
      }

      // pass 3, a thread per key: dk_j = sum_i ds_ij q_i, dv_j = sum_i p_ij
      // go_i
      for (int j = threadIdx.x; j < S; j += blockDim.x) {
        float kv[HD], vv[HD], dk[HD], dv[HD];
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          kv[c] = hb[j * H3 + HD + c];
          vv[c] = hb[j * H3 + 2 * HD + c];
          dk[c] = 0.f;
          dv[c] = 0.f;
        }
        const float g0 = ga0[j];
        for (int i = 0; i < S; ++i) {
          const float* qi = hb + i * H3;
          const float* gi = goh + i * HD;
          const float p = expf(dot_hd(qi, kv) * scale - mrow[i]) * lrow[i];
          const float dp = dot_hd(gi, vv) + (i == 0 ? g0 : 0.f);
          const float ds = p * (dp - drow[i]) * scale;
#pragma unroll
          for (int c = 0; c < HD; ++c) {
            dk[c] = fmaf(ds, qi[c], dk[c]);
            dv[c] = fmaf(p, gi[c], dv[c]);
          }
        }
#pragma unroll
        for (int c = 0; c < HD; ++c) {
          gq[j * D3 + D + h * HD + c] = dk[c];
          gq[j * D3 + 2 * D + h * HD + c] = dv[c];
        }
      }
      __syncthreads();
    }

    // gqkv back from the scratch, over the dead per-head buffers
    for (int e = threadIdx.x; e < S * D3; e += blockDim.x) u[e] = gq[e];
    __syncthreads();
    T* dxr = dx + (size_t)r * S * D;
    block_mm(u, D3, S, wqkv_t, D, D3, D,
             [&](int m, int n, float v) { st(dxr + m * D + n, v); });
    if (want_dw)
      block_mm_tn(xs, D, D, u, D3, D3, S,
                  [&](int m, int n, float v) { dwq[m * D3 + n] += v; });
    __syncthreads();
  }
}

// the backward's dynamic shared memory
size_t smem_bytes(int S) {
  return sizeof(float) * (size_t)S * (D + D3);
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

template <typename T>
int launch_bwd(const void* x, const void* wqkv_heads, const void* wqkv_t,
               const void* wo_t, const void* gout, const void* gattn0,
               void* gscratch, void* dx, void* dwqkv_p, void* dwo_p, int R,
               int S, int blocks, int want_dw, cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      ra_bwd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  ra_bwd_kernel<T><<<blocks, BWD_THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(wqkv_heads),
      static_cast<const float*>(wqkv_t), static_cast<const float*>(wo_t),
      static_cast<const T*>(gout), static_cast<const T*>(gattn0),
      static_cast<float*>(gscratch), static_cast<T*>(dx),
      static_cast<float*>(dwqkv_p), static_cast<float*>(dwo_p), R, S,
      want_dw);
  return (int)cudaGetLastError();
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

// Dynamic shared memory one block needs, in bytes. backward: 0 = forward
// kernel, 1 = backward kernel.
extern "C" long long ray_attention_smem_bytes(int S, int backward) {
  return (long long)(backward ? smem_bytes(S) : fwd_smem_bytes(S));
}

// How many blocks fit on the current device at once (SMs x blocks per SM),
// or 0 when one block does not fit. backward: 0 = forward kernel, 1 =
// backward kernel. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ray_attention_max_blocks(int S, int backward, int dtype) {
  const size_t smem = backward ? smem_bytes(S) : fwd_smem_bytes(S);
  if (backward)
    return dtype == 0
               ? max_blocks(ra_bwd_kernel<float>, BWD_THREADS, smem)
               : max_blocks(ra_bwd_kernel<__nv_bfloat16>, BWD_THREADS, smem);
  return dtype == 0
             ? max_blocks(ra_fwd_kernel<float>, FWD_THREADS, smem)
             : max_blocks(ra_fwd_kernel<__nv_bfloat16>, FWD_THREADS, smem);
}

// What the built forward kernel takes: registers per thread, threads per
// block, local memory (spills) per thread. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ray_attention_fwd_resources(int dtype, int* regs, int* threads,
                                           int* local) {
  cudaFuncAttributes attr;
  const cudaError_t err =
      dtype == 0 ? cudaFuncGetAttributes(&attr, ra_fwd_kernel<float>)
                 : cudaFuncGetAttributes(&attr, ra_fwd_kernel<__nv_bfloat16>);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = FWD_THREADS;
  *local = (int)attr.localSizeBytes;
  return 0;
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

// The forward's weights packed on the card (ra_pack_kernel): wpack holds
// 2 * D * 4D floats, packed Wqkv then packed Wo.
extern "C" int ray_attention_pack_weights(const void* wqkv, const void* wo,
                                          void* wpack, void* stream) {
  constexpr int n = (D / 8) * (QKV_NT + NT) * 32;
  ra_pack_kernel<<<(n + 255) / 256, 256, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(wqkv), static_cast<const float*>(wo),
      static_cast<float4*>(wpack));
  return (int)cudaGetLastError();
}

// Plain C entries for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, out,
// attn0, gout, gattn0, dx); weights, scratch and weight-gradient partials are
// float32, the forward's wqkv and wo packed as TF32 B fragments
// (pack_b_tf32). Each returns the cudaError_t of the launch (0 on success).
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

extern "C" int ray_attention_bwd(const void* x, const void* wqkv_heads,
                                 const void* wqkv_t, const void* wo_t,
                                 const void* gout, const void* gattn0,
                                 void* gscratch, void* dx, void* dwqkv_p,
                                 void* dwo_p, int R, int S, int blocks,
                                 int want_dw, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R < 1 || S < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_bwd<float>(x, wqkv_heads, wqkv_t, wo_t, gout, gattn0,
                             gscratch, dx, dwqkv_p, dwo_p, R, S, blocks,
                             want_dw, st);
  if (dtype == 1)
    return launch_bwd<__nv_bfloat16>(x, wqkv_heads, wqkv_t, wo_t, gout,
                                     gattn0, gscratch, dx, dwqkv_p, dwo_p, R,
                                     S, blocks, want_dw, st);
  return (int)cudaErrorInvalidValue;
}
