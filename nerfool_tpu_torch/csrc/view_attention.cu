// GNT view attention for Hopper (sm_90a), forward only, bound to PyTorch
// through ctypes.
//
// Replaces the TPU kernel fused_view_attention of nerfool_tpu/ops/vt_kernel.py
// (body _vt_kernel) and its lane-packed twin _fused_va_lp (body _vt_kernel_lp,
// the same function on rows paired into 128 lanes). Per row n of N = rays x
// samples, over the V source views, with width D = 64 and hidden width 8:
//
//   qp    = qln[n] Wq                                         [D]
//   kp|vv = k[v, n] [Wk | Wk Wv]                              [2D]
//   p     = relu(pos[v, n] Wp0 + bp0) Wp1 + bp1               [D]
//   a     = relu((kp - qp + p) Wa0 + ba0) Wa1 + ba1           [D]
//   a     = -1e9 where mask[v, n] == 0
//   w     = softmax over v of a, per channel                  [V, D]
//   out[n] = (sum_v (vv + p) w) Wo + bo                       [D]
//
// All seven products run here; only Wk Wv is formed outside (as the TPU
// kernel's caller forms it).
//
// What bounds it: per (view, row) 2 * 64 * 128 = 16 kFLOP in the kv product
// (84% of the operations) and ~3 kFLOP in the two small MLPs, against 276
// bytes of f32 input: operations. The kv product, qln Wq and the output
// product therefore run on the tensor cores with mma.sync; the MLPs (K = 4
// and 8, N = 8 hidden units), the softmax and the epilogues stay f32 FMA.
//  - float32: each product is three TF32 products, a_hi b_hi + a_hi b_lo +
//    a_lo b_hi on mma.sync.m16n8k8, with hi = tf32(x) and lo = tf32(x - hi)
//    (round to nearest): about 2^-21 of each term, far inside the f32
//    route's tolerance. This is not TF32 mode, which keeps hi b_hi alone.
//  - bfloat16: mma.sync.m16n8k16 on the bf16 inputs and bf16-valued
//    weights, f32 accumulators, as K2's bf16 view stage
//    (csrc/gnt_chain.cu).
// Design:
//  - One block per SM (persistent grid) of 8 warps; every weight lives in
//    shared memory, the matrices packed by the host as B fragments in the
//    order they are read (ops/view_attention.py pack_b_tf32: hi and lo of
//    both registers in one 16-byte load per lane; ops/chain.py pack_b for
//    bf16: one 8-byte load).
//  - A warp walks groups of 8 rows on its own, with no block barrier after
//    the weights are in. Its m16 tile is 8 rows x 2 views (rows g and g + 8
//    of the fragment are row g of views 2j and 2j + 1), so each thread keeps
//    the online softmax over the views for one row and 16 channels in 48
//    registers, merging two views per step. A ragged last pair (odd V) does
//    not enter the softmax.
//  - The k tile of the next view pair (16 x 64) is copied by cp.async into
//    the warp's second staging buffer while this pair computes: k is read
//    from device memory once, without registers or instructions spent
//    waiting for it. Rows past N and views past V are zero-filled.
//  - The accumulators of kp start at p - qp and those of vv at p, so a =
//    kp - qp + p and vv + p come out of the tensor cores as they are. The
//    64 -> 8 contraction sums the thread's 16 channels and then the 4 lanes
//    that share its rows.
//  - The output product's A fragments are the softmax result's C fragments
//    in registers: for TF32 the k index of a step is permuted (its logical
//    columns t and t + 4 are channels 8 kt + 2 t and 8 kt + 2 t + 1), with
//    B's rows packed in the same order, so C -> A needs no data movement;
//    for bf16 the C tiles of two n-tiles are one A fragment as they are.
//    The same permutation turns the k tile's A fragments into 8-byte
//    shared-memory loads.
//  - -1e9 is a fill value, not -inf, so a row whose views are all masked
//    gets the uniform 1 / V weights of the module. Rows past N are computed
//    on zeros and never stored.
//
// qln, k, pos, mask and out are float32 or bfloat16; the softmax, the MLPs
// and every accumulator are f32, and bf16 rounds only the output product's
// operand (the softmax's result) and the output. The matrices arrive packed
// (f32 hi/lo words or bf16), the vectors as one f32 blob in the order of the
// O_* offsets below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // netwidth
constexpr int HID = D / 8;    // hidden width of the pos and attention MLPs
constexpr int PD = 4;         // width of the ray-difference encoding
constexpr int G = 8;          // rows per warp step
constexpr int NT = D / 8;     // n-tiles of a D-wide product
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int LDS = D + 8;    // staging row stride in elements: no conflicts

// the vector blob, in floats
constexpr int O_WP0 = 0;                  // [PD][HID]
constexpr int O_BP0 = O_WP0 + PD * HID;   // [HID]
constexpr int O_WP1 = O_BP0 + HID;        // [HID][D]
constexpr int O_BP1 = O_WP1 + HID * D;    // [D]
constexpr int O_WA0T = O_BP1 + D;         // [HID][D]  Wa0 transposed
constexpr int O_BA0 = O_WA0T + HID * D;   // [HID]
constexpr int O_WA1 = O_BA0 + HID;        // [HID][D]
constexpr int O_BA1 = O_WA1 + HID * D;    // [D]
constexpr int O_BO = O_BA1 + D;           // [D]
constexpr int VEC_FLOATS = O_BO + D;

static_assert(VEC_FLOATS % 4 == 0 && O_WP1 % 2 == 0 && O_WA0T % 2 == 0 &&
              O_WA1 % 2 == 0 && O_BP1 % 2 == 0 && O_BA1 % 2 == 0 &&
              O_BO % 2 == 0, "float4 copies and float2 reads of the blob");

// The packed matrices, in 32-bit words: Wkv [D][2D], then Wq [D][D], then
// Wo [D][D]. TF32: hi and lo of both B registers, 4 words per lane and (k
// step of 8, n-tile); bf16: 2 words per lane and (k step of 16, n-tile).
template <typename TT>
constexpr int mat_words(int k, int n) {
  return sizeof(TT) == 4 ? 2 * k * n : k * n / 2;
}
template <typename TT> constexpr int M_WKV = 0;
template <typename TT> constexpr int M_WQ = mat_words<TT>(D, 2 * D);
template <typename TT> constexpr int M_WO = M_WQ<TT> + mat_words<TT>(D, D);
template <typename TT> constexpr int MAT_WORDS = M_WO<TT> + mat_words<TT>(D, D);

template <typename TT>
constexpr size_t smem_bytes() {
  return (size_t)MAT_WORDS<TT> * 4 + (size_t)VEC_FLOATS * 4 +
         (size_t)WARPS * 2 * 16 * LDS * sizeof(TT);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo to ~2^-22 of x, both TF32
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// acc[nt] += A B[., nt0 + nt] over the D = 64 rows of B (n-tiles per k step:
// ntot). fa(kt, a) gives the A fragment of k step kt: for f32 the values of
// logical columns (t, t + 4) = channels (8 kt + 2 t, 8 kt + 2 t + 1) of rows
// (g, g + 8) as a[0] = (g, t), a[1] = (g + 8, t), a[2] = (g, t + 4), a[3] =
// (g + 8, t + 4), split here; for bf16 the pairs of m16n8k16's A fragment.
template <typename TT, int NW, typename FA>
__device__ __forceinline__ void product(float (&acc)[NW][4],
                                        const uint32_t* B, int ntot, int nt0,
                                        int lane, FA fa) {
  if constexpr (sizeof(TT) == 4) {
    const uint4* Bq = reinterpret_cast<const uint4*>(B);
#pragma unroll
    for (int kt = 0; kt < D / 8; ++kt) {
      float x[4];
      fa(kt, x);
      uint32_t hi[4], lo[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split(x[i], hi[i], lo[i]);
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const uint4 b = Bq[((kt * ntot + nt0 + nt) << 5) + lane];
        mma_tf32(acc[nt], lo, b.x, b.y);  // small terms first
        mma_tf32(acc[nt], hi, b.z, b.w);
        mma_tf32(acc[nt], hi, b.x, b.y);
      }
    }
  } else {
    const uint2* Bq = reinterpret_cast<const uint2*>(B);
#pragma unroll
    for (int kt = 0; kt < D / 16; ++kt) {
      uint32_t a[4];
      fa(kt, a);
#pragma unroll
      for (int nt = 0; nt < NW; ++nt) {
        const uint2 b = Bq[((kt * ntot + nt0 + nt) << 5) + lane];
        mma_bf16(acc[nt], a, b.x, b.y);
      }
    }
  }
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int bytes) {
  const uint32_t d = (uint32_t)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N_>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N_));
}

// The warp's 16 staged rows of view pair j of the group at row n0: row r is
// row n0 + (r & 7) of view 2 j + (r >> 3), zeros past N or V.
template <typename TT>
__device__ __forceinline__ void stage_pair(TT* dst, const TT* __restrict__ k,
                                           int n0, int j, int V, int N,
                                           int lane) {
  constexpr int CH = D * sizeof(TT) / 16;  // 16-byte chunks per row
  constexpr int PER = 16 / sizeof(TT);
#pragma unroll
  for (int c = lane; c < 16 * CH; c += 32) {
    const int r = c / CH, q = c - r * CH;
    const int v = 2 * j + (r >> 3), n = n0 + (r & 7);
    const bool ok = v < V && n < N;
    const TT* src = ok ? k + ((size_t)v * N + n) * D + q * PER : k;
    cp_async16(dst + r * LDS + q * PER, src, ok ? 16 : 0);
  }
}

__device__ __forceinline__ void load_pos(const float* p, float (&x)[PD]) {
  const float4 u = __ldg(reinterpret_cast<const float4*>(p));
  x[0] = u.x; x[1] = u.y; x[2] = u.z; x[3] = u.w;
}
__device__ __forceinline__ void load_pos(const __nv_bfloat16* p,
                                         float (&x)[PD]) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  x[0] = __uint_as_float(u.x << 16);
  x[1] = __uint_as_float(u.x & 0xffff0000u);
  x[2] = __uint_as_float(u.y << 16);
  x[3] = __uint_as_float(u.y & 0xffff0000u);
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// grid: persistent, global warp w walks groups n0 = 8 (w + i * warps). qln
// [N, D]; k [V, N, D]; pos [V, N, PD]; mask [V, N]; out [N, D].
template <typename TT>
__global__ void __launch_bounds__(THREADS, 1) va_kernel(
    const TT* __restrict__ qln, const TT* __restrict__ k,
    const TT* __restrict__ pos, const TT* __restrict__ mask,
    const uint32_t* __restrict__ mats, const float* __restrict__ vecs,
    TT* __restrict__ out, int V, int N) {
  extern __shared__ __align__(16) unsigned char smem[];
  uint32_t* sm = reinterpret_cast<uint32_t*>(smem);
  float* sv = reinterpret_cast<float*>(sm + MAT_WORDS<TT>);
  TT* stage0 = reinterpret_cast<TT*>(sv + VEC_FLOATS);

  for (int e = threadIdx.x; e < MAT_WORDS<TT> / 4; e += THREADS)
    reinterpret_cast<uint4*>(sm)[e] =
        __ldg(reinterpret_cast<const uint4*>(mats) + e);
  for (int e = threadIdx.x; e < VEC_FLOATS / 4; e += THREADS)
    reinterpret_cast<float4*>(sv)[e] =
        __ldg(reinterpret_cast<const float4*>(vecs) + e);
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  TT* stg = stage0 + warp * 2 * 16 * LDS;
  const int groups = (N + G - 1) / G;
  const int pairs = (V + 1) / 2;
  const int wstride = gridDim.x * WARPS;
  const int first = blockIdx.x * WARPS + warp;
  if (first >= groups) return;
  const long long items =
      (long long)((groups - 1 - first) / wstride + 1) * pairs;

  stage_pair(stg, k, first * G, 0, V, N, lane);
  cp_commit();

  float qp[NT][2], mx[NT][2], den[NT][2], num[NT][2];
  for (long long it = 0; it < items; ++it) {
    const int gi = (int)(it / pairs), j = (int)(it - (long long)gi * pairs);
    const int n0 = (first + gi * wstride) * G;
    const int n = n0 + g;  // this thread's row
    const bool row_ok = n < N;
    const int v0 = 2 * j, v1 = 2 * j + 1;
    const bool has1 = v1 < V;
    // the pos and mask of the thread's row in both views, issued first
    float pz0[PD], pz1[PD];
    float m0 = 0.f, m1 = 0.f;
#pragma unroll
    for (int i = 0; i < PD; ++i) pz0[i] = pz1[i] = 0.f;
    if (row_ok) {
      load_pos(pos + ((size_t)v0 * N + n) * PD, pz0);
      m0 = load1(mask + (size_t)v0 * N + n);
      if (has1) {
        load_pos(pos + ((size_t)v1 * N + n) * PD, pz1);
        m1 = load1(mask + (size_t)v1 * N + n);
      }
    }

    if (it + 1 < items) {
      const int gn = (int)((it + 1) / pairs);
      const int jn = (int)(it + 1 - (long long)gn * pairs);
      stage_pair(stg + ((it + 1) & 1) * 16 * LDS, k,
                 (first + gn * wstride) * G, jn, V, N, lane);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncwarp();
    const TT* st = stg + (it & 1) * 16 * LDS;

    if (j == 0) {
      // qp = qln Wq for the group's rows (fragment rows g + 8 unused)
      float acc[NT][4];
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      const TT* qrow = qln + (size_t)(row_ok ? n : 0) * D;
      if constexpr (sizeof(TT) == 4) {
        product<TT, NT>(acc, sm + M_WQ<TT>, NT, 0, lane,
                        [&](int kt, float (&x)[4]) {
                          float2 u = make_float2(0.f, 0.f);
                          if (row_ok)
                            u = __ldg(reinterpret_cast<const float2*>(
                                qrow + 8 * kt + 2 * t));
                          x[0] = u.x; x[1] = 0.f; x[2] = u.y; x[3] = 0.f;
                        });
      } else {
        const uint32_t* qw = reinterpret_cast<const uint32_t*>(qrow);
        product<TT, NT>(acc, sm + M_WQ<TT>, NT, 0, lane,
                        [&](int kt, uint32_t (&a)[4]) {
                          a[0] = row_ok ? __ldg(qw + 8 * kt + t) : 0u;
                          a[2] = row_ok ? __ldg(qw + 8 * kt + 4 + t) : 0u;
                          a[1] = a[3] = 0u;
                        });
      }
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          qp[a][e] = acc[a][e];
          mx[a][e] = -INFINITY;
          den[a][e] = 0.f;
          num[a][e] = 0.f;
        }
    }

    // hidden layer of the pos MLP for both views of the row
    float hp[2][HID];
#pragma unroll
    for (int h = 0; h < HID; ++h) {
      float a0 = sv[O_BP0 + h], a1 = a0;
#pragma unroll
      for (int i = 0; i < PD; ++i) {
        const float w = sv[O_WP0 + i * HID + h];
        a0 = fmaf(pz0[i], w, a0);
        a1 = fmaf(pz1[i], w, a1);
      }
      hp[0][h] = fmaxf(a0, 0.f);
      hp[1][h] = fmaxf(a1, 0.f);
    }
    // p on the thread's channels: kp's accumulators start at p - qp, vv's
    // at p (C fragment element e + 2 r is row g + 8 r, channel 8 nt + 2 t +
    // e)
    float ka[NT][4], va[NT][4];
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      const int c = 8 * a + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(sv + O_BP1 + c);
      float p[4] = {b.x, b.y, b.x, b.y};
#pragma unroll
      for (int h = 0; h < HID; ++h) {
        const float2 w =
            *reinterpret_cast<const float2*>(sv + O_WP1 + h * D + c);
        p[0] = fmaf(hp[0][h], w.x, p[0]);
        p[1] = fmaf(hp[0][h], w.y, p[1]);
        p[2] = fmaf(hp[1][h], w.x, p[2]);
        p[3] = fmaf(hp[1][h], w.y, p[3]);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        va[a][e] = p[e];
        ka[a][e] = p[e] - qp[a][e & 1];
      }
    }

    // the k tile's A fragments
    auto fa_k = [&](int kt, auto& a) {
      if constexpr (sizeof(TT) == 4) {
        const float* r0 = reinterpret_cast<const float*>(st) + g * LDS;
        const float2 u = *reinterpret_cast<const float2*>(r0 + 8 * kt + 2 * t);
        const float2 w =
            *reinterpret_cast<const float2*>(r0 + 8 * LDS + 8 * kt + 2 * t);
        a[0] = u.x; a[1] = w.x; a[2] = u.y; a[3] = w.y;
      } else {
        const uint32_t* r0 = reinterpret_cast<const uint32_t*>(st + g * LDS);
        const uint32_t* r1 =
            reinterpret_cast<const uint32_t*>(st + (g + 8) * LDS);
        a[0] = r0[8 * kt + t];
        a[1] = r1[8 * kt + t];
        a[2] = r0[8 * kt + 4 + t];
        a[3] = r1[8 * kt + 4 + t];
      }
    };
    // a = kp - qp + p
    product<TT, NT>(ka, sm + M_WKV<TT>, 2 * NT, 0, lane, fa_k);

    // hidden layer of the attention MLP: the thread's 16 channels, then the
    // 4 lanes that share its rows
    float ha[2][HID];
#pragma unroll
    for (int h = 0; h < HID; ++h) {
      float s0 = 0.f, s1 = 0.f;
#pragma unroll
      for (int a = 0; a < NT; ++a) {
        const float2 w = *reinterpret_cast<const float2*>(
            sv + O_WA0T + h * D + 8 * a + 2 * t);
        s0 = fmaf(ka[a][0], w.x, fmaf(ka[a][1], w.y, s0));
        s1 = fmaf(ka[a][2], w.x, fmaf(ka[a][3], w.y, s1));
      }
      s0 += __shfl_xor_sync(0xffffffffu, s0, 1);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 1);
      s0 += __shfl_xor_sync(0xffffffffu, s0, 2);
      s1 += __shfl_xor_sync(0xffffffffu, s1, 2);
      const float b = sv[O_BA0 + h];
      ha[0][h] = fmaxf(s0 + b, 0.f);
      ha[1][h] = fmaxf(s1 + b, 0.f);
    }
    // the scores, -1e9 where the view is masked
#pragma unroll
    for (int a = 0; a < NT; ++a) {
      const int c = 8 * a + 2 * t;
      const float2 b = *reinterpret_cast<const float2*>(sv + O_BA1 + c);
      float l[4] = {b.x, b.y, b.x, b.y};
#pragma unroll
      for (int h = 0; h < HID; ++h) {
        const float2 w =
            *reinterpret_cast<const float2*>(sv + O_WA1 + h * D + c);
        l[0] = fmaf(ha[0][h], w.x, l[0]);
        l[1] = fmaf(ha[0][h], w.y, l[1]);
        l[2] = fmaf(ha[1][h], w.x, l[2]);
        l[3] = fmaf(ha[1][h], w.y, l[3]);
      }
      ka[a][0] = m0 == 0.f ? -1e9f : l[0];
      ka[a][1] = m0 == 0.f ? -1e9f : l[1];
      ka[a][2] = m1 == 0.f ? -1e9f : l[2];
      ka[a][3] = m1 == 0.f ? -1e9f : l[3];
    }

    // vv + p
    product<TT, NT>(va, sm + M_WKV<TT>, 2 * NT, NT, lane, fa_k);

    // online softmax over the views, two at a time
#pragma unroll
    for (int a = 0; a < NT; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float l0 = ka[a][e], l1 = ka[a][e + 2];
        const float mn = fmaxf(mx[a][e], has1 ? fmaxf(l0, l1) : l0);
        const float corr = __expf(mx[a][e] - mn);
        const float e0 = __expf(l0 - mn);
        const float e1 = has1 ? __expf(l1 - mn) : 0.f;
        den[a][e] = fmaf(den[a][e], corr, e0 + e1);
        num[a][e] = fmaf(num[a][e], corr,
                         fmaf(va[a][e], e0, va[a][e + 2] * e1));
        mx[a][e] = mn;
      }

    if (j == pairs - 1) {
      // out = (num / den) Wo + bo; the C fragments are the A fragments
      float x[NT][2];
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 2; ++e) x[a][e] = num[a][e] / den[a][e];
      float acc[NT][4];
#pragma unroll
      for (int a = 0; a < NT; ++a)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[a][e] = 0.f;
      if constexpr (sizeof(TT) == 4) {
        product<TT, NT>(acc, sm + M_WO<TT>, NT, 0, lane,
                        [&](int kt, float (&y)[4]) {
                          y[0] = x[kt][0]; y[1] = 0.f;
                          y[2] = x[kt][1]; y[3] = 0.f;
                        });
      } else {
        product<TT, NT>(acc, sm + M_WO<TT>, NT, 0, lane,
                        [&](int kt, uint32_t (&y)[4]) {
                          y[0] = pack2(x[2 * kt][0], x[2 * kt][1]);
                          y[2] = pack2(x[2 * kt + 1][0], x[2 * kt + 1][1]);
                          y[1] = y[3] = 0u;
                        });
      }
      if (row_ok) {
#pragma unroll
        for (int a = 0; a < NT; ++a) {
          const int c = 8 * a + 2 * t;
          const float2 b = *reinterpret_cast<const float2*>(sv + O_BO + c);
          store2(out + (size_t)n * D + c, acc[a][0] + b.x, acc[a][1] + b.y);
        }
      }
    }
    __syncwarp();  // every lane has read this stage before it is refilled
  }
}

template <typename TT>
int launch(const void* qln, const void* k, const void* pos, const void* mask,
           const void* mats, const void* vecs, void* out, int V, int N,
           int blocks, cudaStream_t st) {
  const size_t smem = smem_bytes<TT>();
  cudaError_t err = cudaFuncSetAttribute(
      va_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  va_kernel<TT><<<blocks, THREADS, smem, st>>>(
      static_cast<const TT*>(qln), static_cast<const TT*>(k),
      static_cast<const TT*>(pos), static_cast<const TT*>(mask),
      static_cast<const uint32_t*>(mats), static_cast<const float*>(vecs),
      static_cast<TT*>(out), V, N);
  return (int)cudaGetLastError();
}

template <typename TT>
int max_blocks() {
  const size_t smem = smem_bytes<TT>();
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return 0;
  if (cudaFuncSetAttribute(va_kernel<TT>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, va_kernel<TT>,
                                                    THREADS, smem) !=
      cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// The fixed widths the kernel was compiled for, the rows one block takes per
// step (warps x rows per warp), and for dtype (0 = float32, 1 = bfloat16)
// the 32-bit words of the packed matrices and the floats of the vector blob.
extern "C" int view_attention_dims(int dtype, int* d, int* hid, int* pd,
                                   int* block_rows, int* mat_words,
                                   int* vec_floats) {
  *d = D;
  *hid = HID;
  *pd = PD;
  *block_rows = WARPS * G;
  *mat_words = dtype == 0 ? MAT_WORDS<float> : MAT_WORDS<__nv_bfloat16>;
  *vec_floats = VEC_FLOATS;
  return 0;
}

// How many blocks fit on the current device at once (SMs x blocks per SM), or
// 0 when one block does not fit. dtype: 0 = float32, 1 = bfloat16.
extern "C" int view_attention_max_blocks(int dtype) {
  return dtype == 0 ? max_blocks<float>() : max_blocks<__nv_bfloat16>();
}

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (qln, k, pos,
// mask, out); mats are the packed matrices, vecs the f32 vector blob.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int view_attention_fwd(const void* qln, const void* k,
                                  const void* pos, const void* mask,
                                  const void* mats, const void* vecs,
                                  void* out, int V, int N, int blocks,
                                  int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 1 || N < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(qln, k, pos, mask, mats, vecs, out, V, N, blocks,
                         st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qln, k, pos, mask, mats, vecs, out, V, N,
                                 blocks, st);
  return (int)cudaErrorInvalidValue;
}
