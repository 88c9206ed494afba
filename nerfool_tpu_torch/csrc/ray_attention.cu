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
// Design. One thread block per ray at a time, a persistent grid walks over
// the rays; the ray's x [S, D] and qkv [S, 3D] live in shared memory in f32
// (S * 1 KB: 192 KB at S = 192, under the 227 KB a block may take), so no
// score or probability ever reaches device memory. Any S up to that limit is
// taken as it is: no padding, no key mask.
//  - forward: the four matrix products are block-wide 4x4-register-tiled FMA
//    loops; the softmax is online, one thread per (head, query row), the
//    output overwriting the row's own q slot; attn0 is a separate pass over
//    query row 0 before that.
//  - backward: a [S, S] probability matrix of one head (147 KB) does not fit
//    beside qkv, so it works head by head in the flash form. Per head it
//    recomputes q_h | k_h | v_h [S, 48] and go_h = gout @ Wo_h^T [S, 16];
//    pass 1 (a thread per query row) redoes the online softmax and keeps
//    the row's max m_i, 1 / sum l_i, o_i, and delta_i = sum_j p_ij dp_ij;
//    pass 2 (a thread per query row) sums dq_i = sum_j ds_ij k_j; pass 3 (a
//    thread per key) sums dk_j = sum_i ds_ij q_i and dv_j = sum_i p_ij go_i,
//    with dp_ij = go_i . v_j and ds_ij = p_ij (dp_ij - delta_i) / sqrt(HD).
//    The attn0 cotangent adds gattn0 / NH to dp on query row 0 only. The
//    head's dq | dk | dv go to a per-block f32 scratch in device memory
//    (allocated by the wrapper, 147 KB per block, L2 resident); after the
//    last head the scratch is read back over the dead per-head buffers and
//    dx = gqkv @ Wqkv^T and dWqkv += x^T gqkv run as two products. dWo +=
//    o_h^T gout runs per head. The weight gradients accumulate in the
//    block's own [D, 3D] and [D, D] partials (zeroed by the wrapper), every
//    element owned by one thread, so the sum over the partials outside is
//    deterministic; there are no atomics.
//
// What bounds it: 15.7 MFLOP per ray forward (qkv, scores, AV 4.7 each, out
// 1.6) against 98 KB of compulsory traffic, so operations, on the CUDA cores
// in f32 FMA. The backward's minimum is about 2.5x the forward's; the
// recompute in three passes makes it about 4x in the attention part. Tensor
// cores (mma.sync on the [S, 64] x [64, 192] products) and a second block per
// SM are left for later work.
//
// x, gout, gattn0, out, attn0 and dx are float32 or bfloat16; all arithmetic
// is f32. Weights arrive as f32 (bf16-valued on the bf16 route).

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
constexpr int FWD_THREADS = 384;
constexpr int BWD_THREADS = 256;

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float dot_hd(const float* a, const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < HD; ++c) acc = fmaf(a[c], b[c], acc);
  return acc;
}

// Forward. grid: persistent, blockIdx.x walks rays r = blockIdx.x + k *
// gridDim.x. x [R, S, D]; wqkv [D, 3D]; wo [D, D]; bo [D]; out [R, S, D];
// attn0 [R, S]. Shared memory: (S * D + S * 3D) floats.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS) ra_fwd_kernel(
    const T* __restrict__ x, const float* __restrict__ wqkv,
    const float* __restrict__ wo, const float* __restrict__ bo,
    T* __restrict__ out, T* __restrict__ attn0, int R, int S) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;            // [S][D]; then sc [NH][S] and stats [2 * NH]
  float* qkv = xs + S * D;     // [S][3D]; the q slots end as concat_h(o_h)
  const float scale = 1.f / sqrtf((float)HD);

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* xr = x + (size_t)r * S * D;
    for (int e = threadIdx.x; e < S * D; e += blockDim.x) xs[e] = ld(xr + e);
    __syncthreads();
    block_mm(xs, D, S, wqkv, D3, D, D3,
             [&](int m, int n, float v) { qkv[m * D3 + n] = v; });
    __syncthreads();

    // attn0: the softmax row of query 0 per head, averaged over the heads
    float* sc = xs;
    float* stats = xs + NH * S;
    for (int e = threadIdx.x; e < NH * S; e += blockDim.x) {
      const int h = e / S, j = e - h * S;
      sc[e] = dot_hd(qkv + h * HD, qkv + j * D3 + D + h * HD) * scale;
    }
    __syncthreads();
    if (threadIdx.x < 32 * NH) {
      const int h = threadIdx.x >> 5, lane = threadIdx.x & 31;
      float mx = -INFINITY;
      for (int j = lane; j < S; j += 32) mx = fmaxf(mx, sc[h * S + j]);
      mx = warp_max(mx);
      float den = 0.f;
      for (int j = lane; j < S; j += 32) den += expf(sc[h * S + j] - mx);
      den = warp_sum(den);
      if (lane == 0) { stats[2 * h] = mx; stats[2 * h + 1] = 1.f / den; }
    }
    __syncthreads();
    for (int j = threadIdx.x; j < S; j += blockDim.x) {
      float a = 0.f;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        a += expf(sc[h * S + j] - stats[2 * h]) * stats[2 * h + 1];
      st(attn0 + (size_t)r * S + j, a * (1.f / NH));
    }
    __syncthreads();

    // one thread per (head, query row): online softmax over the keys; the
    // output overwrites the row's own q_h slot, which no other thread reads
    for (int item = threadIdx.x; item < NH * S; item += blockDim.x) {
      const int h = item / S, qi = item - h * S;
      float* qrow = qkv + qi * D3 + h * HD;
      float qv[HD], o[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) { qv[c] = qrow[c]; o[c] = 0.f; }
      float mx = -INFINITY, den = 0.f;
      for (int j = 0; j < S; ++j) {
        const float* kj = qkv + j * D3 + D + h * HD;
        const float sv = dot_hd(qv, kj) * scale;
        const float mn = fmaxf(mx, sv);
        const float corr = expf(mx - mn);
        const float pj = expf(sv - mn);
        den = fmaf(den, corr, pj);
#pragma unroll
        for (int c = 0; c < HD; ++c) o[c] = fmaf(o[c], corr, pj * kj[D + c]);
        mx = mn;
      }
      const float inv = 1.f / den;
#pragma unroll
      for (int c = 0; c < HD; ++c) qrow[c] = o[c] * inv;
    }
    __syncthreads();
    T* outr = out + (size_t)r * S * D;
    block_mm(qkv, D3, S, wo, D, D, D, [&](int m, int n, float v) {
      st(outr + m * D + n, v + __ldg(bo + n));
    });
    __syncthreads();
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

size_t smem_bytes(int S) {
  return sizeof(float) * (size_t)S * (D + D3);
}

template <typename T>
int launch_fwd(const void* x, const void* wqkv, const void* wo,
               const void* bo, void* out, void* attn0, int R, int S,
               int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(S);
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

// Dynamic shared memory one block needs, in bytes (both directions).
extern "C" long long ray_attention_smem_bytes(int S) {
  return (long long)smem_bytes(S);
}

// How many blocks fit on the current device at once (SMs x blocks per SM),
// or 0 when one block does not fit. backward: 0 = forward kernel, 1 =
// backward kernel. dtype: 0 = float32, 1 = bfloat16.
extern "C" int ray_attention_max_blocks(int S, int backward, int dtype) {
  const size_t smem = smem_bytes(S);
  if (backward)
    return dtype == 0
               ? max_blocks(ra_bwd_kernel<float>, BWD_THREADS, smem)
               : max_blocks(ra_bwd_kernel<__nv_bfloat16>, BWD_THREADS, smem);
  return dtype == 0
             ? max_blocks(ra_fwd_kernel<float>, FWD_THREADS, smem)
             : max_blocks(ra_fwd_kernel<__nv_bfloat16>, FWD_THREADS, smem);
}

// Plain C entries for ctypes. dtype: 0 = float32, 1 = bfloat16 (x, out,
// attn0, gout, gattn0, dx); weights, scratch and weight-gradient partials are
// float32. Each returns the cudaError_t of the launch (0 on success).
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
