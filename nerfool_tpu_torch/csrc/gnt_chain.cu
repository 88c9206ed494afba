// The whole GNT aggregation chain for Hopper (sm_90a), bound to PyTorch
// through ctypes.
//
// Replaces the TPU kernel fused_gnt_chain (nerfool_tpu/ops/chain_kernel.py,
// body _chain_kernel). Per ray, with V source views and S samples:
//
//   x = relu(rf @ E0 + b) @ E1 + b           [V, S, D]  (rgbfeat_fc)
//   q = max over views of x                   [S, D]
//   for each of `depth` blocks i:
//     view transformer: qp = LN(q) @ Wq, kv = x @ [Wk | Wk @ Wv],
//       p = MLP(ray_diff), a = MLP(kp - qp + p), -1e9 where the view is
//       masked, softmax over V per channel, o = sum_V (v + p) * w,
//       q += o @ Wo + b, then q += FF(LN(q))
//     even i: q = q_fc([q | pts_emb | views_emb])  (replaces q)
//     ray transformer: LN, q/k/v, 4-head softmax over the S samples,
//       q += out @ Wo + b, then q += FF(LN(q))
//   out: q [S, D] and attn0 [S], the last block's head-mean attention row
//   of the first query.
// The NeRF embeddings and the final LayerNorm/mean/rgb_fc head stay outside
// (ops/chain.py), as the JAX package leaves them to XLA.
//
// Design. The TPU kernel keeps an 8-ray tile of every operand in VMEM
// (~100 MB). A Hopper block has at most 227 KB of shared memory, and one
// ray's x alone is V*S*D (240 KB in bf16 at V=10, S=192, D=64). So:
//  - one thread block per ray at a time; a persistent grid (as many blocks
//    as fit on the card) walks over the rays;
//  - q [S, D] and a second [S, D] buffer (qp, then o) stay in shared memory
//    in f32 for the whole chain; every stage works in shared memory;
//  - x is written once per ray into a per-block scratch in the working
//    dtype (allocated by the wrapper) and re-read at every depth. Per block
//    it is 240 KB, 32 MB over 132 blocks, so the re-reads hit L2;
//  - the view stage runs in tiles of TS samples (V*TS rows); the ray stage
//    needs every sample of the ray, so block barriers separate the stages;
//  - every matrix product is a block-wide 4x4-register-tiled FMA loop over
//    A in shared memory and W (f32, L1/L2 resident) in device memory.
//
// What bounds it: about 3.3 MFLOP per sample at depth 8 (the kv product
// 1.3M, the two FFs 1.05M, the ray attention 0.66M) against ~0.23 MB of
// compulsory traffic per ray, so it is compute-bound. It runs on the CUDA
// cores in f32 FMA; the tensor cores (mma.sync / wgmma on the [V*S, 64] x
// [64, 128] products) are left for later work.
//
// Inputs and outputs are float32 or bfloat16; all arithmetic accumulates in
// f32. x is rounded to the working dtype in its scratch, as the TPU kernel
// and the JAX module hold it. Weights arrive as f32 (bf16-valued on the bf16
// route).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;       // netwidth
constexpr int DH = 4 * D;   // feed-forward hidden width
constexpr int D8 = D / 8;   // view-attention MLP bottleneck
constexpr int NH = 4;       // ray-attention heads
constexpr int HD = D / NH;  // head width
constexpr int PE = 63;      // NeRF embedding width, 3 * (1 + 2 * 10)
constexpr int QC = 3 * D;   // q_fc input [q | pe, 0 | ve, 0]
constexpr int TS = 8;       // samples per view-stage tile
constexpr int TQ = 64;      // rows per feed-forward / q_fc tile
constexpr int THREADS = 256;

// Per-depth layer blob (floats). Matrices are [in][out], row-major.
constexpr int VT_LN1 = 0;  // gamma [D], beta [D]
constexpr int VT_WQ = VT_LN1 + 2 * D;
constexpr int VT_WKV = VT_WQ + D * D;  // [D][2D] = [Wk | Wk @ Wv]
constexpr int VT_P0 = VT_WKV + D * 2 * D;
constexpr int VT_P0B = VT_P0 + 4 * D8;
constexpr int VT_P1 = VT_P0B + D8;
constexpr int VT_P1B = VT_P1 + D8 * D;
constexpr int VT_A0 = VT_P1B + D;
constexpr int VT_A0B = VT_A0 + D * D8;
constexpr int VT_A1 = VT_A0B + D8;
constexpr int VT_A1B = VT_A1 + D8 * D;
constexpr int VT_WO = VT_A1B + D;
constexpr int VT_WOB = VT_WO + D * D;
constexpr int VT_LN2 = VT_WOB + D;
constexpr int VT_F1 = VT_LN2 + 2 * D;
constexpr int VT_F1B = VT_F1 + D * DH;
constexpr int VT_F2 = VT_F1B + DH;
constexpr int VT_F2B = VT_F2 + DH * D;
constexpr int RA_LN1 = VT_F2B + D;
constexpr int RA_WQKV = RA_LN1 + 2 * D;  // [NH][D][3 * HD]: q_h | k_h | v_h
constexpr int RA_WO = RA_WQKV + NH * D * 3 * HD;
constexpr int RA_WOB = RA_WO + D * D;
constexpr int RA_LN2 = RA_WOB + D;
constexpr int RA_F1 = RA_LN2 + 2 * D;
constexpr int RA_F1B = RA_F1 + D * DH;
constexpr int RA_F2 = RA_F1B + DH;
constexpr int RA_F2B = RA_F2 + DH * D;
constexpr int LAYER = RA_F2B + D;
// q_fc blob, one per even depth: W0 [QC][D] (rows: q, pe, 0, ve, 0), b0,
// W1 [D][D], b1
constexpr int QF_W0 = 0;
constexpr int QF_B0 = QF_W0 + QC * D;
constexpr int QF_W1 = QF_B0 + D;
constexpr int QF_B1 = QF_W1 + D * D;
constexpr int QFC = QF_B1 + D;
// entry blob: E0 [ci4][D] (zero rows past ci), b0 [D], E1 [D][D], b1 [D]

__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ float ld(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void st(float* p, float v) { *p = v; }
__device__ __forceinline__ void st(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// Block-wide product: epi(m, n, sum_k A[m * lda + k] * W[k * N + n]) for
// m < M, n < N. A is f32 in shared memory with 16-byte aligned rows
// (lda % 4 == 0); W is f32 [K][N] in device memory; K % 4 == 0, N % 4 == 0.
// Each thread computes 4x4 output tiles; every (m, n) goes to one thread.
template <typename Epi>
__device__ __forceinline__ void block_mm(const float* A, int lda, int M,
                                         const float* __restrict__ W, int K,
                                         int N, Epi epi) {
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
        w[kk] = __ldg(reinterpret_cast<const float4*>(W + (k + kk) * N + n0));
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

// LayerNorm over D of M rows, one warp per row: Y = (X - mean) /
// sqrt(var + eps) * g + b, statistics in f32.
__device__ __forceinline__ void block_ln(const float* X, float* Y, int M,
                                         const float* __restrict__ g,
                                         const float* __restrict__ b,
                                         float eps) {
  const int lane = threadIdx.x & 31;
  for (int m = threadIdx.x >> 5; m < M; m += blockDim.x >> 5) {
    const float x0 = X[m * D + lane], x1 = X[m * D + lane + 32];
    const float mean = warp_sum(x0 + x1) * (1.f / D);
    const float d0 = x0 - mean, d1 = x1 - mean;
    const float var = warp_sum(d0 * d0 + d1 * d1) * (1.f / D);
    const float inv = 1.f / sqrtf(var + eps);
    Y[m * D + lane] = d0 * inv * __ldg(g + lane) + __ldg(b + lane);
    Y[m * D + lane + 32] = d1 * inv * __ldg(g + lane + 32) +
                           __ldg(b + lane + 32);
  }
}

// q += FF(LN(q)) over all S rows, in tiles of TQ rows (u: TQ * (D + DH)).
__device__ void ff_residual(float* q, int S, float* u,
                            const float* __restrict__ lw, int ln, int f1,
                            int f1b, int f2, int f2b) {
  float* h = u;            // [TQ][D]
  float* hid = u + TQ * D;  // [TQ][DH]
  for (int m0 = 0; m0 < S; m0 += TQ) {
    const int M = min(TQ, S - m0);
    block_ln(q + m0 * D, h, M, lw + ln, lw + ln + D, 1e-6f);
    __syncthreads();
    block_mm(h, D, M, lw + f1, D, DH, [&](int m, int n, float v) {
      hid[m * DH + n] = fmaxf(v + __ldg(lw + f1b + n), 0.f);
    });
    __syncthreads();
    block_mm(hid, DH, M, lw + f2, DH, D, [&](int m, int n, float v) {
      q[(m0 + m) * D + n] += v + __ldg(lw + f2b + n);
    });
    __syncthreads();
  }
}

// Shared-memory floats past q/qo/attn0 that the stages share (see
// gnt_chain_smem_bytes).
__host__ __device__ inline int imax(int a, int b) { return a > b ? a : b; }

__host__ __device__ inline int union_floats(int V, int S, int ci) {
  const int ci4 = (ci + 3) & ~3;
  const int rows = V * TS;
  int u = rows * (ci4 + 2 * D);                       // entry
  u = imax(u, rows * (D + 2 * D + D + D8 + 4 + 1));   // view tile
  u = imax(u, S * D);                                 // LN(q) for qp
  u = imax(u, TQ * (D + DH));                         // feed-forward
  u = imax(u, TQ * (QC + D));                         // q_fc
  u = imax(u, S * D + S * 3 * HD + S);                // ray attention
  return u;
}

__host__ __device__ inline int fixed_floats(int S) {
  return 2 * S * D + ((S + 3) & ~3) + 4;  // q, qo, attn0 [S], stats [4]
}

// grid: persistent, blockIdx.x walks rays r = blockIdx.x + k * gridDim.x.
// merged [V, R, S, ci + 5] = rgb_feat | ray_diff | mask; emb [R, S, 2 * PE]
// = pts_emb | views_emb; xbuf [gridDim.x, V, S, D] scratch; qout [R, S, D];
// attn0 [R, S].
template <typename T>
__global__ void __launch_bounds__(THREADS) gnt_chain_kernel(
    const T* __restrict__ merged, const T* __restrict__ emb,
    const float* __restrict__ entry, const float* __restrict__ layers,
    const float* __restrict__ qfc, T* __restrict__ xbuf,
    T* __restrict__ qout, T* __restrict__ attn0_out, int V, int R, int S,
    int ci, int depth) {
  extern __shared__ __align__(16) float smem[];
  const int ctot = ci + 5;
  const int ci4 = (ci + 3) & ~3;
  const int rows = V * TS;
  const float scale = 1.f / sqrtf((float)HD);
  float* q = smem;               // [S][D], the running features
  float* qo = q + S * D;         // [S][D]: qp, then the view-attention o
  float* a0 = qo + S * D;        // [S]: sum over heads of attention row 0
  float* stats = a0 + ((S + 3) & ~3);  // [4]
  float* u = stats + 4;          // stage-specific buffers
  T* x = xbuf + (size_t)blockIdx.x * V * S * D;
  const float* e0 = entry;
  const float* e0b = e0 + ci4 * D;
  const float* e1 = e0b + D;
  const float* e1b = e1 + D * D;

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const T* in_r = merged + (size_t)r * S * ctot;  // + v * R * S * ctot
    const size_t vstride = (size_t)R * S * ctot;
    for (int s = threadIdx.x; s < S; s += blockDim.x) a0[s] = 0.f;

    // ---- entry: x = rgbfeat_fc(rf) into the scratch, q = max over views
    {
      float* rf = u;                  // [rows][ci4]
      float* h1 = rf + rows * ci4;    // [rows][D]
      float* xt = h1 + rows * D;      // [rows][D]
      for (int s0 = 0; s0 < S; s0 += TS) {
        for (int e = threadIdx.x; e < rows * ci4; e += blockDim.x) {
          const int m = e / ci4, c = e - m * ci4;
          const int v = m / TS, s = s0 + m % TS;
          rf[e] = (c < ci && s < S)
                      ? ld(in_r + v * vstride + (size_t)s * ctot + c) : 0.f;
        }
        __syncthreads();
        block_mm(rf, ci4, rows, e0, ci4, D, [&](int m, int n, float v) {
          h1[m * D + n] = fmaxf(v + __ldg(e0b + n), 0.f);
        });
        __syncthreads();
        block_mm(h1, D, rows, e1, D, D, [&](int m, int n, float v) {
          const int s = s0 + m % TS;
          const float xv = round_to<T>(v + __ldg(e1b + n));
          xt[m * D + n] = xv;
          if (s < S) st(x + ((size_t)(m / TS) * S + s) * D + n, xv);
        });
        __syncthreads();
        for (int e = threadIdx.x; e < TS * D; e += blockDim.x) {
          const int t = e / D, n = e - t * D;
          if (s0 + t >= S) continue;
          float mx = xt[t * D + n];
          for (int v = 1; v < V; ++v) mx = fmaxf(mx, xt[(v * TS + t) * D + n]);
          q[(s0 + t) * D + n] = mx;
        }
        __syncthreads();
      }
    }

    for (int i = 0; i < depth; ++i) {
      const float* lw = layers + (size_t)i * LAYER;

      // ---- view transformer: qp = LN(q) @ Wq for every sample
      block_ln(q, u, S, lw + VT_LN1, lw + VT_LN1 + D, 1e-6f);
      __syncthreads();
      block_mm(u, D, S, lw + VT_WQ, D, D,
               [&](int m, int n, float v) { qo[m * D + n] = v; });
      __syncthreads();
      {
        float* xs = u;                 // [rows][D]
        float* kv = xs + rows * D;     // [rows][2D]: kp (then a) | v
        float* p = kv + rows * 2 * D;  // [rows][D]
        float* hb = p + rows * D;      // [rows][D8]
        float* rd = hb + rows * D8;    // [rows][4]
        float* mk = rd + rows * 4;     // [rows]
        for (int s0 = 0; s0 < S; s0 += TS) {
          for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
            const int m = e / D, n = e - m * D;
            const int s = s0 + m % TS;
            xs[e] = s < S ? ld(x + ((size_t)(m / TS) * S + s) * D + n) : 0.f;
          }
          for (int e = threadIdx.x; e < rows * 5; e += blockDim.x) {
            const int m = e / 5, c = e - m * 5;
            const int s = s0 + m % TS;
            const float val =
                s < S ? ld(in_r + (m / TS) * vstride + (size_t)s * ctot + ci + c)
                      : 0.f;
            if (c < 4) rd[m * 4 + c] = val; else mk[m] = val;
          }
          __syncthreads();
          block_mm(xs, D, rows, lw + VT_WKV, D, 2 * D,
                   [&](int m, int n, float v) { kv[m * 2 * D + n] = v; });
          block_mm(rd, 4, rows, lw + VT_P0, 4, D8, [&](int m, int n, float v) {
            hb[m * D8 + n] = fmaxf(v + __ldg(lw + VT_P0B + n), 0.f);
          });
          __syncthreads();
          block_mm(hb, D8, rows, lw + VT_P1, D8, D, [&](int m, int n, float v) {
            p[m * D + n] = v + __ldg(lw + VT_P1B + n);
          });
          __syncthreads();
          for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
            const int m = e / D, n = e - m * D;
            const int s = min(s0 + m % TS, S - 1);
            kv[m * 2 * D + n] += p[e] - qo[s * D + n];
          }
          __syncthreads();
          block_mm(kv, 2 * D, rows, lw + VT_A0, D, D8,
                   [&](int m, int n, float v) {
            hb[m * D8 + n] = fmaxf(v + __ldg(lw + VT_A0B + n), 0.f);
          });
          __syncthreads();
          block_mm(hb, D8, rows, lw + VT_A1, D8, D, [&](int m, int n, float v) {
            kv[m * 2 * D + n] = mk[m] == 0.f ? -1e9f
                                             : v + __ldg(lw + VT_A1B + n);
          });
          __syncthreads();
          // softmax over the views per (sample, channel); o replaces qp
          for (int e = threadIdx.x; e < TS * D; e += blockDim.x) {
            const int t = e / D, n = e - t * D;
            if (s0 + t >= S) continue;
            float mx = -INFINITY;
            for (int v = 0; v < V; ++v)
              mx = fmaxf(mx, kv[(v * TS + t) * 2 * D + n]);
            float den = 0.f, o = 0.f;
            for (int v = 0; v < V; ++v) {
              const int m = v * TS + t;
              const float w = expf(kv[m * 2 * D + n] - mx);
              den += w;
              o = fmaf(kv[m * 2 * D + D + n] + p[m * D + n], w, o);
            }
            qo[(s0 + t) * D + n] = o / den;
          }
          __syncthreads();
        }
      }
      block_mm(qo, D, S, lw + VT_WO, D, D, [&](int m, int n, float v) {
        q[m * D + n] += v + __ldg(lw + VT_WOB + n);
      });
      __syncthreads();
      ff_residual(q, S, u, lw, VT_LN2, VT_F1, VT_F1B, VT_F2, VT_F2B);

      // ---- q_fc on even depths: q = MLP([q | pts_emb | views_emb])
      if (i % 2 == 0) {
        const float* qw = qfc + (size_t)(i / 2) * QFC;
        float* cat = u;              // [TQ][QC]
        float* t1 = u + TQ * QC;     // [TQ][D]
        for (int m0 = 0; m0 < S; m0 += TQ) {
          const int M = min(TQ, S - m0);
          for (int e = threadIdx.x; e < M * QC; e += blockDim.x) {
            const int m = e / QC, c = e - m * QC;
            const size_t eo = ((size_t)r * S + m0 + m) * (2 * PE);
            float val = 0.f;
            if (c < D) val = q[(m0 + m) * D + c];
            else if (c < D + PE) val = ld(emb + eo + (c - D));
            else if (c >= 2 * D && c < 2 * D + PE) val = ld(emb + eo + PE + (c - 2 * D));
            cat[e] = val;
          }
          __syncthreads();
          block_mm(cat, QC, M, qw + QF_W0, QC, D, [&](int m, int n, float v) {
            t1[m * D + n] = fmaxf(v + __ldg(qw + QF_B0 + n), 0.f);
          });
          __syncthreads();
          block_mm(t1, D, M, qw + QF_W1, D, D, [&](int m, int n, float v) {
            q[(m0 + m) * D + n] = v + __ldg(qw + QF_B1 + n);
          });
          __syncthreads();
        }
      }

      // ---- ray transformer: 4-head self-attention over the samples
      {
        float* qln = u;               // [S][D]
        float* hb = qln + S * D;      // [S][3 * HD]: q_h (then o_h) | k_h | v_h
        float* sc = hb + S * 3 * HD;  // [S]
        const bool last = (i == depth - 1);
        block_ln(q, qln, S, lw + RA_LN1, lw + RA_LN1 + D, 1e-6f);
        __syncthreads();
        for (int h = 0; h < NH; ++h) {
          block_mm(qln, D, S, lw + RA_WQKV + h * D * 3 * HD, D, 3 * HD,
                   [&](int m, int n, float v) { hb[m * 3 * HD + n] = v; });
          __syncthreads();
          if (last) {  // this head's attention row of query 0
            for (int j = threadIdx.x; j < S; j += blockDim.x) {
              float dot = 0.f;
#pragma unroll
              for (int c = 0; c < HD; ++c)
                dot = fmaf(hb[c], hb[j * 3 * HD + HD + c], dot);
              sc[j] = dot * scale;
            }
            __syncthreads();
            if (threadIdx.x < 32) {
              float mx = -INFINITY;
              for (int j = threadIdx.x; j < S; j += 32) mx = fmaxf(mx, sc[j]);
              mx = warp_max(mx);
              float den = 0.f;
              for (int j = threadIdx.x; j < S; j += 32) den += expf(sc[j] - mx);
              den = warp_sum(den);
              if (threadIdx.x == 0) { stats[0] = mx; stats[1] = den; }
            }
            __syncthreads();
            for (int j = threadIdx.x; j < S; j += blockDim.x)
              a0[j] += expf(sc[j] - stats[0]) / stats[1];
            __syncthreads();
          }
          // one thread per query row, online softmax over the keys; the
          // output overwrites the row's own q_h slot
          for (int qi = threadIdx.x; qi < S; qi += blockDim.x) {
            float qv[HD], o[HD];
#pragma unroll
            for (int c = 0; c < HD; ++c) { qv[c] = hb[qi * 3 * HD + c]; o[c] = 0.f; }
            float mx = -INFINITY, den = 0.f;
            for (int j = 0; j < S; ++j) {
              const float* kj = hb + j * 3 * HD + HD;
              float dot = 0.f;
#pragma unroll
              for (int c = 0; c < HD; ++c) dot = fmaf(qv[c], kj[c], dot);
              const float sv = dot * scale;
              const float mn = fmaxf(mx, sv);
              const float corr = expf(mx - mn);
              const float pj = expf(sv - mn);
              den = fmaf(den, corr, pj);
#pragma unroll
              for (int c = 0; c < HD; ++c) o[c] = fmaf(o[c], corr, pj * kj[HD + c]);
              mx = mn;
            }
            const float inv = 1.f / den;
#pragma unroll
            for (int c = 0; c < HD; ++c) hb[qi * 3 * HD + c] = o[c] * inv;
          }
          __syncthreads();
          // q += o_h @ Wo[h * HD : (h + 1) * HD] (+ the bias once)
          block_mm(hb, 3 * HD, S, lw + RA_WO + h * HD * D, HD, D,
                   [&](int m, int n, float v) {
            q[m * D + n] += v + (h == 0 ? __ldg(lw + RA_WOB + n) : 0.f);
          });
          __syncthreads();
        }
      }
      ff_residual(q, S, u, lw, RA_LN2, RA_F1, RA_F1B, RA_F2, RA_F2B);
    }

    for (int e = threadIdx.x; e < S * D; e += blockDim.x)
      st(qout + (size_t)r * S * D + e, q[e]);
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      st(attn0_out + (size_t)r * S + s, a0[s] * (1.f / NH));
    __syncthreads();
  }
}

size_t smem_bytes(int V, int S, int ci) {
  return sizeof(float) * (size_t)(fixed_floats(S) + union_floats(V, S, ci));
}

template <typename T>
int launch(const void* merged, const void* emb, const void* entry,
           const void* layers, const void* qfc, void* xbuf, void* qout,
           void* attn0, int V, int R, int S, int ci, int depth, int blocks,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(V, S, ci);
  cudaError_t err = cudaFuncSetAttribute(
      gnt_chain_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gnt_chain_kernel<T><<<blocks, THREADS, smem, stream>>>(
      static_cast<const T*>(merged), static_cast<const T*>(emb),
      static_cast<const float*>(entry), static_cast<const float*>(layers),
      static_cast<const float*>(qfc), static_cast<T*>(xbuf),
      static_cast<T*>(qout), static_cast<T*>(attn0), V, R, S, ci, depth);
  return (int)cudaGetLastError();
}

}  // namespace

// Floats of one layer blob and of one q_fc blob: the wrapper checks its
// packed weights against these.
extern "C" int gnt_chain_layout(int* layer, int* qfc) {
  *layer = LAYER;
  *qfc = QFC;
  return 0;
}

// Dynamic shared memory one block needs, in bytes.
extern "C" long long gnt_chain_smem_bytes(int V, int S, int ci) {
  return (long long)smem_bytes(V, S, ci);
}

// How many blocks fit on the current device at once (SMs x blocks per SM),
// or 0 when one block does not fit. dtype: 0 = float32, 1 = bfloat16.
extern "C" int gnt_chain_max_blocks(int V, int S, int ci, int dtype) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = smem_bytes(V, S, ci);
  if (smem > (size_t)optin) return 0;
  cudaError_t err;
  if (dtype == 0) {
    cudaFuncSetAttribute(gnt_chain_kernel<float>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gnt_chain_kernel<float>, THREADS, smem);
  } else {
    cudaFuncSetAttribute(gnt_chain_kernel<__nv_bfloat16>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gnt_chain_kernel<__nv_bfloat16>, THREADS, smem);
  }
  if (err != cudaSuccess) return 0;
  return sms * per_sm;
}

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (merged, emb,
// xbuf, qout, attn0); weights are float32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int gnt_chain(const void* merged, const void* emb,
                         const void* entry, const void* layers,
                         const void* qfc, void* xbuf, void* qout, void* attn0,
                         int V, int R, int S, int ci, int depth, int blocks,
                         int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 1 || R < 1 || S < 1 || blocks < 1 || depth < 1 || ci < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(merged, emb, entry, layers, qfc, xbuf, qout, attn0,
                         V, R, S, ci, depth, blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(merged, emb, entry, layers, qfc, xbuf, qout,
                                 attn0, V, R, S, ci, depth, blocks, st);
  return (int)cudaErrorInvalidValue;
}
