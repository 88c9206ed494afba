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
// The TPU kernel keeps an 8-ray tile of every operand in VMEM (~100 MB) and
// feeds [8 * V * S, 64] products to the 128 x 128 matrix unit. A Hopper block
// has at most 227 KB of shared memory, and one ray's x alone is V*S*D (240 KB
// in bf16 at V=10, S=192, D=64). Both kernels here therefore take one ray per
// thread block at a time on a persistent grid (as many blocks as fit on the
// card walk over the rays), and write x once per ray into a per-block
// scratch (allocated by the wrapper; 32 MB over 132 blocks, so the re-reads
// at every depth hit L2).
//
// What bounds the function: about 3.3 MFLOP per sample at depth 8 (the kv
// product 1.3M, the two FFs 1.05M, the ray attention 0.66M) against ~0.23 MB
// of compulsory traffic per ray: operations, by a factor of ~500 over bytes.
//
// bfloat16 (the route of every bf16 GNT render): gnt_chain_bf16_kernel,
// namespace tc. Every product with K >= 16, and the K = 4 and K = 8 ones
// zero-padded to 16, is mma.sync.m16n8k16 with bf16 operands and f32
// accumulators. wgmma was not taken: its 64-row tiles and shared-memory
// descriptors would force every operand through shared memory, while with
// mma.sync the C fragment of one product, rounded, IS the A fragment of the
// next, so whole chains of products never leave the registers.
//  - One warp owns 16 samples of the ray through the whole chain (12 warps,
//    384 threads, one block per SM at S = 192). LayerNorm, every MLP, the
//    residual adds and the per-sample products touch only rows the warp
//    owns, so they need no block barrier; each lane even reads back only the
//    q elements it wrote itself. Only the ray attention's K and V cross
//    warps: two barriers per depth.
//  - View stage: an m16 tile is 8 samples x 2 views (rows g and g + 8 are
//    the same sample), so the softmax over the views is an online softmax
//    inside each thread: running max, sum and weighted sum of v + p for 8
//    samples x 64 channels in 48 registers. qp, the hidden layers and o stay
//    in registers; a sample masked in every view gets uniform weights (-1e9
//    is a fill value, never -inf). Two biases cost nothing in that loop: the
//    pos MLP's output bias is row 8 of its packed matrix (the hidden layer,
//    K = 8 padded to 16, carries a one in column 8), and the attention
//    MLP's output bias, equal for every view of a channel, is left out of
//    the scores because the softmax over the views does not see it.
//  - x lies in the scratch in fragment order (each lane's own registers,
//    32 bytes per lane and view): written by the lane that reads it, with
//    coalesced 16-byte accesses.
//  - Ray attention in the flash form: Q stays in registers, K [S][64] and V
//    transposed [64][S] in shared memory (bf16, strides chosen so that the
//    4-byte fragment loads hit 32 banks), 32 keys per step, scores and P V
//    as mma with P rounded in registers, online softmax per query row in
//    f32; the last depth's head-mean row of query 0 from a second pass over
//    the first tile's scores. Keys past a ragged S are masked, rows past it
//    are computed on clamped inputs and never stored.
//  - Weights are packed once on the host as B fragments in the order the
//    kernel reads them (ops/chain.py pack_b): one coalesced 8-byte __ldg per
//    lane per mma, served by L1 (shared memory takes 107 KB of the SM's
//    256 KB at S = 192, which leaves L1 room for a stage's weights).
//  - Epilogues (bias, ReLU, residual, rounding) act on the accumulator
//    fragments. The residual stream q, the LayerNorm statistics, both
//    softmaxes and every accumulator are f32; the operands of the products
//    are rounded to bf16, as the TPU kernel and the plain bf16 chain do.
// What limits it now (H100; python -m nerfool_tpu_torch.profile_chain prints
// the clocks by stage and the instruction mix): not the tensor cores and not
// memory but the rate and latency of the other instructions. The view
// stage's loop over a pair of views is ~1000 instructions for 93 mma, a
// flash step ~250 for 8, and 168 registers allow only 3 warps per
// scheduler. The view attention takes ~43% of a warp's clocks, the ray
// attention ~19%, the two feed-forwards ~25%. At 168 registers the view
// loop reloads 4 to 17 loop-invariant values from local memory per pass
// (no stores); with WARPS = 8 (255 registers) nothing spills there, but 12
// tiles over 8 warps leave half the warps idle in the second round and the
// chunk takes ~3% longer, so 12 warps stay.
//
// float32: gnt_chain_f32_kernel, exact f32 FMA on the CUDA cores (no TF32):
// q and a second [S, D] buffer in shared memory, the view stage in tiles of
// TS samples, every product a block-wide 4x4-register-tiled FMA loop over A
// in shared memory and W (L1/L2 resident) in device memory. It is on no
// main path (bf16 renders take the kernel above, f32 renders the module
// path) and is the tight check of the chain's structure and indexing.

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

// The f32 kernel reads and writes device memory through these: indexing its
// __restrict__ parameters directly makes the compiler schedule the tile
// loops differently (105 registers instead of 127) and the kernel 20% slower.
__device__ __forceinline__ float ld(const float* p) { return *p; }
__device__ __forceinline__ void st(float* p, float v) { *p = v; }

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
__global__ void __launch_bounds__(THREADS) gnt_chain_f32_kernel(
    const float* __restrict__ merged, const float* __restrict__ emb,
    const float* __restrict__ entry, const float* __restrict__ layers,
    const float* __restrict__ qfc, float* __restrict__ xbuf,
    float* __restrict__ qout, float* __restrict__ attn0_out, int V, int R,
    int S, int ci, int depth) {
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
  float* x = xbuf + (size_t)blockIdx.x * V * S * D;
  const float* e0 = entry;
  const float* e0b = e0 + ci4 * D;
  const float* e1 = e0b + D;
  const float* e1b = e1 + D * D;

  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const float* in_r = merged + (size_t)r * S * ctot;  // + v * R * S * ctot
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
          const float xv = v + __ldg(e1b + n);
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

size_t smem_bytes_f32(int V, int S, int ci) {
  return sizeof(float) * (size_t)(fixed_floats(S) + union_floats(V, S, ci));
}

// ===========================================================================
// The bf16 kernel: every product with K >= 16 on the tensor cores
// (mma.sync.m16n8k16, bf16 operands, f32 accumulators).
//
// One warp owns a tile of 16 samples of the ray through the whole chain.
// Fragment layouts of the instruction, lane = 4 * g + t:
//   A (16 x 16): a0 (row g, cols 2t, 2t+1), a1 (row g+8, same cols),
//                a2 (row g, cols 2t+8, 2t+9), a3 (row g+8, cols 2t+8, 2t+9)
//   B (16 x 8):  b0 (k 2t, 2t+1; n g), b1 (k 2t+8, 2t+9; n g)
//   C (16 x 8):  c0, c1 (row g, cols 2t, 2t+1), c2, c3 (row g+8, same cols)
// so two neighbouring C tiles, rounded to bf16, are the A fragment of the
// next product: chains of products stay in registers.
// ===========================================================================
namespace tc {

// Built with -DGNT_CHAIN_STAMPS (profile_chain.py), thread 0 of block 0 adds
// the clocks it spends in each stage to stage_cycles; otherwise no code.
#ifdef GNT_CHAIN_STAMPS
constexpr int N_STAGES = 8;
__device__ unsigned long long stage_cycles[N_STAGES];
#define STAMP(k)                                              \
  if (blockIdx.x == 0 && threadIdx.x == 0) {                  \
    const long long now_ = clock64();                         \
    atomicAdd(&stage_cycles[k], (unsigned long long)(now_ - stamp_)); \
    stamp_ = now_;                                            \
  }
#else
#define STAMP(k)
#endif

constexpr int WARPS = 12;
constexpr int THREADS = 32 * WARPS;
constexpr int QS = 72;  // q row stride in floats: conflict-free float2 rows
constexpr int KS = 72;  // K row stride in bf16: conflict-free 4-byte loads
constexpr float NEG = -1e30f;  // "no key yet" / padded key; never -inf

// Packed matrices (bf16 elements). A [K][N] matrix is stored as B fragments:
// element (((kt * N / 8 + nt) * 32 + lane) * 4 + e) holds W[16 kt + 2 t +
// (e & 1) + 8 (e >> 1)][8 nt + g], rows past K zero: one 8-byte load per
// lane per fragment (ops/chain.py pack_b).
constexpr int frag_elems(int K, int N) { return ((K + 15) / 16) * 16 * N; }
constexpr int M_VT_WQ = 0;
constexpr int M_VT_WKV = M_VT_WQ + frag_elems(D, D);
constexpr int M_VT_P0 = M_VT_WKV + frag_elems(D, 2 * D);
constexpr int M_VT_P1 = M_VT_P0 + frag_elems(4, D8);
constexpr int M_VT_A0 = M_VT_P1 + frag_elems(D8 + 1, D);  // row 8: p's bias
constexpr int M_VT_A1 = M_VT_A0 + frag_elems(D, D8);
constexpr int M_VT_WO = M_VT_A1 + frag_elems(D8, D);
constexpr int M_VT_F1 = M_VT_WO + frag_elems(D, D);
constexpr int M_VT_F2 = M_VT_F1 + frag_elems(D, DH);
constexpr int M_RA_WQ = M_VT_F2 + frag_elems(DH, D);
constexpr int M_RA_WKV = M_RA_WQ + frag_elems(D, D);  // [D][K heads | V heads]
constexpr int M_RA_WO = M_RA_WKV + frag_elems(D, 2 * D);
constexpr int M_RA_F1 = M_RA_WO + frag_elems(D, D);
constexpr int M_RA_F2 = M_RA_F1 + frag_elems(D, DH);
constexpr int M_LAYER = M_RA_F2 + frag_elems(DH, D);
// f32 vectors per depth
constexpr int V_VT_LN1 = 0;  // gamma [D], beta [D]
constexpr int V_VT_P0B = V_VT_LN1 + 2 * D;
constexpr int V_VT_A0B = V_VT_P0B + D8;
constexpr int V_VT_WOB = V_VT_A0B + D8;
constexpr int V_VT_LN2 = V_VT_WOB + D;
constexpr int V_VT_F1B = V_VT_LN2 + 2 * D;
constexpr int V_VT_F2B = V_VT_F1B + DH;
constexpr int V_RA_LN1 = V_VT_F2B + D;
constexpr int V_RA_WOB = V_RA_LN1 + 2 * D;
constexpr int V_RA_LN2 = V_RA_WOB + D;
constexpr int V_RA_F1B = V_RA_LN2 + 2 * D;
constexpr int V_RA_F2B = V_RA_F1B + DH;
constexpr int V_LAYER = V_RA_F2B + D;
// q_fc, one per even depth: W0 [QC][D] (rows q | pe, 0 | ve, 0), W1 [D][D];
// vectors b0 [D], b1 [D]
constexpr int M_QF_W0 = 0;
constexpr int M_QF_W1 = M_QF_W0 + frag_elems(QC, D);
constexpr int M_QFC = M_QF_W1 + frag_elems(D, D);
constexpr int V_QFC = 2 * D;
// entry: E0 [ci -> 16 kte][D], E1 [D][D]; vectors b0 [D], b1 [D]

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack2(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ uint32_t raw2(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// elements c, c + 1 of a row of n valid bf16 values, zeros past it
__device__ __forceinline__ uint32_t row_pair(const __nv_bfloat16* p, int c,
                                             int n) {
  const __nv_bfloat16 z = __ushort_as_bfloat16((unsigned short)0);
  return raw2(c < n ? p[c] : z, c + 1 < n ? p[c + 1] : z);
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[nt] += A[kt] x B[kt][n0 + nt] for kt < KT, nt < NW; B is a packed
// matrix with NT n-tiles per k step
template <int KT, int NW>
__device__ __forceinline__ void gemm(float (&acc)[NW][4],
                                     const uint32_t (&a)[KT][4],
                                     const __nv_bfloat16* __restrict__ Bm,
                                     int NT, int n0, int lane) {
  const uint2* B = reinterpret_cast<const uint2*>(Bm);
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const uint2 b = __ldg(B + ((kt * NT + n0 + nt) << 5) + lane);
      mma(acc[nt], a[kt], b.x, b.y);
    }
}

template <int NW>
__device__ __forceinline__ void zero(float (&acc)[NW][4]) {
#pragma unroll
  for (int n = 0; n < NW; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.f;
}

// f32 C tiles [8][4] (16 x 64), rounded, as the 4 A fragments of the next
// product
__device__ __forceinline__ void to_frags(const float (&c)[8][4],
                                         uint32_t (&a)[4][4]) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack2(c[2 * k][0], c[2 * k][1]);
    a[k][1] = pack2(c[2 * k][2], c[2 * k][3]);
    a[k][2] = pack2(c[2 * k + 1][0], c[2 * k + 1][1]);
    a[k][3] = pack2(c[2 * k + 1][2], c[2 * k + 1][3]);
  }
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

// LayerNorm of the warp's 16 rows of q (qt: the tile's first row), in f32,
// rounded into the 4 A fragments of the product that follows
__device__ __forceinline__ void ln_frags(const float* qt,
                                         const float* __restrict__ gb,
                                         int g, int t, uint32_t (&a)[4][4]) {
  float x[2][16];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float* p = qt + (g + 8 * h) * QS + 16 * k + 2 * t;
      const float2 u = *reinterpret_cast<const float2*>(p);
      const float2 w = *reinterpret_cast<const float2*>(p + 8);
      x[h][4 * k] = u.x; x[h][4 * k + 1] = u.y;
      x[h][4 * k + 2] = w.x; x[h][4 * k + 3] = w.y;
    }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) s += x[h][i];
    const float mean = quad_sum(s) * (1.f / D);
    float vs = 0.f;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      x[h][i] -= mean;
      vs = fmaf(x[h][i], x[h][i], vs);
    }
    const float inv = 1.f / sqrtf(quad_sum(vs) * (1.f / D) + 1e-6f);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 16 * k + 2 * t + (e & 1) + 8 * (e >> 1);
        x[h][4 * k + e] = fmaf(x[h][4 * k + e] * inv, __ldg(gb + c),
                               __ldg(gb + D + c));
      }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    a[k][0] = pack2(x[0][4 * k], x[0][4 * k + 1]);
    a[k][1] = pack2(x[1][4 * k], x[1][4 * k + 1]);
    a[k][2] = pack2(x[0][4 * k + 2], x[0][4 * k + 3]);
    a[k][3] = pack2(x[1][4 * k + 2], x[1][4 * k + 3]);
  }
}

// q tile (+)= acc + bias: each lane writes the elements it alone reads
template <bool ADD>
__device__ __forceinline__ void store_q(float* qt, const float (&acc)[8][4],
                                        const float* __restrict__ bias, int g,
                                        int t) {
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int c = 8 * n + 2 * t;
    const float b0 = __ldg(bias + c), b1 = __ldg(bias + c + 1);
    float2* p0 = reinterpret_cast<float2*>(qt + g * QS + c);
    float2* p1 = reinterpret_cast<float2*>(qt + (g + 8) * QS + c);
    float2 u = make_float2(acc[n][0] + b0, acc[n][1] + b1);
    float2 w = make_float2(acc[n][2] + b0, acc[n][3] + b1);
    if (ADD) {
      const float2 u0 = *p0, w0 = *p1;
      u.x += u0.x; u.y += u0.y; w.x += w0.x; w.y += w0.y;
    }
    *p0 = u;
    *p1 = w;
  }
}

// q tile += FF(LN(q tile)): the hidden layer in four chunks of 64 columns,
// each rounded in registers into the A fragments of the second product
__device__ __forceinline__ void ff_tile(float* qt,
                                        const __nv_bfloat16* __restrict__ lm,
                                        const float* __restrict__ lv, int ln,
                                        int f1, int f1b, int f2, int f2b,
                                        int g, int t, int lane) {
  uint32_t af[4][4];
  ln_frags(qt, lv + ln, g, t, af);
  float out[8][4];
  zero(out);
#pragma unroll 1
  for (int ch = 0; ch < 4; ++ch) {
    float h[8][4];
    zero(h);
    gemm<4, 8>(h, af, lm + f1, DH / 8, 8 * ch, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int c = 64 * ch + 8 * n + 2 * t;
      const float b0 = __ldg(lv + f1b + c), b1 = __ldg(lv + f1b + c + 1);
      h[n][0] = fmaxf(h[n][0] + b0, 0.f);
      h[n][1] = fmaxf(h[n][1] + b1, 0.f);
      h[n][2] = fmaxf(h[n][2] + b0, 0.f);
      h[n][3] = fmaxf(h[n][3] + b1, 0.f);
    }
    uint32_t hf[4][4];
    to_frags(h, hf);
    gemm<4, 8>(out, hf, lm + f2 + 4 * ch * 8 * 128, D / 8, 0, lane);
  }
  store_q<true>(qt, out, lv + f2b, g, t);
}

__host__ __device__ inline int pad_to(int n, int m) {
  return (n + m - 1) / m * m;
}

// One view's x of one 8-sample group in the scratch: 32 lanes x 32 bytes,
// the lane's own A-fragment halves, as two coalesced 16-byte rows
__device__ __forceinline__ uint4* x_unit(uint4* xs, int group, int V, int v) {
  return xs + ((size_t)group * V + v) * 64;
}

// grid: persistent, blockIdx.x walks rays r = blockIdx.x + k * gridDim.x.
// merged [V, R, S, ci + 5] = rgb_feat | ray_diff | mask; emb [R, S, 2 * PE];
// xbuf [gridDim.x][pad16(S) / 8][V][512] bf16 scratch; qout [R, S, D];
// attn0 [R, S].
__global__ void __launch_bounds__(THREADS, 1) gnt_chain_bf16_kernel(
    const __nv_bfloat16* __restrict__ merged,
    const __nv_bfloat16* __restrict__ emb,
    const __nv_bfloat16* __restrict__ entry_m,
    const float* __restrict__ entry_v,
    const __nv_bfloat16* __restrict__ layer_m,
    const float* __restrict__ layer_v,
    const __nv_bfloat16* __restrict__ qfc_m, const float* __restrict__ qfc_v,
    uint4* xbuf, __nv_bfloat16* __restrict__ qout,
    __nv_bfloat16* __restrict__ attn0_out, int V, int R, int S, int ci,
    int depth) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int ctot = ci + 5;
  const int kte = (ci + 15) >> 4;
  const int Sp = pad_to(S, 16), Sk = pad_to(S, 32), VS = Sk + 8;
  const int ntiles = Sp >> 4;
  float* q = smem;            // [Sp][QS] f32, the running features
  float* a0 = q + Sp * QS;    // [Sp]: sum over heads of attention row 0
  __nv_bfloat16* Ksm = reinterpret_cast<__nv_bfloat16*>(a0 + Sp);  // [Sk][KS]
  __nv_bfloat16* Vt = Ksm + Sk * KS;                               // [D][VS]
  uint4* xs = xbuf + (size_t)blockIdx.x * (Sp >> 3) * V * 64;
  const __nv_bfloat16* e1m = entry_m + kte * 16 * D;
  const size_t vstride = (size_t)R * S * ctot;

  {  // padded keys and rows read as zeros
    const int words = Sp * QS + Sp + (Sk * KS + D * VS) / 2;
    for (int e = threadIdx.x; e < words; e += blockDim.x) smem[e] = 0.f;
  }
  __syncthreads();

#ifdef GNT_CHAIN_STAMPS
  long long stamp_ = clock64();
#endif
  for (int r = blockIdx.x; r < R; r += gridDim.x) {
    const __nv_bfloat16* in_r = merged + (size_t)r * S * ctot;
    STAMP(7)  // the previous ray's output
    if (warp == 0)
      for (int s = lane; s < Sp; s += 32) a0[s] = 0.f;

    // ---- entry: x = rgbfeat_fc(rf) into the scratch, q = max over views.
    // An m16 tile is 8 samples x 2 views: rows g and g + 8 are one sample.
    for (int tile = warp; tile < ntiles; tile += WARPS) {
#pragma unroll 1
      for (int grp = 0; grp < 2; ++grp) {
        const int sc = min(tile * 16 + 8 * grp + g, S - 1);
        float qm[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) qm[n][0] = qm[n][1] = -INFINITY;
#pragma unroll 1
        for (int v0 = 0; v0 < V; v0 += 2) {
          const int vb = min(v0 + 1, V - 1);
          const __nv_bfloat16* ra = in_r + v0 * vstride + (size_t)sc * ctot;
          const __nv_bfloat16* rb = in_r + vb * vstride + (size_t)sc * ctot;
          float acc[8][4];
          zero(acc);
          for (int kt = 0; kt < kte; ++kt) {
            const int c = 16 * kt + 2 * t;
            uint32_t a[1][4] = {{row_pair(ra, c, ci), row_pair(rb, c, ci),
                                 row_pair(ra, c + 8, ci),
                                 row_pair(rb, c + 8, ci)}};
            gemm<1, 8>(acc, a, entry_m + kt * 16 * D, D / 8, 0, lane);
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            const float b0 = __ldg(entry_v + c), b1 = __ldg(entry_v + c + 1);
            acc[n][0] = fmaxf(acc[n][0] + b0, 0.f);
            acc[n][1] = fmaxf(acc[n][1] + b1, 0.f);
            acc[n][2] = fmaxf(acc[n][2] + b0, 0.f);
            acc[n][3] = fmaxf(acc[n][3] + b1, 0.f);
          }
          uint32_t hf[4][4];
          to_frags(acc, hf);
          zero(acc);
          gemm<4, 8>(acc, hf, e1m, D / 8, 0, lane);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            const float b0 = __ldg(entry_v + D + c);
            const float b1 = __ldg(entry_v + D + c + 1);
            acc[n][0] += b0; acc[n][1] += b1; acc[n][2] += b0; acc[n][3] += b1;
            qm[n][0] = fmaxf(qm[n][0], fmaxf(acc[n][0], acc[n][2]));
            qm[n][1] = fmaxf(qm[n][1], fmaxf(acc[n][1], acc[n][3]));
          }
          uint32_t xf[4][4];
          to_frags(acc, xf);
          uint4* ua = x_unit(xs, tile * 2 + grp, V, v0);
          ua[lane] = make_uint4(xf[0][0], xf[0][2], xf[1][0], xf[1][2]);
          ua[32 + lane] = make_uint4(xf[2][0], xf[2][2], xf[3][0], xf[3][2]);
          if (vb != v0) {
            uint4* ub = x_unit(xs, tile * 2 + grp, V, vb);
            ub[lane] = make_uint4(xf[0][1], xf[0][3], xf[1][1], xf[1][3]);
            ub[32 + lane] = make_uint4(xf[2][1], xf[2][3], xf[3][1], xf[3][3]);
          }
        }
        // max of the rounded x = the rounded max
        float* qrow = q + (tile * 16 + 8 * grp + g) * QS;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 m2 = unpack2(pack2(qm[n][0], qm[n][1]));
          *reinterpret_cast<float2*>(qrow + 8 * n + 2 * t) = m2;
        }
      }
    }

    STAMP(0)  // entry
    for (int i = 0; i < depth; ++i) {
      const __nv_bfloat16* lm = layer_m + (size_t)i * M_LAYER;
      const float* lv = layer_v + (size_t)i * V_LAYER;
      const bool last = (i == depth - 1);

      for (int tile = warp; tile < ntiles; tile += WARPS) {
        float* qt = q + tile * 16 * QS;
        // ---- view transformer. qp = LN(q) @ Wq, rounded, stays in
        // registers: [n][0] the rows of group 0, [n][1] those of group 1
        uint32_t qpk[8][2], opk[8][2];
        {
          uint32_t af[4][4];
          ln_frags(qt, lv + V_VT_LN1, g, t, af);
          float acc[8][4];
          zero(acc);
          gemm<4, 8>(acc, af, lm + M_VT_WQ, D / 8, 0, lane);
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            qpk[n][0] = pack2(acc[n][0], acc[n][1]);
            qpk[n][1] = pack2(acc[n][2], acc[n][3]);
          }
        }
#pragma unroll
        for (int grp = 0; grp < 2; ++grp) {
          const int sc = min(tile * 16 + 8 * grp + g, S - 1);
          // online softmax over the views, per (sample g, channel)
          float mx[8][2], den[8][2], o[8][2];
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 2; ++j) {
              mx[n][j] = NEG; den[n][j] = 0.f; o[n][j] = 0.f;
            }
#pragma unroll 1
          for (int v0 = 0; v0 < V; v0 += 2) {
            const int vb = min(v0 + 1, V - 1);
            const bool has_b = vb != v0;
            uint32_t xf[4][4];
            {
              const uint4* ua = x_unit(xs, tile * 2 + grp, V, v0);
              const uint4* ub = x_unit(xs, tile * 2 + grp, V, vb);
              const uint4 a0v = ua[lane], a1v = ua[32 + lane];
              const uint4 b0v = ub[lane], b1v = ub[32 + lane];
              xf[0][0] = a0v.x; xf[0][1] = b0v.x; xf[0][2] = a0v.y; xf[0][3] = b0v.y;
              xf[1][0] = a0v.z; xf[1][1] = b0v.z; xf[1][2] = a0v.w; xf[1][3] = b0v.w;
              xf[2][0] = a1v.x; xf[2][1] = b1v.x; xf[2][2] = a1v.y; xf[2][3] = b1v.y;
              xf[3][0] = a1v.z; xf[3][1] = b1v.z; xf[3][2] = a1v.w; xf[3][3] = b1v.w;
            }
            const __nv_bfloat16* ra =
                in_r + v0 * vstride + (size_t)sc * ctot + ci;
            const __nv_bfloat16* rb =
                in_r + vb * vstride + (size_t)sc * ctot + ci;
            const bool off_a = __bfloat162float(ra[4]) == 0.f;
            const bool off_b = __bfloat162float(rb[4]) == 0.f;
            // pos MLP hidden layer, K = 4 and then 8, zero-padded to 16
            uint32_t phf[1][4];
            {
              uint32_t rd[1][4] = {{row_pair(ra, 2 * t, 4),
                                    row_pair(rb, 2 * t, 4), 0u, 0u}};
              float c4[1][4];
              zero(c4);
              gemm<1, 1>(c4, rd, lm + M_VT_P0, 1, 0, lane);
              const float b0 = __ldg(lv + V_VT_P0B + 2 * t);
              const float b1 = __ldg(lv + V_VT_P0B + 2 * t + 1);
              phf[0][0] = pack2(fmaxf(c4[0][0] + b0, 0.f),
                                fmaxf(c4[0][1] + b1, 0.f));
              phf[0][1] = pack2(fmaxf(c4[0][2] + b0, 0.f),
                                fmaxf(c4[0][3] + b1, 0.f));
              // column 8 is one: row 8 of the packed P1 holds its bias, so
              // both products with P1 below give p with no bias to load
              phf[0][2] = phf[0][3] = t == 0 ? 0x3f80u : 0u;
            }
            // a = MLP(kp - qp + p): kp and p into one accumulator
            uint32_t hbf[1][4];
            {
              float acc[8][4];
              zero(acc);
              gemm<4, 8>(acc, xf, lm + M_VT_WKV, 2 * D / 8, 0, lane);
              gemm<1, 8>(acc, phf, lm + M_VT_P1, D / 8, 0, lane);
#pragma unroll
              for (int n = 0; n < 8; ++n) {
                const float2 qp = unpack2(qpk[n][grp]);
                acc[n][0] -= qp.x; acc[n][1] -= qp.y;
                acc[n][2] -= qp.x; acc[n][3] -= qp.y;
              }
              uint32_t inf[4][4];
              to_frags(acc, inf);
              float c4[1][4];
              zero(c4);
              gemm<4, 1>(c4, inf, lm + M_VT_A0, 1, 0, lane);
              const float b0 = __ldg(lv + V_VT_A0B + 2 * t);
              const float b1 = __ldg(lv + V_VT_A0B + 2 * t + 1);
              hbf[0][0] = pack2(fmaxf(c4[0][0] + b0, 0.f),
                                fmaxf(c4[0][1] + b1, 0.f));
              hbf[0][1] = pack2(fmaxf(c4[0][2] + b0, 0.f),
                                fmaxf(c4[0][3] + b1, 0.f));
              hbf[0][2] = 0u;
              hbf[0][3] = 0u;
            }
            // v + p for all 64 channels: eight independent accumulators.
            // The scores go without the last layer's bias: it is the same
            // for every view of a channel, and the softmax over the views
            // does not see it (a masked view's -1e9 stays a fill value)
            float vp[8][4];
            zero(vp);
            gemm<4, 8>(vp, xf, lm + M_VT_WKV, 2 * D / 8, 8, lane);
            gemm<1, 8>(vp, phf, lm + M_VT_P1, D / 8, 0, lane);
#pragma unroll
            for (int n = 0; n < 8; ++n) {
              float a4[1][4];
              zero(a4);
              gemm<1, 1>(a4, hbf, lm + M_VT_A1, D / 8, n, lane);
#pragma unroll
              for (int j = 0; j < 2; ++j) {
                const float sa = off_a ? -1e9f : a4[0][j];
                const float sb = off_b ? -1e9f : a4[0][2 + j];
                float mn = fmaxf(mx[n][j], sa);
                if (has_b) mn = fmaxf(mn, sb);
                const float corr = __expf(mx[n][j] - mn);
                const float wa = __expf(sa - mn);
                const float wb = has_b ? __expf(sb - mn) : 0.f;
                den[n][j] = fmaf(den[n][j], corr, wa + wb);
                o[n][j] = fmaf(o[n][j], corr,
                               fmaf(wa, vp[n][j], wb * vp[n][2 + j]));
                mx[n][j] = mn;
              }
            }
          }
#pragma unroll
          for (int n = 0; n < 8; ++n)
            opk[n][grp] = pack2(o[n][0] / den[n][0], o[n][1] / den[n][1]);
        }
        {  // q += o @ Wo + b
          uint32_t of[4][4];
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            of[k][0] = opk[2 * k][0]; of[k][1] = opk[2 * k][1];
            of[k][2] = opk[2 * k + 1][0]; of[k][3] = opk[2 * k + 1][1];
          }
          float acc[8][4];
          zero(acc);
          gemm<4, 8>(acc, of, lm + M_VT_WO, D / 8, 0, lane);
          store_q<true>(qt, acc, lv + V_VT_WOB, g, t);
        }
        STAMP(1)  // view attention
        ff_tile(qt, lm, lv, V_VT_LN2, M_VT_F1, V_VT_F1B, M_VT_F2, V_VT_F2B, g,
                t, lane);

        STAMP(2)  // the view transformer's feed-forward
        // ---- q_fc on even depths: q = MLP([q | pts_emb, 0 | views_emb, 0])
        if (i % 2 == 0) {
          const __nv_bfloat16* qm = qfc_m + (size_t)(i / 2) * M_QFC;
          const float* qv = qfc_v + (size_t)(i / 2) * V_QFC;
          const __nv_bfloat16* ea =
              emb + ((size_t)r * S + min(tile * 16 + g, S - 1)) * (2 * PE);
          const __nv_bfloat16* eb =
              emb + ((size_t)r * S + min(tile * 16 + 8 + g, S - 1)) * (2 * PE);
          float acc[8][4];
          zero(acc);
#pragma unroll 1
          for (int kt = 0; kt < QC / 16; ++kt) {
            uint32_t a[1][4];
            if (kt < 4) {
              const float* p0 = qt + g * QS + 16 * kt + 2 * t;
              const float* p1 = p0 + 8 * QS;
              a[0][0] = pack2(p0[0], p0[1]);
              a[0][1] = pack2(p1[0], p1[1]);
              a[0][2] = pack2(p0[8], p0[9]);
              a[0][3] = pack2(p1[8], p1[9]);
            } else {
              const int part = (kt - 4) >> 2;  // 0: pts_emb, 1: views_emb
              const int c = 16 * ((kt - 4) & 3) + 2 * t;
              a[0][0] = row_pair(ea + part * PE, c, PE);
              a[0][1] = row_pair(eb + part * PE, c, PE);
              a[0][2] = row_pair(ea + part * PE, c + 8, PE);
              a[0][3] = row_pair(eb + part * PE, c + 8, PE);
            }
            gemm<1, 8>(acc, a, qm + M_QF_W0 + kt * 16 * D, D / 8, 0, lane);
          }
#pragma unroll
          for (int n = 0; n < 8; ++n) {
            const int c = 8 * n + 2 * t;
            const float b0 = __ldg(qv + c), b1 = __ldg(qv + c + 1);
            acc[n][0] = fmaxf(acc[n][0] + b0, 0.f);
            acc[n][1] = fmaxf(acc[n][1] + b1, 0.f);
            acc[n][2] = fmaxf(acc[n][2] + b0, 0.f);
            acc[n][3] = fmaxf(acc[n][3] + b1, 0.f);
          }
          uint32_t hf[4][4];
          to_frags(acc, hf);
          zero(acc);
          gemm<4, 8>(acc, hf, qm + M_QF_W1, D / 8, 0, lane);
          store_q<false>(qt, acc, qv + D, g, t);
        }
      }

      STAMP(3)  // q_fc
      // ---- ray transformer: every warp's K and V rows into shared memory
      __syncthreads();  // the previous ray attention has read K and V
      for (int tile = warp; tile < ntiles; tile += WARPS) {
        uint32_t af[4][4];
        ln_frags(q + tile * 16 * QS, lv + V_RA_LN1, g, t, af);
        float acc[8][4];
        zero(acc);
        gemm<4, 8>(acc, af, lm + M_RA_WKV, 2 * D / 8, 0, lane);
        __nv_bfloat16* k0 = Ksm + (tile * 16 + g) * KS + 2 * t;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          *reinterpret_cast<uint32_t*>(k0 + 8 * n) = pack2(acc[n][0], acc[n][1]);
          *reinterpret_cast<uint32_t*>(k0 + 8 * KS + 8 * n) =
              pack2(acc[n][2], acc[n][3]);
        }
        zero(acc);
        gemm<4, 8>(acc, af, lm + M_RA_WKV, 2 * D / 8, 8, lane);
#pragma unroll
        for (int n = 0; n < 8; ++n) {  // V transposed: [channel][key]
          __nv_bfloat16* vp = Vt + (8 * n + 2 * t) * VS + tile * 16 + g;
          vp[0] = __float2bfloat16(acc[n][0]);
          vp[VS] = __float2bfloat16(acc[n][1]);
          vp[8] = __float2bfloat16(acc[n][2]);
          vp[VS + 8] = __float2bfloat16(acc[n][3]);
        }
      }
      __syncthreads();

      STAMP(4)  // K and V, the two barriers
      // ---- flash attention per (16-query tile, head): scores and P V as
      // mma, P stays in registers, online softmax per query row in f32
      for (int tile = warp; tile < ntiles; tile += WARPS) {
        float* qt = q + tile * 16 * QS;
        uint32_t qf[4][4];  // per head: Q / sqrt(HD), one A fragment
        {
          uint32_t af[4][4];
          ln_frags(qt, lv + V_RA_LN1, g, t, af);
          float acc[8][4];
          zero(acc);
          gemm<4, 8>(acc, af, lm + M_RA_WQ, D / 8, 0, lane);
#pragma unroll
          for (int n = 0; n < 8; ++n)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[n][j] *= 0.25f;  // 1 / sqrt(HD)
          to_frags(acc, qf);
        }
        uint32_t of[4][4];
#pragma unroll
        for (int h = 0; h < NH; ++h) {
          float m0 = NEG, m1 = NEG, l0 = 0.f, l1 = 0.f;
          float oa[2][4];
          zero(oa);
#pragma unroll 1
          for (int kb = 0; kb < Sk; kb += 32) {
            float sc[4][4];
            zero(sc);
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              const __nv_bfloat16* kp =
                  Ksm + (kb + 8 * nt + g) * KS + HD * h + 2 * t;
              mma(sc[nt], qf[h], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
            }
            float r0 = NEG, r1 = NEG;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
#pragma unroll
              for (int j = 0; j < 4; ++j) {
                if (kb + 8 * nt + 2 * t + (j & 1) >= S) sc[nt][j] = NEG;
                if (j < 2) r0 = fmaxf(r0, sc[nt][j]);
                else r1 = fmaxf(r1, sc[nt][j]);
              }
            const float n0 = fmaxf(m0, quad_max(r0));
            const float n1 = fmaxf(m1, quad_max(r1));
            const float c0 = __expf(m0 - n0), c1 = __expf(m1 - n1);
            m0 = n0; m1 = n1;
            float s0 = 0.f, s1 = 0.f;
#pragma unroll
            for (int nt = 0; nt < 4; ++nt) {
              sc[nt][0] = __expf(sc[nt][0] - n0);
              sc[nt][1] = __expf(sc[nt][1] - n0);
              sc[nt][2] = __expf(sc[nt][2] - n1);
              sc[nt][3] = __expf(sc[nt][3] - n1);
              s0 += sc[nt][0] + sc[nt][1];
              s1 += sc[nt][2] + sc[nt][3];
            }
            l0 = fmaf(l0, c0, s0);
            l1 = fmaf(l1, c1, s1);
#pragma unroll
            for (int nd = 0; nd < 2; ++nd) {
              oa[nd][0] *= c0; oa[nd][1] *= c0;
              oa[nd][2] *= c1; oa[nd][3] *= c1;
            }
#pragma unroll
            for (int kk = 0; kk < 2; ++kk) {
              const uint32_t pf[4] = {
                  pack2(sc[2 * kk][0], sc[2 * kk][1]),
                  pack2(sc[2 * kk][2], sc[2 * kk][3]),
                  pack2(sc[2 * kk + 1][0], sc[2 * kk + 1][1]),
                  pack2(sc[2 * kk + 1][2], sc[2 * kk + 1][3])};
#pragma unroll
              for (int nd = 0; nd < 2; ++nd) {
                const __nv_bfloat16* vp =
                    Vt + (HD * h + 8 * nd + g) * VS + kb + 16 * kk + 2 * t;
                mma(oa[nd], pf, *reinterpret_cast<const uint32_t*>(vp),
                    *reinterpret_cast<const uint32_t*>(vp + 8));
              }
            }
          }
          const float i0 = 1.f / quad_sum(l0), i1 = 1.f / quad_sum(l1);
          of[h][0] = pack2(oa[0][0] * i0, oa[0][1] * i0);
          of[h][1] = pack2(oa[0][2] * i1, oa[0][3] * i1);
          of[h][2] = pack2(oa[1][0] * i0, oa[1][1] * i0);
          of[h][3] = pack2(oa[1][2] * i1, oa[1][3] * i1);
          if (last && tile == 0) {
            // this head's softmax row of query 0 (row g = 0), from a second
            // pass over the scores now that its maximum and sum are known
#pragma unroll 1
            for (int kb = 0; kb < Sk; kb += 8) {
              float s4[4] = {0.f, 0.f, 0.f, 0.f};
              const __nv_bfloat16* kp = Ksm + (kb + g) * KS + HD * h + 2 * t;
              mma(s4, qf[h], *reinterpret_cast<const uint32_t*>(kp),
                  *reinterpret_cast<const uint32_t*>(kp + 8));
              if (g == 0) {
                const int key = kb + 2 * t;
                if (key < S) a0[key] += __expf(s4[0] - m0) * i0;
                if (key + 1 < S) a0[key + 1] += __expf(s4[1] - m0) * i0;
              }
            }
          }
        }
        float acc[8][4];
        zero(acc);
        gemm<4, 8>(acc, of, lm + M_RA_WO, D / 8, 0, lane);
        store_q<true>(qt, acc, lv + V_RA_WOB, g, t);
        STAMP(5)  // ray attention
        ff_tile(qt, lm, lv, V_RA_LN2, M_RA_F1, V_RA_F1B, M_RA_F2, V_RA_F2B, g,
                t, lane);
        STAMP(6)  // the ray transformer's feed-forward
      }
    }

    for (int tile = warp; tile < ntiles; tile += WARPS) {
      __syncwarp();
      for (int rr = 0; rr < 16; ++rr) {
        const int s = tile * 16 + rr;
        if (s >= S) break;
        const float2 u =
            *reinterpret_cast<const float2*>(q + s * QS + 2 * lane);
        *reinterpret_cast<uint32_t*>(qout + ((size_t)r * S + s) * D + 2 * lane) =
            pack2(u.x, u.y);
      }
    }
    if (warp == 0) {
      __syncwarp();
      for (int s = lane; s < S; s += 32)
        attn0_out[(size_t)r * S + s] = __float2bfloat16(a0[s] * (1.f / NH));
      __syncwarp();
    }
  }
}

size_t smem_bytes(int S) {
  const int Sp = pad_to(S, 16), Sk = pad_to(S, 32);
  return sizeof(float) * (size_t)(Sp * QS + Sp) +
         sizeof(__nv_bfloat16) * (size_t)(Sk * KS + D * (Sk + 8));
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16
size_t smem_bytes(int V, int S, int ci, int dtype) {
  return dtype == 0 ? smem_bytes_f32(V, S, ci) : tc::smem_bytes(S);
}

}  // namespace

// Sizes of the packed weights, for the wrapper to check its blobs against:
// floats of one f32 layer blob and one f32 q_fc blob; bf16 elements and f32
// vector floats of one bf16-route layer and one bf16-route q_fc.
extern "C" int gnt_chain_layout(int* layer, int* qfc, int* layer_m,
                                int* layer_v, int* qfc_m, int* qfc_v) {
  *layer = LAYER;
  *qfc = QFC;
  *layer_m = tc::M_LAYER;
  *layer_v = tc::V_LAYER;
  *qfc_m = tc::M_QFC;
  *qfc_v = tc::V_QFC;
  return 0;
}

// Dynamic shared memory one block needs, in bytes (dtype: 0 = float32,
// 1 = bfloat16).
extern "C" long long gnt_chain_smem_bytes(int V, int S, int ci, int dtype) {
  return (long long)smem_bytes(V, S, ci, dtype);
}

// Elements of x scratch one block needs, in the working dtype.
extern "C" long long gnt_chain_scratch_elems(int V, int S, int dtype) {
  return (long long)V * D * (dtype == 0 ? S : tc::pad_to(S, 16));
}

// How many blocks fit on the current device at once (SMs x blocks per SM),
// or 0 when one block does not fit. dtype: 0 = float32, 1 = bfloat16.
extern "C" int gnt_chain_max_blocks(int V, int S, int ci, int dtype) {
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  const size_t smem = smem_bytes(V, S, ci, dtype);
  if (smem > (size_t)optin) return 0;
  cudaError_t err;
  if (dtype == 0) {
    cudaFuncSetAttribute(gnt_chain_f32_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, gnt_chain_f32_kernel, THREADS, smem);
  } else {
    cudaFuncSetAttribute(tc::gnt_chain_bf16_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, tc::gnt_chain_bf16_kernel, tc::THREADS, smem);
  }
  if (err != cudaSuccess) return 0;
  return sms * per_sm;
}

// Registers per thread, threads per block and bytes of local memory per
// thread (spills) of the bf16 kernel, for reports.
extern "C" int gnt_chain_bf16_resources(int* regs, int* threads, int* local) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, tc::gnt_chain_bf16_kernel);
  if (err != cudaSuccess) return (int)err;
  *regs = attr.numRegs;
  *threads = tc::THREADS;
  *local = (int)attr.localSizeBytes;
  return 0;
}

#ifdef GNT_CHAIN_STAMPS
// Reads (reset == 0) or zeroes the per-stage clocks of a stamped build:
// entry, view attention, its feed-forward, q_fc, K/V with the barriers, ray
// attention, its feed-forward, output.
extern "C" int gnt_chain_stage_cycles(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long z[tc::N_STAGES] = {0};
    return (int)cudaMemcpyToSymbol(tc::stage_cycles, z, sizeof(z));
  }
  return (int)cudaMemcpyFromSymbol(out, tc::stage_cycles,
                                   sizeof(unsigned long long) * tc::N_STAGES);
}
#endif

// Plain C entries for ctypes; each returns the cudaError_t of the launch (0
// on success). float32: exact f32 FMA on the CUDA cores, weights as f32
// blobs.
extern "C" int gnt_chain_f32(const void* merged, const void* emb,
                             const void* entry, const void* layers,
                             const void* qfc, void* xbuf, void* qout,
                             void* attn0, int V, int R, int S, int ci,
                             int depth, int blocks, void* stream) {
  if (V < 1 || R < 1 || S < 1 || blocks < 1 || depth < 1 || ci < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = smem_bytes_f32(V, S, ci);
  cudaError_t err = cudaFuncSetAttribute(
      gnt_chain_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  gnt_chain_f32_kernel<<<blocks, THREADS, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(merged), static_cast<const float*>(emb),
      static_cast<const float*>(entry), static_cast<const float*>(layers),
      static_cast<const float*>(qfc), static_cast<float*>(xbuf),
      static_cast<float*>(qout), static_cast<float*>(attn0), V, R, S, ci,
      depth);
  return (int)cudaGetLastError();
}

// bfloat16: merged, emb, xbuf, qout, attn0 and the packed matrices in bf16,
// the vectors (biases, LayerNorm parameters) in f32.
extern "C" int gnt_chain_bf16(const void* merged, const void* emb,
                              const void* entry_m, const void* entry_v,
                              const void* layer_m, const void* layer_v,
                              const void* qfc_m, const void* qfc_v,
                              void* xbuf, void* qout, void* attn0, int V,
                              int R, int S, int ci, int depth, int blocks,
                              void* stream) {
  if (V < 1 || R < 1 || S < 1 || blocks < 1 || depth < 1 || ci < 1)
    return (int)cudaErrorInvalidValue;
  const size_t smem = tc::smem_bytes(S);
  cudaError_t err = cudaFuncSetAttribute(
      tc::gnt_chain_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  using bf = __nv_bfloat16;
  tc::gnt_chain_bf16_kernel<<<blocks, tc::THREADS, smem,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf*>(merged), static_cast<const bf*>(emb),
      static_cast<const bf*>(entry_m), static_cast<const float*>(entry_v),
      static_cast<const bf*>(layer_m), static_cast<const float*>(layer_v),
      static_cast<const bf*>(qfc_m), static_cast<const float*>(qfc_v),
      static_cast<uint4*>(xbuf), static_cast<bf*>(qout),
      static_cast<bf*>(attn0), V, R, S, ci, depth);
  return (int)cudaGetLastError();
}
