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
// Design. A persistent grid; a block of 256 threads takes a tile of 64 rows at
// a time. Every weight lives in shared memory in f32 (73 KB). The views are
// streamed one at a time: the view's k tile [64, 64] is staged in shared
// memory, and each thread owns 4 rows x 4 channels of the tile, for which it
// keeps the online softmax in registers: running max, running sum and the
// accumulator of (vv + p) e. Nothing of size [V, rows, .] is ever held and k
// is read from device memory once. The [64, 64] x [64, 128] product is a
// 4x4-register-tiled FMA loop giving the thread kp and vv of its own
// (row, channel) set; the 64 -> 8 contraction of the attention MLP is a
// partial sum over the thread's 4 channels followed by a butterfly over the 16
// lanes that share its rows (every lane ends with the same bits). -1e9 is a
// fill value, not -inf, so a row whose views are all masked gets the uniform
// 1 / V weights of the module. Rows past N are loaded as zeros and never
// stored.
//
// What bounds it: per (view, row) 2 * 64 * 128 + 2 * (4 * 8 + 8 * 64) +
// 2 * (64 * 8 + 8 * 64) = 19.5 kFLOP against 276 bytes of f32 input, so
// operations on the CUDA cores in f32 FMA; in bf16 the tensor cores' rate would
// make it bytes. Tensor cores (mma.sync / wgmma on the kv product) and an
// asynchronous double-buffered k tile are left for later work.
//
// qln, k, pos, mask and out are float32 or bfloat16; all arithmetic is f32 and
// bf16 rounds the output only. The weights arrive as one f32 blob (bf16-valued
// on the bf16 route) in the order of the O_* offsets below.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int D = 64;         // netwidth
constexpr int HID = D / 8;    // hidden width of the pos and attention MLPs
constexpr int PD = 4;         // width of the ray-difference encoding
constexpr int T = 64;         // rows per tile
constexpr int THREADS = 256;  // (T / 4) row groups x (D / 4) channel groups
constexpr int LDT = D + 4;    // padded row of the staging tile

// the weight blob, in floats
constexpr int O_WKV = 0;                 // [D][2D]  Wk | Wk Wv
constexpr int O_WQ = O_WKV + D * 2 * D;  // [D][D]
constexpr int O_WO = O_WQ + D * D;       // [D][D]
constexpr int O_WP0 = O_WO + D * D;      // [PD][HID]
constexpr int O_BP0 = O_WP0 + PD * HID;  // [HID]
constexpr int O_WP1 = O_BP0 + HID;       // [HID][D]
constexpr int O_BP1 = O_WP1 + HID * D;   // [D]
constexpr int O_WA0T = O_BP1 + D;        // [HID][D]  Wa0 transposed
constexpr int O_BA0 = O_WA0T + HID * D;  // [HID]
constexpr int O_WA1 = O_BA0 + HID;       // [HID][D]
constexpr int O_BA1 = O_WA1 + HID * D;   // [D]
constexpr int O_BO = O_BA1 + D;          // [D]
constexpr int W_FLOATS = O_BO + D;

constexpr int SMEM_FLOATS = W_FLOATS + T * LDT + T * D + T * PD + T;

static_assert(THREADS == (T / 4) * (D / 4), "one thread per 4x4 of the tile");
static_assert(W_FLOATS % 4 == 0 && O_WP1 % 4 == 0 && O_WA0T % 4 == 0 &&
              O_WA1 % 4 == 0 && O_BP1 % 4 == 0 && O_BA1 % 4 == 0 &&
              O_BO % 4 == 0, "float4 reads of the blob");

__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}
__device__ __forceinline__ float load1(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load1(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, const float (&v)[4]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) p[c] = __float2bfloat16(v[c]);
}

__device__ __forceinline__ float comp(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

// Stage rows [0, T) of a [*, D] array starting at src into the tile, zeros
// past rows_left.
template <typename TT>
__device__ __forceinline__ void load_tile(const TT* __restrict__ src,
                                          int rows_left, float* tile) {
  for (int g = threadIdx.x; g < T * (D / 4); g += THREADS) {
    const int row = g >> 4, c4 = (g & 15) << 2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row < rows_left) v = load4(src + (size_t)row * D + c4);
    *reinterpret_cast<float4*>(tile + row * LDT + c4) = v;
  }
}

// acc[b][i][j] = sum_k a[i * LDT + k] * wc[k * ldw + b * D + j] for the
// thread's 4 rows (a points at the first) and 4 channels (wc points at the
// first), k < D; NB = 1, or 2 for the two halves of Wk | Wk Wv.
template <int NB>
__device__ __forceinline__ void mm4x4(const float* a, const float* wc, int ldw,
                                      float (&acc)[NB][4][4]) {
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[b][i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < D; k += 4) {
    float4 av[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(a + i * LDT + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float4 wv =
            *reinterpret_cast<const float4*>(wc + (k + kk) * ldw + b * D);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float s = comp(av[i], kk);
          acc[b][i][0] = fmaf(s, wv.x, acc[b][i][0]);
          acc[b][i][1] = fmaf(s, wv.y, acc[b][i][1]);
          acc[b][i][2] = fmaf(s, wv.z, acc[b][i][2]);
          acc[b][i][3] = fmaf(s, wv.w, acc[b][i][3]);
        }
      }
    }
  }
}

// grid: persistent, blockIdx.x walks tiles of T rows. qln [N, D]; k [V, N, D];
// pos [V, N, PD]; mask [V, N]; wblob [W_FLOATS]; out [N, D].
template <typename TT>
__global__ void __launch_bounds__(THREADS, 2) va_kernel(
    const TT* __restrict__ qln, const TT* __restrict__ k,
    const TT* __restrict__ pos, const TT* __restrict__ mask,
    const float* __restrict__ wblob, TT* __restrict__ out, int V, int N) {
  extern __shared__ __align__(16) float smem[];
  float* w = smem;
  float* tile = smem + W_FLOATS;  // [T][LDT]: qln, then each view's k, then x
  float* qps = tile + T * LDT;    // [T][D]: qp, each entry private to a thread
  float* poss = qps + T * D;      // [T][PD]
  float* msk = poss + T * PD;     // [T]

  for (int e = threadIdx.x; e < W_FLOATS / 4; e += THREADS)
    reinterpret_cast<float4*>(w)[e] =
        __ldg(reinterpret_cast<const float4*>(wblob) + e);

  const int c0 = (threadIdx.x & 15) << 2;  // first of the thread's 4 channels
  const int r0 = (threadIdx.x >> 4) << 2;  // first of its 4 rows
  const int ntiles = (N + T - 1) / T;

  for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
    const int n0 = t * T;
    const int rows_left = N - n0;
    __syncthreads();  // the weights are in; the last tile's x has been read
    load_tile(qln + (size_t)n0 * D, rows_left, tile);
    __syncthreads();
    {
      float acc[1][4][4];
      mm4x4<1>(tile + r0 * LDT, w + O_WQ + c0, D, acc);
#pragma unroll
      for (int i = 0; i < 4; ++i)
        store4(qps + (r0 + i) * D + c0, acc[0][i]);
    }

    float mx[4][4], den[4][4], num[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        mx[i][c] = -INFINITY;
        den[i][c] = 0.f;
        num[i][c] = 0.f;
      }

    for (int v = 0; v < V; ++v) {
      const size_t base = (size_t)v * N + n0;
      __syncthreads();  // the previous contents of the tile have been read
      load_tile(k + base * D, rows_left, tile);
      if (threadIdx.x < T) {
        float4 pv = make_float4(0.f, 0.f, 0.f, 0.f);
        if ((int)threadIdx.x < rows_left)
          pv = load4(pos + (base + threadIdx.x) * PD);
        *reinterpret_cast<float4*>(poss + threadIdx.x * PD) = pv;
      } else if (threadIdx.x < 2 * T) {
        const int row = threadIdx.x - T;
        msk[row] = row < rows_left ? load1(mask + base + row) : 0.f;
      }
      __syncthreads();

      float kv[2][4][4];  // kp, vv of the thread's rows and channels
      mm4x4<2>(tile + r0 * LDT, w + O_WKV + c0, 2 * D, kv);

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = r0 + i;
        // p = relu(pos Wp0 + bp0) Wp1 + bp1 on the thread's channels
        const float4 pv = *reinterpret_cast<const float4*>(poss + row * PD);
        const float4 b1 = *reinterpret_cast<const float4*>(w + O_BP1 + c0);
        float p[4] = {b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int j = 0; j < HID; ++j) {
          float h = w[O_BP0 + j];
          h = fmaf(pv.x, w[O_WP0 + j], h);
          h = fmaf(pv.y, w[O_WP0 + HID + j], h);
          h = fmaf(pv.z, w[O_WP0 + 2 * HID + j], h);
          h = fmaf(pv.w, w[O_WP0 + 3 * HID + j], h);
          h = fmaxf(h, 0.f);
          const float4 w1 =
              *reinterpret_cast<const float4*>(w + O_WP1 + j * D + c0);
          p[0] = fmaf(h, w1.x, p[0]);
          p[1] = fmaf(h, w1.y, p[1]);
          p[2] = fmaf(h, w1.z, p[2]);
          p[3] = fmaf(h, w1.w, p[3]);
        }
        // a = kp - qp + p, then the 64 -> 8 layer: the thread's 4 channels,
        // summed over the 16 lanes that hold the row
        const float4 q4 = *reinterpret_cast<const float4*>(qps + row * D + c0);
        const float a[4] = {kv[0][i][0] - q4.x + p[0], kv[0][i][1] - q4.y + p[1],
                            kv[0][i][2] - q4.z + p[2], kv[0][i][3] - q4.w + p[3]};
        float hid[HID];
#pragma unroll
        for (int j = 0; j < HID; ++j) {
          const float4 w0 =
              *reinterpret_cast<const float4*>(w + O_WA0T + j * D + c0);
          float h = a[0] * w0.x;
          h = fmaf(a[1], w0.y, h);
          h = fmaf(a[2], w0.z, h);
          h = fmaf(a[3], w0.w, h);
#pragma unroll
          for (int o = 8; o > 0; o >>= 1)
            h += __shfl_xor_sync(0xffffffffu, h, o);
          hid[j] = fmaxf(h + w[O_BA0 + j], 0.f);
        }
        const float4 b2 = *reinterpret_cast<const float4*>(w + O_BA1 + c0);
        float lg[4] = {b2.x, b2.y, b2.z, b2.w};
#pragma unroll
        for (int j = 0; j < HID; ++j) {
          const float4 w1 =
              *reinterpret_cast<const float4*>(w + O_WA1 + j * D + c0);
          lg[0] = fmaf(hid[j], w1.x, lg[0]);
          lg[1] = fmaf(hid[j], w1.y, lg[1]);
          lg[2] = fmaf(hid[j], w1.z, lg[2]);
          lg[3] = fmaf(hid[j], w1.w, lg[3]);
        }
        const bool masked = msk[row] == 0.f;
        // online softmax over the views, per (row, channel)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float l = masked ? -1e9f : lg[c];
          const float mn = fmaxf(mx[i][c], l);
          const float corr = expf(mx[i][c] - mn);
          const float e = expf(l - mn);
          den[i][c] = fmaf(den[i][c], corr, e);
          num[i][c] = fmaf(num[i][c], corr, (kv[1][i][c] + p[c]) * e);
          mx[i][c] = mn;
        }
      }
    }

    // x = num / den into the tile, then out = x Wo + bo
    __syncthreads();  // the last view's k has been read
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float x[4] = {num[i][0] / den[i][0], num[i][1] / den[i][1],
                          num[i][2] / den[i][2], num[i][3] / den[i][3]};
      store4(tile + (r0 + i) * LDT + c0, x);
    }
    __syncthreads();
    float acc[1][4][4];
    mm4x4<1>(tile + r0 * LDT, w + O_WO + c0, D, acc);
    const float4 bo = *reinterpret_cast<const float4*>(w + O_BO + c0);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      if (r0 + i < rows_left) {
        const float o[4] = {acc[0][i][0] + bo.x, acc[0][i][1] + bo.y,
                            acc[0][i][2] + bo.z, acc[0][i][3] + bo.w};
        store4(out + (size_t)(n0 + r0 + i) * D + c0, o);
      }
    }
  }
}

template <typename TT>
int launch(const void* qln, const void* k, const void* pos, const void* mask,
           const void* wblob, void* out, int V, int N, int blocks,
           cudaStream_t st) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      va_kernel<TT>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  va_kernel<TT><<<blocks, THREADS, smem, st>>>(
      static_cast<const TT*>(qln), static_cast<const TT*>(k),
      static_cast<const TT*>(pos), static_cast<const TT*>(mask),
      static_cast<const float*>(wblob), static_cast<TT*>(out), V, N);
  return (int)cudaGetLastError();
}

template <typename K>
int max_blocks(K kernel) {
  const size_t smem = SMEM_FLOATS * sizeof(float);
  int dev = 0, sms = 0, optin = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (smem > (size_t)optin) return 0;
  if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)smem) != cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS,
                                                    smem) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace

// The fixed widths the kernel was compiled for, the rows of a tile and the
// length of the weight blob in floats.
extern "C" int view_attention_dims(int* d, int* hid, int* pd, int* tile_rows,
                                   int* w_floats) {
  *d = D;
  *hid = HID;
  *pd = PD;
  *tile_rows = T;
  *w_floats = W_FLOATS;
  return 0;
}

// How many blocks fit on the current device at once (SMs x blocks per SM), or
// 0 when one block does not fit. dtype: 0 = float32, 1 = bfloat16.
extern "C" int view_attention_max_blocks(int dtype) {
  return dtype == 0 ? max_blocks(va_kernel<float>)
                    : max_blocks(va_kernel<__nv_bfloat16>);
}

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (qln, k, pos,
// mask, out); the weight blob is float32. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int view_attention_fwd(const void* qln, const void* k,
                                  const void* pos, const void* mask,
                                  const void* wblob, void* out, int V, int N,
                                  int blocks, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (V < 1 || N < 1 || blocks < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(qln, k, pos, mask, wblob, out, V, N, blocks, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(qln, k, pos, mask, wblob, out, V, N, blocks,
                                 st);
  return (int)cudaErrorInvalidValue;
}
