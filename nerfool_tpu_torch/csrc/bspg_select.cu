// BSPG tap selection for Hopper (sm_90a), bound to PyTorch through ctypes.
//
// Replaces the TPU selection kernels of nerfool_tpu/ops/bspg_kernel.py:
// select_win_smallc, select_block_pallas_smallc,
// select_block_pallas_ingredients and select_win_fused. All four compute one
// contract, and so does this kernel: for each (view-row rv, sample s)
//
//   out[rv, s, :] = sum over slots k with slots[rv, k] == pid[rv, s],
//                   over corners (dy, dx) in {ly, ly+1} x {lx, lx+1},
//                   of w_y * w_x * G[rv, k, dy * (p+1) + dx, :]
//
// with w_y = wy0 at ly and wy1 at ly+1 (likewise for x), G[rv, k] the patch
// table's row slots[rv, k] of the row's view, channel-minor, and pid, ly,
// lx and the weights the bilinear ingredients of the sample's coordinate
// (ops/spg.py _sample_ingredients, F.grid_sample's zeros padding). Slot
// lists pad with -1 and pid >= 0, so pads never match.
//
// The TPU kernels built a one-hot of the slot id and contracted it on the
// matrix unit because Mosaic had no per-lane dynamic indexing, and they read
// G, the patch rows gathered per (row, slot) into device memory before the
// call. Table row pid holds the padded pixels of patch pid, so every match
// reads the same four corners: the contract is m(rv, s) times the bilinear
// tap of table[view(rv), pid], m the number of slots equal to pid. This
// kernel reads the table through the slot ids and forms no G:
//  - a block takes 256 samples of one row; its slot list is staged once in
//    shared memory;
//  - phase 1, one thread per sample: the ingredients from the normalized
//    coordinate (the same float operations as the PyTorch code, rounded the
//    same way, so pid and the weights are bit-identical), then m by one scan
//    of the staged slots (shared-memory broadcasts); the table offset of the
//    top-left corner and the four weights, m folded in, go to shared memory
//    (m = 0: nothing is read, the taps are 0);
//  - phase 2, one thread per (sample, channel): the four corners of the
//    channel from consecutive addresses (a warp reads whole 128-byte lines at
//    c = 32), accumulated in f32 in the order of the one-hot einsum, written
//    into the caller's buffer at a channel offset and row stride, so rgb
//    (c = 3) and the features (c = 32) land side by side in one
//    [V, R, S, 3 + c] buffer that the aggregator reads as it is.
//
// What bounds it on this card: bytes. Per sample it writes c values and
// reads two coordinates; the table (about 2 MB per view at the IBRNet
// feature shape) is read once from device memory and then from L2 and L1,
// since neighbouring samples tap neighbouring pixels of the same patches.
//
// The table and the output are float32 or bfloat16; coordinates and weights
// are f32; sums are f32, rounded once to the table's type.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int SAMPLES = 256;  // samples per block, one thread each

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(
    float x) {
  return __float2bfloat16(x);
}

// 1 where base cell c0 lies in [0, n - 1], as the PyTorch code's float test
__device__ __forceinline__ float valid(float c0, int n) {
  return (c0 >= 0.f && c0 <= (float)(n - 1)) ? 1.f : 0.f;
}

// grid: (Vg * B, ceil(ns / SAMPLES)); dynamic shared memory: SAMPLES x
// (8 + 16) bytes, then ks ints. table [V, n_patch, (p+1)^2 c]; slots
// [Vg * B, ks]; views [Vg]; gx, gy [V, B, ns]; out [V, B, ns, stride].
template <typename T>
__global__ void __launch_bounds__(SAMPLES) bspg_select_kernel(
    const T* __restrict__ table, const int32_t* __restrict__ slots,
    const int32_t* __restrict__ views, const float* __restrict__ gx,
    const float* __restrict__ gy, T* __restrict__ out, int B, int ks, int ns,
    int p, int c, int n_patch, int pbx, int h, int w, int stride, int off) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* s_base = reinterpret_cast<long long*>(smem);  // [SAMPLES]
  float4* s_w = reinterpret_cast<float4*>(s_base + SAMPLES);  // [SAMPLES]
  int32_t* s_slots = reinterpret_cast<int32_t*>(s_w + SAMPLES);  // [ks]

  const int rv = blockIdx.x;
  const int view = views[rv / B];
  const size_t orow = (size_t)view * B + rv % B;  // row of gx, gy and out
  const int s0 = blockIdx.y * SAMPLES;
  for (int k = threadIdx.x; k < ks; k += SAMPLES)
    s_slots[k] = slots[(size_t)rv * ks + k];
  __syncthreads();

  const int p1 = p + 1;
  const int s = s0 + threadIdx.x;
  if (s < ns) {
    const size_t si = orow * ns + s;
    // ix = (gx + 1) * 0.5 * (w - 1), each operation rounded on its own
    const float ix = __fmul_rn(__fmul_rn(__fadd_rn(gx[si], 1.f), 0.5f),
                               (float)(w - 1));
    const float iy = __fmul_rn(__fmul_rn(__fadd_rn(gy[si], 1.f), 0.5f),
                               (float)(h - 1));
    const float x0 = floorf(ix), y0 = floorf(iy);
    // base cells clip(floor, -1, n - 1) + 1 >= 0, so / is floor division
    const int cbx = (int)fminf(fmaxf(x0, -1.f), (float)(w - 1)) + 1;
    const int cby = (int)fminf(fmaxf(y0, -1.f), (float)(h - 1)) + 1;
    const int qx = cbx / p, qy = cby / p;
    const int pid = qy * pbx + qx;
    int m = 0;
    for (int k = 0; k < ks; ++k) m += s_slots[k] == pid;
    long long base = -1;
    float4 wt = make_float4(0.f, 0.f, 0.f, 0.f);
    if (m) {
      const float fx = __fsub_rn(ix, x0), fy = __fsub_rn(iy, y0);
      const int lx = cbx - qx * p, ly = cby - qy * p;
      base = ((long long)view * n_patch + pid) * p1 * p1 * c +
             (long long)(ly * p1 + lx) * c;
      wt.x = __fmul_rn(__fsub_rn(1.f, fy), valid(y0, h));
      wt.y = __fmul_rn(fy, valid(__fadd_rn(y0, 1.f), h));
      wt.z = (float)m * __fmul_rn(__fsub_rn(1.f, fx), valid(x0, w));
      wt.w = (float)m * __fmul_rn(fx, valid(__fadd_rn(x0, 1.f), w));
    }
    s_base[threadIdx.x] = base;
    s_w[threadIdx.x] = wt;
  }
  __syncthreads();

  const int nsb = min(SAMPLES, ns - s0);
  const int down = p1 * c;
  T* o = out + (orow * ns + s0) * stride + off;
  for (int e = threadIdx.x; e < nsb * c; e += SAMPLES) {
    const int sl = e / c;
    const int ch = e - sl * c;
    const long long base = s_base[sl];
    float acc = 0.f;
    if (base >= 0) {
      const float4 wt = s_w[sl];
      const T* t = table + base + ch;
      // sum over dy first, then dx, as the one-hot einsum contracts them
      acc = wt.z * (wt.x * to_f32(t[0]) + wt.y * to_f32(t[down])) +
            wt.w * (wt.x * to_f32(t[c]) + wt.y * to_f32(t[down + c]));
    }
    o[(size_t)sl * stride + ch] = from_f32<T>(acc);
  }
}

template <typename T>
int launch(const void* table, const void* slots, const void* views,
           const void* gx, const void* gy, void* out, int vg, int B, int ks,
           int ns, int p, int c, int n_patch, int pbx, int h, int w,
           int stride, int off, cudaStream_t stream) {
  dim3 grid((unsigned)(vg * B), (unsigned)((ns + SAMPLES - 1) / SAMPLES));
  const size_t smem = SAMPLES * (sizeof(long long) + sizeof(float4)) +
                      (size_t)ks * sizeof(int32_t);
  bspg_select_kernel<T><<<grid, SAMPLES, smem, stream>>>(
      static_cast<const T*>(table), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(views), static_cast<const float*>(gx),
      static_cast<const float*>(gy), static_cast<T*>(out), B, ks, ns, p, c,
      n_patch, pbx, h, w, stride, off);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (table and
// out). Returns the cudaError_t of the launch (0 on success).
extern "C" int bspg_select(const void* table, const void* slots,
                           const void* views, const void* gx, const void* gy,
                           void* out, int vg, int B, int ks, int ns, int p,
                           int c, int n_patch, int pbx, int h, int w,
                           int stride, int off, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (vg < 1 || B < 1 || ns < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(table, slots, views, gx, gy, out, vg, B, ks, ns, p,
                         c, n_patch, pbx, h, w, stride, off, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(table, slots, views, gx, gy, out, vg, B, ks,
                                 ns, p, c, n_patch, pbx, h, w, stride, off,
                                 st);
  return (int)cudaErrorInvalidValue;
}
