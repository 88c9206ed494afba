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
// with w_y = wy0 at ly and wy1 at ly+1 (likewise for x). G holds the block's
// gathered (p+1)x(p+1)-pixel patch rows, channel-minor. The sum runs over
// every matching slot, as the one-hot matmul of the TPU kernels does (slot
// lists pad with -1 and pid >= 0, so pads never match).
//
// The TPU kernels built a one-hot of the slot id and contracted it on the
// matrix unit because Mosaic had no per-lane dynamic indexing. Here a thread
// indexes directly: one thread per (sample, channel), the row's slot list
// staged once per thread block in shared memory and searched linearly.
//
// What bounds it on this card: per sample it reads 4 corners x c channels of
// G (512 B at c=32 in f32) and the Ks-int slot list. The G rows of one view-
// row are a few tens of KB and are re-read by all of its samples, so the reads
// mostly hit L1/L2; the slot search runs on shared-memory broadcasts (all
// threads of a warp read the same slot). The design keeps each warp's G loads
// and output stores on consecutive channels, so at c=32 a warp moves whole
// 128-byte lines. G itself is materialised by the gather before the call;
// skipping it (reading the patch table through the slot ids) and splitting
// the search across the warp are left for later.
//
// G is read in its table dtype (f32 or bf16) and accumulated in f32; the
// weights are f32; the output is in the table dtype.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

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

// grid: (n_rv, ceil(ns * c / blockDim.x)); dynamic shared memory: ks ints.
template <typename T>
__global__ void bspg_select_kernel(const T* __restrict__ g,
                                   const int32_t* __restrict__ slots,
                                   const int32_t* __restrict__ pid,
                                   const int32_t* __restrict__ ly,
                                   const int32_t* __restrict__ lx,
                                   const float* __restrict__ wy0,
                                   const float* __restrict__ wy1,
                                   const float* __restrict__ wx0,
                                   const float* __restrict__ wx1,
                                   T* __restrict__ out, int ks, int ns, int p1,
                                   int c) {
  extern __shared__ int32_t s_slots[];
  const int64_t rv = blockIdx.x;
  for (int k = threadIdx.x; k < ks; k += blockDim.x) {
    s_slots[k] = slots[rv * ks + k];
  }
  __syncthreads();

  const int64_t e = (int64_t)blockIdx.y * blockDim.x + threadIdx.x;
  if (e >= (int64_t)ns * c) return;
  const int s = (int)(e / c);
  const int ch = (int)(e - (int64_t)s * c);
  const int64_t si = rv * ns + s;
  const int q = pid[si];
  const float a0 = wy0[si], a1 = wy1[si];
  const float b0 = wx0[si], b1 = wx1[si];
  const int64_t row = (int64_t)p1 * p1 * c;
  // corner (ly, lx) of this channel; (ly+1, lx) is p1*c further, etc.
  const T* base = g + rv * ks * row + ((int64_t)ly[si] * p1 + lx[si]) * c + ch;
  const int down = p1 * c;

  float acc = 0.f;
  for (int k = 0; k < ks; ++k) {
    if (s_slots[k] == q) {
      const T* t = base + k * row;
      acc += a0 * (b0 * to_f32(t[0]) + b1 * to_f32(t[c])) +
             a1 * (b0 * to_f32(t[down]) + b1 * to_f32(t[down + c]));
    }
  }
  out[rv * ns * c + e] = from_f32<T>(acc);
}

template <typename T>
int launch(const void* g, const void* slots, const void* pid, const void* ly,
           const void* lx, const void* wy0, const void* wy1, const void* wx0,
           const void* wx1, void* out, int n_rv, int ks, int ns, int p1, int c,
           cudaStream_t stream) {
  const int threads = 256;
  const int64_t work = (int64_t)ns * c;
  dim3 grid((unsigned)n_rv, (unsigned)((work + threads - 1) / threads));
  bspg_select_kernel<T><<<grid, threads, ks * sizeof(int32_t), stream>>>(
      static_cast<const T*>(g), static_cast<const int32_t*>(slots),
      static_cast<const int32_t*>(pid), static_cast<const int32_t*>(ly),
      static_cast<const int32_t*>(lx), static_cast<const float*>(wy0),
      static_cast<const float*>(wy1), static_cast<const float*>(wx0),
      static_cast<const float*>(wx1), static_cast<T*>(out), ks, ns, p1, c);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry for ctypes. dtype: 0 = float32, 1 = bfloat16 (G and out).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int bspg_select(const void* g, const void* slots, const void* pid,
                           const void* ly, const void* lx, const void* wy0,
                           const void* wy1, const void* wx0, const void* wx1,
                           void* out, int n_rv, int ks, int ns, int p1, int c,
                           int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch<float>(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1, out, n_rv,
                         ks, ns, p1, c, st);
  }
  if (dtype == 1) {
    return launch<__nv_bfloat16>(g, slots, pid, ly, lx, wy0, wy1, wx0, wx1,
                                 out, n_rv, ks, ns, p1, c, st);
  }
  return (int)cudaErrorInvalidValue;
}
