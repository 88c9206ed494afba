// K6: pixelNeRF's 512-wide ResnetFC layers for Hopper (sm_90a), forward and
// input gradient, bound to PyTorch through ctypes (ops/linear.py).
//
// Replaces no TPU kernel: the JAX package leaves these products to XLA. It
// was added because cuBLAS's float32 route (TF32 off) runs them as SGEMMs on
// the CUDA cores, the largest part of a pixelNeRF attack iteration.
//
// One kernel computes C [M, Nc] = A [M, Kc] . B [Kc, Nc] with the epilogue
//
//   forward:        Y  = act(X) W^T + b (+ addend)
//                   A = X, B = W^T, act ReLU or the identity, applied to A
//                   as it is loaded;
//   input gradient: dX = (dY W) * [X > 0 where act was ReLU] (+ addend)
//                   A = dY, B = W.
//
// A is row-major [M, Kc] (K-major), or, for the latent taps that reach
// lin_z as a transposed view of grid_sample's output, [V, Kc, P] with P
// contiguous (M-major, M = V P). C, the mask and the addend are row-major
// [M, Nc].
//
// Bound, at the cell's shapes (M = 327,680 coarse and 491,520 fine rows, Kc =
// Nc = 512): 258 GFLOP a fine launch, 1.56 ms as three TF32 products at 495
// TFLOP/s, against 0.6 ms for its ~2 GB of activations at 3.35 TB/s: the
// kernel is bound by operations. Float32 is kept as three TF32 products on
// the tensor cores, a_hi b_hi + a_hi b_lo + a_lo b_hi, as K3-K5 do: the
// weights are split to nearest once a call by pack_kernel (and transposed
// for the input gradient), A in registers as K5 splits it (hi = x with its
// 13 low mantissa bits cleared, lo = x - hi read truncated by the tensor
// cores). The three products of each k step of 8 go into a zeroed
// accumulator that is added to the tile's sum in f32: the tensor cores add
// into their accumulator truncating (all of K in their accumulator put the
// fine forward 2.2e-6 of its largest entry from float64 on an H100, against
// 2.3e-7 so, and cuBLAS's f32 4e-7).
//
// Design: a persistent block on every SM walks the output tiles of 192 rows
// x 128 columns (the 4 column tiles of a row tile on neighbouring blocks, so
// that A is read from device memory once and from L2 thrice). One thread of
// a producer warpgroup keeps TMA loads in flight into a ring of 3 stages of
// 32 k values (A, B hi, B lo: 56 KB a stage, 128-byte swizzle); three
// consumer warpgroups of 64 rows each run wgmma.m64n128k8 with A from
// registers and B from shared memory, with the registers the producer's
// warpgroup gives up (setmaxnreg). A goes through registers so that the ReLU
// and the split happen there, and so that both layouts of A are read the same
// way: TF32 wgmma takes only K-major operands from shared memory. Each
// warpgroup waits for its three products before adding them, while the other
// warpgroups' run on the tensor cores: three warpgroups, because a
// warpgroup's steps wait on each other (two took 3.9 ms at the fine shape on
// an H100, three 3.2), and one zeroed accumulator each, because a second one,
// added while the next step runs, made ptxas serialise every wgmma. The
// producer also prefetches each tile's addend and mask into L2 halfway
// through the tile's k loop (TMA prefetch), and the epilogue loads them in
// batches ahead of its stores: the output could alias them as far as the
// compiler knows, and a load after each store cost 0.6 ms a launch. The
// epilogue adds the bias and the addend (or applies the mask) in f32, in
// registers, and writes C once.
//
// Measured at the fine shape (491,520 x 512 x 512) on an H100 80GB HBM3 at
// 700 W: the forward with ReLU, bias and addend 2.45-2.54 ms (61-64% of the
// bound), the input gradient with mask and addend 2.77-2.79 ms (56%);
// cuBLAS's single TF32 product takes 0.83 ms (311 TFLOP/s), so three would
// take 2.49. Summing every two k steps instead of one took 2.11-2.23 ms
// with the same largest error on those inputs; K5 sums every step, and so
// does this kernel.
//
// Reads of A fragments from the swizzled tiles hit 32 banks: K-major with
// the fragment's k order, M-major with k 2t and 2t + 1 in the place of t
// and t + 4 (pack_kernel permutes B's k within each step of 8 to match).
#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CONSUMERS = 3;       // warpgroups of 64 rows
constexpr int BM = 64 * CONSUMERS;  // rows of a tile
constexpr int BN = 128;  // columns of a tile: one wgmma's n
constexpr int BK = 32;   // k values of a stage: a 128-byte row of floats
constexpr int STAGES = 3;
constexpr int THREADS = 128 * (CONSUMERS + 1);  // and the producer's
// registers a thread: the producer's warpgroup gives up what the consumers'
// accumulators take (128 x 24 + 384 x 160 <= 65,536)
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = 160;
constexpr int A_BYTES = BM * BK * 4;
constexpr int B_BYTES = BN * BK * 4;
constexpr int STAGE_BYTES = A_BYTES + 2 * B_BYTES;
constexpr int SMEM = STAGES * STAGE_BYTES + 1024;  // + the 1024-byte alignment
constexpr int MM_BOX = 32;  // rows of an M-major box (128 bytes)

struct Params {
  const float* mask;    // [M, Nc]: the output is 0 where mask <= 0; or null
  const float* bias;    // [Nc] or null
  const float* addend;  // [M, Nc] or null
  float* out;           // [M, Nc]
  int Nc, Kc;
  int P;                // rows of a view (M-major), else M
  int tiles_n, tiles_per_view, tiles;
};

// ---- shared memory, barriers, TMA ----

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_2d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_3d(uint32_t dst, const CUtensorMap* map,
                                       uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a box of a tensor into L2, no completion tracked
__device__ __forceinline__ void tma_prefetch_2d(const CUtensorMap* map, int c0,
                                                int c1) {
  asm volatile(
      "cp.async.bulk.prefetch.tensor.2d.L2.global.tile [%0, {%1, %2}];\n" ::"l"(
          reinterpret_cast<uint64_t>(map)),
      "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma: m64n128k8, TF32, A from registers ----

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// waits until this warpgroup's committed products are done
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving reads of d across a wgmma wait
__device__ __forceinline__ void fence_regs(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// the descriptor of a K-major tile of 128-byte rows under the 128-byte
// swizzle: 8-row groups 1024 bytes apart (the leading offset is unused)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) | (1ull << 16) |
         (64ull << 32) | (1ull << 62);
}

// d = (scale_d ? d : 0) + a b: a the lane's fragment of a 64 x 8 A, b a
// 128 x 8 K-major tile of B in shared memory
__device__ __forceinline__ void wgmma_128(float (&d)[64],
                                          const uint32_t (&a)[4],
                                          uint64_t desc, int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(scale_d));
}

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (a TF32
// value), lo = x - hi is exact in f32 and read truncated by the tensor cores
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// f32 rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

// ---- the weights: B^T [Nc, Kc] split into hi and lo planes ----
//
// out[0][n][j] = hi, out[1][n][j] = lo of B^T[n][k(j)]: B^T = W [Nc, Kc] in
// the forward, W^T (W [Kc, Nc]) in the input gradient. k(j) = j, or with
// `permute` (an M-major A) the A fragment's order: slot i < 4 of a step of 8
// holds k 2i, slot i + 4 holds k 2i + 1.
__global__ void pack_kernel(const float* __restrict__ w,
                            float* __restrict__ out, int Nc, int Kc,
                            int transpose, int permute) {
  const int total = Nc * Kc;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int n = e / Kc, j = e - n * Kc;
    int k = j;
    if (permute) {
      const int i = j & 7;
      k = (j & ~7) | (i < 4 ? 2 * i : 2 * (i - 4) + 1);
    }
    const float v = transpose ? w[static_cast<size_t>(k) * Nc + n]
                              : w[static_cast<size_t>(n) * Kc + k];
    const float hi = tf32_rna(v);
    out[e] = hi;
    out[total + e] = tf32_rna(v - hi);
  }
}

// ---- the product ----

template <bool MMAJOR, bool RELU>
__global__ void __launch_bounds__(THREADS, 1)
    dense_kernel(const __grid_constant__ CUtensorMap tm_a,
                 const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_addend,
                 const __grid_constant__ CUtensorMap tm_mask,
                 const __grid_constant__ Params p) {
  extern __shared__ uint8_t smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[STAGES], empty_bar[STAGES];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  const uint8_t* sbase = smem_raw + (base - raw);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(smem_u32(&full_bar[s]), 1);
      mbar_init(smem_u32(&empty_bar[s]), CONSUMERS * 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();
  const int KB = p.Kc / BK;

  if (warp < 4) {
    // the producer warpgroup: one thread issues every load
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS)
                 : "memory");
    if (tid != 0) return;
    int stage = 0;
    uint32_t phase = 0;
    for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
      const int mt = tile / p.tiles_n, nt = tile - mt * p.tiles_n;
      const int v = mt / p.tiles_per_view;
      const int p0 = (mt - v * p.tiles_per_view) * BM, n0 = nt * BN;
      for (int kb = 0; kb < KB; ++kb) {
        const uint32_t full = smem_u32(&full_bar[stage]);
        mbar_wait(smem_u32(&empty_bar[stage]), phase ^ 1);
        mbar_expect_tx(full, STAGE_BYTES);
        const uint32_t sa = base + stage * STAGE_BYTES;
        if (MMAJOR) {
#pragma unroll
          for (int b = 0; b < BM / MM_BOX; ++b)
            tma_3d(sa + b * MM_BOX * BK * 4, &tm_a, full, p0 + b * MM_BOX,
                   kb * BK, v);
        } else {
          tma_2d(sa, &tm_a, full, kb * BK, p0);
        }
        tma_2d(sa + A_BYTES, &tm_b, full, kb * BK, n0);
        tma_2d(sa + A_BYTES + B_BYTES, &tm_b, full, kb * BK, p.Nc + n0);
        if (kb == KB / 2) {
          // the epilogue's reads into L2 while the tile's products run
          const int m0 = v * p.P + p0;
          if (p.addend) tma_prefetch_2d(&tm_addend, n0, m0);
          if (p.mask) tma_prefetch_2d(&tm_mask, n0, m0);
        }
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS)
               : "memory");

  // a consumer: warpgroup wg takes rows 64 wg .. 64 wg + 63 of each tile;
  // lane (g, t) holds A at rows g, g + 8 of its warp's 16, k slots t, t + 4
  const int wg = (warp >> 2) - 1, g = lane >> 2, t = lane & 3;
  const int row0 = wg * 64 + (warp & 3) * 16 + g;  // and row0 + 8
  // byte offsets of the fragment's four values in a stage's A tile at k
  // step 0. M-major: box row0 / 32, k rows 2t and 2t + 1
  uint32_t aoff[4];
  if (MMAJOR) {
    const int box = row0 / MM_BOX, mm = row0 % MM_BOX;
    const uint32_t b = box * MM_BOX * BK * 4 + (mm & 3) * 4;
    aoff[0] = b + 2 * t * 128 + (((mm >> 2) ^ (2 * t)) << 4);
    aoff[1] = b + 2 * t * 128 + ((((mm >> 2) + 2) ^ (2 * t)) << 4);
    aoff[2] = b + (2 * t + 1) * 128 + (((mm >> 2) ^ (2 * t + 1)) << 4);
    aoff[3] = b + (2 * t + 1) * 128 + ((((mm >> 2) + 2) ^ (2 * t + 1)) << 4);
  } else {
    aoff[0] = row0 * 128 + t * 4;
    aoff[1] = (row0 + 8) * 128 + t * 4;
  }

  float acc[64], part[64];
  int stage = 0;
  uint32_t phase = 0;
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int mt = tile / p.tiles_n, nt = tile - mt * p.tiles_n;
    const int v = mt / p.tiles_per_view;
    const int p0 = (mt - v * p.tiles_per_view) * BM, n0 = nt * BN;
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.f;

    for (int kb = 0; kb < KB; ++kb) {
      mbar_wait(smem_u32(&full_bar[stage]), phase);
      __syncwarp();
      const uint8_t* sa = sbase + stage * STAGE_BYTES;
      const uint64_t dhi = smem_desc(base + stage * STAGE_BYTES + A_BYTES);
      const uint64_t dlo = dhi + (B_BYTES >> 4);
#pragma unroll
      for (int s = 0; s < BK / 8; ++s) {
        float x[4];
        if (MMAJOR) {
#pragma unroll
          for (int i = 0; i < 4; ++i)
            x[i] = *reinterpret_cast<const float*>(sa + aoff[i] + s * 1024);
        } else {
          // k slots t and t + 4 lie in 16-byte chunks 2s and 2s + 1 of
          // rows row0 and row0 + 8, both at row % 8 == g
          const uint32_t c0 = ((2 * s) ^ g) << 4, c1 = ((2 * s + 1) ^ g) << 4;
          x[0] = *reinterpret_cast<const float*>(sa + aoff[0] + c0);
          x[1] = *reinterpret_cast<const float*>(sa + aoff[1] + c0);
          x[2] = *reinterpret_cast<const float*>(sa + aoff[0] + c1);
          x[3] = *reinterpret_cast<const float*>(sa + aoff[1] + c1);
        }
        uint32_t ah[4], al[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          split(RELU ? fmaxf(x[i], 0.f) : x[i], ah[i], al[i]);
        // the step's three products into a zeroed accumulator, smallest
        // first, then added to the tile's sum in f32
        fence_regs(part);
        wgmma_fence();
        wgmma_128(part, al, dhi + 2 * s, 0);
        wgmma_128(part, ah, dlo + 2 * s, 1);
        wgmma_128(part, ah, dhi + 2 * s, 1);
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(part);
#pragma unroll
        for (int i = 0; i < 64; ++i) acc[i] += part[i];
      }
      // this warp is done with the stage
      if (lane == 0) mbar_arrive(smem_u32(&empty_bar[stage]));
      if (++stage == STAGES) {
        stage = 0;
        phase ^= 1;
      }
    }

    // epilogue: lane (g, t) holds rows row0, row0 + 8 and columns 8j + 2t,
    // 8j + 2t + 1 of each j < 16. Each batch of 8 j issues its loads before
    // its stores (the output could alias them, as far as the compiler knows)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int pr = p0 + row0 + 8 * h;
      if (pr >= p.P) continue;
      const size_t row = (static_cast<size_t>(v) * p.P + pr) * p.Nc;
#pragma unroll
      for (int j0 = 0; j0 < 16; j0 += 8) {
        float2 mk[8], bs[8], ad[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + 8 * (j0 + j) + 2 * t;
          mk[j] = p.mask ? *reinterpret_cast<const float2*>(p.mask + row + n)
                         : make_float2(1.f, 1.f);
          bs[j] = p.bias ? *reinterpret_cast<const float2*>(p.bias + n)
                         : make_float2(0.f, 0.f);
          ad[j] = p.addend
                      ? *reinterpret_cast<const float2*>(p.addend + row + n)
                      : make_float2(0.f, 0.f);
        }
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int n = n0 + 8 * (j0 + j) + 2 * t;
          const int i = 4 * (j0 + j) + 2 * h;
          float2 o;
          o.x = (mk[j].x > 0.f ? acc[i] : 0.f) + bs[j].x + ad[j].x;
          o.y = (mk[j].y > 0.f ? acc[i + 1] : 0.f) + bs[j].y + ad[j].y;
          *reinterpret_cast<float2*>(p.out + row + n) = o;
        }
      }
    }
  }
}

// ---- host side ----

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the runtime (no -lcuda)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn) return fn;
  void* ptr = nullptr;
  cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
  const cudaError_t err = cudaGetDriverEntryPointByVersion(
      "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
  const cudaError_t err = cudaGetDriverEntryPoint(
      "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
  if (err != cudaSuccess || found != cudaDriverEntryPointSuccess)
    return nullptr;
  fn = reinterpret_cast<EncodeTiled>(ptr);
  return fn;
}

// a float32 tensor map of `rank` dimensions (innermost first) with a
// 128-byte swizzle; zeros outside the tensor
bool tensor_map(CUtensorMap* map, const void* ptr, int rank,
                const cuuint64_t* dims, const cuuint64_t* strides,
                const cuuint32_t* box, bool swizzle = true) {
  const EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint32_t ones[3] = {1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
            const_cast<void*>(ptr), dims, strides, box, ones,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <bool MMAJOR, bool RELU>
cudaError_t launch(const CUtensorMap& ta, const CUtensorMap& tb,
                   const CUtensorMap& tadd, const CUtensorMap& tmask,
                   const Params& p, cudaStream_t stream) {
  auto kern = dense_kernel<MMAJOR, RELU>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int grid = p.tiles < sms ? p.tiles : sms;
  kern<<<grid, THREADS, SMEM, stream>>>(ta, tb, tadd, tmask, p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15) == 0;
}

// C [M, Nc] = A [M, Kc] . B with the epilogue above; views > 0: A is
// [views, Kc, M / views] (M-major), else [M, Kc]; transpose: B = W [Kc,
// Nc] (the input gradient), else B = W^T, W [Nc, Kc] (the forward)
cudaError_t run(const float* a, const float* w, const float* mask,
                const float* bias, const float* addend, float* out,
                float* wpack, int M, int Nc, int Kc, int views, int relu,
                int transpose, cudaStream_t stream) {
  const bool mmajor = views > 0;
  const int P = mmajor ? M / views : M;
  if (Kc % BK != 0 || Nc % BN != 0 || M < 0 ||
      (mmajor && (P * views != M || P % 4 != 0)) || !aligned16(a) ||
      !aligned16(wpack) || !aligned16(out) ||
      (mask && !aligned16(mask)) || (addend && !aligned16(addend)))
    return cudaErrorInvalidValue;
  if (M == 0) return cudaSuccess;

  const int total = Nc * Kc;
  pack_kernel<<<(total + 255) / 256, 256, 0, stream>>>(w, wpack, Nc, Kc,
                                                       transpose, mmajor);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;

  CUtensorMap ta{}, tb{};
  bool ok;
  if (mmajor) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(P),
                                static_cast<cuuint64_t>(Kc),
                                static_cast<cuuint64_t>(views)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(P) * 4,
                                   static_cast<cuuint64_t>(P) * Kc * 4};
    const cuuint32_t box[3] = {MM_BOX, BK, 1};
    ok = tensor_map(&ta, a, 3, dims, strides, box);
  } else {
    const cuuint64_t dims[2] = {static_cast<cuuint64_t>(Kc),
                                static_cast<cuuint64_t>(M)};
    const cuuint64_t strides[1] = {static_cast<cuuint64_t>(Kc) * 4};
    const cuuint32_t box[2] = {BK, BM};
    ok = tensor_map(&ta, a, 2, dims, strides, box);
  }
  const cuuint64_t bdims[2] = {static_cast<cuuint64_t>(Kc),
                               static_cast<cuuint64_t>(2 * Nc)};
  const cuuint64_t bstrides[1] = {static_cast<cuuint64_t>(Kc) * 4};
  const cuuint32_t bbox[2] = {BK, BN};
  ok = ok && tensor_map(&tb, wpack, 2, bdims, bstrides, bbox);
  // the addend and the mask, [M, Nc], for their prefetch a tile at a time
  CUtensorMap tadd{}, tmask{};
  const cuuint64_t cdims[2] = {static_cast<cuuint64_t>(Nc),
                               static_cast<cuuint64_t>(M)};
  const cuuint64_t cstrides[1] = {static_cast<cuuint64_t>(Nc) * 4};
  const cuuint32_t cbox[2] = {BN, BM};
  if (addend)
    ok = ok && tensor_map(&tadd, addend, 2, cdims, cstrides, cbox, false);
  if (mask)
    ok = ok && tensor_map(&tmask, mask, 2, cdims, cstrides, cbox, false);
  if (!ok) return cudaErrorInvalidValue;

  Params p{};
  p.mask = mask, p.bias = bias, p.addend = addend, p.out = out;
  p.Nc = Nc, p.Kc = Kc, p.P = P;
  p.tiles_n = Nc / BN;
  p.tiles_per_view = (P + BM - 1) / BM;
  p.tiles = (mmajor ? views : 1) * p.tiles_per_view * p.tiles_n;
  if (mmajor)
    return relu ? launch<true, true>(ta, tb, tadd, tmask, p, stream)
                : launch<true, false>(ta, tb, tadd, tmask, p, stream);
  return relu ? launch<false, true>(ta, tb, tadd, tmask, p, stream)
              : launch<false, false>(ta, tb, tadd, tmask, p, stream);
}

}  // namespace

extern "C" {

// floats of the split weights of one call (scratch for dense_forward and
// dense_input_grad): two planes of n x k
long long dense_wpack_floats(int n, int k) { return 2LL * n * k; }

// y [M, N] = act(x) w^T + bias (+ addend): x [M, K] row-major, or (views
// > 0) [views, K, M / views] with its last dimension contiguous; w [N, K];
// bias [N], addend [M, N] or null; act ReLU where relu. wpack: scratch of
// dense_wpack_floats(N, K). Returns a cudaError_t: cudaErrorInvalidValue
// where K is not a multiple of 32 or N of 128, an M-major view's rows are
// not a multiple of 4, or a pointer is not 16-byte aligned.
int dense_forward(const float* x, const float* w, const float* bias,
                  const float* addend, float* y, float* wpack, int M, int N,
                  int K, int views, int relu, void* stream) {
  return static_cast<int>(run(x, w, nullptr, bias, addend, y, wpack, M, N, K,
                              views, relu, 0,
                              static_cast<cudaStream_t>(stream)));
}

// dx [M, K] = (dy w) * [mask > 0] (+ addend): dy [M, N] row-major, w [N,
// K]; mask (the forward's x, where it took a ReLU) and addend [M, K] or
// null. wpack: scratch of dense_wpack_floats(K, N). Errors as
// dense_forward's, with K and N in each other's place.
int dense_input_grad(const float* dy, const float* w, const float* mask,
                     const float* addend, float* dx, float* wpack, int M,
                     int N, int K, void* stream) {
  return static_cast<int>(run(dy, w, mask, nullptr, addend, dx, wpack, M, K,
                              N, 0, 0, 1, static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
