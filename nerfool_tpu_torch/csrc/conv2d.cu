// The ResUNet feature net's convolutions for Hopper (sm_90a), forward and
// input gradient, bound to PyTorch through ctypes (ops/conv2d.py).
//
// Replaces no TPU kernel: the JAX package leaves its convolutions to XLA.
// It was added because the feature net is most of an attack iteration, and
// cuDNN's float32 route for these shapes (TF32 off) is an FFT convolution
// whose complex GEMM runs on the CUDA cores at a few percent of the card.
//
// One kernel computes a "valid" cross-correlation as an implicit GEMM over
// NCHW float32 tensors, with a gather offset that reads zeros outside the
// input (no padding is ever materialised):
//
//   out[v, n, i*os + oh, j*os + ow] = bias[n] + sum_{c, r, s}
//       in[v, c, i*is + r - ph, j*is + s - pw] * B[(r, s, c)][n]
//
// M = V * Hi * Wi output pixels, N output channels, K = C * taps. A (the
// input) is gathered tile by tile into shared memory with 4-byte cp.async
// (consecutive pixels of a warp are consecutive addresses), zeros where the
// gather falls outside; B (the weights) is packed once a call by
// conv_pack_kernel into the B fragments of mma.sync.m16n8k8, hi and lo
// planes side by side, and copied with 16-byte cp.async.
//
//  - forward: the input padded by PyTorch (the reflect pad is an F.pad),
//    gather stride = the convolution's stride, offset 0, B = w[n, c, r, s];
//  - input gradient at stride 1: dy read with offset k - 1 (zeros around
//    it), B = w flipped and transposed, so the gradient of the padded input;
//  - input gradient at stride 2: four problems, one per parity (ph, pw) of
//    the input pixel, each a stride-1 correlation of dy with the sub-kernel
//    w[:, :, ph::2, pw::2] flipped, written at (2i + ph, 2j + pw). Every
//    input pixel is written once, by one problem, with no atomics; where a
//    parity has no taps (a 1x1 kernel at odd pixels) a memset of the whole
//    output writes its zeros first.
//
// Bound, at the attack's shapes (10 views at 756x1008): 1.180 TFLOP the
// forward and as much the input gradient, so operations (three TF32
// products: 3 x 2.36 / 495 TFLOP/s = 14.3 ms an iteration); the activations
// are a few GB, ~2 ms at 3.35 TB/s. Float32 is kept as three TF32 products
// on the tensor cores, a_hi b_hi + a_hi b_lo + a_lo b_hi, as K3 and K4 do:
// the weights are split to nearest in the pack, the activations in the
// kernel in two instructions, as K3 does (hi = x with its 13 low mantissa
// bits cleared, lo = x - hi read truncated by the tensor cores; rounding
// both halves to nearest took 14% longer on an H100 and moved neither the
// largest error of a convolution nor the benchmark's comparisons). The
// three products of a k step go through a zeroed accumulator and are added
// in f32: the tensor cores add into their accumulator truncating, and K
// reaches 2304 here.
//
// Tiles: 256 threads, 8 warps; a block tile of BM pixels x BN channels, a
// 4-stage ring of BK = 16 k values in shared memory (~100 KB, two blocks an
// SM). BN follows N: 128 (N > 64), 64, 32 or 8 (the stem's input gradient,
// 3 channels, padded to 8 in the pack and masked in the store: it gathers
// K = 64 x taps values for every 3 outputs, 5.3 ms on an H100, where a GEMM
// of dy's pixels by the weights and a col2im pass took 2.4). K is walked
// tap by tap, 16 channels at a time, when C is a multiple of 16 (every
// convolution but the stem's forward); otherwise a table of (channel, tap)
// per k in shared memory serves the gather. A is
// stored [k][pixel] with a row of BM + 8 floats, so that the A fragments'
// scalar loads hit 32 banks. Running every parity problem of a pixel tile
// in one block, through one ring, spilled registers and lost more than it
// saved on an H100.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int BK = 16;
constexpr int STAGES = 4;
constexpr int GEN_MAX_K = 1024;  // the table's length (padded K)
constexpr int MAX_PROBS = 4;

struct Prob {
  const float* wpack;  // [Kpad/8][Npad/8][32][4]
  int hi, wi;          // the output grid of this problem, per view
  int th, tw;          // taps
  int ph, pw;          // gather offset
  int oh, ow;          // output offset
  int K, kpad;
  int tile0;           // the problem's first tile
};

struct Params {
  const float* in;
  float* out;
  const float* bias;  // or null
  int V, C, H, W;     // the gathered tensor [V, C, H, W]
  int N, npad;        // GEMM columns, real and padded to BN
  int hout, wout;     // the output tensor's spatial size
  int is, os;         // gather and output strides
  int tiles_n;
  int nprob;
  Prob prob[MAX_PROBS];
};

// ---- split TF32 on mma.sync.m16n8k8 ----

// x = hi + lo: hi is x with its 13 low mantissa bits cleared (a TF32
// value), lo = x - hi is exact in f32 and read truncated to TF32 by the
// tensor cores, so x to ~2^-20 of itself in two instructions
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a b in three TF32 products through a zeroed accumulator, added in
// f32; b = (hi of rows t, t + 4; lo of rows t, t + 4) of the lane's column
__device__ __forceinline__ void mma3_acc(float (&c)[4], const uint32_t (&ah)[4],
                                         const uint32_t (&al)[4], uint4 b) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma_tf32(t, al, b.x, b.y);
  mma_tf32(t, ah, b.z, b.w);
  mma_tf32(t, ah, b.x, b.y);
#pragma unroll
  for (int i = 0; i < 4; ++i) c[i] += t[i];
}

// f32 rounded to TF32, to nearest with ties away from zero (cvt.rna)
__device__ __forceinline__ float tf32_rna(float x) {
  uint32_t u = __float_as_uint(x);
  if ((u & 0x7f800000u) != 0x7f800000u) u = (u + 0x1000u) & 0xffffe000u;
  return __uint_as_float(u);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// ---- the weights as B fragments ----
//
// B[k][n] of problem (ph, pw): forward (dgrad 0) B = w[n, c, r, s]; input
// gradient B = w[c, n, S (th-1-r) + ph, S (tw-1-s) + pw] (w is [Cout, Cin,
// kh, kw]; the GEMM's channels c are the convolution's outputs, its columns
// n the convolution's inputs). k = (r tw + s) C + c when tap_major, else
// c th tw + r tw + s. Lane 4g + t of fragment (kt, nt) holds (hi, hi, lo,
// lo) of B[8kt + t][8nt + g] and B[8kt + t + 4][8nt + g]; zeros past K, N.
__device__ __forceinline__ float b_entry(const float* w, int k, int n, int K,
                                         int N, int C, int dgrad,
                                         int tap_major, int kh, int kw,
                                         int S, int th, int tw, int ph,
                                         int pw) {
  if (k >= K || n >= N) return 0.f;
  int c, tap;
  if (tap_major) {
    tap = k / C;
    c = k - tap * C;
  } else {
    c = k / (th * tw);
    tap = k - c * th * tw;
  }
  const int r = tap / tw, s = tap - r * tw;
  if (!dgrad) return w[((n * C + c) * kh + r) * kw + s];
  const int rr = S * (th - 1 - r) + ph, ss = S * (tw - 1 - s) + pw;
  return w[((c * N + n) * kh + rr) * kw + ss];
}

__global__ void conv_pack_kernel(const float* __restrict__ w,
                                 float4* __restrict__ out, int K, int kpad,
                                 int N, int npad, int C, int dgrad,
                                 int tap_major, int kh, int kw, int S, int th,
                                 int tw, int ph, int pw) {
  const int total = (kpad / 8) * (npad / 8) * 32;
  for (int e = blockIdx.x * blockDim.x + threadIdx.x; e < total;
       e += gridDim.x * blockDim.x) {
    const int lane = e & 31, frag = e >> 5;
    const int nt = frag % (npad / 8), kt = frag / (npad / 8);
    const int g = lane >> 2, t = lane & 3;
    const int n = 8 * nt + g, k0 = 8 * kt + t;
    const float b0 = b_entry(w, k0, n, K, N, C, dgrad, tap_major, kh, kw, S,
                             th, tw, ph, pw);
    const float b1 = b_entry(w, k0 + 4, n, K, N, C, dgrad, tap_major, kh, kw,
                             S, th, tw, ph, pw);
    const float h0 = tf32_rna(b0), h1 = tf32_rna(b1);
    out[e] = make_float4(h0, h1, tf32_rna(b0 - h0), tf32_rna(b1 - h1));
  }
}

// ---- the implicit GEMM ----

int round_up(int x, int m) { return (x + m - 1) / m * m; }

template <int BM, int BN, int WM, int WN, bool TAP_MAJOR>
struct Conv {
  static constexpr int WARPS_M = BM / WM;
  static constexpr int MT = WM / 16, NT = WN / 8;
  static constexpr int LDA = BM + 8;
  static constexpr int A_FLOATS = BK * LDA;
  static constexpr int B_FLOATS = BK * BN * 2;
  static constexpr int KPT = BK * BM / THREADS;  // k values a thread gathers
  static constexpr int SMEM =
      STAGES * (A_FLOATS + B_FLOATS) * 4 + (TAP_MAJOR ? 0 : 8 * GEN_MAX_K);
  static_assert((BM / WM) * (BN / WN) == THREADS / 32, "8 warps");
  static_assert(BM % 32 == 0 && THREADS % BM == 0, "pixel rows");
};

template <int BM, int BN, int WM, int WN, bool TAP_MAJOR>
__global__ void __launch_bounds__(THREADS, 2)
    conv_kernel(const __grid_constant__ Params p) {
  using Cfg = Conv<BM, BN, WM, WN, TAP_MAJOR>;
  constexpr int LDA = Cfg::LDA, MT = Cfg::MT, NT = Cfg::NT, KPT = Cfg::KPT;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;
  float* Bs = smem + STAGES * Cfg::A_FLOATS;

  // the problem and the tile
  int tile = blockIdx.x;
  int pi = 0;
#pragma unroll
  for (int q = 1; q < MAX_PROBS; ++q)
    if (q < p.nprob && tile >= p.prob[q].tile0) pi = q;
  const Prob& pr = p.prob[pi];
  tile -= pr.tile0;
  const int nb = tile % p.tiles_n, mb = tile / p.tiles_n;
  const int m0 = mb * BM, n0 = nb * BN;
  const int hw = pr.hi * pr.wi;
  const int M = p.V * hw;
  const int HW = p.H * p.W;
  const int tid = threadIdx.x;

  int* ktab = reinterpret_cast<int*>(Bs + STAGES * Cfg::B_FLOATS);
  if (!TAP_MAJOR) {
    // (channel offset, tap) of every k; -1 past K
    const int taps = pr.th * pr.tw;
    for (int k = tid; k < pr.kpad; k += THREADS) {
      int off = -1, rs = 0;
      if (k < pr.K) {
        const int c = k / taps, tap = k - c * taps;
        const int r = tap / pr.tw;
        off = c * HW;
        rs = (r << 16) | (tap - r * pr.tw);
      }
      ktab[k] = off;
      ktab[GEN_MAX_K + k] = rs;
    }
    __syncthreads();
  }

  // this thread gathers pixel m0 + ml, k values kg * KPT .. + KPT - 1 of
  // every stage
  const int ml = tid % BM, kg = tid / BM;
  const int m = m0 + ml;
  const bool m_ok = m < M;
  int row0 = 0, col0 = 0;
  const float* src_v = p.in;
  if (m_ok) {
    const int v = m / hw, rem = m - v * hw;
    const int i = rem / pr.wi, j = rem - i * pr.wi;
    row0 = i * p.is - pr.ph;
    col0 = j * p.is - pr.pw;
    src_v = p.in + static_cast<size_t>(v) * p.C * HW;
  }
  // the tap-major walk: the stage's first channel and its tap
  int c0 = 0, tr = 0, ts = 0;

  const int KB = pr.kpad / BK;
  auto load_stage = [&](int slot, int kb) {
    float* a = As + slot * Cfg::A_FLOATS + (kg * KPT) * LDA + ml;
    if (TAP_MAJOR) {
      const int r = row0 + tr, c = col0 + ts;
      const bool ok = m_ok && static_cast<unsigned>(r) < static_cast<unsigned>(p.H) &&
                      static_cast<unsigned>(c) < static_cast<unsigned>(p.W);
      const float* s =
          ok ? src_v + (c0 + kg * KPT) * HW + r * p.W + c : p.in;
      const int step = ok ? HW : 0, bytes = ok ? 4 : 0;
#pragma unroll
      for (int e = 0; e < KPT; ++e) cp_async4(a + e * LDA, s + e * step, bytes);
      c0 += BK;
      if (c0 == p.C) {
        c0 = 0;
        if (++ts == pr.tw) {
          ts = 0;
          ++tr;
        }
      }
    } else {
      const int kbase = kb * BK + kg * KPT;
#pragma unroll
      for (int e = 0; e < KPT; ++e) {
        const int off = ktab[kbase + e], rs = ktab[GEN_MAX_K + kbase + e];
        const int r = row0 + (rs >> 16), c = col0 + (rs & 0xffff);
        const bool ok = m_ok && off >= 0 &&
                        static_cast<unsigned>(r) < static_cast<unsigned>(p.H) &&
                        static_cast<unsigned>(c) < static_cast<unsigned>(p.W);
        cp_async4(a + e * LDA, ok ? src_v + off + r * p.W + c : p.in,
                  ok ? 4 : 0);
      }
    }
    // B: the stage's two k rows of fragments, BN / 8 n tiles each
    const float* wsrc = pr.wpack;
    float* b = Bs + slot * Cfg::B_FLOATS;
    constexpr int CHUNKS = Cfg::B_FLOATS / 4;
    for (int q = tid; q < CHUNKS; q += THREADS) {
      const int ktl = q / (BN / 8 * 32), rem = q - ktl * (BN / 8 * 32);
      cp_async16(b + 4 * q,
                 wsrc + (static_cast<size_t>(kb * 2 + ktl) * (p.npad / 8) +
                         n0 / 8) * 128 + 4 * rem);
    }
  };

  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int wm = (warp % Cfg::WARPS_M) * WM, wn = (warp / Cfg::WARPS_M) * WN;
  float acc[MT][NT][4];
#pragma unroll
  for (int a = 0; a < MT; ++a)
#pragma unroll
    for (int b = 0; b < NT; ++b)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[a][b][q] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KB) load_stage(s, s);
    cp_async_commit();
  }
  for (int kb = 0; kb < KB; ++kb) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int next = kb + STAGES - 1;
    if (next < KB) load_stage(next % STAGES, next);
    cp_async_commit();

    const float* a_s = As + (kb % STAGES) * Cfg::A_FLOATS;
    const float* b_s = Bs + (kb % STAGES) * Cfg::B_FLOATS;
#pragma unroll
    for (int ks = 0; ks < BK / 8; ++ks) {
      uint4 bf[NT];
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        bf[nt] = *reinterpret_cast<const uint4*>(
            b_s + ((ks * (BN / 8) + wn / 8 + nt) * 32 + lane) * 4);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const float* ap = a_s + (ks * 8 + t) * LDA + wm + mt * 16 + g;
        uint32_t ah[4], al[4];
        split(ap[0], ah[0], al[0]);
        split(ap[8], ah[1], al[1]);
        split(ap[4 * LDA], ah[2], al[2]);
        split(ap[4 * LDA + 8], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma3_acc(acc[mt][nt], ah, al, bf[nt]);
      }
    }
  }
  cp_async_wait<0>();

  // epilogue: C fragment rows g, g + 8 are pixels, columns 2t, 2t + 1
  // channels; NCHW stores, 8 neighbouring pixels of a channel per quad row
  const int HWo = p.hout * p.wout;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int mm = m0 + wm + mt * 16 + g + 8 * h;
      if (mm >= M) continue;
      const int v = mm / hw, rem = mm - v * hw;
      const int i = rem / pr.wi, j = rem - i * pr.wi;
      float* o = p.out + static_cast<size_t>(v) * p.N * HWo +
                 (i * p.os + pr.oh) * p.wout + j * p.os + pr.ow;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int n = n0 + wn + nt * 8 + 2 * t + q;
          if (n < p.N)
            o[static_cast<size_t>(n) * HWo] =
                acc[mt][nt][2 * h + q] + (p.bias ? p.bias[n] : 0.f);
        }
      }
    }
  }
}

int bn_for(int n) { return n > 64 ? 128 : n > 32 ? 64 : n > 8 ? 32 : 8; }

// the problems of one launch: their taps, offsets and output grids
struct Plan {
  int nprob;
  int th[MAX_PROBS], tw[MAX_PROBS], ph[MAX_PROBS], pw[MAX_PROBS];
  int hi[MAX_PROBS], wi[MAX_PROBS], oh[MAX_PROBS], ow[MAX_PROBS];
};

// forward: one problem over the output; input gradient: one problem per
// parity of the input pixel (S x S of them)
Plan make_plan(int dgrad, int kh, int kw, int S, int H, int W, int Ho,
               int Wo) {
  Plan pl{};
  if (!dgrad) {
    pl.nprob = 1;
    pl.th[0] = kh, pl.tw[0] = kw, pl.hi[0] = Ho, pl.wi[0] = Wo;
    return pl;
  }
  pl.nprob = S * S;
  for (int a = 0; a < S; ++a)
    for (int b = 0; b < S; ++b) {
      const int q = a * S + b;
      pl.th[q] = (kh - a + S - 1) / S;
      pl.tw[q] = (kw - b + S - 1) / S;
      pl.ph[q] = pl.th[q] > 0 ? pl.th[q] - 1 : 0;
      pl.pw[q] = pl.tw[q] > 0 ? pl.tw[q] - 1 : 0;
      pl.hi[q] = (H - a + S - 1) / S;
      pl.wi[q] = (W - b + S - 1) / S;
      pl.oh[q] = a, pl.ow[q] = b;
    }
  return pl;
}

template <int BM, int BN, int WM, int WN, bool TAP_MAJOR>
cudaError_t launch_conv(Params& p, cudaStream_t stream) {
  using Cfg = Conv<BM, BN, WM, WN, TAP_MAJOR>;
  auto kern = conv_kernel<BM, BN, WM, WN, TAP_MAJOR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::SMEM);
  if (err != cudaSuccess) return err;
  int tiles = 0;
  p.tiles_n = p.npad / BN;
  for (int q = 0; q < p.nprob; ++q) {
    Prob& pr = p.prob[q];
    pr.tile0 = tiles;
    // a problem with no taps is left to run()'s memset: no tiles
    const int m = pr.K > 0 ? p.V * pr.hi * pr.wi : 0;
    tiles += (m + BM - 1) / BM * p.tiles_n;
  }
  if (tiles == 0) return cudaSuccess;
  kern<<<tiles, THREADS, Cfg::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <bool TAP_MAJOR>
cudaError_t launch_by_bn(Params& p, int bn, cudaStream_t stream) {
  switch (bn) {
    case 128: return launch_conv<128, 128, 64, 32, TAP_MAJOR>(p, stream);
    case 64: return launch_conv<256, 64, 64, 32, TAP_MAJOR>(p, stream);
    case 32: return launch_conv<256, 32, 32, 32, TAP_MAJOR>(p, stream);
    default: return launch_conv<256, 8, 32, 8, TAP_MAJOR>(p, stream);
  }
}

// C: the gathered tensor's channels; N: the GEMM's columns
long long wpack_floats(const Plan& pl, int C, int N, bool tap_major) {
  long long total = 0;
  const int npad = round_up(N, bn_for(N));
  for (int q = 0; q < pl.nprob; ++q) {
    const int K = C * pl.th[q] * pl.tw[q];
    total += 2LL * round_up(K, BK) * npad;
  }
  return total;
}

cudaError_t run(int dgrad, const float* in, const float* w, const float* bias,
                float* out, float* wpack, int V, int C, int H, int W, int N,
                int kh, int kw, int S, int hin, int win, int hout, int wout,
                cudaStream_t stream) {
  // forward: in = x [V, C, H, W] (padded), out = y [V, N, hout, wout];
  // input gradient: in = dy [V, C, hin, win] (C = Cout), out = dx [V, N,
  // hout, wout] (N = Cin, the padded input's size)
  const Plan pl = dgrad ? make_plan(1, kh, kw, S, hout, wout, 0, 0)
                        : make_plan(0, kh, kw, S, 0, 0, hout, wout);
  const bool tap_major = C % BK == 0;
  const int bn = bn_for(N);
  Params p{};
  p.in = in, p.out = out, p.bias = bias;
  p.V = V, p.C = C, p.H = dgrad ? hin : H, p.W = dgrad ? win : W;
  p.N = N, p.npad = round_up(N, bn);
  p.hout = hout, p.wout = wout;
  p.is = dgrad ? 1 : S;
  p.os = dgrad ? S : 1;
  p.nprob = pl.nprob;
  float* dst = wpack;
  for (int q = 0; q < pl.nprob; ++q) {
    if (pl.th[q] * pl.tw[q] == 0) {
      // a parity with no taps (a 1x1 kernel at odd pixels): zeros, written
      // once for the whole output, before the kernel writes the others
      const cudaError_t err = cudaMemsetAsync(
          out, 0, sizeof(float) * static_cast<size_t>(V) * N * hout * wout,
          stream);
      if (err != cudaSuccess) return err;
      break;
    }
  }
  for (int q = 0; q < pl.nprob; ++q) {
    Prob& pr = p.prob[q];
    pr.th = pl.th[q], pr.tw = pl.tw[q], pr.ph = pl.ph[q], pr.pw = pl.pw[q];
    pr.hi = pl.hi[q], pr.wi = pl.wi[q], pr.oh = pl.oh[q], pr.ow = pl.ow[q];
    pr.K = C * pr.th * pr.tw;
    pr.kpad = round_up(pr.K, BK);
    if (!tap_major && pr.kpad > GEN_MAX_K) return cudaErrorInvalidValue;
    pr.wpack = dst;
    const int frags = pr.kpad / 8 * (p.npad / 8) * 32;
    if (frags > 0) {
      const int blocks = (frags + 255) / 256;
      conv_pack_kernel<<<blocks, 256, 0, stream>>>(
          w, reinterpret_cast<float4*>(dst), pr.K, pr.kpad, N, p.npad, C,
          dgrad, tap_major, kh, kw, S, pr.th, pr.tw, pl.oh[q], pl.ow[q]);
      const cudaError_t err = cudaGetLastError();
      if (err != cudaSuccess) return err;
    }
    dst += 2LL * pr.kpad * p.npad;
  }
  return tap_major ? launch_by_bn<true>(p, bn, stream)
                   : launch_by_bn<false>(p, bn, stream);
}

}  // namespace

extern "C" {

// floats of the packed weights of one call: forward (dgrad 0) of a
// convolution with C inputs, N outputs, or its input gradient (dgrad 1)
long long conv2d_wpack_floats(int dgrad, int cin, int cout, int kh, int kw,
                              int S) {
  const Plan pl = make_plan(dgrad, kh, kw, S, 1, 1, 1, 1);
  return dgrad ? wpack_floats(pl, cout, cin, cout % BK == 0)
               : wpack_floats(pl, cin, cout, cin % BK == 0);
}

// y [V, N, Ho, Wo] = x [V, C, H, W] (already padded) correlated with w [N,
// C, kh, kw] at stride S, plus bias [N] (or null); wpack: scratch of
// conv2d_wpack_floats(0, ...) floats. Returns a cudaError_t:
// cudaErrorInvalidValue where C is not a multiple of BK and the padded K
// exceeds GEN_MAX_K (the gather table).
int conv2d_forward(const float* x, const float* w, const float* bias,
                   float* y, float* wpack, int V, int C, int H, int W, int N,
                   int kh, int kw, int S, int Ho, int Wo, void* stream) {
  return static_cast<int>(run(0, x, w, bias, y, wpack, V, C, H, W, N, kh, kw,
                              S, 0, 0, Ho, Wo,
                              static_cast<cudaStream_t>(stream)));
}

// dx [V, C, H, W], the gradient of conv2d_forward's (padded) input, from dy
// [V, N, Ho, Wo] and w [N, C, kh, kw]; every entry of dx is written.
int conv2d_input_grad(const float* dy, const float* w, float* dx,
                      float* wpack, int V, int N, int Ho, int Wo, int C,
                      int kh, int kw, int S, int H, int W, void* stream) {
  return static_cast<int>(run(1, dy, w, nullptr, dx, wpack, V, N, 0, 0, C,
                              kh, kw, S, Ho, Wo, H, W,
                              static_cast<cudaStream_t>(stream)));
}

}  // extern "C"
