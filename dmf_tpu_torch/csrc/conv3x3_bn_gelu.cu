// Fused 3x3 conv (stride 1, pad 1) + inference BatchNorm + exact GELU, NHWC.
//
// Replaces the TPU kernels `_conv_kernel` (dmf_tpu/ops/conv3x3_pallas.py:217)
// and `_conv_kernel_t` (:146), reached through `conv3x3_bn_gelu` (:270).
//
// An implicit GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin.  The K
// loop walks the nine taps and, inside each tap, Cin in chunks of BK; a
// tap's K slice of an NHWC pixel is contiguous, and zero padding is handled
// in the gather (out-of-image taps load zeros).  The weights come as a
// K-major (Cout, 9*Cin) matrix (column k = tap*Cin + c), prepared once per
// parameter set by the wrapper.  Accumulation is fp32; the epilogue applies
// out = gelu(acc * s + t), with s = gamma/sqrt(var+eps) and t = (bias -
// mean)*s + beta folded by the wrapper, and rounds once.
//
// What bounds it on the card: at the neck geometries (K = 1152..27648,
// Cout 128/256) the GEMM does 100-1000 FLOP per byte of input, above the
// H100's ridge, so it is compute bound and the tensor cores decide.
//   * bf16 (conv3x3_bn_gelu_wgmma): a block tile of 128 pixels x BN
//     channels (BN = 128 or 256) on two warpgroups of m64 wgmma, K steps of
//     64 channels of one tap (one 128-byte swizzle atom per row), over a
//     four-stage shared-memory ring: the weight tile is TMA-loaded (a 3-D
//     tensor map over (Cout, 9, Cin), so channels past Cin and rows past
//     Cout read zeros), the pixel tile is gathered with 16-byte cp.async
//     into the swizzled layout (zero-fill for taps outside the image and
//     channels past Cin).  Loads run two steps ahead and one wgmma group
//     stays in flight across the step's barrier.  The accumulator and the
//     BN + GELU epilogue stay in registers; the output is stored NHWC.
//   * fp32 (conv3x3_bn_gelu_f32): 128x64 tiles on the CUDA cores (SIMT),
//     8x4 outputs per thread, synchronous loads, so fp32 results carry no
//     TF32 rounding.
//
// Deliberately not carried over from the TPU: the (H, W, B, C) layout
// variant, the whole-map-in-VMEM blocks and their batch-tile budgets.
//
// Plain C interface for ctypes: conv3x3_bn_gelu_launch returns
// cudaGetLastError() after the launch (or the error of setting the
// shared-memory size or of encoding the tensor map).  Offsets are 32-bit:
// the wrapper rejects maps of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block (fp32)
constexpr int BK = 32;   // input channels per K step (fp32, within one tap)
constexpr int THREADS = 256;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// Packs the (h, w) of output pixel m, or -1 past the last pixel.
__device__ __forceinline__ int pixel_hw(int m, int M, int H, int W) {
  if (m >= M) return -1;
  const int w = m % W;
  const int h = (m / W) % H;
  return (h << 16) | w;
}

__device__ __forceinline__ bool tap_inside(int hw, int dy, int dx, int H, int W) {
  if (hw < 0) return false;
  const int ih = (hw >> 16) + dy;
  const int iw = (hw & 0xffff) + dx;
  return ih >= 0 && ih < H && iw >= 0 && iw < W;
}

// ---------------------------------------------------------------- fp32 SIMT
constexpr int TM = 8;  // pixels per thread
constexpr int TN = 4;  // channels per thread
constexpr int A_ROWS = THREADS / BK;         // 8 pixel rows per load sweep
constexpr int A_ITERS = BM / A_ROWS;         // 16 sweeps
constexpr int B_ITERS = BK * BN / THREADS;   // 8

__global__ void __launch_bounds__(THREADS)
conv3x3_bn_gelu_f32(const float* __restrict__ x, const float* __restrict__ w,
                    const float* __restrict__ scale,
                    const float* __restrict__ shift, float* __restrict__ out,
                    int N, int H, int W, int Cin, int Cout) {
  // A^T tile and B tile, channel-major, each padded by one column against
  // bank conflicts on the channel-fastest stores
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN + 1];
  const int tid = threadIdx.x;
  const int M = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int a_c = tid % BK;    // channel this thread gathers
  const int a_row = tid / BK;  // first pixel row it gathers
  const int tx = tid % (BN / TN);
  const int ty = tid / (BN / TN);

  int hw[A_ITERS];
#pragma unroll
  for (int i = 0; i < A_ITERS; ++i) hw[i] = pixel_hw(m0 + a_row + i * A_ROWS, M, H, W);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int delta = dy * W + dx;  // pixel offset of this tap
    unsigned inside = 0;
#pragma unroll
    for (int i = 0; i < A_ITERS; ++i)
      if (tap_inside(hw[i], dy, dx, H, W)) inside |= 1u << i;
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + a_c;
#pragma unroll
      for (int i = 0; i < A_ITERS; ++i) {
        const int ml = a_row + i * A_ROWS;
        float v = 0.f;
        if (((inside >> i) & 1u) && c < Cin) v = x[(m0 + ml + delta) * Cin + c];
        As[a_c][ml] = v;
      }
#pragma unroll
      for (int i = 0; i < B_ITERS; ++i) {
        const int e = tid + i * THREADS;
        const int kk = e % BK, nn = e / BK;  // a warp reads 32 channels of one row
        const int ck = c0 + kk, n = n0 + nn;
        Bs[kk][nn] = (ck < Cin && n < Cout) ? w[(n * 9 + tap) * Cin + ck] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty * TM + i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx * TN + j;
      if (n < Cout) out[m * Cout + n] = gelu_erf(acc[i][j] * scale[n] + shift[n]);
    }
  }
}

// ----------------------------------------------------------- bf16 wgmma
constexpr int WBK = 64;     // input channels per K step: one 128-byte row per pixel
constexpr int STAGES = 4;   // ring depth; loads run STAGES - 2 steps ahead
constexpr int SMEM_MAX = 232448;

template <int TILE_N>
struct WgSmem {
  static constexpr int A_BYTES = BM * WBK * 2;      // 128 pixel rows x 128 B
  static constexpr int B_BYTES = TILE_N * WBK * 2;  // TILE_N weight rows x 128 B
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * STAGES + 1024;  // + alignment slack
};
static_assert(WgSmem<256>::BYTES <= SMEM_MAX, "conv wgmma shared memory");

template <int TILE_N>
__device__ __forceinline__ void tile_product(float (&acc)[TILE_N / 2], uint64_t a, uint64_t b);
template <>
__device__ __forceinline__ void tile_product<128>(float (&acc)[64], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n128k16_ss(acc, a, b, 1);
}
template <>
__device__ __forceinline__ void tile_product<256>(float (&acc)[128], uint64_t a, uint64_t b) {
  hopper::wgmma_m64n256k16_ss(acc, a, b, 1);
}

template <int TILE_N>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bn_gelu_wgmma(const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, __nv_bfloat16* __restrict__ out,
                      int N, int H, int W, int Cin, int Cout) {
  using namespace hopper;
  using L = WgSmem<TILE_N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  const int tid = threadIdx.x, wgi = tid / 128;
  const int M = N * H * W;
  // neighbouring blocks share their pixels (channel tiles innermost), so a
  // map's second read of a pixel tile finds it in L2
  const int ntn = (Cout + TILE_N - 1) / TILE_N;
  const int n0 = (blockIdx.x % ntn) * TILE_N;
  const int m0 = (blockIdx.x / ntn) * BM;
  const int kc = (Cin + WBK - 1) / WBK;  // K steps per tap
  const int kt_total = 9 * kc;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
  }
  __syncthreads();

  // the A gather: this thread's 16-byte chunk j of pixel rows tid/8 + 32i
  const int j = tid % 8;
  int ph[4], pw[4];
  bool pin[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + tid / 8 + 32 * i;
    pin[i] = m < M;
    pw[i] = m % W;
    ph[i] = (m / W) % H;
  }
  auto load = [&](int kt) {
    const int s = kt % STAGES;
    unsigned char* a = smem + s * L::STAGE;
    const int tap = kt / kc, c0 = (kt % kc) * WBK;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int c = c0 + j * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + 32 * i;
      const int ih = ph[i] + dy, iw = pw[i] + dx;
      const bool ok = pin[i] && c < Cin && ih >= 0 && ih < H && iw >= 0 && iw < W;
      cp_async_16(a + sw128(r, j), ok ? x + (m0 + r + dy * W + dx) * Cin + c : x, ok);
    }
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[s], L::B_BYTES);
      tma_load_3d(a + L::A_BYTES, &wmap, &full[s], c0, tap, n0);
    }
  };

  float acc[TILE_N / 2];
#pragma unroll
  for (int i = 0; i < TILE_N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < STAGES - 2; ++kt) {
    if (kt < kt_total) load(kt);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_total; ++kt) {
    const int s = kt % STAGES;
    cp_async_wait<STAGES - 3>();  // this thread's part of step kt has landed
    fence_proxy_async();
    mbar_wait(&full[s], (kt / STAGES) & 1);
    // every thread's gather of step kt is visible, and every warpgroup's
    // wgmma of step kt - 2 is done: its stage may be refilled
    __syncthreads();
    if (kt + STAGES - 2 < kt_total) load(kt + STAGES - 2);
    cp_async_commit();
    const unsigned char* a = smem + s * L::STAGE + wgi * 64 * 128;
    const unsigned char* b = smem + s * L::STAGE + L::A_BYTES;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < WBK / 16; ++kk)
      tile_product<TILE_N>(acc, desc_sw128(a + kk * 32, 16, 1024),
                           desc_sw128(b + kk * 32, 16, 1024));
    wgmma_commit();
    wgmma_wait<1>();  // step kt - 1 is done; step kt stays in flight
    fence_regs(acc);
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // epilogue on the registers: gelu(acc * s + t), one rounding, NHWC stores
  const int lane = tid % 32;
  const int row = m0 + wgi * 64 + ((tid % 128) / 32) * 16 + lane / 4;
#pragma unroll
  for (int jn = 0; jn < TILE_N / 8; ++jn) {
    const int col = n0 + jn * 8 + (lane % 4) * 2;
    if (col >= Cout) continue;  // Cout is a multiple of 8: col + 1 < Cout too
    const float2 sc = *reinterpret_cast<const float2*>(scale + col);
    const float2 sh = *reinterpret_cast<const float2*>(shift + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = row + 8 * h;
      if (m < M)
        *reinterpret_cast<uint32_t*>(out + m * Cout + col) =
            pack_bf16(gelu_erf(acc[4 * jn + 2 * h] * sc.x + sh.x),
                      gelu_erf(acc[4 * jn + 2 * h + 1] * sc.y + sh.y));
    }
  }
}

template <int TILE_N>
int launch_wgmma(const void* x, const void* w, const void* scale, const void* shift, void* out,
                 int N, int H, int W, int Cin, int Cout, cudaStream_t s) {
  // the weights as dims {Cin, 9, Cout}: boxes of 64 channels x 1 tap x TILE_N rows
  CUtensorMap wmap;
  cudaError_t e = hopper::tensor_map_3d(&wmap, w, Cin, 9, Cout, Cin * 2ull, 9ull * Cin * 2,
                                        WBK, 1, TILE_N);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = WgSmem<TILE_N>::BYTES;
  e = cudaFuncSetAttribute(conv3x3_bn_gelu_wgmma<TILE_N>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int M = N * H * W;
  const int blocks = ((M + BM - 1) / BM) * ((Cout + TILE_N - 1) / TILE_N);
  conv3x3_bn_gelu_wgmma<TILE_N><<<blocks, THREADS, bytes, s>>>(
      wmap, static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(scale),
      static_cast<const float*>(shift), static_cast<__nv_bfloat16*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int conv3x3_bn_gelu_launch(int is_bf16, const void* x, const void* w,
                                      const void* scale, const void* shift,
                                      void* out, int N, int H, int W, int Cin,
                                      int Cout, int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    if (tile_n == 256)
      return launch_wgmma<256>(x, w, scale, shift, out, N, H, W, Cin, Cout, s);
    if (tile_n == 128)
      return launch_wgmma<128>(x, w, scale, shift, out, N, H, W, Cin, Cout, s);
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  conv3x3_bn_gelu_f32<<<grid, THREADS, 0, s>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<const float*>(scale), static_cast<const float*>(shift),
      static_cast<float*>(out), N, H, W, Cin, Cout);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory of the bf16 kernel at channel tile tile_n, for build reports.
extern "C" int conv3x3_bn_gelu_wgmma_smem(int tile_n) {
  return tile_n == 256 ? WgSmem<256>::BYTES : tile_n == 128 ? WgSmem<128>::BYTES : -1;
}
