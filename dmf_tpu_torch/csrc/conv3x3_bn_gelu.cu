// Fused 3x3 conv (stride 1, pad 1) + inference BatchNorm + exact GELU, NHWC.
//
// Replaces the TPU kernels `_conv_kernel` (dmf_tpu/ops/conv3x3_pallas.py:217)
// and `_conv_kernel_t` (:146), reached through `conv3x3_bn_gelu` (:270).
//
// An implicit GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin.  The K
// loop walks the nine taps and, inside each tap, Cin in chunks of BK; a
// tap's K slice of an NHWC pixel is contiguous, and zero padding is handled
// in the gather (out-of-image taps load zeros).  Accumulation is fp32; the
// epilogue applies out = gelu(acc * s + t), with s = gamma/sqrt(var+eps)
// and t = (bias - mean)*s + beta folded by the wrapper, and rounds once.
//
// What bounds it on the card: at the neck geometries (K = 1152..27648,
// Cout 128/256) the GEMM does 100-1000 FLOP per byte of input, above the
// H100's ridge, so it is compute bound and the tensor cores decide:
//   * bf16: 128x64 block tile, 8 warps each computing 32x32 with WMMA
//     16x16x16 bf16 fragments (mma.sync on the tensor cores), fp32 accum;
//   * fp32: the same tiling on the CUDA cores (SIMT), 8x4 outputs per
//     thread, so fp32 results carry no TF32 rounding.
// Both stage the A (pixels x channels) and B (channels x Cout) tiles through
// shared memory with plain synchronous loads.  wgmma, TMA and a multi-stage
// pipeline are later work.
//
// Deliberately not carried over from the TPU: the (H, W, B, C) layout
// variant, the whole-map-in-VMEM blocks and their batch-tile budgets.
//
// Plain C interface for ctypes: conv3x3_bn_gelu_launch returns
// cudaGetLastError() after the launch.  Offsets are 32-bit: the wrapper
// rejects maps of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int BN = 64;   // output channels per block
constexpr int BK = 32;   // input channels per K step (within one tap)
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
  // A^T tile (channel-major, padded by one column against bank conflicts on
  // the channel-fastest stores) and B tile
  __shared__ float As[BK][BM + 1];
  __shared__ float Bs[BK][BN];
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
        const int kk = e / BN, nn = e % BN;
        const int ck = c0 + kk, n = n0 + nn;
        Bs[kk][nn] = (ck < Cin && n < Cout) ? w[(tap * Cin + ck) * Cout + n] : 0.f;
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

// ----------------------------------------------------------- bf16 tensor core
// 8 warps as 4 (pixels) x 2 (channels); each warp owns a 32x32 output tile of
// 2x2 WMMA fragments.  A is gathered 8 channels (16 bytes) at a time, so Cin
// and Cout must be multiples of 8 (the wrapper checks).
constexpr int LDA = BK + 8;  // bf16 row pitch of the A tile (80 bytes)
constexpr int LDB = BN + 8;  // bf16 row pitch of the B tile (144 bytes)
constexpr int LDC = BN + 4;  // fp32 row pitch of the staged output tile
constexpr int AB_BYTES = (BM * LDA + BK * LDB) * 2;
constexpr int C_BYTES = BM * LDC * 4;
constexpr int SMEM_BYTES = AB_BYTES > C_BYTES ? AB_BYTES : C_BYTES;

__global__ void __launch_bounds__(THREADS)
conv3x3_bn_gelu_bf16(const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w,
                     const float* __restrict__ scale,
                     const float* __restrict__ shift,
                     __nv_bfloat16* __restrict__ out,
                     int N, int H, int W, int Cin, int Cout) {
  using namespace nvcuda;
  // the operand tiles and the staged fp32 output share one buffer
  __shared__ __align__(128) unsigned char smem[SMEM_BYTES];
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem);  // [BM][LDA]
  __nv_bfloat16* Bs = As + BM * LDA;                            // [BK][LDB]
  float* Cs = reinterpret_cast<float*>(smem);                   // [BM][LDC]

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int wm = warp % 4, wn = warp / 4;
  const int M = N * H * W;
  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  // A gather: 4 threads per pixel row (8 channels each), 64 rows per sweep
  const int a_cg = (tid % 4) * 8;
  const int a_row = tid / 4;
  const int hw0 = pixel_hw(m0 + a_row, M, H, W);
  const int hw1 = pixel_hw(m0 + a_row + 64, M, H, W);
  // B gather: one 8-channel vector per thread
  const int b_k = tid / 8;
  const int b_n = (tid % 8) * 8;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const uint4 zero = make_uint4(0, 0, 0, 0);
  for (int tap = 0; tap < 9; ++tap) {
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int delta = dy * W + dx;
    const bool in0 = tap_inside(hw0, dy, dx, H, W);
    const bool in1 = tap_inside(hw1, dy, dx, H, W);
    for (int c0 = 0; c0 < Cin; c0 += BK) {
      const int c = c0 + a_cg;
      const bool cok = c < Cin;
      uint4 v0 = zero, v1 = zero;
      if (in0 && cok)
        v0 = *reinterpret_cast<const uint4*>(x + (m0 + a_row + delta) * Cin + c);
      if (in1 && cok)
        v1 = *reinterpret_cast<const uint4*>(x + (m0 + a_row + 64 + delta) * Cin + c);
      *reinterpret_cast<uint4*>(As + a_row * LDA + a_cg) = v0;
      *reinterpret_cast<uint4*>(As + (a_row + 64) * LDA + a_cg) = v1;
      const int ck = c0 + b_k, n = n0 + b_n;
      uint4 vb = zero;
      if (ck < Cin && n < Cout)
        vb = *reinterpret_cast<const uint4*>(w + (tap * Cin + ck) * Cout + n);
      *reinterpret_cast<uint4*>(Bs + b_k * LDB + b_n) = vb;
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], As + (wm * 32 + i * 16) * LDA + kk, LDA);
#pragma unroll
        for (int j = 0; j < 2; ++j)
          wmma::load_matrix_sync(fb[j], Bs + kk * LDB + wn * 32 + j * 16, LDB);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  // stage the fp32 tile through shared memory, then BN + GELU + one rounding
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 2; ++j)
      wmma::store_matrix_sync(Cs + (wm * 32 + i * 16) * LDC + wn * 32 + j * 16,
                              acc[i][j], LDC, wmma::mem_row_major);
  __syncthreads();
  for (int e = tid; e < BM * BN; e += THREADS) {
    const int r = e / BN, cn = e % BN;
    const int m = m0 + r, n = n0 + cn;
    if (m < M && n < Cout)
      out[m * Cout + n] = __float2bfloat16(gelu_erf(Cs[r * LDC + cn] * scale[n] + shift[n]));
  }
}

}  // namespace

extern "C" int conv3x3_bn_gelu_launch(int is_bf16, const void* x, const void* w,
                                      const void* scale, const void* shift,
                                      void* out, int N, int H, int W, int Cin,
                                      int Cout, void* stream) {
  const int M = N * H * W;
  const dim3 grid((M + BM - 1) / BM, (Cout + BN - 1) / BN);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16) {
    conv3x3_bn_gelu_bf16<<<grid, THREADS, 0, s>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<__nv_bfloat16*>(out), N, H, W, Cin, Cout);
  } else {
    conv3x3_bn_gelu_f32<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<const float*>(scale), static_cast<const float*>(shift),
        static_cast<float*>(out), N, H, W, Cin, Cout);
  }
  return static_cast<int>(cudaGetLastError());
}
