// Fused 3x3 conv (stride 1, pad 1) + inference BatchNorm + exact GELU, NHWC.
//
// Replaces the TPU kernels `_conv_kernel` (dmf_tpu/ops/conv3x3_pallas.py:217)
// and `_conv_kernel_t` (:146), reached through `conv3x3_bn_gelu` (:270).
//
// An implicit GEMM: M = N*H*W output pixels, N = Cout, K = 9*Cin.  The K
// loop walks the nine taps and, inside each tap, Cin in steps of one
// 128-byte row (64 bf16 or 32 fp32 channels); a tap's K slice of an NHWC
// pixel is contiguous, and zero padding is handled in the gather
// (out-of-image taps load zeros).  The weights come as a K-major (Cout,
// 9*Cin) matrix (column k = tap*Cin + c), prepared once per parameter set by
// the wrapper.  Accumulation is fp32; the epilogue applies out = gelu(acc *
// s + t), with s = gamma/sqrt(var+eps) and t = (bias - mean)*s + beta folded
// by the wrapper, and rounds once.
//
// One kernel for both dtypes, on the tensor cores: a block tile of 128
// pixels x TILE_N channels on two warpgroups of m64 wgmma, over a
// shared-memory ring.  The weight tiles are TMA-loaded (3-D tensor maps over
// (Cout, 9, Cin), so channels past Cin and rows past Cout read zeros), the
// pixel tile is gathered with 16-byte cp.async into the swizzled layout
// (zero-fill for taps outside the image and channels past Cin).  Loads run
// STAGES - 2 steps ahead and one wgmma group stays in flight across the
// step's barrier.  The accumulator and the BN + GELU epilogue stay in
// registers; the output is stored NHWC.
//   * bf16: TILE_N = 128 or 256, four stages, one k16 wgmma per 32 bytes of K.
//   * fp32 (3xTF32): the tensor cores take fp32 only as TF32 (10 mantissa
//     bits, relative error ~2^-11 per operand), which at K = 27648 lands
//     above the fp32 tolerance and is not the JAX reference's fp32 numerics.
//     So each operand is split into hi = tf32(a) and lo = tf32(a - hi), and
//     every k8 step issues three products, hi*hi + hi*lo + lo*hi (dropping
//     lo*lo, ~2^-22 relative): fp32-class products at a third of the TF32
//     rate.  The weights come split (W_hi, W_lo, two tensor maps); each
//     thread splits its own gathered pixel chunks once they land, hi in place
//     and lo into a second tile at the same swizzled offset.  The tensor
//     cores' own accumulation is coarser than an fp32 sum, so a step's
//     products go into a fresh accumulator that is added into the fp32 sum
//     once its group is done.  The two accumulators (2 x 64 registers) fit
//     at TILE_N = 128 only; a stage holds four 128-row tiles (A_hi, A_lo,
//     B_hi, B_lo), 64 KB, three stages.
//
// What bounds it on the card: at the neck geometries (K = 1152..27648,
// Cout 128/256) the GEMM does 100-1000 FLOP per byte of input, above the
// H100's ridge, so the tensor-core operations bound it: 2*M*K*Cout at 989
// TFLOP/s in bf16, three times that at 495 TFLOP/s in 3xTF32.  Each block
// streams its whole K slice of the weights (both halves in fp32) through L2.
//
// Deterministic: no split-K, one block per output tile, a fixed K order; two
// calls give the same bits.
//
// Deliberately not carried over from the TPU: the (H, W, B, C) layout
// variant, the whole-map-in-VMEM blocks and their batch-tile budgets.
//
// Plain C interface for ctypes: conv3x3_bn_gelu_launch returns
// cudaGetLastError() after the launch (or the error of setting the
// shared-memory size or of encoding the tensor maps).  Offsets are 32-bit:
// the wrapper rejects maps of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;  // output pixels per block
constexpr int THREADS = 256;
constexpr int SMEM_MAX = 232448;

__device__ __forceinline__ float gelu_erf(float v) {
  return 0.5f * v * (1.0f + erff(v * 0.70710678118654752f));
}

// The shared-memory ring of element type T at channel tile TILE_N (3xTF32:
// 128 only, see conv_tile).
template <typename T, int TILE_N>
struct Ring {
  static constexpr bool TF32 = sizeof(T) == 4;
  static_assert(!TF32 || TILE_N == 128, "3xTF32 holds a step's accumulator beside the sum");
  static constexpr int KC = 128 / sizeof(T);  // channels per K step: one 128-byte row
  static constexpr int CHUNK = 16 / sizeof(T);  // channels per 16-byte chunk
  static constexpr int HALVES = TF32 ? 2 : 1;   // hi (and lo) of each operand
  static constexpr int A_BYTES = BM * 128;      // 128 pixel rows x 128 B
  static constexpr int B_BYTES = TILE_N * 128;  // TILE_N weight rows x 128 B
  static constexpr int B_OFF = HALVES * A_BYTES;
  static constexpr int STAGE = HALVES * (A_BYTES + B_BYTES);
  static constexpr int STAGES = TF32 ? 3 : 4;
  static constexpr int AHEAD = 2;  // steps the loads run ahead of the wgmma
  static constexpr int BAR_OFF = STAGES * STAGE;
  static constexpr int BYTES = BAR_OFF + 8 * STAGES + 1024;  // + alignment slack
  static_assert(BYTES <= SMEM_MAX, "conv wgmma shared memory");
};

// acc += A B over one 128-byte K row of a stage (four k16 or k8 steps): one
// product in bf16; in 3xTF32 three (hi*hi + hi*lo + lo*hi), into an acc that
// the first product overwrites (a step's own accumulator).
template <typename T, int TILE_N>
__device__ __forceinline__ void row_product(float (&acc)[TILE_N / 2], const unsigned char* a,
                                            const unsigned char* b) {
  using namespace hopper;
  using L = Ring<T, TILE_N>;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t ah = desc_sw128(a + kk * 32, 16, 1024);
    const uint64_t bh = desc_sw128(b + kk * 32, 16, 1024);
    const int add = kk > 0 || !L::TF32;
    if constexpr (L::TF32) {
      wgmma_m64n128k8_tf32_ss(acc, ah, bh, add);
      wgmma_m64n128k8_tf32_ss(acc, ah, desc_sw128(b + L::B_BYTES + kk * 32, 16, 1024), 1);
      wgmma_m64n128k8_tf32_ss(acc, desc_sw128(a + L::A_BYTES + kk * 32, 16, 1024), bh, 1);
    } else if constexpr (TILE_N == 256) {
      wgmma_m64n256k16_ss(acc, ah, bh, add);
    } else {
      wgmma_m64n128k16_ss(acc, ah, bh, add);
    }
  }
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b);
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store2<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = hopper::pack_bf16(a, b);
}

// One block's output tile; wmap_lo (the weights' lo half) is read in 3xTF32 only.
template <typename T, int TILE_N>
__device__ __forceinline__ void conv_tile(const CUtensorMap& wmap, const CUtensorMap& wmap_lo,
                                          const T* __restrict__ x,
                                          const float* __restrict__ scale,
                                          const float* __restrict__ shift, T* __restrict__ out,
                                          int N, int H, int W, int Cin, int Cout) {
  using namespace hopper;
  using L = Ring<T, TILE_N>;
  constexpr int STAGES = L::STAGES, AHEAD = L::AHEAD;
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
  const int kc = (Cin + L::KC - 1) / L::KC;  // K steps per tap
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
    const int tap = kt / kc, c0 = (kt % kc) * L::KC;
    const int dy = tap / 3 - 1, dx = tap % 3 - 1;
    const int c = c0 + j * L::CHUNK;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 8 + 32 * i;
      const int ih = ph[i] + dy, iw = pw[i] + dx;
      const bool ok = pin[i] && c < Cin && ih >= 0 && ih < H && iw >= 0 && iw < W;
      cp_async_16(a + sw128(r, j), ok ? x + (m0 + r + dy * W + dx) * Cin + c : x, ok);
    }
    if (tid == 0) {
      mbar_arrive_expect_tx(&full[s], L::HALVES * L::B_BYTES);
      tma_load_3d(a + L::B_OFF, &wmap, &full[s], c0, tap, n0);
      if constexpr (L::TF32)
        tma_load_3d(a + L::B_OFF + L::B_BYTES, &wmap_lo, &full[s], c0, tap, n0);
    }
  };
  // 3xTF32: this thread's landed chunks of stage s become hi in place and lo
  // in the A_lo tile, at the same swizzled offsets
  auto split = [&](int s) {
    unsigned char* a = smem + s * L::STAGE;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = sw128(tid / 8 + 32 * i, j);
      const float4 v = *reinterpret_cast<const float4*>(a + off);
      const float4 hi = make_float4(tf32_rna(v.x), tf32_rna(v.y), tf32_rna(v.z), tf32_rna(v.w));
      *reinterpret_cast<float4*>(a + off) = hi;
      *reinterpret_cast<float4*>(a + L::A_BYTES + off) =
          make_float4(tf32_rna(v.x - hi.x), tf32_rna(v.y - hi.y), tf32_rna(v.z - hi.z),
                      tf32_rna(v.w - hi.w));
    }
  };

  const int a_off = wgi * 64 * 128;  // this warpgroup's 64 pixel rows
  float acc[TILE_N / 2];
#pragma unroll
  for (int i = 0; i < TILE_N / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int kt = 0; kt < AHEAD; ++kt) {
    if (kt < kt_total) load(kt);
    cp_async_commit();
  }
  if constexpr (!L::TF32) {
    for (int kt = 0; kt < kt_total; ++kt) {
      const int s = kt % STAGES;
      cp_async_wait<AHEAD - 1>();  // this thread's part of step kt has landed
      fence_proxy_async();
      mbar_wait(&full[s], (kt / STAGES) & 1);
      // every thread's gather of step kt is visible, and every warpgroup's
      // wgmma of step kt - 2 is done: its stage may be refilled
      __syncthreads();
      if (kt + AHEAD < kt_total) load(kt + AHEAD);
      cp_async_commit();
      const unsigned char* st = smem + s * L::STAGE;
      fence_regs(acc);
      wgmma_fence();
      row_product<T, TILE_N>(acc, st + a_off, st + L::B_OFF);
      wgmma_commit();
      wgmma_wait<1>();  // step kt - 1 is done; step kt stays in flight
      fence_regs(acc);
    }
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    // The tensor cores round each addition into their accumulator more
    // coarsely than an fp32 add: one accumulator over the thousands of
    // additions of K = 27648 missed the fp32 tolerance.  So each step's
    // products go into an accumulator of their own, started afresh, which is
    // added into acc in fp32 once the step's group is done.  While a step's
    // group runs, the threads split the next step's pixels and the loads of
    // the step after it are in flight.
    auto ready = [&](int kt) {  // step kt landed, split and handed to the async proxy
      const int s = kt % STAGES;
      cp_async_wait<AHEAD - 1>();
      split(s);
      fence_proxy_async();
      mbar_wait(&full[s], (kt / STAGES) & 1);
    };
    float part[TILE_N / 2];
#pragma unroll
    for (int i = 0; i < TILE_N / 2; ++i) part[i] = 0.f;
    ready(0);
    __syncthreads();
    for (int kt = 0; kt < kt_total; ++kt) {
      const unsigned char* st = smem + (kt % STAGES) * L::STAGE;
      fence_regs(part);
      wgmma_fence();
      row_product<T, TILE_N>(part, st + a_off, st + L::B_OFF);
      wgmma_commit();
      // the stage of step kt - 1, whose group every warpgroup finished before
      // the last barrier
      if (kt + AHEAD < kt_total) load(kt + AHEAD);
      cp_async_commit();
      if (kt + 1 < kt_total) ready(kt + 1);
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int i = 0; i < TILE_N / 2; ++i) acc[i] += part[i];
      // step kt + 1 is split in every thread, step kt's group done in every
      // warpgroup
      __syncthreads();
    }
  }

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
        store2(out + m * Cout + col, gelu_erf(acc[4 * jn + 2 * h] * sc.x + sh.x),
               gelu_erf(acc[4 * jn + 2 * h + 1] * sc.y + sh.y));
    }
  }
}

// The kernels (one name per dtype, as the profiler reports them)
template <int TILE_N>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bn_gelu_wgmma(const __grid_constant__ CUtensorMap wmap,
                      const __nv_bfloat16* __restrict__ x, const float* __restrict__ scale,
                      const float* __restrict__ shift, __nv_bfloat16* __restrict__ out, int N,
                      int H, int W, int Cin, int Cout) {
  conv_tile<__nv_bfloat16, TILE_N>(wmap, wmap, x, scale, shift, out, N, H, W, Cin, Cout);
}

template <int TILE_N>
__global__ void __launch_bounds__(THREADS, 1)
conv3x3_bn_gelu_tf32x3(const __grid_constant__ CUtensorMap w_hi,
                       const __grid_constant__ CUtensorMap w_lo, const float* __restrict__ x,
                       const float* __restrict__ scale, const float* __restrict__ shift,
                       float* __restrict__ out, int N, int H, int W, int Cin, int Cout) {
  conv_tile<float, TILE_N>(w_hi, w_lo, x, scale, shift, out, N, H, W, Cin, Cout);
}

// Sets the kernel's dynamic shared memory and launches it on `s`.
template <typename Kernel, typename... Args>
int launch_kernel(Kernel* kernel, int blocks, int bytes, cudaStream_t s, Args... args) {
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<blocks, THREADS, bytes, s>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int TILE_N>
int launch_wgmma(const void* x, const void* w, const void* w_lo, const void* scale,
                 const void* shift, void* out, int N, int H, int W, int Cin, int Cout,
                 cudaStream_t s) {
  using L = Ring<T, TILE_N>;
  // the weights as dims {Cin, 9, Cout}: boxes of one 128-byte row of channels
  // x 1 tap x TILE_N rows
  const CUtensorMapDataType type =
      L::TF32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  constexpr uint64_t es = sizeof(T);
  CUtensorMap wmap, wmap_lo;
  cudaError_t e = hopper::tensor_map_3d(&wmap, w, Cin, 9, Cout, Cin * es, 9ull * Cin * es,
                                        L::KC, 1, TILE_N, type);
  if (e != cudaSuccess) return static_cast<int>(e);
  if constexpr (L::TF32) {
    e = hopper::tensor_map_3d(&wmap_lo, w_lo, Cin, 9, Cout, Cin * es, 9ull * Cin * es, L::KC,
                              1, TILE_N, type);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const int M = N * H * W;
  const int blocks = ((M + BM - 1) / BM) * ((Cout + TILE_N - 1) / TILE_N);
  const T* xt = static_cast<const T*>(x);
  const float* sc = static_cast<const float*>(scale);
  const float* sh = static_cast<const float*>(shift);
  T* o = static_cast<T*>(out);
  if constexpr (L::TF32)
    return launch_kernel(conv3x3_bn_gelu_tf32x3<TILE_N>, blocks, L::BYTES, s, wmap, wmap_lo, xt,
                         sc, sh, o, N, H, W, Cin, Cout);
  else
    return launch_kernel(conv3x3_bn_gelu_wgmma<TILE_N>, blocks, L::BYTES, s, wmap, xt, sc, sh,
                         o, N, H, W, Cin, Cout);
}

template <typename T>
int launch_tile(int tile_n, const void* x, const void* w, const void* w_lo, const void* scale,
                const void* shift, void* out, int N, int H, int W, int Cin, int Cout,
                cudaStream_t s) {
  if (tile_n == 128)
    return launch_wgmma<T, 128>(x, w, w_lo, scale, shift, out, N, H, W, Cin, Cout, s);
  if constexpr (!Ring<T, 128>::TF32)
    if (tile_n == 256)
      return launch_wgmma<T, 256>(x, w, w_lo, scale, shift, out, N, H, W, Cin, Cout, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// w is the K-major weight matrix (bf16), or its TF32 hi half (fp32) with
// w_lo its lo half; w_lo is not read in bf16.
extern "C" int conv3x3_bn_gelu_launch(int is_bf16, const void* x, const void* w,
                                      const void* w_lo, const void* scale, const void* shift,
                                      void* out, int N, int H, int W, int Cin, int Cout,
                                      int tile_n, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return launch_tile<__nv_bfloat16>(tile_n, x, w, w_lo, scale, shift, out, N, H, W, Cin,
                                      Cout, s);
  return launch_tile<float>(tile_n, x, w, w_lo, scale, shift, out, N, H, W, Cin, Cout, s);
}

// Dynamic shared memory of the bf16 (is_bf16) or 3xTF32 kernel at channel tile
// tile_n (-1 where there is no such kernel), for build reports.
extern "C" int conv3x3_bn_gelu_wgmma_smem(int is_bf16, int tile_n) {
  if (tile_n == 128) return is_bf16 ? Ring<__nv_bfloat16, 128>::BYTES : Ring<float, 128>::BYTES;
  return tile_n == 256 && is_bf16 ? Ring<__nv_bfloat16, 256>::BYTES : -1;
}
