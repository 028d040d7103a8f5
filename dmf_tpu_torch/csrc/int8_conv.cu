// int8 implicit-GEMM convolution with a dequantizing epilogue, sm_90a.
//
// Replaces no Pallas kernel: the JAX package's int8 conv
// (dmf_tpu/ops/quant.py:_quant_conv_call, :127-139) is
// `lax.conv_general_dilated` on int8 operands with an int32 result, which
// XLA lowers itself.  PyTorch has no int8 convolution on CUDA (`F.conv2d`
// refuses int8, `torch._int_mm` is a 2-D product), so the port writes one.
// Built by ops/cuda_build.py with nvcc into a shared library with a plain C
// interface, loaded with ctypes (ops/quant_cuda.py).
//
// What it computes, for an NHWC int8 input x (N, H, W, C), an OHWI int8
// weight w (O, kh, kw, C), strides, paddings and dilations:
//   acc[m, o] = sum_k A[m, k] * B[o, k]                    exact, int32
// with M = N * Ho * Wo output pixels, K = kh * kw * C, A the input pixels a
// window reads (zero outside the image and past K) and B the weight's rows.
// out_mode 0 writes acc as int32; 1 (fp32) and 2 (bf16) write
//   y = float(acc) * (x_scale * w_scale[o])  (+ bias[o])
// rounded once to the output type, the products and the add as separate
// IEEE operations (__fmul_rn, __fadd_rn: nvcc would contract a*b + c into an
// FMA), the order of quant.py:136-139.  The output is NHWC (M, O).
//
// What bounds it on this card: the int8 tensor-core products (2 K operations
// an output, 1979 dense TOP/s) at the served shapes, whose K runs from 288
// to 4608; the 1x1 convs over few channels lean on the bytes.  This first
// version is `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32`, not wgmma:
//   * a block computes a 128 x BN tile (BN = 128, or 64 where O <= 64) with
//     8 warps of 64 x BN/4, in K steps of 64 bytes;
//   * a 3-stage ring of A and B tiles in shared memory.  Where C is a
//     multiple of 16 (every served conv but the 7x7 stems and the ViT patch
//     conv) each 16-byte piece of a row lies in one (r, s) tap, and the
//     gather is `cp.async` with a zero fill outside the image and past K;
//     elsewhere a thread gathers its pieces byte by byte;
//   * rows are padded to 80 bytes, so the fragment loads (32 bits a lane)
//     hit 32 distinct banks without ldmatrix;
//   * the epilogue dequantizes from the accumulators and writes two
//     neighbouring channels a lane.
// Left for later: wgmma s8 with TMA and a persistent grid, and the quantize
// pass fused into the producer's epilogue (ROADMAP 2b).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBM = 128;
constexpr int kBK = 64;         // bytes of K a stage: two m16n8k32 steps
constexpr int kLds = kBK + 16;  // padded row: conflict-free 32-bit fragment loads
constexpr int kStages = 3;
constexpr int kThreads = 256;

struct Shape {
  int n, h, w, c;  // input, NHWC
  int o, kh, kw;   // weight, OHWI
  int ho, wo;
  int sh, sw, ph, pw, dh, dw;
  int k;           // kh * kw * c
  long long m;     // n * ho * wo
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem),
               "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// One output row (pixel) a thread gathers for: its image's offset and the
// window's top-left corner in the input.
struct Row {
  long long base;
  int ih0, iw0;
  bool ok;
};

__device__ __forceinline__ Row make_row(const Shape& s, long long m) {
  Row r;
  r.ok = m < s.m;
  const long long mm = r.ok ? m : 0;
  const long long hw = static_cast<long long>(s.ho) * s.wo;
  const int img = static_cast<int>(mm / hw);
  const int rem = static_cast<int>(mm - img * hw);
  const int oh = rem / s.wo;
  const int ow = rem - oh * s.wo;
  r.base = static_cast<long long>(img) * s.h * s.w * s.c;
  r.ih0 = oh * s.sh - s.ph;
  r.iw0 = ow * s.sw - s.pw;
  return r;
}

// 16 bytes of A (row ``row``, K from ``k``), byte by byte: any C.
__device__ __forceinline__ uint4 gather16(const int8_t* __restrict__ x, const Shape& s,
                                          const Row& row, int k) {
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (row.ok && k < s.k) {
    int rs = k / s.c;
    int c = k - rs * s.c;
    int r = rs / s.kw;
    int q = rs - r * s.kw;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < s.k) {
        const int ih = row.ih0 + r * s.dh;
        const int iw = row.iw0 + q * s.dw;
        if (ih >= 0 && ih < s.h && iw >= 0 && iw < s.w) {
          const uint8_t v = static_cast<uint8_t>(
              __ldg(x + row.base + (static_cast<long long>(ih) * s.w + iw) * s.c + c));
          words[j >> 2] |= static_cast<uint32_t>(v) << (8 * (j & 3));
        }
      }
      if (++c == s.c) {
        c = 0;
        if (++q == s.kw) {
          q = 0;
          ++r;
        }
      }
    }
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

// 16 bytes of B (weight row ``o``, K from ``k``), byte by byte: any K.
__device__ __forceinline__ uint4 weight16(const int8_t* __restrict__ w, const Shape& s, int o,
                                          int k) {
  uint32_t words[4] = {0u, 0u, 0u, 0u};
  if (o < s.o) {
    const int8_t* p = w + static_cast<long long>(o) * s.k;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
      if (k + j < s.k) {
        words[j >> 2] |= static_cast<uint32_t>(static_cast<uint8_t>(__ldg(p + k + j)))
                         << (8 * (j & 3));
      }
    }
  }
  return make_uint4(words[0], words[1], words[2], words[3]);
}

template <int BN, bool VEC>
__global__ void __launch_bounds__(kThreads)
    int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                     const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                     const float* __restrict__ bias, void* __restrict__ out, int out_mode,
                     Shape s) {
  constexpr int kWN = BN / 4;          // columns a warp
  constexpr int kNT = kWN / 8;         // n8 tiles a warp
  constexpr int kBChunks = BN * 4 / kThreads;  // 16-byte pieces of B a thread
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* a_smem = smem;
  unsigned char* b_smem = smem + kStages * kBM * kLds;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int warp_m = warp >> 2;
  const int warp_n = warp & 3;
  const int g = lane >> 2;
  const int t = lane & 3;
  const long long m0 = static_cast<long long>(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * BN;

  // this thread's pieces: A rows tid/4 and tid/4 + 64, B rows tid/4 (+ 64),
  // all at K offset 16 * (tid % 4) within a stage
  const int kc = (tid & 3) * 16;
  Row rows[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) rows[i] = make_row(s, m0 + (tid >> 2) + 64 * i);

  auto load = [&](int slot, int kt) {
    const int k = kt * kBK + kc;
    unsigned char* as = a_smem + slot * kBM * kLds;
    unsigned char* bs = b_smem + slot * BN * kLds;
    if constexpr (VEC) {
      // C % 16 == 0: the piece lies in one tap (r, q) of the window
      int r = 0, q = 0, c = 0;
      const bool in_k = k < s.k;
      if (in_k) {
        const int rs = k / s.c;
        c = k - rs * s.c;
        r = rs / s.kw;
        q = rs - r * s.kw;
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const Row& row = rows[i];
        const int ih = row.ih0 + r * s.dh;
        const int iw = row.iw0 + q * s.dw;
        const bool ok = in_k && row.ok && ih >= 0 && ih < s.h && iw >= 0 && iw < s.w;
        const int8_t* src =
            ok ? x + row.base + (static_cast<long long>(ih) * s.w + iw) * s.c + c : x;
        cp_async16(as + ((tid >> 2) + 64 * i) * kLds + kc, src, ok ? 16 : 0);
      }
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        const int o = n0 + (tid >> 2) + 64 * i;
        const bool ok = in_k && o < s.o;
        const int8_t* src = ok ? w + static_cast<long long>(o) * s.k + k : w;
        cp_async16(bs + ((tid >> 2) + 64 * i) * kLds + kc, src, ok ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        *reinterpret_cast<uint4*>(as + ((tid >> 2) + 64 * i) * kLds + kc) =
            gather16(x, s, rows[i], k);
      }
#pragma unroll
      for (int i = 0; i < kBChunks; ++i) {
        *reinterpret_cast<uint4*>(bs + ((tid >> 2) + 64 * i) * kLds + kc) =
            weight16(w, s, n0 + (tid >> 2) + 64 * i, k);
      }
    }
  };

  int acc[4][kNT][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

  const int kt_n = (s.k + kBK - 1) / kBK;
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < kt_n) load(st, st);
    cp_async_commit();
  }
  for (int kt = 0; kt < kt_n; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    // the slot refilled here was last read in step kt - 1, which every
    // thread has finished at the barrier above
    const int nxt = kt + kStages - 1;
    if (nxt < kt_n) load(nxt % kStages, nxt);
    cp_async_commit();

    const unsigned char* as = a_smem + (kt % kStages) * kBM * kLds;
    const unsigned char* bs = b_smem + (kt % kStages) * BN * kLds;
#pragma unroll
    for (int ks = 0; ks < kBK; ks += 32) {
      uint32_t a[4][4];
      uint32_t b[kNT][2];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        const unsigned char* p = as + (warp_m * 64 + mt * 16 + g) * kLds + ks + t * 4;
        a[mt][0] = *reinterpret_cast<const uint32_t*>(p);
        a[mt][1] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds);
        a[mt][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[mt][3] = *reinterpret_cast<const uint32_t*>(p + 8 * kLds + 16);
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
        const unsigned char* p = bs + (warp_n * kWN + nt * 8 + g) * kLds + ks + t * 4;
        b[nt][0] = *reinterpret_cast<const uint32_t*>(p);
        b[nt][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) mma_s8(acc[mt][nt], a[mt], b[nt]);
    }
  }
  cp_async_wait<0>();

  // epilogue: lane (g, t) holds rows g and g + 8 of each m16 tile at
  // channels 2t and 2t + 1 of each n8 tile
  const float xs = out_mode != 0 ? *x_scale : 0.f;
  const bool pairs = (s.o & 1) == 0;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const int col = n0 + warp_n * kWN + nt * 8 + t * 2;
    if (col >= s.o) continue;
    const bool has1 = col + 1 < s.o;
    float sc[2] = {0.f, 0.f}, bb[2] = {0.f, 0.f};
    if (out_mode != 0) {
      sc[0] = __fmul_rn(xs, w_scale[col]);
      if (has1) sc[1] = __fmul_rn(xs, w_scale[col + 1]);
      if (bias != nullptr) {
        bb[0] = bias[col];
        if (has1) bb[1] = bias[col + 1];
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const long long m = m0 + warp_m * 64 + mt * 16 + g + half * 8;
        if (m >= s.m) continue;
        const long long off = m * s.o + col;
        const int v0 = acc[mt][nt][2 * half];
        const int v1 = acc[mt][nt][2 * half + 1];
        if (out_mode == 0) {
          int* o32 = static_cast<int*>(out) + off;
          if (pairs) {
            *reinterpret_cast<int2*>(o32) = make_int2(v0, v1);
          } else {
            o32[0] = v0;
            if (has1) o32[1] = v1;
          }
          continue;
        }
        float y0 = __fmul_rn(__int2float_rn(v0), sc[0]);
        float y1 = __fmul_rn(__int2float_rn(v1), sc[1]);
        if (bias != nullptr) {
          y0 = __fadd_rn(y0, bb[0]);
          y1 = __fadd_rn(y1, bb[1]);
        }
        if (out_mode == 1) {
          float* f = static_cast<float*>(out) + off;
          if (pairs) {
            *reinterpret_cast<float2*>(f) = make_float2(y0, y1);
          } else {
            f[0] = y0;
            if (has1) f[1] = y1;
          }
        } else {
          __nv_bfloat16* h = static_cast<__nv_bfloat16*>(out) + off;
          if (pairs) {
            __nv_bfloat162 v;
            v.x = __float2bfloat16_rn(y0);
            v.y = __float2bfloat16_rn(y1);
            *reinterpret_cast<__nv_bfloat162*>(h) = v;
          } else {
            h[0] = __float2bfloat16_rn(y0);
            if (has1) h[1] = __float2bfloat16_rn(y1);
          }
        }
      }
  }
}

template <int BN>
constexpr int smem_bytes() {
  return kStages * (kBM + BN) * kLds;
}

template <int BN, bool VEC>
int launch(const void* x, const void* w, const void* w_scale, const void* x_scale,
           const void* bias, void* out, int out_mode, const Shape& s, cudaStream_t st) {
  auto kernel = int8_conv_kernel<BN, VEC>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         smem_bytes<BN>());
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((s.m + kBM - 1) / kBM),
                  static_cast<unsigned>((s.o + BN - 1) / BN));
  kernel<<<grid, kThreads, smem_bytes<BN>(), st>>>(
      static_cast<const int8_t*>(x), static_cast<const int8_t*>(w),
      static_cast<const float*>(w_scale), static_cast<const float*>(x_scale),
      static_cast<const float*>(bias), out, out_mode, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out_mode: 0 int32 accumulators, 1 fp32, 2 bf16 (dequantized).  vec: 1 when
// C % 16 == 0 and x, w are 16-byte aligned (the cp.async gather), else 0.
// block_n: 64 or 128, the block's channel tile.
extern "C" int int8_conv_launch(const void* x, const void* w, const void* w_scale,
                                const void* x_scale, const void* bias, void* out,
                                int out_mode, int vec, int block_n, int n, int h, int wd,
                                int c, int o, int kh, int kw, int ho, int wo, int sh, int sw,
                                int ph, int pw, int dh, int dw, void* stream) {
  Shape s{n, h, wd, c, o, kh, kw, ho, wo, sh, sw, ph, pw, dh, dw, kh * kw * c,
          static_cast<long long>(n) * ho * wo};
  if (s.m <= 0 || o <= 0) return 0;
  if (out_mode < 0 || out_mode > 2 || (vec && c % 16 != 0) || s.m > (1LL << 31) * kBM)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define INT8_CONV_ARGS x, w, w_scale, x_scale, bias, out, out_mode, s, st
  if (block_n == 64) {
    return vec ? launch<64, true>(INT8_CONV_ARGS) : launch<64, false>(INT8_CONV_ARGS);
  }
  if (block_n == 128) {
    return vec ? launch<128, true>(INT8_CONV_ARGS) : launch<128, false>(INT8_CONV_ARGS);
  }
#undef INT8_CONV_ARGS
  return static_cast<int>(cudaErrorInvalidValue);
}
