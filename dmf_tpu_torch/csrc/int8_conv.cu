// int8 implicit-GEMM convolution with a dequantizing epilogue, sm_90a.
//
// Replaces no Pallas kernel: the JAX package's int8 conv
// (dmf_tpu/ops/quant.py:_quant_conv_call, :127-139) is
// `lax.conv_general_dilated` on int8 operands with an int32 result, lowered
// by XLA.  PyTorch has no int8 convolution on CUDA (`F.conv2d` refuses int8,
// `torch._int_mm` is a 2-D product), so the port writes one.  Built by
// ops/cuda_build.py with nvcc into a shared library with a plain C
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
// FMA), the order of quant.py:136-139.  The output is NHWC (M, O).  No
// split-K and no atomics: two calls give the same bits.
//
// What bounds it on this card: the int8 tensor-core products (2 K operations
// an output, 1979 dense TOP/s) at the served shapes, whose K runs from 288 to
// 4608; the 1x1 convs over few channels lean on the bytes.  Measured
// (PERF.md, section 6), the large convs run at ~35-40 % of the product
// rate; with consumers that only issue their products (no gather, weights
// or stores) a stage still takes ~1.1 us at every tile width, so neither the
// products nor the data movement sets this design's pace, and what does is
// not found.
//
// Design: one warp-specialised kernel on a persistent grid.
//   * A block owns 128-pixel x BN-channel output tiles, BN = 64, 128 or 256
//     chosen from O alone (ops/quant_cuda.py::conv_tile), and walks them with
//     the channel tiles innermost, so that the blocks reading one pixel tile
//     run together and its bytes come from HBM once; the weights (at most a
//     few MB a conv) stay in L2.  One block per SM (grid = min(tiles, SMs)).
//   * Warpgroups 0 and 1 consume: each issues `wgmma.m64nBNk32.s32.s8.s8`
//     over its 64 rows, both operands K-major in 128B-swizzled shared
//     memory, four k32 products a 128-byte K stage, one group in flight
//     across the wait for the next stage; the int32 sums stay in registers
//     through the epilogue, which dequantizes (the tile's scales and biases
//     loaded into a shared-memory table while the products run) and stores
//     NHWC rows, whole 32-byte sectors a row and warp store (int32 / fp32:
//     two channels a lane; bf16: four, neighbouring lanes swapping halves by
//     a shuffle).
//   * Warpgroup 2 produces into a ring of stages (full/empty mbarriers), as
//     many as 227 KB of shared memory hold, at most 8: 8 / 6 / 4 at BN = 64 /
//     128 / 256.  One thread TMA-loads the weight tile (the OHWI weight
//     viewed as a K-major (O, K) matrix, zeros past O and K); all the
//     producer's threads gather the pixel tile, each one 16-byte chunk of 8
//     rows a stage, from a per-tile table of rows in shared memory:
//       - C % 16 == 0: 16-byte cp.async with zero fill, each thread's
//         arrival made by its copies' completion (cp.async.mbarrier.arrive),
//         the consumers' fence.proxy.async after their wait handing the
//         bytes to wgmma;
//       - else (the 7x7 stems with C 14 and 6, the ViT patch conv): element
//         by element, stored with st.shared and fence.proxy.async.
//   * The K stages run in an order of their own (the int32 sums do not
//     depend on it): each block starts from its own offset, so that the
//     blocks do not all ask L2 for one weight tile at once, and where C %
//     128 == 0 a window's taps run innermost, so that a pixel's channels are
//     read by all its taps within a few stages.
//   * setmaxnreg gives each consumer thread 200 of the 168 registers a
//     thread of 384 (their 128 int32 sums at BN = 256) and each producer 104.
// The producer runs into the next tile while the consumers finish the
// current one's epilogue.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BM = 128;          // output pixels a tile, 64 a consumer warpgroup
constexpr int KSTEP = 128;       // bytes of K a stage: one swizzled row, four k32 products
constexpr int CONSUMERS = 256;   // warpgroups 0, 1 consume
constexpr int PRODUCERS = 128;   // warpgroup 2 produces
constexpr int THREADS = CONSUMERS + PRODUCERS;
// setmaxnreg moves registers within the block's launch allocation (65536 /
// 384 = 168 a thread): 3 x 168 = 104 + 2 x 200
constexpr int PRODUCER_REGS = 104;
constexpr int CONSUMER_REGS = 200;
constexpr int SMEM_MAX = 232448;
constexpr int ROW_BYTES = BM * 16;  // a tile's table of rows (int4 each)
constexpr int NOT_A_ROW = -(1 << 28);  // the window origin of a row past M: outside every image

// The pixel (A) source: how a 16-byte chunk of a row is gathered.  The
// numbers are the C interface's `src`.
enum Src {
  kInt8Vec = 0,    // C % 16 == 0: 16-byte cp.async straight into the tile
  kInt8Bytes = 1,  // any C: element by element
  kSources = 2
};

template <int BN>
struct Layout {
  static constexpr int A_BYTES = BM * KSTEP;
  static constexpr int B_BYTES = BN * KSTEP;
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int COL_BYTES = 2 * BN * 4;  // a tile's dequantize scales and biases
  // alignment slack, row and column tables (two each), barriers
  static constexpr int FIXED = 1024 + 2 * ROW_BYTES + 2 * COL_BYTES + 256;
  static constexpr int FIT = (SMEM_MAX - FIXED) / STAGE;
  static constexpr int STAGES = FIT > 8 ? 8 : FIT;
  static constexpr int ROWS_OFF = STAGES * STAGE;
  static constexpr int COLS_OFF = ROWS_OFF + 2 * ROW_BYTES;
  static constexpr int BAR_OFF = COLS_OFF + 2 * COL_BYTES;
  static constexpr int BYTES = BAR_OFF + 16 * STAGES + 1024;
  static_assert(STAGES >= 4, "int8 conv ring depth");
  static_assert(BYTES <= SMEM_MAX, "int8 conv shared memory");
};

struct Shape {
  int n, h, w, c;  // input, NHWC
  int o, kh, kw;   // weight, OHWI
  int ho, wo;
  int sh, sw, ph, pw, dh, dw;
  int k;           // kh * kw * c
  int m;           // n * ho * wo
  int m_tiles, n_tiles, kt_n;
};

// ---------------------------------------------------------------- products
template <int BN>
__device__ __forceinline__ void mma_k32(uint32_t (&acc)[BN / 2], uint64_t da, uint64_t db,
                                        int accumulate) {
  if constexpr (BN == 64)
    hopper::wgmma_m64n64k32_s8_ss(acc, da, db, accumulate);
  else if constexpr (BN == 128)
    hopper::wgmma_m64n128k32_s8_ss(acc, da, db, accumulate);
  else
    hopper::wgmma_m64n256k32_s8_ss(acc, da, db, accumulate);
}

// ---------------------------------------------------------------- producer
// Row r of the tile at m0: its image's element offset and its window's
// top-left corner (NOT_A_ROW past M).
__device__ __forceinline__ int4 row_entry(const Shape& s, int m) {
  if (m >= s.m) return make_int4(0, NOT_A_ROW, 0, 0);
  const int hw = s.ho * s.wo;
  const int img = m / hw;
  const int rem = m - img * hw;
  const int oh = rem / s.wo;
  const int ow = rem - oh * s.wo;
  return make_int4(img * s.h * s.w * s.c, oh * s.sh - s.ph, ow * s.sw - s.pw, 0);
}

// The tap (r, q) and channel c of K index k.
struct Tap {
  int r, q, c;
};

__device__ __forceinline__ Tap tap_of(const Shape& s, int k) {
  const int rs = k / s.c;
  const int r = rs / s.kw;
  return {r, rs - r * s.kw, k - rs * s.c};
}

// t advanced by n <= C elements along K.
__device__ __forceinline__ void step(const Shape& s, Tap& t, int n) {
  t.c += n;
  if (t.c >= s.c) {
    t.c -= s.c;
    if (++t.q == s.kw) {
      t.q = 0;
      ++t.r;
    }
  }
}

// The element offset of tap t in the window of row e, or -1 outside the image.
__device__ __forceinline__ long long pixel(const Shape& s, int4 e, const Tap& t) {
  const int ih = e.y + t.r * s.dh;
  const int iw = e.z + t.q * s.dw;
  if (static_cast<unsigned>(ih) >= static_cast<unsigned>(s.h) ||
      static_cast<unsigned>(iw) >= static_cast<unsigned>(s.w))
    return -1;
  return e.x + (static_cast<long long>(ih) * s.w + iw) * s.c + t.c;
}

// A thread's 16 elements from K index k of each of its 8 rows (table
// entries e), element by element (any C): the rows' loads of an element go
// out together.
__device__ __forceinline__ void gather_bytes(const unsigned char* __restrict__ x, const Shape& s,
                                             const int4 (&e)[8], int k,
                                             uint32_t (&words)[8][4]) {
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int w = 0; w < 4; ++w) words[i][w] = 0u;
  if (k >= s.k) return;
  Tap t = tap_of(s, k);
#pragma unroll
  for (int el = 0; el < 16; ++el) {
    if (k + el < s.k) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const long long at = pixel(s, e[i], t);
        if (at >= 0) words[i][el >> 2] |= static_cast<uint32_t>(__ldg(x + at)) << 8 * (el & 3);
      }
    }
    step(s, t, 1);
  }
}

template <int BN, int SRC>
__device__ __forceinline__ void produce(const CUtensorMap& wmap, const unsigned char* x,
                                        unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const Shape& s, int tiles) {
  using namespace hopper;
  using L = Layout<BN>;
  const int p = threadIdx.x - CONSUMERS;
  const int j = p & 7;    // this thread's chunk of each of its rows
  const int r0 = p >> 3;  // its rows r0 + 16 i
  // the K stage of the tile's kt-th step (see the note at the top)
  const int kt0 = blockIdx.x % s.kt_n;
  const int taps = s.kh * s.kw, cbs = s.c / KSTEP;
  auto k_step = [&](int kt) {
    const int v = kt + kt0 < s.kt_n ? kt + kt0 : kt + kt0 - s.kt_n;
    return s.c % KSTEP == 0 ? (v % taps) * cbs + v / taps : v;
  };
  int4* tables = reinterpret_cast<int4*>(smem + L::ROWS_OFF);
  int it = 0, tile_i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tile_i) {
    // each thread writes its row of tile i's table, by the tile's parity;
    // the barrier makes it visible, and keeps every thread past tile i - 1
    // (whose table is the other one) before tile i + 1 overwrites it
    if (p < BM) tables[(tile_i & 1) * BM + p] = row_entry(s, (tile / s.n_tiles) * BM + p);
    named_barrier(1, PRODUCERS);
    const int4* table = tables + (tile_i & 1) * BM;
    for (int kt = 0; kt < s.kt_n; ++kt, ++it) {
      const int st = it % L::STAGES;
      unsigned char* a = smem + st * L::STAGE;
      mbar_wait(&empty[st], ((it / L::STAGES) & 1) ^ 1);
      const int kk = k_step(kt);
      if (p == 0) {
        mbar_arrive_expect_tx(&full[st], L::B_BYTES);
        tma_load_3d(a + L::A_BYTES, &wmap, &full[st], kk * KSTEP, (tile % s.n_tiles) * BN, 0);
      }
      const int k = kk * KSTEP + 16 * j;
      if constexpr (SRC == kInt8Vec) {
        const bool in_k = k < s.k;
        const Tap t = tap_of(s, in_k ? k : 0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const long long at = in_k ? pixel(s, table[r0 + 16 * i], t) : -1;
          cp_async_16(a + sw128(r0 + 16 * i, j), at >= 0 ? x + at : x, at >= 0);
        }
        // arrives once this thread's copies have landed; the consumers hand
        // them to the async proxy (their fence after the wait)
        cp_async_mbar_arrive(&full[st]);
      } else {
        int4 e[8];
        uint32_t words[8][4];
#pragma unroll
        for (int i = 0; i < 8; ++i) e[i] = table[r0 + 16 * i];
        gather_bytes(x, s, e, k, words);
#pragma unroll
        for (int i = 0; i < 8; ++i)
          *reinterpret_cast<uint4*>(a + sw128(r0 + 16 * i, j)) =
              make_uint4(words[i][0], words[i][1], words[i][2], words[i][3]);
        fence_proxy_async();
        mbar_arrive(&full[st]);
      }
    }
  }
  if constexpr (SRC == kInt8Vec) cp_async_wait<0>();
}

// ---------------------------------------------------------------- consumers
__device__ __forceinline__ void store_pair(void* out, int out_mode, long long off, int v0, int v1,
                                           float sc0, float sc1, float b0, float b1, bool add_bias,
                                           bool pair, bool has1) {
  if (out_mode == 0) {
    int* o32 = static_cast<int*>(out) + off;
    if (pair) {
      *reinterpret_cast<int2*>(o32) = make_int2(v0, v1);
    } else {
      o32[0] = v0;
      if (has1) o32[1] = v1;
    }
    return;
  }
  float y0 = __fmul_rn(__int2float_rn(v0), sc0);
  float y1 = __fmul_rn(__int2float_rn(v1), sc1);
  if (add_bias) {
    y0 = __fadd_rn(y0, b0);
    y1 = __fadd_rn(y1, b1);
  }
  if (out_mode == 1) {
    float* f = static_cast<float*>(out) + off;
    if (pair) {
      *reinterpret_cast<float2*>(f) = make_float2(y0, y1);
    } else {
      f[0] = y0;
      if (has1) f[1] = y1;
    }
  } else {
    __nv_bfloat16* hb = static_cast<__nv_bfloat16*>(out) + off;
    if (pair) {
      __nv_bfloat162 v;
      v.x = __float2bfloat16_rn(y0);
      v.y = __float2bfloat16_rn(y1);
      *reinterpret_cast<__nv_bfloat162*>(hb) = v;
    } else {
      hb[0] = __float2bfloat16_rn(y0);
      if (has1) hb[1] = __float2bfloat16_rn(y1);
    }
  }
}

template <int BN, int SRC>
__device__ __forceinline__ void consume(unsigned char* smem, uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ w_scale,
                                        const float* __restrict__ x_scale,
                                        const float* __restrict__ bias, void* __restrict__ out,
                                        int out_mode, const Shape& s, int tiles) {
  using namespace hopper;
  using L = Layout<BN>;
  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  const int lane = t % 32;
  const float xs = out_mode != 0 ? *x_scale : 0.f;
  const bool pair = (s.o & 1) == 0;
  uint32_t acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0u;
  int it = 0, tile_i = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x, ++tile_i) {
    const int n0 = (tile % s.n_tiles) * BN;
    const int m0 = (tile / s.n_tiles) * BM;
    // the tile's x_scale * w_scale and bias a channel, into a table by the
    // tile's parity: their loads land during the products, and the barrier
    // before the epilogue (which every consumer passes after the previous
    // tile's epilogue) keeps tile i + 2 from overwriting tile i's early
    float* cols = reinterpret_cast<float*>(smem + L::COLS_OFF) + (tile_i & 1) * 2 * BN;
    if (out_mode != 0) {
      for (int c = threadIdx.x; c < BN; c += CONSUMERS) {
        const bool in = n0 + c < s.o;
        cols[c] = in ? __fmul_rn(xs, __ldg(w_scale + n0 + c)) : 0.f;
        cols[BN + c] = in && bias != nullptr ? __ldg(bias + n0 + c) : 0.f;
      }
    }
    for (int kt = 0; kt < s.kt_n; ++kt, ++it) {
      const int st = it % L::STAGES;
      mbar_wait(&full[st], (it / L::STAGES) & 1);
      if constexpr (SRC == kInt8Vec) fence_proxy_async();  // the producer's cp.async writes
      const unsigned char* a = smem + st * L::STAGE + wg * 64 * KSTEP;
      const unsigned char* b = smem + st * L::STAGE + L::A_BYTES;
      fence_regs(acc);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        mma_k32<BN>(acc, desc_sw128(a + 32 * kk, 16, 1024), desc_sw128(b + 32 * kk, 16, 1024),
                    kt > 0 || kk > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done: hand its slot back
      fence_regs(acc);
      if (kt > 0) mbar_arrive(&empty[(it - 1) % L::STAGES]);
    }
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(&empty[(it - 1) % L::STAGES]);
    named_barrier(2, CONSUMERS);  // the column table is written

    // epilogue: lane (l/4, l%4) of warp w holds rows 16w + l/4 (+ 8) of the
    // warpgroup's 64 at channels 8jn + 2(l%4) (+ 1)
    const int row = m0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int quad = lane % 4;
#pragma unroll
    for (int jn = 0; jn < BN / 8; jn += 2) {
      const int col = n0 + jn * 8 + quad * 2;
      float sc[4] = {0.f, 0.f, 0.f, 0.f}, bb[4] = {0.f, 0.f, 0.f, 0.f};
      if (out_mode != 0) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int c = col - n0 + (e >> 1) * 8 + (e & 1);
          sc[e] = cols[c];
          bb[e] = cols[BN + c];
        }
      }
      // bf16 with the 16 channels of jn, jn + 1 in range and 8-byte aligned:
      // neighbouring lanes swap halves, so that a lane holds four adjacent
      // channels and a warp's store fills one 32-byte sector a row
      const bool swap = out_mode == 2 && (s.o & 3) == 0 && n0 + jn * 8 + 16 <= s.o;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = row + 8 * h;
        if (swap) {
          float y[4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            y[e] = __fmul_rn(__int2float_rn(static_cast<int>(acc[4 * (jn + (e >> 1)) + 2 * h +
                                                                 (e & 1)])), sc[e]);
            if (bias != nullptr) y[e] = __fadd_rn(y[e], bb[e]);
          }
          const uint32_t w0 = pack_bf16(y[0], y[1]), w1 = pack_bf16(y[2], y[3]);
          const uint32_t got = __shfl_xor_sync(0xffffffffu, (quad & 1) ? w0 : w1, 1);
          if (m < s.m) {
            const int c0 = (quad & 1) ? col + 6 : col;  // odd lanes: jn + 1, from 2(quad - 1)
            *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(out) +
                                      static_cast<long long>(m) * s.o + c0) =
                (quad & 1) ? make_uint2(got, w1) : make_uint2(w0, got);
          }
          continue;
        }
        if (m >= s.m) continue;
#pragma unroll
        for (int g2 = 0; g2 < 2; ++g2) {
          const int c = col + 8 * g2;
          if (c >= s.o) continue;
          store_pair(out, out_mode, static_cast<long long>(m) * s.o + c,
                     static_cast<int>(acc[4 * (jn + g2) + 2 * h]),
                     static_cast<int>(acc[4 * (jn + g2) + 2 * h + 1]), sc[2 * g2],
                     sc[2 * g2 + 1], bb[2 * g2], bb[2 * g2 + 1], bias != nullptr, pair,
                     c + 1 < s.o);
        }
      }
    }
  }
}

// One name per (tile, source), as ptxas and the profiler report them.
template <int BN, int SRC>
__global__ void __launch_bounds__(THREADS, 1)
    int8_conv_wgmma(const __grid_constant__ CUtensorMap wmap, const void* __restrict__ x,
                    const float* __restrict__ w_scale, const float* __restrict__ x_scale,
                    const float* __restrict__ bias, void* __restrict__ out, int out_mode,
                    Shape s) {
  using namespace hopper;
  using L = Layout<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* empty = full + L::STAGES;
  if (threadIdx.x == 0) {
    for (int i = 0; i < L::STAGES; ++i) {
      mbar_init(&full[i], PRODUCERS + 1);  // the producers and the weight's expect-tx
      mbar_init(&empty[i], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();
  const int tiles = s.m_tiles * s.n_tiles;
  if (threadIdx.x >= CONSUMERS) {
    reg_dealloc<PRODUCER_REGS>();
    produce<BN, SRC>(wmap, static_cast<const unsigned char*>(x), smem, full, empty, s, tiles);
  } else {
    reg_alloc<CONSUMER_REGS>();
    consume<BN, SRC>(smem, full, empty, w_scale, x_scale, bias, out, out_mode, s, tiles);
  }
}

int sm_count() {
  static int counts[64] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (counts[dev] == 0) {
    int n = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess) return 0;
    counts[dev] = n;
  }
  return counts[dev];
}

// The weight's tensor map for (w, K, O, w_ld, BN), encoded once: a launch
// encodes only what it has not seen (a small direct-mapped cache of the
// maps, which hold the address and the shape, not the bytes).
const CUtensorMap* weight_map(const void* w, int k, int o, int w_ld, int bn, cudaError_t* err) {
  struct Entry {
    const void* w;
    int k, o, ld, bn;
    CUtensorMap map;
  };
  static thread_local Entry cache[64] = {};
  Entry& e = cache[(reinterpret_cast<uintptr_t>(w) >> 8 ^ static_cast<uintptr_t>(k) ^
                    static_cast<uintptr_t>(bn)) % 64];
  if (e.w != w || e.k != k || e.o != o || e.ld != w_ld || e.bn != bn) {
    // a K-major (O, K) matrix of bytes, rows w_ld apart: boxes of one
    // 128-byte K row x BN rows, zeros past K and O
    *err = hopper::tensor_map_3d(&e.map, w, k, o, 1, w_ld, static_cast<uint64_t>(w_ld) * o,
                                 KSTEP, bn, 1, CU_TENSOR_MAP_DATA_TYPE_UINT8);
    if (*err != cudaSuccess) {
      e.w = nullptr;
      return nullptr;
    }
    e.w = w;
    e.k = k;
    e.o = o;
    e.ld = w_ld;
    e.bn = bn;
  }
  *err = cudaSuccess;
  return &e.map;
}

template <int BN, int SRC>
int launch(const void* x, const void* w, int w_ld, const void* w_scale, const void* x_scale,
           const void* bias, void* out, int out_mode, const Shape& s, cudaStream_t st) {
  using L = Layout<BN>;
  cudaError_t e;
  const CUtensorMap* wmap = weight_map(w, s.k, s.o, w_ld, BN, &e);
  if (wmap == nullptr) return static_cast<int>(e);
  auto kernel = int8_conv_wgmma<BN, SRC>;
  static bool sized[64] = {};  // the shared-memory attribute, set once a device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (!sized[dev]) {
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return static_cast<int>(e);
    sized[dev] = true;
  }
  const int sms = sm_count();
  if (sms <= 0) return static_cast<int>(cudaErrorInvalidDevice);
  const long long tiles = static_cast<long long>(s.m_tiles) * s.n_tiles;
  const int grid = static_cast<int>(tiles < sms ? tiles : sms);
  kernel<<<grid, THREADS, L::BYTES, st>>>(*wmap, x, static_cast<const float*>(w_scale),
                                               static_cast<const float*>(x_scale),
                                               static_cast<const float*>(bias), out, out_mode,
                                               s);
  return static_cast<int>(cudaGetLastError());
}

#define INT8_CONV_ARGS x, w, w_ld, w_scale, x_scale, bias, out, out_mode, s, st

template <int BN, int SRC = 0>
int launch_src(int src, const void* x, const void* w, int w_ld, const void* w_scale,
               const void* x_scale, const void* bias, void* out, int out_mode, const Shape& s,
               cudaStream_t st) {
  if constexpr (SRC == kSources) {
    return static_cast<int>(cudaErrorInvalidValue);
  } else {
    if (src == SRC) return launch<BN, SRC>(INT8_CONV_ARGS);
    return launch_src<BN, SRC + 1>(src, INT8_CONV_ARGS);
  }
}

}  // namespace

// src: the pixel source (Src: 0 16-byte cp.async, which needs C % 16 == 0
// and a 16-byte aligned x; 1 element by element).  w: the OHWI int8 weight
// as (O, K) rows of w_ld bytes (w_ld >= K, a multiple of 16, w 16-byte
// aligned).  out_mode: 0 int32 accumulators, 1 fp32, 2 bf16 (dequantized,
// x_scale the fp32 scale of x).  block_n: 64, 128 or 256, the tiles' channel
// width.  Offsets into x are 32-bit: N H W C < 2^31 and N Ho Wo < 2^31.
extern "C" int int8_conv_launch(int src, const void* x, const void* w, int w_ld,
                                const void* w_scale, const void* x_scale, const void* bias,
                                void* out, int out_mode, int block_n, int n, int h, int wd,
                                int c, int o, int kh, int kw, int ho, int wo, int sh, int sw,
                                int ph, int pw, int dh, int dw, void* stream) {
  const long long m = static_cast<long long>(n) * ho * wo;
  if (m <= 0 || o <= 0) return 0;
  const int k = kh * kw * c;
  if (src < 0 || src >= kSources || out_mode < 0 || out_mode > 2 ||
      (src == kInt8Vec && c % 16 != 0) || (block_n != 64 && block_n != 128 && block_n != 256) ||
      m >= (1LL << 31) || static_cast<long long>(n) * h * wd * c >= (1LL << 31) ||
      w_ld < k || w_ld % 16 != 0 || (out_mode != 0 && x_scale == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Shape s{n, h, wd, c, o, kh, kw, ho, wo, sh, sw, ph, pw, dh, dw, k, static_cast<int>(m),
          static_cast<int>((m + BM - 1) / BM), (o + block_n - 1) / block_n,
          (k + KSTEP - 1) / KSTEP};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_n == 64) return launch_src<64>(src, INT8_CONV_ARGS);
  if (block_n == 128) return launch_src<128>(src, INT8_CONV_ARGS);
  if (block_n == 256) return launch_src<256>(src, INT8_CONV_ARGS);
  return static_cast<int>(cudaErrorInvalidValue);
}

#undef INT8_CONV_ARGS

// Dynamic shared memory of the kernel at channel tile block_n (-1 where
// there is none), for build reports.
extern "C" int int8_conv_smem(int block_n) {
  if (block_n == 64) return Layout<64>::BYTES;
  if (block_n == 128) return Layout<128>::BYTES;
  if (block_n == 256) return Layout<256>::BYTES;
  return -1;
}
