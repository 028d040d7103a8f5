// Exact blocked (flash) attention over (BH, N, D) tensors: forward, dQ and dK/dV.
//
// Replaces the TPU kernels of dmf_tpu/ops/flash_attention.py:
//   * `_flash_kernel` (:43)    -> flash_fwd_wgmma (bf16), flash_fwd_kernel (fp32)
//   * `_bwd_dq_kernel` (:114)  -> flash_bwd_dq_kernel
//   * `_bwd_dkv_kernel` (:144) -> flash_bwd_dkv_kernel
// reached through `flash_attention` (:281) and its custom VJP (:261-277).
//
// Semantics (the TPU kernel's): S = (Q K^T) * scale with fp32 accumulation,
// an online softmax with running row max m and row sum l, acc = acc * alpha
// + P V, then out = acc / l and lse = m + log(l).  The backward is the
// FlashAttention-2 recompute with no atomics: P = exp(S - lse) is rebuilt
// from (Q, K, lse); dS = P * (dO V^T - delta) * scale with delta =
// rowsum(dO * O) computed by the caller; dQ = dS K over key tiles in one
// kernel (a block per query tile), dK = dS^T Q and dV = P^T dO over query
// tiles in another (a block per key tile).
//
// What bounds it on the card: operations.  The forward does 4*BH*Nq*Nk*D
// FLOP on 3*BH*N*D inputs, about N/3 FLOP per byte (1365 at N=4096), far
// above the H100's ridge of ~295 FLOP/byte; dQ does ~6 and dK/dV ~8 times
// BH*Nq*Nk*D.  Each pass also takes BH*Nq*Nk exponentials, which run on the
// SFU at a small fraction of the tensor-core rate.
//
// The bf16 forward (flash_fwd_wgmma) is the FlashAttention-3 shape, simple
// first: a block owns 128 query rows, two consumer warpgroups of 64 rows and
// a producer warpgroup.  One producer thread TMA-loads the Q tile once and
// K, V tiles of 128 keys into a two-stage ring (full/empty mbarriers, tiles
// 128-byte swizzled, split into 64-column panels).  Each consumer computes
// S = Q K^T with wgmma (both K-major in shared memory), runs the online
// softmax on the accumulator registers (quad shuffles, exp2 with log2(e)
// folded into the scale), converts P to bf16 in registers and computes
// O += P V with P as wgmma's register operand and V as the MN-major operand
// (the transpose bit).  O never leaves registers until the epilogue divides
// by l and rounds once.  setmaxnreg moves registers from the producer to the
// consumers.  Later work: ping-pong scheduling of the consumers, so that one
// softmax overlaps the other's products.
//
// The fp32 forward and the backward kernels are block-level products of
// tiles in shared memory, written once (block_mma) for two engines: bf16 on
// the tensor cores through WMMA 16x16x16 fragments (mma.sync, bf16 in, fp32
// accumulate), fp32 on the CUDA cores (SIMT FMA, so fp32 results carry no
// TF32 rounding); accumulators and score tiles live in fp32 shared memory;
// tiles are staged with plain 16-byte loads.
//
// Rounding points.  bf16: P (forward, dK/dV) and dS (dQ, dK/dV) are rounded
// to bf16 before they enter a tensor-core product; S, the softmax
// statistics, every accumulator and lse stay fp32; outputs are rounded once.
// fp32: nothing is rounded below fp32.  The plain version
// (ops/flash_attention.py::flash_attention_ref) computes everything in fp32
// from the input-dtype operands and rounds the output once.
//
// Deliberately not carried over from the TPU: the (N, 1) column layout of
// lse/delta (here (BH, N) fp32 rows), the whole-sequence-in-VMEM K/V blocks
// and the 256/512 block sizes.  D is 64 or 128 and N a multiple of 64; the
// wgmma forward masks the ragged half of a 128-row query block (rows past
// N_q are loaded as zeros and not written) and keys past N_k (set to -inf
// before the row max).
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch (or the error of setting the shared-memory size or of
// encoding a tensor map).  Offsets are 32-bit: the wrapper rejects tensors
// of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;          // threads per block
constexpr int NWARPS = NT / 32;
constexpr int BQ = 64;           // query rows per block (forward, dQ)
constexpr int BK = 64;           // key rows per step (forward, dQ) and per block (dK/dV)
constexpr int BQI = 32;          // query rows per step of the dK/dV kernel
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use on sm_90

using bf16 = __nv_bfloat16;

// Row padding, in elements: PAD for operand tiles of T, CPAD for fp32 tiles.
// bf16 keeps WMMA's alignment (multiples of 8 and 4 elements); fp32 pads by
// one so that the SIMT engine's column walks hit distinct banks.
template <typename T> struct Pad;
template <> struct Pad<float> { static constexpr int OP = 1, ACC = 1; };
template <> struct Pad<bf16> { static constexpr int OP = 8, ACC = 4; };

__host__ __device__ constexpr int a128(int bytes) { return (bytes + 127) / 128 * 128; }

struct Carve {
  unsigned char* p;
  template <typename U> __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += a128(n * static_cast<int>(sizeof(U)));
    return r;
  }
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) { return __float2bfloat16(v); }

// R x D tile of T, contiguous in global memory, into shared rows of pitch ld.
template <typename T, int R, int D>
__device__ __forceinline__ void load_tile(T* s, int ld, const T* __restrict__ g) {
  constexpr int V = 16 / sizeof(T);
  static_assert(D % V == 0, "D must be a multiple of the vector width");
  for (int e = threadIdx.x * V; e < R * D; e += NT * V) {
    const uint4 u = *reinterpret_cast<const uint4*>(g + e);
    const int r = e / D, c = e % D;
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(s + r * ld + c) = u;
    } else {
      const T* src = reinterpret_cast<const T*>(&u);
#pragma unroll
      for (int i = 0; i < V; ++i) s[r * ld + c + i] = src[i];
    }
  }
}

// R rows of fp32 vector g (row statistics) into shared memory.
template <int R>
__device__ __forceinline__ void load_rows(float* s, const float* __restrict__ g) {
  for (int i = threadIdx.x; i < R; i += NT) s[i] = g[i];
}

// C (+)= A B over shared tiles: A is M x K, B is K x N, C is M x N fp32.
// A_T: A(m, k) sits at A[k * lda + m] (else A[m * lda + k]).
// B_T: B(k, n) sits at B[n * ldb + k] (else B[k * ldb + n]).
// fp32 engine: a 16 x 16 thread grid, thread (ty, tx) owning the strided
// outputs (ty + 16 i, tx + 16 j), fp32 FMA.
template <int M, int N, int K, bool A_T, bool B_T>
__device__ __forceinline__ void block_mma(const float* A, int lda, const float* B, int ldb,
                                          float* C, int ldc, bool accumulate) {
  constexpr int TX = 16, TY = NT / TX;
  static_assert(M % TY == 0 && N % TX == 0, "tile does not fit the thread grid");
  constexpr int TM = M / TY, TN = N / TX;
  const int tx = threadIdx.x % TX, ty = threadIdx.x / TX;
  float c[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j)
      c[i][j] = accumulate ? C[(ty + i * TY) * ldc + tx + j * TX] : 0.f;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
      a[i] = A_T ? A[k * lda + ty + i * TY] : A[(ty + i * TY) * lda + k];
#pragma unroll
    for (int j = 0; j < TN; ++j)
      b[j] = B_T ? B[(tx + j * TX) * ldb + k] : B[k * ldb + tx + j * TX];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) c[i][j] = fmaf(a[i], b[j], c[i][j]);
  }
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) C[(ty + i * TY) * ldc + tx + j * TX] = c[i][j];
}

// bf16 engine: each warp takes 16 x 16 output tiles in turn; WMMA fragments
// read A/B in either layout, the fp32 tile is loaded from and stored back to C.
template <int M, int N, int K, bool A_T, bool B_T>
__device__ __forceinline__ void block_mma(const bf16* A, int lda, const bf16* B, int ldb,
                                          float* C, int ldc, bool accumulate) {
  using namespace nvcuda;
  using ALay = typename std::conditional<A_T, wmma::col_major, wmma::row_major>::type;
  using BLay = typename std::conditional<B_T, wmma::col_major, wmma::row_major>::type;
  static_assert(M % 16 == 0 && N % 16 == 0 && K % 16 == 0, "WMMA tiles are 16x16x16");
  constexpr int TN = N / 16;
  const int warp = threadIdx.x / 32;
  for (int t = warp; t < (M / 16) * TN; t += NWARPS) {
    const int m0 = (t / TN) * 16, n0 = (t % TN) * 16;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> c;
    if (accumulate)
      wmma::load_matrix_sync(c, C + m0 * ldc + n0, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(c, 0.f);
#pragma unroll
    for (int k0 = 0; k0 < K; k0 += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, ALay> a;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, BLay> b;
      wmma::load_matrix_sync(a, A_T ? A + k0 * lda + m0 : A + m0 * lda + k0, lda);
      wmma::load_matrix_sync(b, B_T ? B + n0 * ldb + k0 : B + k0 * ldb + n0, ldb);
      wmma::mma_sync(c, a, b, c);
    }
    wmma::store_matrix_sync(C + m0 * ldc + n0, c, ldc, wmma::mem_row_major);
  }
}

// ------------------------------------------------------- forward, fp32 (SIMT)
template <int D>
constexpr int fwd_smem() {
  using T = float;
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  return a128(BQ * LD * sizeof(T)) + 2 * a128(BK * LD * sizeof(T)) +
         a128(BQ * LDP * sizeof(T)) + a128(BQ * LDS * 4) + a128(BQ * LDO * 4) + a128(BQ * 4);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Nq, int Nk, float scale) {
  using T = float;
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BQ * LD);
  T* Ks = cv.take<T>(BK * LD);
  T* Vs = cv.take<T>(BK * LD);
  T* Ps = cv.take<T>(BQ * LDP);
  float* Ss = cv.take<float>(BQ * LDS);
  float* Os = cv.take<float>(BQ * LDO);
  float* Ls = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;
  load_tile<T, BQ, D>(Qs, LD, q + (bh * Nq + q0) * D);
  for (int e = threadIdx.x; e < BQ * LDO; e += NT) Os[e] = 0.f;
  // softmax passes: 4 neighbouring lanes share a query row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float m = -1e30f, l = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs, Ps
    load_tile<T, BK, D>(Ks, LD, kb + k0 * D);
    load_tile<T, BK, D>(Vs, LD, vb + k0 * D);
    __syncthreads();
    block_mma<BQ, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDS, false);
    __syncthreads();
    float mx = -1e30f;
    for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ss[r * LDS + c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int c = part; c < BK; c += 4) {
      const float p = expf(Ss[r * LDS + c] * scale - m_new);
      sum += p;
      Ps[r * LDP + c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int c = part; c < D; c += 4) Os[r * LDO + c] *= alpha;
    __syncthreads();
    block_mma<BQ, D, BK, false, false>(Ps, LDP, Vs, LD, Os, LDO, true);
  }
  if (part == 0) {
    Ls[r] = l;
    lse[bh * Nq + q0 + r] = m + logf(l);
  }
  __syncthreads();
  T* ob = out + (bh * Nq + q0) * D;
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int rr = e / D, c = e % D;
    ob[e] = Os[rr * LDO + c] / Ls[rr];
  }
}

// ------------------------------------------------------- forward, bf16 (wgmma)
namespace wg {

constexpr int BM = 128;       // query rows per block: two consumer warpgroups of 64
constexpr int BN = 128;       // keys per tile
constexpr int STAGES = 2;     // K/V ring depth
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CONSUMERS = 256;
constexpr float kNegInf = -__builtin_huge_valf();

// Shared memory: Q (D/64 panels of BM x 128 B), the K and V rings (D/64
// panels of BN x 128 B per stage), then the barriers.
template <int D>
struct Smem {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;
  static constexpr int K_OFF = Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};
static_assert(Smem<128>::BYTES <= SMEM_MAX, "wgmma forward shared memory");

template <int D>
__device__ __forceinline__ void pv_product(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void pv_product<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n64k16_rs_tb(o, a, b, 1);
}
template <>
__device__ __forceinline__ void pv_product<128>(float (&o)[64], const uint32_t (&a)[4],
                                                uint64_t b) {
  hopper::wgmma_m64n128k16_rs_tb(o, a, b, 1);
}

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                float* __restrict__ lse, int Nq, int Nk, float scale) {
  using namespace hopper;
  using L = Smem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = q_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nkt = (Nk + BN - 1) / BN;
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: one thread keeps the ring full
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(q_full, L::Q_BYTES);
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(smem + p * BM * 128, &qmap, q_full, p * 64, q0, bh);
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
        unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
        mbar_arrive_expect_tx(&k_full[s], L::KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(ks + p * BN * 128, &kmap, &k_full[s], p * 64, kt * BN, bh);
        mbar_arrive_expect_tx(&v_full[s], L::KV_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(vs + p * BN * 128, &vmap, &v_full[s], p * 64, kt * BN, bh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    reg_alloc<232>();
    const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    const float c = scale * 1.4426950408889634f;  // S -> log2 units
    float sacc[BN / 2];
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sacc[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    const unsigned char* qs = smem + wgi * 64 * 128;  // this warpgroup's rows of each panel
    mbar_wait(q_full, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int s = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      const unsigned char* ks = smem + L::K_OFF + s * L::KV_BYTES;
      const unsigned char* vs = smem + L::V_OFF + s * L::KV_BYTES;
      // S = Q K^T over D in steps of 16 (32 bytes inside a 64-column panel)
      mbar_wait(&k_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const int off = (kk % 4) * 32;
        wgmma_m64n128k16_ss(sacc, desc_sw128(qs + (kk / 4) * BM * 128 + off, 16, 1024),
                            desc_sw128(ks + (kk / 4) * BN * 128 + off, 16, 1024), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(sacc);
      if ((kt + 1) * BN > Nk) {  // the last tile: keys past N_k drop out
#pragma unroll
        for (int j = 0; j < BN / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kt * BN + 8 * j + 2 * quad + e >= Nk)
              sacc[4 * j + e] = sacc[4 * j + 2 + e] = kNegInf;
      }
      // online softmax on the registers: row h of this thread is 16w + l/4 + 8h
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(sacc[4 * j], sacc[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(sacc[4 * j + 2], sacc[4 * j + 3]));
      }
      float alpha[2], mc[2], sum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        alpha[h] = exp2f((m[h] - mx[h]) * c);
        m[h] = mx[h];
        mc[h] = mx[h] * c;
      }
      uint32_t pa[BN / 16][4];  // P in bf16 as wgmma's register operand, 16 keys each
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const float p0 = exp2f(fmaf(sacc[4 * j], c, -mc[0]));
        const float p1 = exp2f(fmaf(sacc[4 * j + 1], c, -mc[0]));
        const float p2 = exp2f(fmaf(sacc[4 * j + 2], c, -mc[1]));
        const float p3 = exp2f(fmaf(sacc[4 * j + 3], c, -mc[1]));
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= alpha[0];
        o[4 * j + 1] *= alpha[0];
        o[4 * j + 2] *= alpha[1];
        o[4 * j + 3] *= alpha[1];
      }
      // O += P V over the keys in steps of 16 (2048 bytes: two 8-row atoms)
      mbar_wait(&v_full[s], parity);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        pv_product<D>(o, pa[kk], desc_sw128(vs + kk * 2048, BN * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(o);
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) fence_regs(pa[kk]);
      mbar_arrive(&empty[s]);
    }
    // epilogue: out = O / l rounded once, lse = m * scale + log(l)
    const int row0 = q0 + wgi * 64 + (t / 32) * 16 + lane / 4;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Nq) continue;  // the ragged half of the last query block
      const int at = bh * Nq + row;
      if (quad == 0) lse[at] = m[h] * scale + logf(l[h]);
      bf16* orow = out + at * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(orow + 8 * j) =
            pack_bf16(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

}  // namespace wg

// ------------------------------------------------------------------ dQ
template <typename T, int D>
constexpr int dq_smem() {
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  return 2 * a128(BQ * LD * sizeof(T)) + 2 * a128(BK * LD * sizeof(T)) +
         a128(BQ * LDP * sizeof(T)) + 2 * a128(BQ * LDS * 4) + a128(BQ * LDO * 4) +
         2 * a128(BQ * 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Nq, int Nk,
                    float scale) {
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Qs = cv.take<T>(BQ * LD);
  T* dOs = cv.take<T>(BQ * LD);
  T* Ks = cv.take<T>(BK * LD);
  T* Vs = cv.take<T>(BK * LD);
  T* dSs = cv.take<T>(BQ * LDP);
  float* Ss = cv.take<float>(BQ * LDS);
  float* dPs = cv.take<float>(BQ * LDS);
  float* dQs = cv.take<float>(BQ * LDO);
  float* Lse = cv.take<float>(BQ);
  float* Dl = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int row0 = bh * Nq + q0;
  const T* kb = k + bh * Nk * D;
  const T* vb = v + bh * Nk * D;
  load_tile<T, BQ, D>(Qs, LD, q + row0 * D);
  load_tile<T, BQ, D>(dOs, LD, dout + row0 * D);
  load_rows<BQ>(Lse, lse + row0);
  load_rows<BQ>(Dl, delta + row0);
  for (int e = threadIdx.x; e < BQ * LDO; e += NT) dQs[e] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs, dSs
    load_tile<T, BK, D>(Ks, LD, kb + k0 * D);
    load_tile<T, BK, D>(Vs, LD, vb + k0 * D);
    __syncthreads();
    block_mma<BQ, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDS, false);    // S = Q K^T
    block_mma<BQ, BK, D, false, true>(dOs, LD, Vs, LD, dPs, LDS, false);  // dP = dO V^T
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int rr = e / BK, c = e % BK;
      const float p = expf(Ss[rr * LDS + c] * scale - Lse[rr]);
      dSs[rr * LDP + c] = from_f<T>(p * (dPs[rr * LDS + c] - Dl[rr]) * scale);
    }
    __syncthreads();
    block_mma<BQ, D, BK, false, false>(dSs, LDP, Ks, LD, dQs, LDO, true);  // dQ += dS K
  }
  __syncthreads();
  T* ob = dq + row0 * D;
  for (int e = threadIdx.x; e < BQ * D; e += NT) ob[e] = from_f<T>(dQs[(e / D) * LDO + e % D]);
}

// ------------------------------------------------------------------ dK / dV
template <typename T, int D>
constexpr int dkv_smem() {
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  return 2 * a128(BK * LD * sizeof(T)) + 2 * a128(BQI * LD * sizeof(T)) +
         2 * a128(BQI * LDP * sizeof(T)) + 2 * a128(BQI * LDS * 4) +
         2 * a128(BK * LDO * 4) + 2 * a128(BQI * 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Nq, int Nk, float scale) {
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* Ks = cv.take<T>(BK * LD);
  T* Vs = cv.take<T>(BK * LD);
  T* Qs = cv.take<T>(BQI * LD);
  T* dOs = cv.take<T>(BQI * LD);
  T* Ps = cv.take<T>(BQI * LDP);
  T* dSs = cv.take<T>(BQI * LDP);
  float* Ss = cv.take<float>(BQI * LDS);
  float* dPs = cv.take<float>(BQI * LDS);
  float* dKs = cv.take<float>(BK * LDO);
  float* dVs = cv.take<float>(BK * LDO);
  float* Lse = cv.take<float>(BQI);
  float* Dl = cv.take<float>(BQI);

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int krow0 = bh * Nk + k0;
  load_tile<T, BK, D>(Ks, LD, k + krow0 * D);
  load_tile<T, BK, D>(Vs, LD, v + krow0 * D);
  for (int e = threadIdx.x; e < BK * LDO; e += NT) dKs[e] = dVs[e] = 0.f;
  for (int q0 = 0; q0 < Nq; q0 += BQI) {
    const int row0 = bh * Nq + q0;
    __syncthreads();  // the previous step is done with Qs, dOs, Ps, dSs, Lse, Dl
    load_tile<T, BQI, D>(Qs, LD, q + row0 * D);
    load_tile<T, BQI, D>(dOs, LD, dout + row0 * D);
    load_rows<BQI>(Lse, lse + row0);
    load_rows<BQI>(Dl, delta + row0);
    __syncthreads();
    block_mma<BQI, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDS, false);    // S = Q K^T
    block_mma<BQI, BK, D, false, true>(dOs, LD, Vs, LD, dPs, LDS, false);  // dP = dO V^T
    __syncthreads();
    for (int e = threadIdx.x; e < BQI * BK; e += NT) {
      const int rr = e / BK, c = e % BK;
      const float p = expf(Ss[rr * LDS + c] * scale - Lse[rr]);
      Ps[rr * LDP + c] = from_f<T>(p);
      dSs[rr * LDP + c] = from_f<T>(p * (dPs[rr * LDS + c] - Dl[rr]) * scale);
    }
    __syncthreads();
    block_mma<BK, D, BQI, true, false>(Ps, LDP, dOs, LD, dVs, LDO, true);  // dV += P^T dO
    block_mma<BK, D, BQI, true, false>(dSs, LDP, Qs, LD, dKs, LDO, true);  // dK += dS^T Q
  }
  __syncthreads();
  T* kout = dk + krow0 * D;
  T* vout = dv + krow0 * D;
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    const int at = (e / D) * LDO + e % D;
    kout[e] = from_f<T>(dKs[at]);
    vout[e] = from_f<T>(dVs[at]);
  }
}

static_assert(fwd_smem<128>() <= SMEM_MAX, "forward shared memory");
static_assert(dq_smem<float, 128>() <= SMEM_MAX, "dQ shared memory");
static_assert(dkv_smem<float, 128>() <= SMEM_MAX, "dK/dV shared memory");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <int D>
int fwd_f32(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int nq,
            int nk, float scale, cudaStream_t s) {
  constexpr int bytes = fwd_smem<D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<D><<<dim3(nq / BQ, bh), NT, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(out), static_cast<float*>(lse), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int nq,
              int nk, float scale, cudaStream_t s) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {nq, nk, nk};
  for (int i = 0; i < 3; ++i) {
    // (BH, N, D) as dims {D, N, BH}: boxes of 64 columns x a tile of rows x 1 head;
    // rows past N (the ragged tile) read zeros instead of the next head's
    const cudaError_t e = hopper::tensor_map_3d(
        &maps[i], ptrs[i], D, rows[i], bh, D * 2ull, static_cast<uint64_t>(rows[i]) * D * 2,
        64, i == 0 ? wg::BM : wg::BN, 1);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int bytes = wg::Smem<D>::BYTES;
  cudaError_t e = allow_smem(wg::flash_fwd_wgmma<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_fwd_wgmma<D><<<dim3((nq + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), static_cast<float*>(lse), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
       const void* delta, void* dq_out, int bh, int nq, int nk, float scale, cudaStream_t s) {
  constexpr int bytes = dq_smem<T, D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<T, D><<<dim3(nq / BQ, bh), NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dq_out), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
        const void* delta, void* dk, void* dv, int bh, int nq, int nk, float scale,
        cudaStream_t s) {
  constexpr int bytes = dkv_smem<T, D>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_kernel<T, D><<<dim3(nk / BK, bh), NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<T*>(dk), static_cast<T*>(dv), nq, nk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int BAD_ARGUMENT = -1;  // a head width or type the kernels do not take

}  // namespace

extern "C" int flash_fwd_launch(int is_bf16, int d, const void* q, const void* k,
                                const void* v, void* out, void* lse, int bh, int nq, int nk,
                                float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128) return fwd_wgmma<128>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64) return fwd_wgmma<64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128) return fwd_f32<128>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64) return fwd_f32<64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

// Dynamic shared memory of the bf16 forward at head width d, for build reports.
extern "C" int flash_fwd_wgmma_smem(int d) {
  return d == 128 ? wg::Smem<128>::BYTES : d == 64 ? wg::Smem<64>::BYTES : BAD_ARGUMENT;
}

extern "C" int flash_bwd_dq_launch(int is_bf16, int d, const void* q, const void* k,
                                   const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dq_out, int bh, int nq, int nk,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dq<bf16, 128>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dq<bf16, 64>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dq<float, 128>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dq<float, 64>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

extern "C" int flash_bwd_dkv_launch(int is_bf16, int d, const void* q, const void* k,
                                    const void* v, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh, int nq,
                                    int nk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dkv<bf16, 128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dkv<bf16, 64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dkv<float, 128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dkv<float, 64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}
