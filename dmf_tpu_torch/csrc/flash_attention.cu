// Exact blocked (flash) attention over (BH, N, D) tensors: forward, dQ and dK/dV.
//
// Replaces the TPU kernels of dmf_tpu/ops/flash_attention.py:
//   * `_flash_kernel` (:43)    -> flash_fwd_kernel
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
// SFU at a small fraction of the tensor-core rate.  Design, simple first:
//   * every product is a block-level product of tiles in shared memory,
//     written once (block_mma) for two engines: bf16 runs on the tensor
//     cores through WMMA 16x16x16 fragments (mma.sync, bf16 in, fp32
//     accumulate), fp32 on the CUDA cores (SIMT FMA, so fp32 results carry
//     no TF32 rounding);
//   * the accumulators (O, dQ, dK, dV) and the score tiles live in shared
//     memory in fp32; the row statistics and the softmax are elementwise
//     passes over those tiles;
//   * Q/K/V/dO tiles are staged with plain 16-byte loads, no pipeline.
//   wgmma, TMA, register-resident accumulators and a multi-stage pipeline
//   are later work.
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
// and the 256/512 block sizes.  Tiles are 64 queries x 64 keys (dK/dV steps
// over 32 queries), D is 64 or 128, and N must be a multiple of 64.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch (or the error of setting the shared-memory size).
// Offsets are 32-bit: the wrapper rejects tensors of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

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

// ------------------------------------------------------------------ forward
template <typename T, int D>
constexpr int fwd_smem() {
  constexpr int LD = D + Pad<T>::OP, LDP = BK + Pad<T>::OP;
  constexpr int LDS = BK + Pad<T>::ACC, LDO = D + Pad<T>::ACC;
  return a128(BQ * LD * sizeof(T)) + 2 * a128(BK * LD * sizeof(T)) +
         a128(BQ * LDP * sizeof(T)) + a128(BQ * LDS * 4) + a128(BQ * LDO * 4) + a128(BQ * 4);
}

template <typename T, int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, float scale) {
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
      Ps[r * LDP + c] = from_f<T>(p);  // bf16: P rounded for the tensor cores
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
    ob[e] = from_f<T>(Os[rr * LDO + c] / Ls[rr]);
  }
}

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

static_assert(fwd_smem<float, 128>() <= SMEM_MAX, "forward shared memory");
static_assert(dq_smem<float, 128>() <= SMEM_MAX, "dQ shared memory");
static_assert(dkv_smem<float, 128>() <= SMEM_MAX, "dK/dV shared memory");

template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int D>
int fwd(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int nq,
        int nk, float scale, cudaStream_t s) {
  constexpr int bytes = fwd_smem<T, D>();
  cudaError_t e = allow_smem(flash_fwd_kernel<T, D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_fwd_kernel<T, D><<<dim3(nq / BQ, bh), NT, bytes, s>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(out), static_cast<float*>(lse), nq, nk, scale);
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
  if (is_bf16 && d == 128) return fwd<bf16, 128>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64) return fwd<bf16, 64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128) return fwd<float, 128>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64) return fwd<float, 64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
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
