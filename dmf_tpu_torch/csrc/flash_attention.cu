// Exact blocked (flash) attention over (BH, N, D) tensors: forward, dQ and dK/dV.
//
// Replaces the TPU kernels of dmf_tpu/ops/flash_attention.py, reached through
// `flash_attention` (:281) and its custom VJP (:261-277):
//   * `_flash_kernel` (:43)    -> wg::flash_fwd_wgmma (bf16), flash_fwd_kernel (fp32)
//   * `_bwd_dq_kernel` (:114)  -> wg::flash_bwd_dq_wgmma (bf16), flash_bwd_dq_kernel (fp32)
//   * `_bwd_dkv_kernel` (:144) -> wg::flash_bwd_dkv_wgmma (bf16), flash_bwd_dkv_kernel (fp32)
//
// Semantics (the TPU kernels'): S = (Q K^T) * scale with fp32 accumulation,
// an online softmax with running row max m and row sum l, acc = acc * alpha
// + P V, then out = acc / l and lse = m + log(l).  The backward is the
// FlashAttention-2 recompute: P = exp(S - lse) is rebuilt from (Q, K, lse);
// dS = P * (dO V^T - delta) * scale with delta = rowsum(dO * O) computed by
// the caller; dQ = dS K summed over keys, dK = dS^T Q and dV = P^T dO summed
// over queries.
//
// What bounds them on the card: operations.  Per score element the forward
// does 4 D FLOP, dQ 6 D and dK/dV 8 D on the tensor cores, against inputs
// of a few bytes per row (N/3 FLOP per byte for the forward, 1365 at N=4096,
// far above the H100's ridge of ~295).  Each kernel also takes one
// exponential per score element on the SFU, which issues 16 a clock per SM
// against ~4096 bf16 tensor-core FLOP: a third of dQ's tensor time at D=128
// and two thirds at D=64, before the FP32 work around it (scale, subtract,
// multiply, convert).  So the design keeps the tensor cores fed from
// registers and shared memory and lets one warpgroup's exponentials run
// while the other's products do.
//
// The bf16 kernels share one shape (FlashAttention-3's, simple first): a
// block owns 128 rows of its output, two consumer warpgroups of 64 rows
// each, and a producer warpgroup.  One producer thread TMA-loads the block's
// own operands once and streams the other side's tiles into a two-stage
// ring (full/empty mbarriers; tiles 128-byte swizzled, split into 64-column
// panels).  Consumers issue wgmma with accumulators in registers; setmaxnreg
// moves registers from the producer to the consumers.
//   * Forward: Q once, K and V tiles of 128 keys.  S = Q K^T (both K-major),
//     the online softmax on the accumulator registers (quad shuffles, exp2
//     with log2(e) folded into the scale), P packed to bf16 in registers as
//     wgmma's A operand of O += P V with V MN-major (the transpose bit).
//     Later work: ping-pong scheduling of the consumers.
//   * dQ: Q, dO, and the block's lse, delta rows once; K and V tiles of 64
//     keys (64, not 128: dQ's 64 fp32 accumulators per thread at D=128 plus
//     S and dP of a 128-key tile would not fit the registers).  S = Q K^T and
//     dP = dO V^T are SS products; P and dS are formed on the accumulator
//     registers; dS packed to bf16 is the A operand of dQ += dS K with K
//     MN-major; dQ stays in registers until one rounding in the epilogue.
//   * dK/dV: K and V once; Q, dO tiles of 64 queries with their lse, delta
//     entries (a plain bulk copy into the same stage).  The kernel computes
//     the transposed tiles S^T = K Q^T and dP^T = V dO^T (SS), so that P^T
//     and dS^T already sit in the A-operand register layout of dV += P^T dO
//     and dK += dS^T Q (RS, dO and Q MN-major): the same swizzled Q and dO
//     tiles are the K-major operand of one product and the MN-major operand
//     of the other.  lse and delta are indexed by column here and read from
//     the stage.  dK and dV (2 x 64 fp32 registers a thread at D=128) leave
//     no room for 128-query tiles.
//
// Why two backward kernels and no atomics: dQ sums over keys, dK and dV over
// queries.  A single kernel over key blocks (FlashAttention-2/3's) has to
// add every block's share of dQ into global memory with atomics, in an order
// that changes from run to run.  Here each block owns its output rows and
// adds its tiles in a fixed order, so two runs give the same bits.  The
// price: S, dP and P are computed in both kernels, 14 BH Nq Nk D FLOP and
// two exponentials per score element against the fused form's 10 and one.
//
// The fp32 kernels are block-level products of tiles in shared memory on the
// CUDA cores (block_mma: SIMT FMA, so fp32 results carry no TF32 rounding),
// tiles staged with plain 16-byte loads.
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
// and the 256/512 block sizes.  D is 64 or 128 and N a multiple of 64, so a
// block's 128 rows, or a forward tile of 128 keys, may be half full.  TMA
// reads zeros past N within a head (3-D tensor maps), never the next head's
// rows; rows past N are not written.  Zero rows give S = 0, not -inf, so the
// kernels mask what such rows would add: keys past N_k (-inf in the
// forward, P = 0 in dQ) and queries past N_q (P = 0 in dK/dV).  Under the
// wrapper's multiple of 64 the backward's 64-row ring tiles are always full
// and those two masks never act; they keep a ragged tile exact.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch (or the error of setting the shared-memory size or of
// encoding a tensor map).  Offsets are 32-bit: the wrapper rejects tensors
// of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;          // threads per block of the fp32 kernels
constexpr int BQ = 64;           // query rows per block (fp32 forward, dQ)
constexpr int BK = 64;           // key rows per step (fp32 forward, dQ) and per block (dK/dV)
constexpr int BQI = 32;          // query rows per step of the fp32 dK/dV kernel
constexpr int PAD = 1;           // fp32 row padding: column walks hit distinct banks
constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use on sm_90

using bf16 = __nv_bfloat16;

__host__ __device__ constexpr int a128(int bytes) { return (bytes + 127) / 128 * 128; }

struct Carve {
  unsigned char* p;
  template <typename U> __device__ U* take(int n) {
    U* r = reinterpret_cast<U*>(p);
    p += a128(n * static_cast<int>(sizeof(U)));
    return r;
  }
};

// R x D fp32 tile, contiguous in global memory, into shared rows of pitch ld.
template <int R, int D>
__device__ __forceinline__ void load_tile(float* s, int ld, const float* __restrict__ g) {
  static_assert(D % 4 == 0, "D must be a multiple of the vector width");
  for (int e = threadIdx.x * 4; e < R * D; e += NT * 4) {
    const float4 u = *reinterpret_cast<const float4*>(g + e);
    float* d = s + (e / D) * ld + e % D;
    d[0] = u.x;
    d[1] = u.y;
    d[2] = u.z;
    d[3] = u.w;
  }
}

// R rows of fp32 vector g (row statistics) into shared memory.
template <int R>
__device__ __forceinline__ void load_rows(float* s, const float* __restrict__ g) {
  for (int i = threadIdx.x; i < R; i += NT) s[i] = g[i];
}

// C (+)= A B over shared fp32 tiles: A is M x K, B is K x N, C is M x N.
// A_T: A(m, k) sits at A[k * lda + m] (else A[m * lda + k]).
// B_T: B(k, n) sits at B[n * ldb + k] (else B[k * ldb + n]).
// A 16 x 16 thread grid, thread (ty, tx) owning the strided outputs
// (ty + 16 i, tx + 16 j), fp32 FMA.
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

// ------------------------------------------------------- forward, fp32 (SIMT)
template <int D>
constexpr int fwd_smem() {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  return a128(BQ * LD * 4) + 2 * a128(BK * LD * 4) + a128(BQ * LDP * 4) +
         a128(BQ * LDP * 4) + a128(BQ * LD * 4) + a128(BQ * 4);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Nq, int Nk, float scale) {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(BQ * LD);
  float* Ks = cv.take<float>(BK * LD);
  float* Vs = cv.take<float>(BK * LD);
  float* Ps = cv.take<float>(BQ * LDP);
  float* Ss = cv.take<float>(BQ * LDP);
  float* Os = cv.take<float>(BQ * LD);
  float* Ls = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const float* kb = k + bh * Nk * D;
  const float* vb = v + bh * Nk * D;
  load_tile<BQ, D>(Qs, LD, q + (bh * Nq + q0) * D);
  for (int e = threadIdx.x; e < BQ * LD; e += NT) Os[e] = 0.f;
  // softmax passes: 4 neighbouring lanes share a query row
  const int r = threadIdx.x / 4, part = threadIdx.x % 4;
  float m = -1e30f, l = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs, Ps
    load_tile<BK, D>(Ks, LD, kb + k0 * D);
    load_tile<BK, D>(Vs, LD, vb + k0 * D);
    __syncthreads();
    block_mma<BQ, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDP, false);
    __syncthreads();
    float mx = -1e30f;
    for (int c = part; c < BK; c += 4) mx = fmaxf(mx, Ss[r * LDP + c] * scale);
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    float sum = 0.f;
    for (int c = part; c < BK; c += 4) {
      const float p = expf(Ss[r * LDP + c] * scale - m_new);
      sum += p;
      Ps[r * LDP + c] = p;
    }
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    const float alpha = expf(m - m_new);
    l = l * alpha + sum;
    m = m_new;
    for (int c = part; c < D; c += 4) Os[r * LD + c] *= alpha;
    __syncthreads();
    block_mma<BQ, D, BK, false, false>(Ps, LDP, Vs, LD, Os, LD, true);
  }
  if (part == 0) {
    Ls[r] = l;
    lse[bh * Nq + q0 + r] = m + logf(l);
  }
  __syncthreads();
  float* ob = out + (bh * Nq + q0) * D;
  for (int e = threadIdx.x; e < BQ * D; e += NT) {
    const int rr = e / D, c = e % D;
    ob[e] = Os[rr * LD + c] / Ls[rr];
  }
}

// ------------------------------------------------------- bf16 (wgmma)
namespace wg {

constexpr int BM = 128;       // output rows per block: two consumer warpgroups of 64
constexpr int BN = 128;       // keys per tile of the forward
constexpr int BT = 64;        // keys (dQ) or queries (dK/dV) per tile of the backward
constexpr int STAGES = 2;     // ring depth
constexpr int THREADS = 384;  // warpgroups 0, 1 consume; warpgroup 2 produces
constexpr int CONSUMERS = 256;
constexpr float kNegInf = -__builtin_huge_valf();
constexpr float kLog2e = 1.4426950408889634f;

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

// O (+)= A B with A from registers and B MN-major, N = D: the register-operand
// product of every kernel here (P V, dS K, P^T dO, dS^T Q).
template <int D>
__device__ __forceinline__ void rs_product(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b);
template <>
__device__ __forceinline__ void rs_product<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b) {
  hopper::wgmma_m64n64k16_rs_tb(o, a, b, 1);
}
template <>
__device__ __forceinline__ void rs_product<128>(float (&o)[64], const uint32_t (&a)[4],
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
    const float c = scale * kLog2e;  // S -> log2 units
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
        rs_product<D>(o, pa[kk], desc_sw128(vs + kk * 2048, BN * 128, 1024));
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

// 64 x 64 score tile (S or dP, or their transposes) of this warpgroup:
// acc = A B^T over D, A's 64 rows at `a` inside the block's panels of BM
// rows, B's 64 rows at `b` inside a ring tile's panels of BT rows; both
// K-major.
template <int D>
__device__ __forceinline__ void score_tile(float (&acc)[BT / 2], const unsigned char* a,
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int off = (kk % 4) * 32;
    hopper::wgmma_m64n64k16_ss(acc, hopper::desc_sw128(a + (kk / 4) * BM * 128 + off, 16, 1024),
                               hopper::desc_sw128(b + (kk / 4) * BT * 128 + off, 16, 1024),
                               kk > 0);
  }
}

// Rows of this thread in a 64-row accumulator: 16w + l/4 and that + 8.
__device__ __forceinline__ int acc_row(int t) { return (t / 32) * 16 + (t % 32) / 4; }

// Writes this warpgroup's 64 rows of acc (rows past n dropped), rounded once.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ dst, const float (&acc)[D / 2],
                                           int row0, int n, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = row0 + 8 * h;
    if (row >= n) continue;  // the ragged half of the last block
    bf16* r = dst + row * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(r + 8 * j) = hopper::pack_bf16(acc[4 * j + 2 * h],
                                                                   acc[4 * j + 2 * h + 1]);
  }
}

// dQ shared memory: Q and dO (D/64 panels of BM x 128 B each), the K and V
// rings (D/64 panels of BT x 128 B per stage), then the barriers.
template <int D>
struct DqSmem {
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int T_BYTES = BT * D * 2;
  static constexpr int DO_OFF = Q_BYTES;
  static constexpr int K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * T_BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * T_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};
static_assert(DqSmem<128>::BYTES <= SMEM_MAX, "wgmma dQ shared memory");

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int Nq, int Nk,
                   float scale) {
  using namespace hopper;
  using L = DqSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* qdo_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* k_full = qdo_full + 1;
  uint64_t* v_full = k_full + STAGES;
  uint64_t* empty = v_full + STAGES;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nkt = (Nk + BT - 1) / BT;
  if (threadIdx.x == 0) {
    mbar_init(qdo_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&k_full[s], 1);
      mbar_init(&v_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: Q and dO once, then K and V tiles of 64 keys
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(qdo_full, 2 * L::Q_BYTES);
      for (int p = 0; p < PANELS; ++p) {
        tma_load_3d(smem + p * BM * 128, &qmap, qdo_full, p * 64, q0, bh);
        tma_load_3d(smem + L::DO_OFF + p * BM * 128, &domap, qdo_full, p * 64, q0, bh);
      }
      for (int kt = 0; kt < nkt; ++kt) {
        const int s = kt % STAGES;
        mbar_wait(&empty[s], ((kt / STAGES) & 1) ^ 1);
        unsigned char* ks = smem + L::K_OFF + s * L::T_BYTES;
        unsigned char* vs = smem + L::V_OFF + s * L::T_BYTES;
        mbar_arrive_expect_tx(&k_full[s], L::T_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(ks + p * BT * 128, &kmap, &k_full[s], p * 64, kt * BT, bh);
        mbar_arrive_expect_tx(&v_full[s], L::T_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(vs + p * BT * 128, &vmap, &v_full[s], p * 64, kt * BT, bh);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    reg_alloc<232>();
    const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
    const int quad = t % 4;
    const float c = scale * kLog2e;  // S -> log2 units
    const int row0 = q0 + wgi * 64 + acc_row(t);
    float lse2[2], dl[2];  // this thread's two rows: lse in log2 units, delta
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      lse2[h] = row < Nq ? lse[bh * Nq + row] * kLog2e : 0.f;
      dl[h] = row < Nq ? delta[bh * Nq + row] : 0.f;
    }
    float s[BT / 2], dp[BT / 2], acc[D / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    const unsigned char* qs = smem + wgi * 64 * 128;  // this warpgroup's rows of each panel
    const unsigned char* dos = smem + L::DO_OFF + wgi * 64 * 128;
    mbar_wait(qdo_full, 0);
    for (int kt = 0; kt < nkt; ++kt) {
      const int st = kt % STAGES;
      const uint32_t parity = (kt / STAGES) & 1;
      const unsigned char* ks = smem + L::K_OFF + st * L::T_BYTES;
      const unsigned char* vs = smem + L::V_OFF + st * L::T_BYTES;
      // S = Q K^T and dP = dO V^T, two groups in flight
      mbar_wait(&k_full[st], parity);
      wgmma_fence();
      score_tile<D>(s, qs, ks);
      wgmma_commit();
      mbar_wait(&v_full[st], parity);
      score_tile<D>(dp, dos, vs);
      wgmma_commit();
      // P = exp(S scale - lse) while dP is in flight
      wgmma_wait<1>();
      fence_regs(s);
#pragma unroll
      for (int i = 0; i < BT / 2; ++i) s[i] = exp2f(fmaf(s[i], c, -lse2[(i / 2) % 2]));
      if ((kt + 1) * BT > Nk) {  // keys past N_k: zero rows of K give S = 0, not -inf
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (kt * BT + 8 * j + 2 * quad + e >= Nk) s[4 * j + e] = s[4 * j + 2 + e] = 0.f;
      }
      wgmma_wait<0>();
      fence_regs(dp);
      // dS = P (dP - delta) scale, packed to bf16 as the A operand, 16 keys each
      uint32_t da[BT / 16][4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const float d0 = s[4 * j] * (dp[4 * j] - dl[0]) * scale;
        const float d1 = s[4 * j + 1] * (dp[4 * j + 1] - dl[0]) * scale;
        const float d2 = s[4 * j + 2] * (dp[4 * j + 2] - dl[1]) * scale;
        const float d3 = s[4 * j + 3] * (dp[4 * j + 3] - dl[1]) * scale;
        da[j / 2][(j % 2) * 2] = pack_bf16(d0, d1);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(d2, d3);
      }
      // dQ += dS K, K MN-major: 16 keys are 2048 bytes (two 8-row atoms)
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) fence_regs(da[kk]);  // packed before the fence
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        rs_product<D>(acc, da[kk], desc_sw128(ks + kk * 2048, BT * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) fence_regs(da[kk]);
      mbar_arrive(&empty[st]);
    }
    store_rows<D>(dq + bh * Nq * D, acc, row0, Nq, quad);
  }
}

// dK/dV shared memory: K and V (D/64 panels of BM x 128 B each), the Q and
// dO rings (D/64 panels of BT x 128 B per stage), the lse and delta entries
// of each stage's queries, then the barriers.
template <int D>
struct DkvSmem {
  static constexpr int KV_BYTES = BM * D * 2;
  static constexpr int T_BYTES = BT * D * 2;
  static constexpr int ROW_BYTES = BT * 4;
  static constexpr int V_OFF = KV_BYTES;
  static constexpr int Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * T_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * T_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * ROW_BYTES;
  static constexpr int BAR_OFF = DELTA_OFF + STAGES * ROW_BYTES;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 3 * STAGES) + 1024;
};
static_assert(DkvSmem<128>::BYTES <= SMEM_MAX, "wgmma dK/dV shared memory");

template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Nq, int Nk, float scale) {
  using namespace hopper;
  using L = DkvSmem<D>;
  constexpr int PANELS = D / 64;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* kv_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* q_full = kv_full + 1;
  uint64_t* do_full = q_full + STAGES;
  uint64_t* empty = do_full + STAGES;
  float* lse_s = reinterpret_cast<float*>(smem + L::LSE_OFF);
  float* delta_s = reinterpret_cast<float*>(smem + L::DELTA_OFF);
  const int bh = blockIdx.y, k0 = blockIdx.x * BM;
  const int nqt = (Nq + BT - 1) / BT;
  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&q_full[s], 1);
      mbar_init(&do_full[s], 1);
      mbar_init(&empty[s], CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS) {
    // ---- producer: K and V once, then Q, dO tiles of 64 queries with
    // their lse and delta entries
    reg_dealloc<40>();
    if (threadIdx.x == CONSUMERS) {
      mbar_arrive_expect_tx(kv_full, 2 * L::KV_BYTES);
      for (int p = 0; p < PANELS; ++p) {
        tma_load_3d(smem + p * BM * 128, &kmap, kv_full, p * 64, k0, bh);
        tma_load_3d(smem + L::V_OFF + p * BM * 128, &vmap, kv_full, p * 64, k0, bh);
      }
      for (int qt = 0; qt < nqt; ++qt) {
        const int s = qt % STAGES;
        mbar_wait(&empty[s], ((qt / STAGES) & 1) ^ 1);
        unsigned char* qs = smem + L::Q_OFF + s * L::T_BYTES;
        unsigned char* dos = smem + L::DO_OFF + s * L::T_BYTES;
        const int row = bh * Nq + qt * BT;  // 16-byte aligned: N is a multiple of 64
        mbar_arrive_expect_tx(&q_full[s], L::T_BYTES + L::ROW_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(qs + p * BT * 128, &qmap, &q_full[s], p * 64, qt * BT, bh);
        bulk_load(lse_s + s * BT, lse + row, L::ROW_BYTES, &q_full[s]);
        mbar_arrive_expect_tx(&do_full[s], L::T_BYTES + L::ROW_BYTES);
        for (int p = 0; p < PANELS; ++p)
          tma_load_3d(dos + p * BT * 128, &domap, &do_full[s], p * 64, qt * BT, bh);
        bulk_load(delta_s + s * BT, delta + row, L::ROW_BYTES, &do_full[s]);
      }
    }
  } else {
    // ---- consumers: 64 key rows per warpgroup
    reg_alloc<232>();
    const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
    const int quad = t % 4;
    const float c = scale * kLog2e;  // S -> log2 units
    float s[BT / 2], dp[BT / 2], acc_k[D / 2], acc_v[D / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
    const unsigned char* ks = smem + wgi * 64 * 128;  // this warpgroup's keys of each panel
    const unsigned char* vs = smem + L::V_OFF + wgi * 64 * 128;
    mbar_wait(kv_full, 0);
    for (int qt = 0; qt < nqt; ++qt) {
      const int st = qt % STAGES;
      const uint32_t parity = (qt / STAGES) & 1;
      const unsigned char* qs = smem + L::Q_OFF + st * L::T_BYTES;
      const unsigned char* dos = smem + L::DO_OFF + st * L::T_BYTES;
      const float* ls = lse_s + st * BT;
      const float* dls = delta_s + st * BT;
      // S^T = K Q^T and dP^T = V dO^T: rows are keys, columns queries
      mbar_wait(&q_full[st], parity);
      wgmma_fence();
      score_tile<D>(s, ks, qs);
      wgmma_commit();
      mbar_wait(&do_full[st], parity);
      score_tile<D>(dp, vs, dos);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);
      // P^T = exp(S^T scale - lse) and dS^T = P^T (dP^T - delta) scale, both
      // packed to bf16 as A operands; this thread's columns are the queries
      // 8j + 2(l%4) + {0, 1}
      const bool ragged = (qt + 1) * BT > Nq;  // queries past N_q: P = 0
      uint32_t pa[BT / 16][4], da[BT / 16][4];
#pragma unroll
      for (int j = 0; j < BT / 8; ++j) {
        const int col = 8 * j + 2 * quad;
        const float2 l2 = *reinterpret_cast<const float2*>(ls + col);
        const float2 d2 = *reinterpret_cast<const float2*>(dls + col);
        const float m0 = l2.x * kLog2e, m1 = l2.y * kLog2e;
        float p[4] = {exp2f(fmaf(s[4 * j], c, -m0)), exp2f(fmaf(s[4 * j + 1], c, -m1)),
                      exp2f(fmaf(s[4 * j + 2], c, -m0)), exp2f(fmaf(s[4 * j + 3], c, -m1))};
        if (ragged) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (qt * BT + col + (e % 2) >= Nq) p[e] = 0.f;
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(p[0], p[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2], p[3]);
        da[j / 2][(j % 2) * 2] = pack_bf16(p[0] * (dp[4 * j] - d2.x) * scale,
                                           p[1] * (dp[4 * j + 1] - d2.y) * scale);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2] * (dp[4 * j + 2] - d2.x) * scale,
                                               p[3] * (dp[4 * j + 3] - d2.y) * scale);
      }
      // dV += P^T dO and dK += dS^T Q, dO and Q MN-major (16 queries: 2048 bytes)
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {  // packed before the fence
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        rs_product<D>(acc_v, pa[kk], desc_sw128(dos + kk * 2048, BT * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk)
        rs_product<D>(acc_k, da[kk], desc_sw128(qs + kk * 2048, BT * 128, 1024));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_v);
      fence_regs(acc_k);
#pragma unroll
      for (int kk = 0; kk < BT / 16; ++kk) {
        fence_regs(pa[kk]);
        fence_regs(da[kk]);
      }
      mbar_arrive(&empty[st]);
    }
    const int row0 = k0 + wgi * 64 + acc_row(t);
    store_rows<D>(dk + bh * Nk * D, acc_k, row0, Nk, quad);
    store_rows<D>(dv + bh * Nk * D, acc_v, row0, Nk, quad);
  }
}

}  // namespace wg

// ------------------------------------------------------------------ dQ, fp32 (SIMT)
template <int D>
constexpr int dq_smem() {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  return 2 * a128(BQ * LD * 4) + 2 * a128(BK * LD * 4) + 3 * a128(BQ * LDP * 4) +
         a128(BQ * LD * 4) + 2 * a128(BQ * 4);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Nq, int Nk, float scale) {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Qs = cv.take<float>(BQ * LD);
  float* dOs = cv.take<float>(BQ * LD);
  float* Ks = cv.take<float>(BK * LD);
  float* Vs = cv.take<float>(BK * LD);
  float* dSs = cv.take<float>(BQ * LDP);
  float* Ss = cv.take<float>(BQ * LDP);
  float* dPs = cv.take<float>(BQ * LDP);
  float* dQs = cv.take<float>(BQ * LD);
  float* Lse = cv.take<float>(BQ);
  float* Dl = cv.take<float>(BQ);

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int row0 = bh * Nq + q0;
  const float* kb = k + bh * Nk * D;
  const float* vb = v + bh * Nk * D;
  load_tile<BQ, D>(Qs, LD, q + row0 * D);
  load_tile<BQ, D>(dOs, LD, dout + row0 * D);
  load_rows<BQ>(Lse, lse + row0);
  load_rows<BQ>(Dl, delta + row0);
  for (int e = threadIdx.x; e < BQ * LD; e += NT) dQs[e] = 0.f;
  for (int k0 = 0; k0 < Nk; k0 += BK) {
    __syncthreads();  // the previous step is done with Ks, Vs, dSs
    load_tile<BK, D>(Ks, LD, kb + k0 * D);
    load_tile<BK, D>(Vs, LD, vb + k0 * D);
    __syncthreads();
    block_mma<BQ, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDP, false);    // S = Q K^T
    block_mma<BQ, BK, D, false, true>(dOs, LD, Vs, LD, dPs, LDP, false);  // dP = dO V^T
    __syncthreads();
    for (int e = threadIdx.x; e < BQ * BK; e += NT) {
      const int rr = e / BK, c = e % BK;
      const float p = expf(Ss[rr * LDP + c] * scale - Lse[rr]);
      dSs[rr * LDP + c] = p * (dPs[rr * LDP + c] - Dl[rr]) * scale;
    }
    __syncthreads();
    block_mma<BQ, D, BK, false, false>(dSs, LDP, Ks, LD, dQs, LD, true);  // dQ += dS K
  }
  __syncthreads();
  float* ob = dq + row0 * D;
  for (int e = threadIdx.x; e < BQ * D; e += NT) ob[e] = dQs[(e / D) * LD + e % D];
}

// ------------------------------------------------------------------ dK / dV, fp32 (SIMT)
template <int D>
constexpr int dkv_smem() {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  return 2 * a128(BK * LD * 4) + 2 * a128(BQI * LD * 4) + 4 * a128(BQI * LDP * 4) +
         2 * a128(BK * LD * 4) + 2 * a128(BQI * 4);
}

template <int D>
__global__ void __launch_bounds__(NT)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Nq, int Nk,
                     float scale) {
  constexpr int LD = D + PAD, LDP = BK + PAD;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* Ks = cv.take<float>(BK * LD);
  float* Vs = cv.take<float>(BK * LD);
  float* Qs = cv.take<float>(BQI * LD);
  float* dOs = cv.take<float>(BQI * LD);
  float* Ps = cv.take<float>(BQI * LDP);
  float* dSs = cv.take<float>(BQI * LDP);
  float* Ss = cv.take<float>(BQI * LDP);
  float* dPs = cv.take<float>(BQI * LDP);
  float* dKs = cv.take<float>(BK * LD);
  float* dVs = cv.take<float>(BK * LD);
  float* Lse = cv.take<float>(BQI);
  float* Dl = cv.take<float>(BQI);

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int krow0 = bh * Nk + k0;
  load_tile<BK, D>(Ks, LD, k + krow0 * D);
  load_tile<BK, D>(Vs, LD, v + krow0 * D);
  for (int e = threadIdx.x; e < BK * LD; e += NT) dKs[e] = dVs[e] = 0.f;
  for (int q0 = 0; q0 < Nq; q0 += BQI) {
    const int row0 = bh * Nq + q0;
    __syncthreads();  // the previous step is done with Qs, dOs, Ps, dSs, Lse, Dl
    load_tile<BQI, D>(Qs, LD, q + row0 * D);
    load_tile<BQI, D>(dOs, LD, dout + row0 * D);
    load_rows<BQI>(Lse, lse + row0);
    load_rows<BQI>(Dl, delta + row0);
    __syncthreads();
    block_mma<BQI, BK, D, false, true>(Qs, LD, Ks, LD, Ss, LDP, false);    // S = Q K^T
    block_mma<BQI, BK, D, false, true>(dOs, LD, Vs, LD, dPs, LDP, false);  // dP = dO V^T
    __syncthreads();
    for (int e = threadIdx.x; e < BQI * BK; e += NT) {
      const int rr = e / BK, c = e % BK;
      const float p = expf(Ss[rr * LDP + c] * scale - Lse[rr]);
      Ps[rr * LDP + c] = p;
      dSs[rr * LDP + c] = p * (dPs[rr * LDP + c] - Dl[rr]) * scale;
    }
    __syncthreads();
    block_mma<BK, D, BQI, true, false>(Ps, LDP, dOs, LD, dVs, LD, true);  // dV += P^T dO
    block_mma<BK, D, BQI, true, false>(dSs, LDP, Qs, LD, dKs, LD, true);  // dK += dS^T Q
  }
  __syncthreads();
  float* kout = dk + krow0 * D;
  float* vout = dv + krow0 * D;
  for (int e = threadIdx.x; e < BK * D; e += NT) {
    const int at = (e / D) * LD + e % D;
    kout[e] = dKs[at];
    vout[e] = dVs[at];
  }
}

static_assert(fwd_smem<128>() <= SMEM_MAX, "forward shared memory");
static_assert(dq_smem<128>() <= SMEM_MAX, "dQ shared memory");
static_assert(dkv_smem<128>() <= SMEM_MAX, "dK/dV shared memory");

// ------------------------------------------------------------------ host
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// (BH, rows, D) bf16 as a 3-D tensor map {D, rows, BH}: boxes of 64 columns x
// box_rows rows x 1 head; rows past the tensor's (a ragged tile) read zeros
// instead of the next head's.
template <int D>
cudaError_t head_map(CUtensorMap* map, const void* p, int rows, int bh, int box_rows) {
  return hopper::tensor_map_3d(map, p, D, rows, bh, D * 2ull, static_cast<uint64_t>(rows) * D * 2,
                               64, box_rows, 1);
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
    const cudaError_t e = head_map<D>(&maps[i], ptrs[i], rows[i], bh, i == 0 ? wg::BM : wg::BN);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int bytes = wg::Smem<D>::BYTES;
  cudaError_t e = allow_smem(wg::flash_fwd_wgmma<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_fwd_wgmma<D><<<dim3((nq + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), static_cast<float*>(lse), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

// The four operand maps of a bf16 backward kernel: q, k, v, dout, each with
// the box of its role (the block's own rows, BM, or a ring tile, BT).
template <int D>
cudaError_t bwd_maps(CUtensorMap (&maps)[4], const void* q, const void* k, const void* v,
                     const void* dout, int bh, int nq, int nk, bool query_blocks) {
  const int qbox = query_blocks ? wg::BM : wg::BT, kbox = query_blocks ? wg::BT : wg::BM;
  const void* ptrs[4] = {q, k, v, dout};
  const int rows[4] = {nq, nk, nk, nq};
  const int box[4] = {qbox, kbox, kbox, qbox};
  for (int i = 0; i < 4; ++i) {
    const cudaError_t e = head_map<D>(&maps[i], ptrs[i], rows[i], bh, box[i]);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int D>
int dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq_out, int bh, int nq, int nk, float scale,
             cudaStream_t s) {
  CUtensorMap maps[4];
  cudaError_t e = bwd_maps<D>(maps, q, k, v, dout, bh, nq, nk, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = wg::DqSmem<D>::BYTES;
  e = allow_smem(wg::flash_bwd_dq_wgmma<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_bwd_dq_wgmma<D><<<dim3((nq + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq_out), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int nq, int nk, float scale,
              cudaStream_t s) {
  CUtensorMap maps[4];
  cudaError_t e = bwd_maps<D>(maps, q, k, v, dout, bh, nq, nk, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = wg::DkvSmem<D>::BYTES;
  e = allow_smem(wg::flash_bwd_dkv_wgmma<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_bwd_dkv_wgmma<D><<<dim3((nk + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dq_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
           const void* delta, void* dq_out, int bh, int nq, int nk, float scale, cudaStream_t s) {
  constexpr int bytes = dq_smem<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dq_kernel<D><<<dim3(nq / BQ, bh), NT, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dq_out), nq, nk, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int dkv_f32(const void* q, const void* k, const void* v, const void* dout, const void* lse,
            const void* delta, void* dk, void* dv, int bh, int nq, int nk, float scale,
            cudaStream_t s) {
  constexpr int bytes = dkv_smem<D>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  flash_bwd_dkv_kernel<D><<<dim3(nk / BK, bh), NT, bytes, s>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(dout), static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), nq, nk,
      scale);
  return static_cast<int>(cudaGetLastError());
}

constexpr int BAD_ARGUMENT = -1;  // a head width, type or kernel the library does not take

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

// Dynamic shared memory of a bf16 kernel (0 forward, 1 dQ, 2 dK/dV) at head
// width d, for build reports.
extern "C" int flash_wgmma_smem(int kernel, int d) {
  if (d != 64 && d != 128) return BAD_ARGUMENT;
  const bool w = d == 128;
  switch (kernel) {
    case 0: return w ? wg::Smem<128>::BYTES : wg::Smem<64>::BYTES;
    case 1: return w ? wg::DqSmem<128>::BYTES : wg::DqSmem<64>::BYTES;
    case 2: return w ? wg::DkvSmem<128>::BYTES : wg::DkvSmem<64>::BYTES;
    default: return BAD_ARGUMENT;
  }
}

extern "C" int flash_bwd_dq_launch(int is_bf16, int d, const void* q, const void* k,
                                   const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dq_out, int bh, int nq, int nk,
                                   float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dq_wgmma<128>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dq_wgmma<64>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dq_f32<128>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dq_f32<64>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

extern "C" int flash_bwd_dkv_launch(int is_bf16, int d, const void* q, const void* k,
                                    const void* v, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, int bh, int nq,
                                    int nk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dkv_f32<128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dkv_f32<64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}
