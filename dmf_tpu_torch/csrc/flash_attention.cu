// Exact blocked (flash) attention over (BH, N, D) tensors: forward, dQ and dK/dV.
//
// Replaces the TPU kernels of dmf_tpu/ops/flash_attention.py, reached through
// `flash_attention` (:281) and its custom VJP (:261-277):
//   * `_flash_kernel` (:43)    -> wg::flash_fwd_wgmma (bf16), tf::flash_fwd_tf32x3 (fp32)
//   * `_bwd_dq_kernel` (:114)  -> wg::flash_bwd_dq_wgmma (bf16), tf::flash_bwd_dq_tf32x3 (fp32)
//   * `_bwd_dkv_kernel` (:144) -> wg::flash_bwd_dkv_wgmma (bf16), tf::flash_bwd_dkv_tf32x3 (fp32)
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
// The fp32 forward runs on the tensor cores as 3xTF32 (tf::flash_fwd_tf32x3,
// the bf16 forward's shape).  The tensor cores take fp32 only as TF32 (10
// mantissa bits), so every operand is split into hi = tf32(a) and lo =
// tf32(a - hi) and each k8 step sums hi*hi + hi*lo + lo*hi (lo*lo, ~2^-22
// relative, dropped): S = Q K^T and O += P V at fp32 accuracy for three
// times the TF32 work (bound: 3 x 4 BH Nq Nk D FLOP at 495 TFLOP/s).
//   * Shared memory decides the tiles.  Q's halves for 128 rows at D=128
//     take 128 KB, so K and V^T tiles of 32 keys (64 at D=64; 32 KB with
//     both halves) share one three-slot ring: K_0, V_0, K_1, ... (228 KB in
//     all).  A product of 32 keys reads 3 KB of shared memory for 16
//     tensor-core clocks, above the 128 bytes a clock it can take, so S
//     runs as two products a k8 step, not three: Q_hi [K_hi; K_lo]^T at
//     m64n64 (K's hi and lo rows stacked in the tile) and Q_lo K_hi^T at
//     m64n32, 7 KB instead of 9 (7-9 % off the forward's time on the H100).
//   * The consumers take turns issuing S (named barriers): one warpgroup's
//     softmax runs while the other's products do, where warpgroups in step
//     would leave the tensor cores idle through both softmaxes (10-11 %
//     off the forward's time on the H100).
//   * TF32 wgmma has no transpose bit: B must be K-major, so P V needs V^T
//     (keys contiguous).  A pre-pass (tf::flash_split on K, then on V,
//     launched by the same entry point) writes each key tile's K and V^T
//     halves into the caller's scratch as the slot's image, swizzled, so the
//     forward streams a slot with one bulk copy: every K/V tile is read by
//     N_q/128 query blocks, and a split (and a transpose) inside the loop
//     would repeat it that often, where the pre-pass reads K and V once and
//     writes 4 BH N_k D x 4 bytes (0.58 ms at BH=128, N=4096, D=128 on the
//     H100, against ~9 ms for the forward).  Q is read once per block and
//     split in shared memory by the consumers.
//   * P is the register A operand of O += P V, split into hi and lo in
//     registers.  The accumulator of S gives a thread keys 2(l%4) and
//     2(l%4)+1 of each k8 step, the A operand wants positions l%4 and
//     l%4+4: V^T's keys are stored in the order tf::perm8 so that the two
//     agree without shuffles.
//   * The tensor cores' own sum is coarser than an fp32 add (the 3xTF32
//     conv missed the fp32 tolerance with one accumulator over K = 27648),
//     so each tile's P V goes into an accumulator of its own, added into the
//     fp32 O after the rescale: the JAX kernel's acc * alpha + P V (one
//     accumulator across the key tiles, measured once on the H100, was
//     within the fp32 tolerance at N=4096 but 8-25x further from float64).
//     Each thread holds O and that sum (2 x D/2 registers) and P's halves
//     (2 x BN/2), or O and S's two accumulators (BN + BN/2): 160 values of
//     its 232 registers at D=128 (ptxas: 168 used, no spills).
//
// The fp32 backward runs as 3xTF32 too (tf::flash_bwd_dq_tf32x3,
// tf::flash_bwd_dkv_tf32x3; bounds 3 x 6 and 3 x 8 BH Nq Nk D FLOP at 495
// TFLOP/s: 2.499 and 3.332 ms at (32, 4096, 128)).
//   * No transpose bit.  S = Q K^T and dP = dO V^T take Q, K, dO and V as
//     they are stored (K-major over D), but dQ += dS K contracts over keys
//     (B = K^T), dV += P^T dO and dK += dS^T Q over queries (B = dO^T, Q^T).
//     The pre-pass (tf::flash_split, twice a call) writes each streamed tile
//     of BT rows as a row image (D/32 panels of 2 BT rows, hi rows then lo
//     rows: the forward's K layout) and, where a product contracts over its
//     rows, a transposed image (tcol: D rows of 2 BT values, hi then lo),
//     16 KB each, 128B-swizzled, into the caller's scratch: K, V and K^T for
//     dQ (6 x k's size, 1.5 GiB at (128, 4096, 128)); Q, dO, Q^T and dO^T
//     for dK/dV (8 x q's, 2 GiB), freed after the call.  The block's own
//     operands arrive by TMA and the consumers split them in shared memory.
//   * Shared memory binds.  Two own operands' halves take 2 KB a row at
//     D=128, so a block owns 64 rows (128 KB; the bf16 kernels' 128 rows
//     would need 256), and the other 99 KB hold six 16 KB slots: streamed
//     tiles of BT = 16 rows (32 at D=64, 64 KB own, ten slots).  Each of the
//     two consumer warpgroups has its own ring of three (five) slots and its
//     own producer thread.  dQ's warpgroups hold the same 64 query rows and
//     take the key tiles in turn, each with its own fp32 sum, added at the
//     end in a fixed order.  dK/dV's split the work: warpgroup 0 S^T, P^T
//     and dV, warpgroup 1 dP^T, dS^T and dK, P^T handed over through the
//     slot of the Q tile it came from; a thread then holds one output and
//     one tile sum (2 x D/2 registers), where dK, dV and a tile sum would
//     take 192 of its 232 registers before S^T.
//   * Shared-memory rate.  At BT=16 an S-type product runs as A_hi [B_hi;
//     B_lo]^T (m64n32k8) and A_lo B_hi^T (m64n16k8): 5.5 KB per 24
//     tensor-core clocks, 1.8x the 128 bytes a clock; the register-operand
//     products read 4 KB per 64 clocks.  That caps dQ (two S-type products
//     and one other a tile) near 74 % of its bound and dK/dV (two and two)
//     near 88 %.
//   * L2.  Every 64-row block streams its head's images: 12.6 MB (dQ) and
//     16.8 MB (dK/dV) at N=4096, D=128, 25.8 and 34.4 GB a call at BH=32
//     (5.0-5.6 TB/s at the kernels' times on the H100; ~10 TB/s at the
//     bounds).  Halving that (clusters of two row blocks, each image
//     multicast to both) did not make them faster on the H100: dK/dV took as
//     long, dQ longer.  L2 is not what holds them.
//   * P, P^T, dS and dS^T are the register A operand (m64nDk8 TF32, RS),
//     split into hi and lo in registers; transposed images keep each group
//     of 8 rows in perm8 order, as V^T in the forward, so the accumulator's
//     registers are the operand as they lie.  dK/dV computes the transposed
//     tiles S^T = K Q^T and dP^T = V dO^T (as the bf16 dK/dV does), so P^T
//     and dS^T sit in that layout already.
//   * Each tile's dS K, P^T dO or dS^T Q goes into a sum of its own (the
//     first product overwrites it), added into the fp32 dQ, dV or dK: the
//     JAX acc + dot, over 4096 keys or queries at N=4096 (one accumulator
//     inside the tensor cores is what missed the fp32 tolerance in the conv).
//   * Two kernels, each owning its output rows, no atomics, a fixed order of
//     sums: two calls give the same bits.
//
// Rounding points.  bf16: P (forward, dK/dV) and dS (dQ, dK/dV) are rounded
// to bf16 before they enter a tensor-core product; S, the softmax
// statistics, every accumulator and lse stay fp32; outputs are rounded once.
// fp32: every product is 3xTF32 (fp32-class, ~2^-22 relative per product);
// P, dS and every sum across tiles are fp32 (within a tile the tensor cores
// sum; P and dS are split into TF32 halves as they enter a product).  The
// plain version (ops/flash_attention.py::flash_attention_ref) computes
// everything in fp32 from the input-dtype operands and rounds the output
// once.
//
// Attention-weight dropout (flash_fwd_dropout_launch: the DROP instances of
// both forward kernels) replaces what XLA lowers for JAX's MC attention, the
// materialized weights, flax's dropout and the value product
// (dmf_tpu/models/transformer.py:45-49); no Pallas kernel is behind it.  No
// mask is written: P V takes P * keep / (1 - p), while the online softmax's m
// and l, and so the normalisation, are the undropped P's, as
// softmax-then-dropout.  The keep bit of a weight is one word of a
// Philox4x32-10 call (kernel 1's keep test, philox.cuh), and at H = 4 with a
// counter base that is a multiple of 4 a call's four words are the four
// heads' bits of one (row, q, k).  Two instances, chosen by the shape:
//   * DROP_SHARED (hs below; the served hybrid-nb sites): a pre-pass on
//     every SM makes one call for the G = 4 heads (2 on a 2-way shard) of a
//     weight and writes each head's bits in the order the consumers read
//     them; the forward reads one word a row a key tile, a tile ahead.
//   * DROP_EACH (every other shape, e.g. H = 2 or a base = 2 mod 4): each
//     consumer thread draws its own weights' bits in registers
//     (philox::keep1), one call a weight, three of its four words unused.
// The draw is integer issue (a call is ~57 SASS instructions: ~18 wide
// multiplies, the xors, the keep tests); inside the forward it only gets
// the issue slots that the softmax leaves, so the head-shared instance draws
// before the forward instead (PERF.md section 6 has the measurements).
// Both dropout instances write lse, the undropped P's.
//
// The backward of that dropout (JAX's training route, the same weights
// route; flash_bwd_dq_dropout_launch, flash_bwd_dkv_dropout_launch): with
// P~ = P keep / (1 - p) the forward's dropped weights and dP~ = dO V^T,
// dV = P~^T dO and dS = P (dP~ keep / (1 - p) - delta), delta = rowsum(dO
// O) as without dropout (sum_k P_k dP_k = sum_k P~_k dP~_k = dO . O); dQ and
// dK as without dropout from dS.  The DROP instances of the four backward
// kernels read the keep bits that a pre-pass writes a slab of rows at a
// time: hs::draw_bits (one call for G heads) where the forward's rule gives
// G > 1, else hs::draw_each (one call a weight: the backward has no
// per-element instance), in the forward's layout for dQ (query rows, key
// tiles of the forward's BN = 2 BT) and transposed for dK/dV (key rows,
// query tiles), so that a thread reads one word a row every BN / BT tiles.
// No mask is kept between the forward and the backward: the backward draws
// the bits again (twice: once a layout).
//
// Deliberately not carried over from the TPU: the (N, 1) column layout of
// lse/delta (here (BH, N) fp32 rows), the whole-sequence-in-VMEM K/V blocks
// and the 256/512 block sizes.  D is 64 or 128 and N a multiple of 64, so a
// block's 128 rows, or a forward tile of 128 keys, may be half full.  TMA
// reads zeros past N within a head (3-D tensor maps), never the next head's
// rows; rows past N are not written.  Zero rows give S = 0, not -inf, so the
// kernels mask what such rows would add: keys past N_k (-inf in the bf16
// forward, P = 0 in dQ) and queries past N_q (P = 0 in dK/dV).  Under the
// wrapper's multiple of 64 the backward's 64-row ring tiles are always full
// and those two masks never act; they keep a ragged tile exact.  The fp32
// kernels' blocks and tiles (64-row blocks, 16-64 row tiles) are always
// full: their launchers refuse an N they do not divide.
//
// Plain C interface for ctypes: each *_launch returns cudaGetLastError()
// after the launch (or the error of setting the shared-memory size or of
// encoding a tensor map).  Offsets are 32-bit: the wrapper rejects tensors
// of 2^31 elements or more.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "philox.cuh"

namespace {

constexpr int SMEM_MAX = 232448; // bytes of shared memory a block may use on sm_90
constexpr int BAD_ARGUMENT = -1; // a head width, type, length or kernel the library does not take

using bf16 = __nv_bfloat16;

// The forward's attention-weight dropout (the DROP instances of both forward
// kernels): the seed route's mask of the (B, H, N_q, N_k) weights of one MC
// site, whose seed order is (B, N_q, N_k, H) with H the whole head count.
// Grid row bh is row b = bh / local_heads of the call (rows pass-major,
// `rows` a pass) and head h = h0 + bh % local_heads of the H; weight (b, h,
// q, k) is element e = (((b mod rows) N_q + q) N_k + k) H + h of its pass
// (pass word pass0 + b / rows), kept by philox::keep1 at counter base + e.
// A model-axis shard (h0 > 0, local_heads < H) so draws its slice of the
// whole mask.
struct Dropout {
  const long long* seed;    // the request seed: one int64 on the device
  unsigned long long base;  // the site's counter of element 0 of each pass
  unsigned pass0;           // the pass word of the call's first pass
  int rows;                 // rows of a pass
  int heads;                // H, the whole head count
  int h0;                   // the call's first head among the H
  int local_heads;          // the call's heads a row: BH = B x local_heads
  float keep_prob;          // float32(1 - p)
  float drop_scale;         // float32(1 / (1 - p)): a kept weight's factor
  unsigned threshold;       // philox::keep_threshold(keep_prob): the head-shared keep test
  int group;                // G, the heads a Philox call serves (DROP_SHARED)
  const uint32_t* bits;     // DROP_SHARED: the pre-pass's keep bits of the call (hs::draw_bits)
};

// The forward kernels' instances: without dropout; with dropout, each
// consumer thread drawing its own weights' bits, one Philox call a weight
// (DROP_EACH, any shape); or reading the bits that a pre-pass drew, one
// call for G heads (DROP_SHARED, namespace hs below).
constexpr int DROP_NONE = 0, DROP_EACH = 1, DROP_SHARED = 2;

// A consumer thread's share of the mask: its two accumulator rows, q and q +
// 8, as the counters of their key 0, and the step from one key to the next.
struct DropRows {
  uint2 key;
  unsigned pass;
  unsigned long long at[2];
  unsigned step;  // H: the counter distance of neighbouring keys (N_k H < 2^32)
  float keep_prob, drop_scale;

  DropRows() = default;
  __device__ __forceinline__ DropRows(const Dropout& d, int bh, int q, int nq, int nk) {
    const int b = bh / d.local_heads, h = d.h0 + bh % d.local_heads;
    key = philox::seed_key(d.seed);
    pass = d.pass0 + static_cast<unsigned>(b / d.rows);
    step = static_cast<unsigned>(d.heads);
    const unsigned long long row = static_cast<unsigned long long>(b % d.rows) * nq + q;
#pragma unroll
    for (int r = 0; r < 2; ++r) at[r] = d.base + ((row + 8 * r) * nk) * step + h;
    keep_prob = d.keep_prob;
    drop_scale = d.drop_scale;
  }

  // p_ * keep / (1 - p) for the weight of row r (0: q, 1: q + 8) and key k
  __device__ __forceinline__ float drop(float p_, int r, int k) const {
    return philox::keep1(key, at[r] + static_cast<unsigned>(k) * step, pass, keep_prob)
               ? p_ * drop_scale
               : 0.0f;
  }
};

// ------------------------------------------------------- the head-shared draw
// DROP_SHARED, for H % 4 == 0 and a counter base % 4 == 0 (the served
// hybrid-nb sites): the four words of the Philox call of counter (e/4, pass)
// are the keep bits of heads 4m .. 4m + 3 of one (row, q, k), so one call
// serves the G heads of a group (G = 4, or 2 on a 2-way head shard, words
// 0-1 or 2-3) where DROP_EACH makes G.  A pre-pass (hs::draw_bits) makes
// those calls on every SM and writes each head's bits to global memory as
// the forward's consumers read them; the forward then reads one word a row
// a key tile, a tile ahead, and tests bits.  The draw so runs on every SM's
// integer pipes alone instead of in the issue slots that the forward's
// softmax leaves (a draw inside the forward, by the producer warpgroups of
// clusters of G blocks sharing each call over DSMEM, measured ~1.5x slower
// at the served shape: PERF.md section 6).  The keep test is the integer
// one (philox::keep_threshold), the same bits.
namespace hs {

constexpr int DRAW_THREADS = 128;  // threads a block of the pre-pass
constexpr int DRAW_CHUNKS = 4;     // chunks of 8 calls a pre-pass thread

// The bits of one (row, head): N_k rounded up to the key tile BN, BN / 32
// words a tile; position quad (BN/4) + 2j + e of a tile holds key 8j + 2
// quad + e, so consumer thread (lane l, quad = l % 4) reads the BN/4 bits of
// its accumulator fragment of a row as one aligned piece.
template <int BN>
__host__ __device__ constexpr int row_words(int nk) {
  return (nk + BN - 1) / BN * (BN / 32);
}

// The pre-pass: the keep bits of rows b0 .. b0 + gridDim.z / groups - 1 of
// the call (grid (1, R, rows x local_heads / G), one block a (row, head
// group, r)) into bits[((b - b0) local_heads + h) R + r][row_words] as rows
// r of columns c: the weights (q, k) = (r, c), R = N_q (the forward's and
// dQ's layout, query-major) or, `transposed`, (c, r), R = N_k (dK/dV's,
// key-major).  Chunk i of a (row, head group, r) is 8 calls: bit positions
// 8 (i % (BN/8)) .. + 7 of column tile i / (BN/8); byte g of x is head g's
// 8 bits of it.  The 4 lanes of a word transpose their bytes (shuffles,
// byte_perm) and lane g < G stores head g's word.  Each thread draws
// DRAW_CHUNKS chunks of its row under the round keys it computes once.
// Transposed, the call offsets need N_q N_k H / 4 < 2^32.
template <int BN>
__global__ void __launch_bounds__(DRAW_THREADS)
draw_bits(const Dropout d, uint32_t* __restrict__ bits, int b0, int nq, int nk, int transposed) {
  constexpr int CHUNKS_TILE = BN / 8;
  const int group = d.group, groups = d.local_heads / group;
  const int r = blockIdx.y, bg = blockIdx.z, gi = bg % groups, b = b0 + bg / groups;
  const int h_first = d.h0 + gi * group;  // the group's first head among the H
  const int words = row_words<BN>(transposed ? nq : nk), chunks = 4 * words;
  const philox::RoundKeys keys = philox::round_keys(philox::seed_key(d.seed));
  const unsigned pass = d.pass0 + static_cast<unsigned>(b / d.rows);
  const unsigned hq = static_cast<unsigned>(d.heads / 4);  // calls from one key to the next
  const unsigned col_step = transposed ? static_cast<unsigned>(nk) * hq : hq;  // a column's calls
  const unsigned long long row = transposed ? r : static_cast<unsigned long long>(r) * nk;
  const unsigned long long at =
      d.base / 4 + (static_cast<unsigned long long>(b % d.rows) * nq * nk + row) * hq +
      h_first / 4;
  const int lane = threadIdx.x % 32, l4 = lane % 4, quad4 = lane & ~3;
  const int sel = (h_first % 4 + l4) & 3;
  const unsigned pick = static_cast<unsigned>(sel | (sel + 4) << 4);
  uint32_t* out = bits + (static_cast<size_t>(bg / groups * d.local_heads + gi * group +
                                                min(l4, group - 1)) * gridDim.y +
                          r) * words;
  // every lane of a warp runs each chunk (the shuffles); past `chunks` none stores
  for (int i0 = blockIdx.x * DRAW_THREADS * DRAW_CHUNKS; i0 < chunks;
       i0 += gridDim.x * DRAW_THREADS * DRAW_CHUNKS) {
#pragma unroll
    for (int u = 0; u < DRAW_CHUNKS; ++u) {
      const int i = i0 + u * DRAW_THREADS + threadIdx.x;
      const int kt = i / CHUNKS_TILE, c = i % CHUNKS_TILE;
      const int quad = c / (CHUNKS_TILE / 4), j0 = 4 * (c % (CHUNKS_TILE / 4));
      const unsigned long long call =
          at + static_cast<unsigned>(kt * BN + 8 * j0 + 2 * quad) * col_step;
      uint4 w[8];  // columns 8 (j0 + bit/2) + 2 quad + bit % 2, bit = 0 .. 7
#pragma unroll
      for (int bit = 0; bit < 8; ++bit) {
        const unsigned long long n =
            call + static_cast<unsigned>(8 * (bit / 2) + bit % 2) * col_step;
        w[bit] = make_uint4(static_cast<unsigned>(n), static_cast<unsigned>(n >> 32), pass, 0u);
      }
      philox::philox4x32_10(w, keys);
      uint32_t x = 0;
#pragma unroll
      for (int bit = 0; bit < 8; ++bit)
        x |= (w[bit].x <= d.threshold ? 1u : 0u) << bit |
             (w[bit].y <= d.threshold ? 1u : 0u) << (8 + bit) |
             (w[bit].z <= d.threshold ? 1u : 0u) << (16 + bit) |
             (w[bit].w <= d.threshold ? 1u : 0u) << (24 + bit);
      const uint32_t x0 = __shfl_sync(0xffffffffu, x, quad4),
                     x1 = __shfl_sync(0xffffffffu, x, quad4 + 1),
                     x2 = __shfl_sync(0xffffffffu, x, quad4 + 2),
                     x3 = __shfl_sync(0xffffffffu, x, quad4 + 3);
      if (l4 < group && i < chunks)
        out[i / 4] =
            __byte_perm(__byte_perm(x0, x1, pick), __byte_perm(x2, x3, pick), 0x5410);
    }
  }
}

// The pre-pass of the other shapes (G = 1, which the backward needs: its
// kernels only read bits): draw_bits's output, one thread a word, each
// weight's bit by its own Philox call (philox::keep1; grid (words, R,
// rows x local_heads)).
template <int BN>
__global__ void __launch_bounds__(DRAW_THREADS)
draw_each(const Dropout d, uint32_t* __restrict__ bits, int b0, int nq, int nk, int transposed) {
  const int r = blockIdx.y, bl = blockIdx.z;
  const int b = b0 + bl / d.local_heads, h = d.h0 + bl % d.local_heads;
  const int ncols = transposed ? nq : nk, words = row_words<BN>(ncols);
  const int w = blockIdx.x * DRAW_THREADS + threadIdx.x;
  if (w >= words) return;
  const uint2 key = philox::seed_key(d.seed);
  const unsigned pass = d.pass0 + static_cast<unsigned>(b / d.rows);
  const unsigned long long e0 =
      d.base + static_cast<unsigned long long>(b % d.rows) * nq * nk * d.heads + h;
  const int tile = w / (BN / 32), first = 32 * (w % (BN / 32));  // the word's bit positions
  uint32_t x = 0;
  for (int i = 0; i < 32; ++i) {
    const int pos = first + i, quad = pos / (BN / 4), jj = pos % (BN / 4);
    const int col = tile * BN + 8 * (jj / 2) + 2 * quad + jj % 2;
    if (col >= ncols) continue;
    const unsigned long long qk = transposed ? static_cast<unsigned long long>(col) * nk + r
                                             : static_cast<unsigned long long>(r) * nk + col;
    x |= (philox::keep1(key, e0 + qk * d.heads, pass, d.keep_prob) ? 1u : 0u) << i;
  }
  bits[(static_cast<size_t>(bl) * gridDim.y + r) * words + w] = x;
}

// A consumer thread's bits of block row `row` (clamped to the R rows: a
// ragged block's rows past them are not written) in the pre-pass's output
// of rows of `ncols` bits: word kt (BN/32) of the returned pointer, shifted
// right by bits_shift<BN>, holds its BN/4 bits of column tile kt.
template <int BN>
__device__ __forceinline__ const uint32_t* bits_row(const Dropout& d, int bh, int row, int quad,
                                                    int nrows, int ncols) {
  return d.bits + (static_cast<size_t>(bh) * nrows + min(row, nrows - 1)) * row_words<BN>(ncols) +
         quad * (BN / 4) / 32;
}
template <int BN>
__device__ __forceinline__ int bits_shift(int quad) {
  return quad * (BN / 4) % 32;
}

// p_ / (1 - p) if bit `bit` of `bits` keeps, else 0: DropRows::drop's value.
__device__ __forceinline__ float drop_bit(float p_, uint32_t bits, int bit, float drop_scale) {
  return (bits >> bit) & 1u ? p_ * drop_scale : 0.0f;
}

// A backward consumer thread's keep bits: its accumulator rows row0 and
// row0 + 8 of the pre-pass's output (layout of tile BN), in column tiles of
// BT (BN a multiple of BT, BT >= 8).  Bit 2j + e of a word that `take`
// returns keeps column 8j + 2 quad + e of tile t, j < BT / 8; each word is
// loaded a take ahead (__ldg, as the forward reads them).
template <int BN, int BT>
struct TileBits {
  const uint32_t* at[2];
  uint32_t next[2];
  int shift;

  __device__ __forceinline__ void init(const Dropout& d, int bh, int row0, int quad, int nrows,
                                       int ncols, int t0) {
    shift = bits_shift<BN>(quad);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      at[r] = bits_row<BN>(d, bh, row0 + 8 * r, quad, nrows, ncols);
      next[r] = __ldg(at[r] + t0 / (BN / BT) * (BN / 32));
    }
  }

  // tile t's bits into `bits` (t the tile of the last load); loads tile t_next's
  __device__ __forceinline__ void take(int t, int t_next, int tiles, uint32_t (&bits)[2]) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      bits[r] = next[r] >> (shift + t % (BN / BT) * (BT / 4));
      if (t_next < tiles) next[r] = __ldg(at[r] + t_next / (BN / BT) * (BN / 32));
    }
  }
};

}  // namespace hs

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

// DROP (DROP_EACH, DROP_SHARED): the dropout instances (Dropout above); P
// enters O += P V dropped and scaled, while m, l and so lse stay those of the
// undropped P (the lse the backward's dropout instances take).  DROP_SHARED
// reads the pre-pass's bits (hs).
template <int D, int DROP>
__global__ void __launch_bounds__(THREADS, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                const __grid_constant__ CUtensorMap vmap, bf16* __restrict__ out,
                float* __restrict__ lse, int Nq, int Nk, float scale, const Dropout dropout) {
  using namespace hopper;
  using L = Smem<D>;
  constexpr int PANELS = D / 64;
  constexpr bool SHARED = DROP == DROP_SHARED;
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
    const int brow = wgi * 64 + (t / 32) * 16 + lane / 4;  // this thread's first block row
    [[maybe_unused]] const DropRows drows =
        DROP == DROP_EACH ? DropRows(dropout, bh, q0 + brow, Nq, Nk) : DropRows();
    // DROP_SHARED: rows brow and brow + 8 of the pre-pass's bits, each key
    // tile's words loaded a tile ahead
    [[maybe_unused]] const uint32_t* brows[2] = {};
    [[maybe_unused]] uint32_t next[2] = {};
    if constexpr (SHARED) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        brows[r] = hs::bits_row<BN>(dropout, bh, q0 + brow + 8 * r, quad, Nq, Nk);
        next[r] = __ldg(brows[r]);
      }
    }
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
      [[maybe_unused]] uint32_t bits[2];  // DROP_SHARED: this tile's, the next one's loading
      if constexpr (SHARED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bits[r] = next[r] >> hs::bits_shift<BN>(quad);
          if (kt + 1 < nkt) next[r] = __ldg(brows[r] + (kt + 1) * (BN / 32));
        }
      }
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
        float p0 = exp2f(fmaf(sacc[4 * j], c, -mc[0]));
        float p1 = exp2f(fmaf(sacc[4 * j + 1], c, -mc[0]));
        float p2 = exp2f(fmaf(sacc[4 * j + 2], c, -mc[1]));
        float p3 = exp2f(fmaf(sacc[4 * j + 3], c, -mc[1]));
        sum[0] += p0 + p1;
        sum[1] += p2 + p3;
        if constexpr (DROP == DROP_EACH) {  // keys k, k + 1 of rows q, q + 8
          const int k = kt * BN + 8 * j + 2 * quad;
          p0 = drows.drop(p0, 0, k);
          p1 = drows.drop(p1, 0, k + 1);
          p2 = drows.drop(p2, 1, k);
          p3 = drows.drop(p3, 1, k + 1);
        } else if constexpr (SHARED) {
          p0 = hs::drop_bit(p0, bits[0], 2 * j, dropout.drop_scale);
          p1 = hs::drop_bit(p1, bits[0], 2 * j + 1, dropout.drop_scale);
          p2 = hs::drop_bit(p2, bits[1], 2 * j, dropout.drop_scale);
          p3 = hs::drop_bit(p3, bits[1], 2 * j + 1, dropout.drop_scale);
        }
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
    const int row0 = q0 + brow;
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

// DROP: the dropout instance (the training route's attention-weight
// dropout): dS = P (dP~ keep / (1 - p) - delta) scale, dP~ = dO V^T the
// gradient of the dropped weights, on the pre-pass's keep bits (hs, the
// forward's layout: query rows, key tiles of BN = 2 BT).
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap,
                   const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap,
                   const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                   const float* __restrict__ delta, bf16* __restrict__ dq, int Nq, int Nk,
                   float scale, const Dropout dropout) {
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
    [[maybe_unused]] hs::TileBits<BN, BT> tb;
    if constexpr (DROP) tb.init(dropout, bh, row0, quad, Nq, Nk, 0);
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
      [[maybe_unused]] uint32_t bits[2];  // DROP: this tile's keep bits, the next one's loading
      if constexpr (DROP) tb.take(kt, kt + 1, nkt, bits);
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
        float g[4] = {dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]};
        if constexpr (DROP) {  // keys 8j + 2 quad + e of rows q (bits[0]) and q + 8 (bits[1])
#pragma unroll
          for (int e = 0; e < 4; ++e)
            g[e] = hs::drop_bit(g[e], bits[e / 2], 2 * j + e % 2, dropout.drop_scale);
        }
        const float d0 = s[4 * j] * (g[0] - dl[0]) * scale;
        const float d1 = s[4 * j + 1] * (g[1] - dl[0]) * scale;
        const float d2 = s[4 * j + 2] * (g[2] - dl[1]) * scale;
        const float d3 = s[4 * j + 3] * (g[3] - dl[1]) * scale;
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

// DROP: the dropout instance: dV += P~^T dO with P~ = P keep / (1 - p), and
// dS^T = P^T (dP~^T keep / (1 - p) - delta) scale, on the pre-pass's keep
// bits in the transposed layout (key rows, query tiles of BN = 2 BT).
template <int D, bool DROP>
__global__ void __launch_bounds__(THREADS, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap,
                    const __grid_constant__ CUtensorMap domap, const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dk,
                    bf16* __restrict__ dv, int Nq, int Nk, float scale, const Dropout dropout) {
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
    const int row0 = k0 + wgi * 64 + acc_row(t);
    [[maybe_unused]] hs::TileBits<BN, BT> tb;
    if constexpr (DROP) tb.init(dropout, bh, row0, quad, Nk, Nq, 0);
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
      [[maybe_unused]] uint32_t bits[2];  // DROP: this tile's keep bits, the next one's loading
      if constexpr (DROP) tb.take(qt, qt + 1, nqt, bits);
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
        // DROP: the dropped P^T and dP~^T keep / (1 - p), queries col + e % 2
        // of keys row0 (bits[0]) and row0 + 8 (bits[1])
        float pt[4] = {p[0], p[1], p[2], p[3]};
        float g[4] = {dp[4 * j], dp[4 * j + 1], dp[4 * j + 2], dp[4 * j + 3]};
        if constexpr (DROP) {
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            pt[e] = hs::drop_bit(pt[e], bits[e / 2], 2 * j + e % 2, dropout.drop_scale);
            g[e] = hs::drop_bit(g[e], bits[e / 2], 2 * j + e % 2, dropout.drop_scale);
          }
        }
        pa[j / 2][(j % 2) * 2] = pack_bf16(pt[0], pt[1]);
        pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(pt[2], pt[3]);
        da[j / 2][(j % 2) * 2] = pack_bf16(p[0] * (g[0] - d2.x) * scale,
                                           p[1] * (g[1] - d2.y) * scale);
        da[j / 2][(j % 2) * 2 + 1] = pack_bf16(p[2] * (g[2] - d2.x) * scale,
                                               p[3] * (g[3] - d2.y) * scale);
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
    store_rows<D>(dk + bh * Nk * D, acc_k, row0, Nk, quad);
    store_rows<D>(dv + bh * Nk * D, acc_v, row0, Nk, quad);
  }
}

}  // namespace wg

// ------------------------------------------------------- fp32 forward (3xTF32 wgmma)
namespace tf {

constexpr int BM = 128;             // query rows per block: two consumer warpgroups of 64
constexpr int SLOT = 32768;         // a ring slot: one K or V^T tile, hi half then lo half
constexpr int SLOTS = 3;            // ring depth; K and V tiles take turns
constexpr int SPLIT_THREADS = 256;  // threads per block of the pre-pass (flash_split)

// Key order inside each group of 8 keys of a V^T tile: position c holds key
// perm8(c).  The accumulator of S = Q K^T gives thread (lane l) the keys
// 2(l%4) and 2(l%4)+1 of each k8 step, and the register A operand of P V
// wants positions l%4 and l%4 + 4 (hopper.cuh); with V^T's keys in this
// order P's registers are the A operand as they lie, no shuffles.
__host__ __device__ constexpr int perm8(int c) { return c < 4 ? 2 * c : 2 * (c - 4) + 1; }

// Shared memory: Q_hi and Q_lo (D/32 panels of BM x 128 B each), the ring,
// then the barriers.  A K tile holds BN keys x D as D/32 panels of 2 BN
// rows, the keys' hi rows then their lo rows, so that Q_hi [K_hi; K_lo]^T is
// one m64n(2BN)k8 product per k8 step; a V^T tile holds D x BN keys as BN/32
// panels of D rows, hi half then lo half.  Each half of a slot is 16 KB, so
// BN = 32 at D=128 and 64 at D=64.
template <int D>
struct Layout {
  static constexpr int BN = SLOT / (2 * D * 4);  // keys per tile
  static constexpr int PANELS = D / 32;           // 128-byte column panels of a Q or K row
  static constexpr int Q_HALF = BM * D * 4;
  static constexpr int RING_OFF = 2 * Q_HALF;
  static constexpr int BAR_OFF = RING_OFF + SLOTS * SLOT;
  static constexpr int BYTES = BAR_OFF + 8 * (1 + 2 * SLOTS) + 1024;  // + alignment slack
};
static_assert(Layout<128>::BYTES <= SMEM_MAX, "3xTF32 forward shared memory");

// Four fp32 values as their TF32 halves: hi = rna(x) at `hi`, lo = rna(x - hi) at `lo`.
__device__ __forceinline__ void split4(float4 x, unsigned char* hi, unsigned char* lo) {
  using hopper::tf32_rna;
  const float4 h = make_float4(tf32_rna(x.x), tf32_rna(x.y), tf32_rna(x.z), tf32_rna(x.w));
  *reinterpret_cast<float4*>(hi) = h;
  *reinterpret_cast<float4*>(lo) = make_float4(tf32_rna(x.x - h.x), tf32_rna(x.y - h.y),
                                               tf32_rna(x.z - h.z), tf32_rna(x.w - h.w));
}

// A transposed tile image (V^T in the forward, K^T, Q^T and dO^T in the
// backward): D rows of 2 BN values, the hi halves of the tile's BN rows
// (keys or queries, in perm8 order within each group of 8) then their lo
// halves, in 128-byte panels of D rows.  Byte offset of value u of row 0 (u
// a multiple of 4).
template <int D>
__host__ __device__ constexpr int tcol(int u) {
  return (u / 32) * D * 128 + (u % 32) * 4;
}

// The fp32 kernels' pre-pass: tile t (BT rows) of head bh of x (BH, N, D)
// becomes, unless null, its row image at `rows` (D/32 panels of 2 BT rows,
// the hi rows then the lo rows: the B operand of S = Q K^T-type products)
// and its transposed image at `cols` (tcol: the B operand of the products
// that contract over the tile's rows), both (bh * N/BT + t) * stride bytes
// on and 128B-swizzled: byte for byte what a ring slot holds, so a kernel
// fetches each with one bulk copy.  Every tile is read by every block of
// the other side; the pre-pass splits (and transposes) it once.
template <int D, int BT>
__global__ void __launch_bounds__(SPLIT_THREADS)
flash_split(const float* __restrict__ x, unsigned char* __restrict__ rows,
            unsigned char* __restrict__ cols, int N, int stride) {
  __shared__ float xs[BT][D + 1];
  const int t = blockIdx.x, bh = blockIdx.y;
  const size_t at = (static_cast<size_t>(bh) * (N / BT) + t) * stride;
  const float4* xt =
      reinterpret_cast<const float4*>(x + (static_cast<size_t>(bh) * N + t * BT) * D);
  // chunk c4 (4 columns) of row r -> panel c4/8, rows r (hi) and BT + r (lo), swizzled chunk c4%8
  for (int e = threadIdx.x; e < BT * D / 4; e += SPLIT_THREADS) {
    const int r = e / (D / 4), c4 = e % (D / 4);
    const float4 v = xt[e];
    if (rows != nullptr) {
      const uint32_t off = (c4 / 8) * 2 * BT * 128 + hopper::sw128(r, c4 % 8);
      split4(v, rows + at + off, rows + at + BT * 128 + off);
    }
    xs[r][4 * c4] = v.x;
    xs[r][4 * c4 + 1] = v.y;
    xs[r][4 * c4 + 2] = v.z;
    xs[r][4 * c4 + 3] = v.w;
  }
  if (cols == nullptr) return;
  __syncthreads();
  // positions u..u+3 of column d (rows g + perm8(u%8..), g = u - u%8): hi at value u, lo at BT + u
  for (int e = threadIdx.x; e < D * BT / 4; e += SPLIT_THREADS) {
    const int d = e / (BT / 4), u = 4 * (e % (BT / 4));
    const int g = u - u % 8, c = u % 8;
    const float4 v = make_float4(xs[g + perm8(c)][d], xs[g + perm8(c + 1)][d],
                                 xs[g + perm8(c + 2)][d], xs[g + perm8(c + 3)][d]);
    const auto pos = [d](int w) {  // value w of row d: panel w/32, swizzled chunk (w%32)/4
      return (w / 32) * D * 128 + hopper::sw128(d, (w % 32) / 4);
    };
    split4(v, cols + at + pos(u), cols + at + pos(BT + u));
  }
}

// S (+)= A B^T over one k8 step, N rows of B.
template <int N>
__device__ __forceinline__ void score_step(float (&s)[N / 2], uint64_t a, uint64_t b, int acc);
template <>
__device__ __forceinline__ void score_step<16>(float (&s)[8], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n16k8_tf32_ss(s, a, b, acc);
}
template <>
__device__ __forceinline__ void score_step<32>(float (&s)[16], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n32k8_tf32_ss(s, a, b, acc);
}
template <>
__device__ __forceinline__ void score_step<64>(float (&s)[32], uint64_t a, uint64_t b, int acc) {
  hopper::wgmma_m64n64k8_tf32_ss(s, a, b, acc);
}
template <>
__device__ __forceinline__ void score_step<128>(float (&s)[64], uint64_t a, uint64_t b,
                                                int acc) {
  hopper::wgmma_m64n128k8_tf32_ss(s, a, b, acc);
}

// O (+)= P V over one k8 step, N = D, P from registers.
template <int D>
__device__ __forceinline__ void value_step(float (&o)[D / 2], const uint32_t (&a)[4], uint64_t b,
                                           int acc);
template <>
__device__ __forceinline__ void value_step<64>(float (&o)[32], const uint32_t (&a)[4], uint64_t b,
                                               int acc) {
  hopper::wgmma_m64n64k8_tf32_rs(o, a, b, acc);
}
template <>
__device__ __forceinline__ void value_step<128>(float (&o)[64], const uint32_t (&a)[4],
                                                uint64_t b, int acc) {
  hopper::wgmma_m64n128k8_tf32_rs(o, a, b, acc);
}

// sa = A_hi [B_hi; B_lo]^T (hi*hi in its first BN columns, hi*lo in the next
// BN) and sb = A_lo B_hi^T over D in k8 steps, each the tile's own sum: two
// products a step where three would each read A_hi or B_hi again.  A: 64
// rows of resident panels of ROWS rows (hi at ah, lo at al); B: a row image
// of BN rows, D/32 panels of 2 BN rows (hi rows, then lo rows).
template <int D, int BN, int ROWS>
__device__ __forceinline__ void score_tile(float (&sa)[BN], float (&sb)[BN / 2],
                                           const unsigned char* ah, const unsigned char* al,
                                           const unsigned char* b) {
  using hopper::desc_sw128;
#pragma unroll
  for (int kk = 0; kk < D / 8; ++kk) {
    const int ao = (kk / 4) * ROWS * 128 + (kk % 4) * 32;  // 32 bytes inside a 32-column panel
    const uint64_t bd = desc_sw128(b + (kk / 4) * 2 * BN * 128 + (kk % 4) * 32, 16, 1024);
    score_step<2 * BN>(sa, desc_sw128(ah + ao, 16, 1024), bd, kk > 0);
    score_step<BN>(sb, desc_sw128(al + ao, 16, 1024), bd, kk > 0);
  }
}

// acc = A B over a transposed image of BN rows (the tile's own sum: the first
// product overwrites acc), A's TF32 halves from registers: per k8 step
// hi*hi + lo*hi + hi*lo.  P V in the forward; dS K, P^T dO and dS^T Q in the
// backward.
template <int D, int BN>
__device__ __forceinline__ void value_tile(float (&acc)[D / 2], const uint32_t (&ph)[BN / 8][4],
                                           const uint32_t (&pl)[BN / 8][4],
                                           const unsigned char* vs) {
  using hopper::desc_sw128;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const uint64_t vh = desc_sw128(vs + tcol<D>(8 * j), 16, 1024);
    value_step<D>(acc, ph[j], vh, j > 0);
    value_step<D>(acc, pl[j], vh, 1);
    value_step<D>(acc, ph[j], desc_sw128(vs + tcol<D>(BN + 8 * j), 16, 1024), 1);
  }
}

// The TF32 halves of four accumulator values as one k8 step's register A
// operand, in the order of an operand stored in perm8 order: a thread's
// values {x0, x1} (row g) and {x2, x3} (row g + 8) of keys 2(l%4) and
// 2(l%4)+1 are positions (row g, l%4), (g + 8, l%4), (g, l%4 + 4), (g + 8,
// l%4 + 4): a = {x0, x2, x1, x3}.
__device__ __forceinline__ void a_halves(float x0, float x1, float x2, float x3, uint32_t (&hi)[4],
                                         uint32_t (&lo)[4]) {
  const float x[4] = {x0, x2, x1, x3};
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float h = hopper::tf32_rna(x[e]);
    hi[e] = __float_as_uint(h);
    lo[e] = __float_as_uint(hopper::tf32_rna(x[e] - h));
  }
}

// Each tile's P V goes into an accumulator of its own, added into the fp32 O
// after the rescale (the JAX kernel's acc * alpha + P V).  DROP: the dropout
// instances, as the bf16 kernel's (P dropped and scaled before its split; m,
// l and lse undropped; DROP_SHARED on the pre-pass's bits).
template <int D, int DROP>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_fwd_tf32x3(const __grid_constant__ CUtensorMap qmap, const unsigned char* __restrict__ img,
                 float* __restrict__ out, float* __restrict__ lse, int Nq, int Nk, float scale,
                 const Dropout dropout) {
  using namespace hopper;
  using L = Layout<D>;
  constexpr int BN = L::BN, PANELS = L::PANELS;
  constexpr bool SHARED = DROP == DROP_SHARED;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  unsigned char* ring = smem + L::RING_OFF;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + SLOTS;
  const int bh = blockIdx.y, q0 = blockIdx.x * BM;
  const int nkt = Nk / BN;  // the launcher takes N_k a multiple of BN: no ragged key tile
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < SLOTS; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], wg::CONSUMERS);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= wg::CONSUMERS) {
    // ---- producer: Q once (TMA, zeros past N_q), then K_0, V_0, K_1, ... one
    // bulk copy of a slot image each
    reg_dealloc<40>();
    if (threadIdx.x == wg::CONSUMERS) {
      mbar_arrive_expect_tx(q_full, L::Q_HALF);
      for (int p = 0; p < PANELS; ++p)
        tma_load_3d(smem + p * BM * 128, &qmap, q_full, p * 32, q0, bh);
      const unsigned char* src = img + static_cast<size_t>(bh) * nkt * 2 * SLOT;
      for (int i = 0; i < 2 * nkt; ++i) {
        const int s = i % SLOTS;
        mbar_wait(&empty[s], ((i / SLOTS) & 1) ^ 1);
        mbar_arrive_expect_tx(&full[s], SLOT);
        bulk_load(ring + s * SLOT, src + static_cast<size_t>(i) * SLOT, SLOT, &full[s]);
      }
    }
  } else {
    // ---- consumers: 64 query rows per warpgroup
    reg_alloc<232>();
    const int wgi = threadIdx.x / 128, t = threadIdx.x % 128;
    const int lane = t % 32, quad = lane % 4;
    const float c = scale * wg::kLog2e;  // S -> log2 units
    unsigned char* qh = smem + wgi * 64 * 128;  // this warpgroup's rows of each panel
    const unsigned char* ql = qh + L::Q_HALF;
    // Q is read by every key tile: split once, hi in place and lo into Q_lo
    mbar_wait(q_full, 0);
#pragma unroll
    for (int p = 0; p < PANELS; ++p)
#pragma unroll
      for (int j = t; j < 64 * 8; j += 128) {  // 16-byte chunks of 64 rows of the panel
        unsigned char* at = qh + p * BM * 128 + 16 * j;
        split4(*reinterpret_cast<const float4*>(at), at, at + L::Q_HALF);
      }
    fence_proxy_async();
    named_barrier(1 + wgi, 128);  // the warpgroup's split is visible to its wgmma
    // The warpgroups take turns issuing S (barriers 3 + w): warpgroup 1's S
    // queues behind warpgroup 0's on the tensor cores, so one warpgroup's
    // softmax runs while the other's products do, instead of both at once.
    // Warpgroup 0 goes first; warpgroup 1 skips its last signal, so every
    // arrival is waited on.
    if (wgi == 1) named_barrier_arrive(3, 256);

    float sa[BN], sb[BN / 2], o[D / 2], part[D / 2];
#pragma unroll
    for (int i = 0; i < BN; ++i) sa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) sb[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) part[i] = 0.f;
    float m[2] = {-1e30f, -1e30f}, l[2] = {0.f, 0.f};
    const int brow = wgi * 64 + (t / 32) * 16 + lane / 4;  // this thread's first block row
    [[maybe_unused]] const DropRows drows =
        DROP == DROP_EACH ? DropRows(dropout, bh, q0 + brow, Nq, Nk) : DropRows();
    // DROP_SHARED: rows brow and brow + 8 of the pre-pass's bits, each key
    // tile's words loaded a tile ahead
    [[maybe_unused]] const uint32_t* brows[2] = {};
    [[maybe_unused]] uint32_t next[2] = {};
    if constexpr (SHARED) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        brows[r] = hs::bits_row<BN>(dropout, bh, q0 + brow + 8 * r, quad, Nq, Nk);
        next[r] = __ldg(brows[r]);
      }
    }
    for (int kt = 0; kt < nkt; ++kt) {
      const int ik = 2 * kt, iv = ik + 1;  // ring items of this tile's K and V^T
      const unsigned char* ks = ring + (ik % SLOTS) * SLOT;
      const unsigned char* vs = ring + (iv % SLOTS) * SLOT;
      // S = Q K^T over D in k8 steps (32 bytes inside a 32-column panel):
      // sa = Q_hi [K_hi; K_lo]^T (hi*hi in its first BN columns, hi*lo in
      // the next BN) and sb = Q_lo K_hi^T, two products a step where three
      // would each read Q_hi or K_hi again
      mbar_wait(&full[ik % SLOTS], (ik / SLOTS) & 1);
      named_barrier(3 + wgi, 256);  // this warpgroup's turn
      wgmma_fence();
      score_tile<D, BN, BM>(sa, sb, qh, ql, ks);
      wgmma_commit();
      if (wgi == 0 || kt + 1 < nkt) named_barrier_arrive(4 - wgi, 256);  // the other's turn
      [[maybe_unused]] uint32_t bits[2];  // DROP_SHARED: this tile's, the next one's loading
      if constexpr (SHARED) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bits[r] = next[r] >> hs::bits_shift<BN>(quad);
          if (kt + 1 < nkt) next[r] = __ldg(brows[r] + (kt + 1) * (BN / 32));
        }
      }
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(sb);
      mbar_arrive(&empty[ik % SLOTS]);  // K's slot refills while the softmax runs
      float s[BN / 2];  // hi*hi + hi*lo + lo*hi of this thread's keys
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) s[i] = sa[i] + sa[i + BN / 2] + sb[i];
      // online softmax on the registers: row h of this thread is 16w + l/4 + 8h
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
      // P and its TF32 halves as the A operand of each k8 step (perm8)
      uint32_t ph[BN / 8][4], pl[BN / 8][4];
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        float p[4] = {exp2f(fmaf(s[4 * j], c, -mc[0])), exp2f(fmaf(s[4 * j + 1], c, -mc[0])),
                      exp2f(fmaf(s[4 * j + 2], c, -mc[1])), exp2f(fmaf(s[4 * j + 3], c, -mc[1]))};
        sum[0] += p[0] + p[1];
        sum[1] += p[2] + p[3];
        if constexpr (DROP == DROP_EACH) {  // keys k, k + 1 of rows q, q + 8
          const int k = kt * BN + 8 * j + 2 * quad;
          p[0] = drows.drop(p[0], 0, k);
          p[1] = drows.drop(p[1], 0, k + 1);
          p[2] = drows.drop(p[2], 1, k);
          p[3] = drows.drop(p[3], 1, k + 1);
        } else if constexpr (SHARED) {
          p[0] = hs::drop_bit(p[0], bits[0], 2 * j, dropout.drop_scale);
          p[1] = hs::drop_bit(p[1], bits[0], 2 * j + 1, dropout.drop_scale);
          p[2] = hs::drop_bit(p[2], bits[1], 2 * j, dropout.drop_scale);
          p[3] = hs::drop_bit(p[3], bits[1], 2 * j + 1, dropout.drop_scale);
        }
        a_halves(p[0], p[1], p[2], p[3], ph[j], pl[j]);
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 1);
        sum[h] += __shfl_xor_sync(0xffffffffu, sum[h], 2);
        l[h] = l[h] * alpha[h] + sum[h];
      }
      // O += P V, V^T K-major (keys contiguous): 8 keys are 32 bytes of a panel
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {  // packed before the fence
        fence_regs(ph[j]);
        fence_regs(pl[j]);
      }
      mbar_wait(&full[iv % SLOTS], (iv / SLOTS) & 1);
      wgmma_fence();
      value_tile<D, BN>(part, ph, pl, vs);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        fence_regs(ph[j]);
        fence_regs(pl[j]);
      }
      mbar_arrive(&empty[iv % SLOTS]);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] = fmaf(o[4 * j], alpha[0], part[4 * j]);
        o[4 * j + 1] = fmaf(o[4 * j + 1], alpha[0], part[4 * j + 1]);
        o[4 * j + 2] = fmaf(o[4 * j + 2], alpha[1], part[4 * j + 2]);
        o[4 * j + 3] = fmaf(o[4 * j + 3], alpha[1], part[4 * j + 3]);
      }
    }
    // epilogue: out = O / l, lse = m * scale + log(l); rows past N_q not written
    const int row0 = q0 + brow;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + 8 * h;
      if (row >= Nq) continue;
      const int at = bh * Nq + row;
      if (quad == 0) lse[at] = m[h] * scale + logf(l[h]);
      float* orow = out + at * D + 2 * quad;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(orow + 8 * j) =
            make_float2(o[4 * j + 2 * h] / l[h], o[4 * j + 2 * h + 1] / l[h]);
    }
  }
}

// ------------------------------------------------------- fp32 backward (3xTF32 wgmma)
constexpr int BWD_ROWS = 64;     // output rows a backward block owns: queries (dQ) or keys (dK/dV)
constexpr int ITEM = 16384;      // a backward ring slot: one streamed tile's image, both halves

// Backward shared memory: the block's two resident operands (Q and dO for
// dQ, K and V for dK/dV), each hi then lo in D/32 panels of 64 rows, then a
// ring of SPW slots per consumer warpgroup, then the barriers.  A streamed
// tile of BT rows is 16 KB as either image, so BT = 16 at D=128 and 32 at
// D=64; what is left of the 227 KB after the 128 (64) KB resident operands
// holds 6 (10) slots.
template <int D>
struct BwdLayout {
  static constexpr int BT = ITEM / (8 * D);        // rows of a streamed tile
  static constexpr int SPW = D == 128 ? 3 : 5;     // ring slots per consumer warpgroup, odd
  static constexpr int HALF = BWD_ROWS * D * 4;    // one TF32 half of a resident operand
  static constexpr int RING_OFF = 4 * HALF;
  static constexpr int BAR_OFF = RING_OFF + 2 * SPW * ITEM;
  // the resident operands'; full and empty per slot; P handed over, per slot of warpgroup 0
  static constexpr int BARS = 1 + 5 * SPW;
  static constexpr int BYTES = BAR_OFF + 8 * BARS + 1024;  // + alignment slack
};
static_assert(BwdLayout<128>::BYTES <= SMEM_MAX && BwdLayout<64>::BYTES <= SMEM_MAX,
              "3xTF32 backward shared memory");

// The consumers split a resident operand once: hi in place, lo HALF bytes on
// (chunks j0, j0 + step, ... of the 16-byte chunks at `base`).
template <int D>
__device__ __forceinline__ void split_resident(unsigned char* base, int j0, int step) {
  for (int j = j0; j < BwdLayout<D>::HALF / 16; j += step) {
    unsigned char* at = base + 16 * j;
    split4(*reinterpret_cast<const float4*>(at), at, at + BwdLayout<D>::HALF);
  }
}

// Writes 64 rows of an fp32 accumulator (this thread's rows row0, row0 + 8).
template <int D>
__device__ __forceinline__ void store_acc(float* __restrict__ dst, const float (&acc)[D / 2],
                                          int row0, int quad) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float* r = dst + (row0 + 8 * h) * D + 2 * quad;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<float2*>(r + 8 * j) =
          make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
  }
}

// dQ for 64 query rows.  The two consumer warpgroups hold the same rows and
// take the key tiles in turn (warpgroup w the tiles t = w mod 2), each with
// its own ring fed by its own producer thread: K's row image (S = Q K^T),
// V's (dP = dO V^T), K's transposed image (dQ += dS K).  Each warpgroup adds
// each tile's dS K into its fp32 sum; at the end warpgroup 0 adds warpgroup
// 1's sum into its own.  img: the planes of K rows, V rows and K^T, each
// BH x N_k/BT tiles.  DROP: the dropout instance, as the bf16 kernel's (the
// keep bits in the forward's layout, key tiles of the forward's BN = 2 BT).
template <int D, bool DROP>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_bwd_dq_tf32x3(const __grid_constant__ CUtensorMap qmap,
                    const __grid_constant__ CUtensorMap domap,
                    const unsigned char* __restrict__ img, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int Nq, int Nk,
                    float scale, const Dropout dropout) {
  using namespace hopper;
  using L = BwdLayout<D>;
  constexpr int BT = L::BT, SPW = L::SPW, PANELS = D / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = res_full + 1;  // [warpgroup][slot]
  uint64_t* empty = full + 2 * SPW;
  const int bh = blockIdx.y, q0 = blockIdx.x * BWD_ROWS;
  const int nkt = Nk / BT;  // even: N_k is a multiple of 64
  const size_t plane = static_cast<size_t>(gridDim.y) * nkt * ITEM;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < 2 * SPW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= wg::CONSUMERS) {
    // ---- producer: Q and dO once; thread 32w feeds warpgroup w's ring
    reg_dealloc<40>();
    const int p = threadIdx.x - wg::CONSUMERS;
    if (p == 0) {
      mbar_arrive_expect_tx(res_full, 2 * L::HALF);
      for (int c = 0; c < PANELS; ++c) {
        tma_load_3d(smem + c * BWD_ROWS * 128, &qmap, res_full, c * 32, q0, bh);
        tma_load_3d(smem + 2 * L::HALF + c * BWD_ROWS * 128, &domap, res_full, c * 32, q0, bh);
      }
    }
    if (p == 0 || p == 32) {
      const int w = p / 32;
      unsigned char* ring = smem + L::RING_OFF + w * SPW * ITEM;
      for (int j = 0; j < nkt / 2; ++j) {
        const size_t tile = static_cast<size_t>(bh) * nkt + 2 * j + w;
        for (int op = 0; op < 3; ++op) {  // K rows, V rows, K^T
          const int i = 3 * j + op, s = i % SPW;
          mbar_wait(&empty[w * SPW + s], ((i / SPW) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[w * SPW + s], ITEM);
          bulk_load(ring + s * ITEM, img + op * plane + tile * ITEM, ITEM, &full[w * SPW + s]);
        }
      }
    }
  } else {
    // ---- consumers
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128, quad = t % 4;
    const float c = scale * wg::kLog2e;  // S -> log2 units
    const unsigned char* qs = smem;      // Q_hi, Q_lo at + HALF
    const unsigned char* dos = smem + 2 * L::HALF;
    const unsigned char* ring = smem + L::RING_OFF + w * SPW * ITEM;
    uint64_t* wfull = full + w * SPW;
    uint64_t* wempty = empty + w * SPW;
    mbar_wait(res_full, 0);
    split_resident<D>(smem, threadIdx.x, wg::CONSUMERS);
    split_resident<D>(smem + 2 * L::HALF, threadIdx.x, wg::CONSUMERS);
    fence_proxy_async();
    named_barrier(1, wg::CONSUMERS);  // both splits are visible to both warpgroups' wgmma
    const int row0 = q0 + wg::acc_row(t);
    float lse2[2], dl[2];  // this thread's rows: lse in log2 units, delta
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      lse2[h] = lse[bh * Nq + row0 + 8 * h] * wg::kLog2e;
      dl[h] = delta[bh * Nq + row0 + 8 * h];
    }
    float sa[BT], sb[BT / 2], pa[BT], pb[BT / 2], acc[D / 2], part[D / 2];
#pragma unroll
    for (int i = 0; i < BT; ++i) sa[i] = pa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) sb[i] = pb[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = part[i] = 0.f;
    [[maybe_unused]] hs::TileBits<Layout<D>::BN, BT> tb;  // DROP: this warpgroup's tiles' bits
    if constexpr (DROP) tb.init(dropout, bh, row0, quad, Nq, Nk, w);
    for (int j = 0; j < nkt / 2; ++j) {
      const int ik = 3 * j, iv = ik + 1, it = ik + 2;  // ring items: K rows, V rows, K^T
      // S = Q K^T and dP = dO V^T, both in flight
      mbar_wait(&wfull[ik % SPW], (ik / SPW) & 1);
      wgmma_fence();
      score_tile<D, BT, BWD_ROWS>(sa, sb, qs, qs + L::HALF, ring + (ik % SPW) * ITEM);
      wgmma_commit();
      mbar_wait(&wfull[iv % SPW], (iv / SPW) & 1);
      score_tile<D, BT, BWD_ROWS>(pa, pb, dos, dos + L::HALF, ring + (iv % SPW) * ITEM);
      wgmma_commit();
      [[maybe_unused]] uint32_t bits[2];  // DROP: key tile 2j + w's keep bits
      if constexpr (DROP) tb.take(2 * j + w, 2 * j + w + 2, nkt, bits);
      // P = exp(S scale - lse) while dP is in flight
      wgmma_wait<1>();
      fence_regs(sa);
      fence_regs(sb);
      mbar_arrive(&wempty[ik % SPW]);
      float p[BT / 2];
#pragma unroll
      for (int i = 0; i < BT / 2; ++i)
        p[i] = exp2f(fmaf(sa[i] + sa[i + BT / 2] + sb[i], c, -lse2[(i / 2) % 2]));
      wgmma_wait<0>();
      fence_regs(pa);
      fence_regs(pb);
      mbar_arrive(&wempty[iv % SPW]);
      // dS = P (dP - delta) scale and its TF32 halves as the A operand
      uint32_t dh[BT / 8][4], dlo[BT / 8][4];
#pragma unroll
      for (int k = 0; k < BT / 8; ++k) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * k + e;
          float g = pa[i] + pa[i + BT / 2] + pb[i];  // dP, or DROP dP~ keep / (1 - p)
          if constexpr (DROP) g = hs::drop_bit(g, bits[e / 2], 2 * k + e % 2, dropout.drop_scale);
          ds[e] = p[i] * (g - dl[e / 2]) * scale;
        }
        a_halves(ds[0], ds[1], ds[2], ds[3], dh[k], dlo[k]);
      }
      // dQ += dS K over K^T's image (keys in perm8 order): the tile's own sum, added in fp32
#pragma unroll
      for (int k = 0; k < BT / 8; ++k) {  // packed before the fence
        fence_regs(dh[k]);
        fence_regs(dlo[k]);
      }
      mbar_wait(&wfull[it % SPW], (it / SPW) & 1);
      wgmma_fence();
      value_tile<D, BT>(part, dh, dlo, ring + (it % SPW) * ITEM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < BT / 8; ++k) {
        fence_regs(dh[k]);
        fence_regs(dlo[k]);
      }
      mbar_arrive(&wempty[it % SPW]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }
    // warpgroup 1's sum through its own ring (all its items consumed), into warpgroup 0's
    float* xfer = reinterpret_cast<float*>(smem + L::RING_OFF + SPW * ITEM);
    if (w == 1) {
#pragma unroll
      for (int i = 0; i < D / 2; ++i) xfer[i * 128 + t] = acc[i];
      named_barrier_arrive(2, wg::CONSUMERS);
    } else {
      named_barrier(2, wg::CONSUMERS);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += xfer[i * 128 + t];
      store_acc<D>(dq + static_cast<size_t>(bh) * Nq * D, acc, row0, quad);
    }
  }
}

// dK and dV for 64 keys.  The transposed tiles S^T = K Q^T and dP^T = V dO^T
// put P^T and dS^T in the register layout of the A operand of dV += P^T dO
// and dK += dS^T Q.  Warpgroup 0 computes S^T, P^T and dV; warpgroup 1 dP^T,
// dS^T and dK, with P^T handed over through warpgroup 0's ring slot of the
// Q tile it came from (warpgroup 1 frees that slot).  Ring items: warpgroup
// 0 Q rows, dO^T; warpgroup 1 dO rows, Q^T.  lse and delta are indexed by
// column (query) and read from global memory.  img: the planes of Q rows,
// dO rows, Q^T and dO^T, each BH x N_q/BT tiles.  DROP: the dropout
// instance, as the bf16 kernel's: warpgroup 0 hands over the undropped P^T
// and multiplies the dropped one into dV; both warpgroups read the keep bits
// (the transposed layout).
template <int D, bool DROP>
__global__ void __launch_bounds__(wg::THREADS, 1)
flash_bwd_dkv_tf32x3(const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap,
                     const unsigned char* __restrict__ img, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Nq, int Nk, float scale,
                     const Dropout dropout) {
  using namespace hopper;
  using L = BwdLayout<D>;
  constexpr int BT = L::BT, SPW = L::SPW, PANELS = D / 32;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align1024(smem_raw);
  uint64_t* res_full = reinterpret_cast<uint64_t*>(smem + L::BAR_OFF);
  uint64_t* full = res_full + 1;  // [warpgroup][slot]
  uint64_t* empty = full + 2 * SPW;
  uint64_t* p_full = empty + 2 * SPW;  // [slot of warpgroup 0]
  const int bh = blockIdx.y, k0 = blockIdx.x * BWD_ROWS;
  const int nqt = Nq / BT;
  const size_t plane = static_cast<size_t>(gridDim.y) * nqt * ITEM;
  if (threadIdx.x == 0) {
    mbar_init(res_full, 1);
    for (int s = 0; s < 2 * SPW; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 128);
    }
    for (int s = 0; s < SPW; ++s) mbar_init(&p_full[s], 128);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= wg::CONSUMERS) {
    // ---- producer: K and V once; thread 32w feeds warpgroup w's ring
    reg_dealloc<40>();
    const int p = threadIdx.x - wg::CONSUMERS;
    if (p == 0) {
      mbar_arrive_expect_tx(res_full, 2 * L::HALF);
      for (int c = 0; c < PANELS; ++c) {
        tma_load_3d(smem + c * BWD_ROWS * 128, &kmap, res_full, c * 32, k0, bh);
        tma_load_3d(smem + 2 * L::HALF + c * BWD_ROWS * 128, &vmap, res_full, c * 32, k0, bh);
      }
    }
    if (p == 0 || p == 32) {
      const int w = p / 32;
      unsigned char* ring = smem + L::RING_OFF + w * SPW * ITEM;
      const unsigned char* src[2] = {img + (w == 0 ? 0 : 1) * plane,    // Q rows | dO rows
                                     img + (w == 0 ? 3 : 2) * plane};   // dO^T | Q^T
      for (int qt = 0; qt < nqt; ++qt) {
        const size_t tile = static_cast<size_t>(bh) * nqt + qt;
        for (int op = 0; op < 2; ++op) {
          const int i = 2 * qt + op, s = i % SPW;
          mbar_wait(&empty[w * SPW + s], ((i / SPW) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[w * SPW + s], ITEM);
          bulk_load(ring + s * ITEM, src[op] + tile * ITEM, ITEM, &full[w * SPW + s]);
        }
      }
    }
  } else {
    // ---- consumers: warpgroup 0 S^T, P^T, dV; warpgroup 1 dP^T, dS^T, dK
    reg_alloc<232>();
    const int w = threadIdx.x / 128, t = threadIdx.x % 128, quad = t % 4;
    const float c = scale * wg::kLog2e;  // S -> log2 units
    unsigned char* res = smem + w * 2 * L::HALF;  // K (warpgroup 0) or V (warpgroup 1)
    unsigned char* ring0 = smem + L::RING_OFF;    // warpgroup 0's slots
    const unsigned char* ring = ring0 + w * SPW * ITEM;
    uint64_t* wfull = full + w * SPW;
    uint64_t* wempty = empty + w * SPW;
    mbar_wait(res_full, 0);
    split_resident<D>(res, t, 128);
    fence_proxy_async();
    named_barrier(1 + w, 128);  // this warpgroup's split is visible to its wgmma
    const float* rowstat = (w == 0 ? lse : delta) + bh * Nq;  // indexed by query
    float sa[BT], sb[BT / 2], acc[D / 2], part[D / 2];
#pragma unroll
    for (int i = 0; i < BT; ++i) sa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) sb[i] = 0.f;
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = part[i] = 0.f;
    [[maybe_unused]] hs::TileBits<Layout<D>::BN, BT> tb;  // DROP: the keys' bits
    if constexpr (DROP) tb.init(dropout, bh, k0 + wg::acc_row(t), quad, Nk, Nq, 0);
    for (int qt = 0; qt < nqt; ++qt) {
      const int ia = 2 * qt, ib = ia + 1;  // ring items: Q | dO rows, then dO^T | Q^T
      // this thread's columns are the queries qt BT + 8k + 2(l%4) + {0, 1}
      float2 st[BT / 8];
#pragma unroll
      for (int k = 0; k < BT / 8; ++k)
        st[k] = *reinterpret_cast<const float2*>(rowstat + qt * BT + 8 * k + 2 * quad);
      // S^T = K Q^T (warpgroup 0) or dP^T = V dO^T (warpgroup 1)
      mbar_wait(&wfull[ia % SPW], (ia / SPW) & 1);
      wgmma_fence();
      score_tile<D, BT, BWD_ROWS>(sa, sb, res, res + L::HALF, ring + (ia % SPW) * ITEM);
      wgmma_commit();
      [[maybe_unused]] uint32_t bits[2];  // DROP: query tile qt's keep bits
      if constexpr (DROP) tb.take(qt, qt + 1, nqt, bits);
      wgmma_wait<0>();
      fence_regs(sa);
      fence_regs(sb);
      // P^T (warpgroup 0; DROP: dropped after the handover) or dS^T (warpgroup 1)
      float x[BT / 2];
      float* handed = reinterpret_cast<float*>(ring0 + (ia % SPW) * ITEM);  // Q tile's slot
      if (w == 0) {
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const float2 l2 = st[i / 4];
          x[i] = exp2f(fmaf(sa[i] + sa[i + BT / 2] + sb[i], c,
                            -(i % 2 ? l2.y : l2.x) * wg::kLog2e));
          handed[i * 128 + t] = x[i];
          if constexpr (DROP)
            x[i] = hs::drop_bit(x[i], bits[(i / 2) % 2], 2 * (i / 4) + i % 2, dropout.drop_scale);
        }
        fence_proxy_async();  // the slot goes back to TMA after warpgroup 1 has read it
        mbar_arrive(&p_full[ia % SPW]);
      } else {
        mbar_wait(&p_full[ia % SPW], (qt / SPW) & 1);
#pragma unroll
        for (int i = 0; i < BT / 2; ++i) {
          const float2 d2 = st[i / 4];
          float g = sa[i] + sa[i + BT / 2] + sb[i];  // dP^T, or DROP dP~^T keep / (1 - p)
          if constexpr (DROP)
            g = hs::drop_bit(g, bits[(i / 2) % 2], 2 * (i / 4) + i % 2, dropout.drop_scale);
          x[i] = handed[i * 128 + t] * (g - (i % 2 ? d2.y : d2.x)) * scale;
        }
        fence_proxy_async();
        mbar_arrive(&empty[ia % SPW]);   // warpgroup 0's Q slot
        mbar_arrive(&wempty[ia % SPW]);  // this warpgroup's dO slot
      }
      uint32_t xh[BT / 8][4], xl[BT / 8][4];
#pragma unroll
      for (int k = 0; k < BT / 8; ++k) {
        a_halves(x[4 * k], x[4 * k + 1], x[4 * k + 2], x[4 * k + 3], xh[k], xl[k]);
        fence_regs(xh[k]);  // packed before the fence
        fence_regs(xl[k]);
      }
      // dV += P^T dO (over dO^T) or dK += dS^T Q (over Q^T): the tile's own sum, added in fp32
      mbar_wait(&wfull[ib % SPW], (ib / SPW) & 1);
      wgmma_fence();
      value_tile<D, BT>(part, xh, xl, ring + (ib % SPW) * ITEM);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
#pragma unroll
      for (int k = 0; k < BT / 8; ++k) {
        fence_regs(xh[k]);
        fence_regs(xl[k]);
      }
      mbar_arrive(&wempty[ib % SPW]);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] += part[i];
    }
    store_acc<D>((w == 0 ? dv : dk) + static_cast<size_t>(bh) * Nk * D, acc,
                 k0 + wg::acc_row(t), quad);
  }
}

}  // namespace tf

// ------------------------------------------------------------------ host
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

// (BH, rows, D) bf16 or fp32 as a 3-D tensor map {D, rows, BH}: boxes of one
// 128-byte row of columns (64 bf16, 32 fp32) x box_rows rows x 1 head; rows
// past the tensor's (a ragged tile) read zeros instead of the next head's.
template <int D, typename T = bf16>
cudaError_t head_map(CUtensorMap* map, const void* p, int rows, int bh, int box_rows) {
  constexpr uint64_t es = sizeof(T);
  return hopper::tensor_map_3d(map, p, D, rows, bh, D * es, static_cast<uint64_t>(rows) * D * es,
                               128 / es, box_rows, 1,
                               es == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                                       : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16);
}

// The fp32 pre-pass over x (BH, n, D) in tiles of BT rows: row images into
// `rows` and transposed images into `cols`, either may be null, `stride`
// bytes a tile.
template <int D, int BT>
cudaError_t split_images(const void* x, unsigned char* rows, unsigned char* cols, int bh, int n,
                         int stride, cudaStream_t s) {
  tf::flash_split<D, BT><<<dim3(n / BT, bh), tf::SPLIT_THREADS, 0, s>>>(
      static_cast<const float*>(x), rows, cols, n, stride);
  return cudaGetLastError();
}

// The fp32 forward: the K/V pre-pass into `img` (4 x BH x N_k x D floats, the
// caller's scratch), then the 3xTF32 kernel (DROP: its dropout instances).
template <int D, int DROP = DROP_NONE>
int fwd_tf32x3(const void* q, const void* k, const void* v, void* out, void* lse, void* img,
               int bh, int nq, int nk, float scale, cudaStream_t s, const Dropout& drop = {}) {
  using L = tf::Layout<D>;
  if (nk % L::BN) return BAD_ARGUMENT;
  // each key tile's K then V^T image, the order the kernel streams them
  unsigned char* im = static_cast<unsigned char*>(img);
  cudaError_t e = split_images<D, L::BN>(k, im, nullptr, bh, nk, 2 * tf::SLOT, s);
  if (e == cudaSuccess)
    e = split_images<D, L::BN>(v, nullptr, im + tf::SLOT, bh, nk, 2 * tf::SLOT, s);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap;
  e = head_map<D, float>(&qmap, q, nq, bh, tf::BM);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = allow_smem(tf::flash_fwd_tf32x3<D, DROP>, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  tf::flash_fwd_tf32x3<D, DROP><<<dim3((nq + tf::BM - 1) / tf::BM, bh), wg::THREADS, L::BYTES,
                                    s>>>(qmap, static_cast<const unsigned char*>(img),
                                         static_cast<float*>(out), static_cast<float*>(lse), nq,
                                         nk, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, int DROP = DROP_NONE>
int fwd_wgmma(const void* q, const void* k, const void* v, void* out, void* lse, int bh, int nq,
              int nk, float scale, cudaStream_t s, const Dropout& drop = {}) {
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  const int rows[3] = {nq, nk, nk};
  for (int i = 0; i < 3; ++i) {
    const cudaError_t e = head_map<D>(&maps[i], ptrs[i], rows[i], bh, i == 0 ? wg::BM : wg::BN);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  constexpr int bytes = wg::Smem<D>::BYTES;
  cudaError_t e = allow_smem(wg::flash_fwd_wgmma<D, DROP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_fwd_wgmma<D, DROP><<<dim3((nq + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes, s>>>(
      maps[0], maps[1], maps[2], static_cast<bf16*>(out), static_cast<float*>(lse), nq, nk, scale,
      drop);
  return static_cast<int>(cudaGetLastError());
}

// A call's dropout on the pre-pass's keep bits, a slab of rows b at a time
// (as many as `bits_words` words of bits hold, one at least): for each
// slab the pre-pass (hs::draw_bits where G > 1, else hs::draw_each) writes
// the slab's bits, in the layout of column tile BN over query rows (the
// forward's and dQ's) or, `transposed`, key rows (dK/dV's), then
// `run(first, n, drop)` launches the kernel on grid rows first .. first + n
// - 1 of the call's BH, drop.bits the slab's bits.
template <int BN, typename Run>
int per_slab(Dropout drop, uint32_t* bits, long long bits_words, int bh, int nq, int nk,
             bool transposed, cudaStream_t s, Run&& run) {
  const int rows = bh / drop.local_heads, nrows = transposed ? nk : nq;
  const int words = hs::row_words<BN>(transposed ? nq : nk);
  const long long row_bits = static_cast<long long>(drop.local_heads) * nrows * words;
  const long long fit = bits_words / row_bits;
  if (fit < 1) return BAD_ARGUMENT;
  const int slab = static_cast<int>(fit < rows ? fit : rows);
  drop.bits = bits;
  for (int b0 = 0; b0 < rows; b0 += slab) {
    const int nb = rows - b0 < slab ? rows - b0 : slab;
    if (drop.group > 1) {
      const int chunks = 4 * words, per_block = hs::DRAW_THREADS * hs::DRAW_CHUNKS;
      hs::draw_bits<BN><<<dim3((chunks + per_block - 1) / per_block, nrows,
                               nb * (drop.local_heads / drop.group)),
                          hs::DRAW_THREADS, 0, s>>>(drop, bits, b0, nq, nk, transposed);
    } else {
      hs::draw_each<BN><<<dim3((words + hs::DRAW_THREADS - 1) / hs::DRAW_THREADS, nrows,
                               nb * drop.local_heads),
                          hs::DRAW_THREADS, 0, s>>>(drop, bits, b0, nq, nk, transposed);
    }
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const int rc = run(b0 * drop.local_heads, nb * drop.local_heads, drop);
    if (rc != 0) return rc;
  }
  return 0;
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

template <int D, bool DROP = false>
int dq_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
             const void* delta, void* dq_out, int bh, int nq, int nk, float scale,
             cudaStream_t s, const Dropout& drop = {}) {
  CUtensorMap maps[4];
  cudaError_t e = bwd_maps<D>(maps, q, k, v, dout, bh, nq, nk, true);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = wg::DqSmem<D>::BYTES;
  e = allow_smem(wg::flash_bwd_dq_wgmma<D, DROP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_bwd_dq_wgmma<D, DROP><<<dim3((nq + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes,
                                    s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dq_out), nq, nk, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

template <int D, bool DROP = false>
int dkv_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dk, void* dv, int bh, int nq, int nk, float scale,
              cudaStream_t s, const Dropout& drop = {}) {
  CUtensorMap maps[4];
  cudaError_t e = bwd_maps<D>(maps, q, k, v, dout, bh, nq, nk, false);
  if (e != cudaSuccess) return static_cast<int>(e);
  constexpr int bytes = wg::DkvSmem<D>::BYTES;
  e = allow_smem(wg::flash_bwd_dkv_wgmma<D, DROP>, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  wg::flash_bwd_dkv_wgmma<D, DROP><<<dim3((nk + wg::BM - 1) / wg::BM, bh), wg::THREADS, bytes,
                                     s>>>(
      maps[0], maps[1], maps[2], maps[3], static_cast<const float*>(lse),
      static_cast<const float*>(delta), static_cast<bf16*>(dk), static_cast<bf16*>(dv), nq, nk,
      scale, drop);
  return static_cast<int>(cudaGetLastError());
}


// The fp32 dQ: the pre-pass writes K's row and transposed images and V's row
// images into `img` (planes K rows, V rows, K^T: 6 x BH x N_k x D floats),
// then the 3xTF32 kernel.
template <int D, bool DROP = false>
int dq_tf32x3(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq_out, void* img, int bh, int nq, int nk, float scale,
              cudaStream_t s, const Dropout& drop = {}) {
  using L = tf::BwdLayout<D>;
  if (nq % tf::BWD_ROWS || nk % (2 * L::BT)) return BAD_ARGUMENT;
  unsigned char* im = static_cast<unsigned char*>(img);
  const size_t plane = static_cast<size_t>(bh) * nk * D * 8;
  CUtensorMap maps[2];
  cudaError_t e = split_images<D, L::BT>(k, im, im + 2 * plane, bh, nk, tf::ITEM, s);
  if (e == cudaSuccess) e = split_images<D, L::BT>(v, im + plane, nullptr, bh, nk, tf::ITEM, s);
  if (e == cudaSuccess) e = head_map<D, float>(&maps[0], q, nq, bh, tf::BWD_ROWS);
  if (e == cudaSuccess) e = head_map<D, float>(&maps[1], dout, nq, bh, tf::BWD_ROWS);
  if (e == cudaSuccess) e = allow_smem(tf::flash_bwd_dq_tf32x3<D, DROP>, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  tf::flash_bwd_dq_tf32x3<D, DROP><<<dim3(nq / tf::BWD_ROWS, bh), wg::THREADS, L::BYTES, s>>>(
      maps[0], maps[1], im, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dq_out), nq, nk, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

// The fp32 dK/dV: the pre-pass writes Q's and dO's row and transposed images
// into `img` (planes Q rows, dO rows, Q^T, dO^T: 8 x BH x N_q x D floats),
// then the 3xTF32 kernel.
template <int D, bool DROP = false>
int dkv_tf32x3(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, void* img, int bh, int nq, int nk,
               float scale, cudaStream_t s, const Dropout& drop = {}) {
  using L = tf::BwdLayout<D>;
  if (nk % tf::BWD_ROWS || nq % (2 * L::BT)) return BAD_ARGUMENT;
  unsigned char* im = static_cast<unsigned char*>(img);
  const size_t plane = static_cast<size_t>(bh) * nq * D * 8;
  CUtensorMap maps[2];
  cudaError_t e = split_images<D, L::BT>(q, im, im + 2 * plane, bh, nq, tf::ITEM, s);
  if (e == cudaSuccess)
    e = split_images<D, L::BT>(dout, im + plane, im + 3 * plane, bh, nq, tf::ITEM, s);
  if (e == cudaSuccess) e = head_map<D, float>(&maps[0], k, nk, bh, tf::BWD_ROWS);
  if (e == cudaSuccess) e = head_map<D, float>(&maps[1], v, nk, bh, tf::BWD_ROWS);
  if (e == cudaSuccess) e = allow_smem(tf::flash_bwd_dkv_tf32x3<D, DROP>, L::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  tf::flash_bwd_dkv_tf32x3<D, DROP><<<dim3(nk / tf::BWD_ROWS, bh), wg::THREADS, L::BYTES, s>>>(
      maps[0], maps[1], im, static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<float*>(dk), static_cast<float*>(dv), nq, nk, scale, drop);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// fp32 takes `scratch`, 4 x BH x N_k x D floats (16-byte aligned) for the
// split K/V images; bf16 does not read it.
extern "C" int flash_fwd_launch(int is_bf16, int d, const void* q, const void* k,
                                const void* v, void* out, void* lse, void* scratch, int bh,
                                int nq, int nk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128) return fwd_wgmma<128>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64) return fwd_wgmma<64>(q, k, v, out, lse, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return fwd_tf32x3<128>(q, k, v, out, lse, scratch, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return fwd_tf32x3<64>(q, k, v, out, lse, scratch, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

// The Dropout of a dropout launch, or BAD_ARGUMENT (below).
static int dropout_of(Dropout* drop, int bh, int nq, int nk, int d, const void* seed,
                      long long base, long long pass0, int rows, int heads, int h0,
                      int local_heads, float keep_prob, float drop_scale, int group) {
  if (base < 0 || rows < 1 || local_heads < 1 || h0 < 0 || h0 + local_heads > heads ||
      static_cast<long long>(nk) * heads >= (1LL << 32) || bh % local_heads ||
      (bh / local_heads) % rows || pass0 < 0 ||
      pass0 + (bh / local_heads) / rows > (1LL << 32) || !(keep_prob > 0.0f) ||
      (d != 64 && d != 128))
    return BAD_ARGUMENT;
  if (group != 1 && ((group != 2 && group != 4) || heads % 4 || base % 4 || h0 % group ||
                     local_heads % group))
    return BAD_ARGUMENT;
  *drop = Dropout{static_cast<const long long*>(seed), static_cast<unsigned long long>(base),
                  static_cast<unsigned>(pass0), rows, heads, h0, local_heads, keep_prob,
                  drop_scale, philox::keep_threshold(keep_prob), group, nullptr};
  return 0;
}

// per_slab for the kernels of one type and head width, at their bits' column
// tile: the forward's key tile (bf16 wg::BN; fp32 tf::Layout's BN), twice the
// backward's BT.
template <typename Run>
static int per_slab_for(int is_bf16, int d, const Dropout& drop, void* bits,
                        long long bits_words, int bh, int nq, int nk, bool transposed,
                        cudaStream_t s, Run&& run) {
  uint32_t* words = static_cast<uint32_t*>(bits);
  if (is_bf16) return per_slab<wg::BN>(drop, words, bits_words, bh, nq, nk, transposed, s, run);
  if (d == 128)
    return per_slab<tf::Layout<128>::BN>(drop, words, bits_words, bh, nq, nk, transposed, s,
                                         run);
  return per_slab<tf::Layout<64>::BN>(drop, words, bits_words, bh, nq, nk, transposed, s, run);
}

// Grid rows `first` .. of a (BH, n, d) operand of element size `elem`.
static const void* rows_at(const void* p, int first, int n, int d, int elem) {
  return static_cast<const char*>(p) + static_cast<size_t>(first) * n * d * elem;
}
static void* rows_at(void* p, int first, int n, int d, int elem) {
  return static_cast<char*>(p) + static_cast<size_t>(first) * n * d * elem;
}

// The forward with attention-weight dropout (the DROP instances; Dropout
// above): out and lse (the undropped P's, as the forward's; the MC path
// drops it).  seed: one int64 on the device; base >= 0; the BH = B x
// local_heads rows hold B / rows passes from pass0, pass-major; heads h0 ..
// h0 + local_heads - 1 of `heads`.  keep_prob = float32(1 - p), drop_scale =
// float32(1 / (1 - p)).  group 1: DROP_EACH; 2 or 4: DROP_SHARED (one
// Philox call for `group` heads), which needs heads and base multiples of 4
// and h0, local_heads multiples of the group, and takes `bits` (bits_words
// uint32 words: the pre-pass's output for as many rows b at a time as it
// holds, one at least).  fp32 takes `scratch` as the forward.
extern "C" int flash_fwd_dropout_launch(int is_bf16, int d, const void* q, const void* k,
                                        const void* v, void* out, void* lse, void* scratch,
                                        void* bits, long long bits_words, int bh, int nq, int nk,
                                        float scale, const void* seed, long long base,
                                        long long pass0, int rows, int heads, int h0,
                                        int local_heads, float keep_prob, float drop_scale,
                                        int group, void* stream) {
  Dropout drop;
  if (dropout_of(&drop, bh, nq, nk, d, seed, base, pass0, rows, heads, h0, local_heads,
                 keep_prob, drop_scale, group))
    return BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (group == 1) {
    if (is_bf16 && d == 128)
      return fwd_wgmma<128, DROP_EACH>(q, k, v, out, lse, bh, nq, nk, scale, s, drop);
    if (is_bf16 && d == 64)
      return fwd_wgmma<64, DROP_EACH>(q, k, v, out, lse, bh, nq, nk, scale, s, drop);
    if (!is_bf16 && d == 128)
      return fwd_tf32x3<128, DROP_EACH>(q, k, v, out, lse, scratch, bh, nq, nk, scale, s, drop);
    return fwd_tf32x3<64, DROP_EACH>(q, k, v, out, lse, scratch, bh, nq, nk, scale, s, drop);
  }
  const int el = is_bf16 ? 2 : 4;
  const auto run = [&](int first, int n, const Dropout& dr) {
    const void *qs = rows_at(q, first, nq, d, el), *ks = rows_at(k, first, nk, d, el),
               *vs = rows_at(v, first, nk, d, el);
    void* os = rows_at(out, first, nq, d, el);
    float* ls = static_cast<float*>(lse) + static_cast<size_t>(first) * nq;
    if (is_bf16)
      return d == 128 ? fwd_wgmma<128, DROP_SHARED>(qs, ks, vs, os, ls, n, nq, nk, scale, s, dr)
                      : fwd_wgmma<64, DROP_SHARED>(qs, ks, vs, os, ls, n, nq, nk, scale, s, dr);
    return d == 128 ? fwd_tf32x3<128, DROP_SHARED>(qs, ks, vs, os, ls, scratch, n, nq, nk, scale,
                                                   s, dr)
                    : fwd_tf32x3<64, DROP_SHARED>(qs, ks, vs, os, ls, scratch, n, nq, nk, scale,
                                                  s, dr);
  };
  return per_slab_for(is_bf16, d, drop, bits, bits_words, bh, nq, nk, false, s, run);
}

// Dynamic shared memory of a wgmma kernel (0 bf16 forward, 1 dQ, 2 dK/dV, 3
// the 3xTF32 forward, 4 the 3xTF32 dQ and dK/dV) at head width d, for build
// reports.
extern "C" int flash_wgmma_smem(int kernel, int d) {
  if (d != 64 && d != 128) return BAD_ARGUMENT;
  const bool w = d == 128;
  switch (kernel) {
    case 0: return w ? wg::Smem<128>::BYTES : wg::Smem<64>::BYTES;
    case 1: return w ? wg::DqSmem<128>::BYTES : wg::DqSmem<64>::BYTES;
    case 2: return w ? wg::DkvSmem<128>::BYTES : wg::DkvSmem<64>::BYTES;
    case 3: return w ? tf::Layout<128>::BYTES : tf::Layout<64>::BYTES;
    case 4: return w ? tf::BwdLayout<128>::BYTES : tf::BwdLayout<64>::BYTES;
    default: return BAD_ARGUMENT;
  }
}

// fp32 takes `scratch` for the pre-pass's images (16-byte aligned): 6 x BH x
// N_k x D floats for dQ, 8 x BH x N_q x D for dK/dV; bf16 does not read it.
extern "C" int flash_bwd_dq_launch(int is_bf16, int d, const void* q, const void* k,
                                   const void* v, const void* dout, const void* lse,
                                   const void* delta, void* dq_out, void* scratch, int bh,
                                   int nq, int nk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dq_wgmma<128>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dq_wgmma<64>(q, k, v, dout, lse, delta, dq_out, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dq_tf32x3<128>(q, k, v, dout, lse, delta, dq_out, scratch, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dq_tf32x3<64>(q, k, v, dout, lse, delta, dq_out, scratch, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

extern "C" int flash_bwd_dkv_launch(int is_bf16, int d, const void* q, const void* k,
                                    const void* v, const void* dout, const void* lse,
                                    const void* delta, void* dk, void* dv, void* scratch,
                                    int bh, int nq, int nk, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16 && d == 128)
    return dkv_wgmma<128>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (is_bf16 && d == 64)
    return dkv_wgmma<64>(q, k, v, dout, lse, delta, dk, dv, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 128)
    return dkv_tf32x3<128>(q, k, v, dout, lse, delta, dk, dv, scratch, bh, nq, nk, scale, s);
  if (!is_bf16 && d == 64)
    return dkv_tf32x3<64>(q, k, v, dout, lse, delta, dk, dv, scratch, bh, nq, nk, scale, s);
  return BAD_ARGUMENT;
}

// The backward's dropout instances (the training route's attention-weight
// dropout; the arguments as flash_fwd_dropout_launch's, lse the forward's):
// for each slab of rows b, the pre-pass writes the slab's keep bits (the
// head-shared draw where group > 1, one Philox call a weight where group is
// 1: the kernels only read bits) into `bits` (bits_words uint32 words, at
// least one row b's: local_heads x N x N bits, N rounded up to the forward's
// key tile), query-major for dQ, key-major for dK/dV, then the kernel runs on
// the slab's rows.  Needs N_q N_k heads < 2^32.  fp32 takes `scratch` as the
// kernels without dropout.
static int bwd_dropout_args(Dropout* drop, int bh, int nq, int nk, int d, const void* seed,
                            long long base, long long pass0, int rows, int heads, int h0,
                            int local_heads, float keep_prob, float drop_scale, int group) {
  if (static_cast<long long>(nq) * nk * heads >= (1LL << 32)) return BAD_ARGUMENT;
  return dropout_of(drop, bh, nq, nk, d, seed, base, pass0, rows, heads, h0, local_heads,
                    keep_prob, drop_scale, group);
}

extern "C" int flash_bwd_dq_dropout_launch(int is_bf16, int d, const void* q, const void* k,
                                           const void* v, const void* dout, const void* lse,
                                           const void* delta, void* dq_out, void* scratch,
                                           void* bits, long long bits_words, int bh, int nq,
                                           int nk, float scale, const void* seed, long long base,
                                           long long pass0, int rows, int heads, int h0,
                                           int local_heads, float keep_prob, float drop_scale,
                                           int group, void* stream) {
  Dropout drop;
  if (bwd_dropout_args(&drop, bh, nq, nk, d, seed, base, pass0, rows, heads, h0, local_heads,
                       keep_prob, drop_scale, group))
    return BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int el = is_bf16 ? 2 : 4;
  const auto run = [&](int first, int n, const Dropout& dr) {
    const void *qs = rows_at(q, first, nq, d, el), *ks = rows_at(k, first, nk, d, el),
               *vs = rows_at(v, first, nk, d, el), *dos = rows_at(dout, first, nq, d, el);
    const float* ls = static_cast<const float*>(lse) + static_cast<size_t>(first) * nq;
    const float* dls = static_cast<const float*>(delta) + static_cast<size_t>(first) * nq;
    void* dqs = rows_at(dq_out, first, nq, d, el);
    if (is_bf16)
      return d == 128 ? dq_wgmma<128, true>(qs, ks, vs, dos, ls, dls, dqs, n, nq, nk, scale, s, dr)
                      : dq_wgmma<64, true>(qs, ks, vs, dos, ls, dls, dqs, n, nq, nk, scale, s, dr);
    return d == 128 ? dq_tf32x3<128, true>(qs, ks, vs, dos, ls, dls, dqs, scratch, n, nq, nk,
                                           scale, s, dr)
                    : dq_tf32x3<64, true>(qs, ks, vs, dos, ls, dls, dqs, scratch, n, nq, nk,
                                          scale, s, dr);
  };
  return per_slab_for(is_bf16, d, drop, bits, bits_words, bh, nq, nk, false, s, run);
}

extern "C" int flash_bwd_dkv_dropout_launch(int is_bf16, int d, const void* q, const void* k,
                                            const void* v, const void* dout, const void* lse,
                                            const void* delta, void* dk, void* dv, void* scratch,
                                            void* bits, long long bits_words, int bh, int nq,
                                            int nk, float scale, const void* seed,
                                            long long base, long long pass0, int rows, int heads,
                                            int h0, int local_heads, float keep_prob,
                                            float drop_scale, int group, void* stream) {
  Dropout drop;
  if (bwd_dropout_args(&drop, bh, nq, nk, d, seed, base, pass0, rows, heads, h0, local_heads,
                       keep_prob, drop_scale, group))
    return BAD_ARGUMENT;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int el = is_bf16 ? 2 : 4;
  const auto run = [&](int first, int n, const Dropout& dr) {
    const void *qs = rows_at(q, first, nq, d, el), *ks = rows_at(k, first, nk, d, el),
               *vs = rows_at(v, first, nk, d, el), *dos = rows_at(dout, first, nq, d, el);
    const float* ls = static_cast<const float*>(lse) + static_cast<size_t>(first) * nq;
    const float* dls = static_cast<const float*>(delta) + static_cast<size_t>(first) * nq;
    void *dks = rows_at(dk, first, nk, d, el), *dvs = rows_at(dv, first, nk, d, el);
    if (is_bf16)
      return d == 128 ? dkv_wgmma<128, true>(qs, ks, vs, dos, ls, dls, dks, dvs, n, nq, nk, scale,
                                             s, dr)
                      : dkv_wgmma<64, true>(qs, ks, vs, dos, ls, dls, dks, dvs, n, nq, nk, scale,
                                            s, dr);
    return d == 128 ? dkv_tf32x3<128, true>(qs, ks, vs, dos, ls, dls, dks, dvs, scratch, n, nq,
                                            nk, scale, s, dr)
                    : dkv_tf32x3<64, true>(qs, ks, vs, dos, ls, dls, dks, dvs, scratch, n, nq,
                                           nk, scale, s, dr);
  };
  return per_slab_for(is_bf16, d, drop, bits, bits_words, bh, nq, nk, true, s, run);
}
