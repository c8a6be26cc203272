// Flash attention for f32 operands (sm_90a): forward, dQ and dK/dV.
//
// The same three functions as flash_attention.cu, on f32 [BH, T, Dh]
// operands, instantiated for head dims D = 16, 32, 64, 128 and 256 (a Dh
// between two of them, a multiple of 4, runs on the next one up: TMA fills
// the columns past Dh with zeros in shared memory, the split leaves zeros
// zero, and the output rows are written Dh columns wide): they replace the Pallas
// kernels _fwd_kernel, _dq_kernel and _dkv_kernel
// (ray_tpu/ops/flash_attention.py:72, :135, :168) where those run on f32
// inputs (the ring's f32 path, an f32 model). Scores, softmax and every
// product keep f32 accuracy, P and dS stay f32 (the Pallas kernels' casts
// to the operands' dtype are no-ops in f32), lse, delta and all outputs are
// f32. The JAX package holds its f32 kernels to 1e-5 (forward) and 1e-4
// (gradients) of reference attention; a single TF32 product keeps about
// three decimal digits and misses that.
//
// All three: 3xTF32 on the tensor cores. Each f32 operand x is split
// into big = tf32(x) (cvt.rna.tf32.f32's rounding, hopper::tf32_rna) and
// small = tf32(x - big), and a product is
// big.small + small.big + big.big, the cross terms first, into one f32
// accumulator (CUTLASS's OpMultiplyAddFastF32 order); only small.small,
// below 2^-22 of the product, is dropped.
// Bound on an H100 SXM: 4 (forward), 6 (dQ) and 8 (dK/dV) FLOPs per (q,
// key) pair the mask keeps and per head-dim element, done as three TF32
// products at 495 TFLOP/s, i.e. 165 TFLOP/s of f32-accurate work (0.078,
// 0.117 and 0.156 ms at B 8, T 1024, H 12, Dh 64, causal); the bytes (q, k,
// v, dO, lse, delta in, the results out, 126 MB for dQ) take at most a
// third of that: operations.
// Design: a block owns 64 rows of its result (q rows: dQ; keys: dK/dV) of
// one head and walks over BK keys (dQ) or BQ q rows (dK/dV) a stage, sizes
// and ring depths per head dim in F32Tiles<D>. The first warpgroups (three;
// two at head dim 128) load and split: warp 0 streams each stage's tiles
// by TMA into raw slots ahead of a ring of stages (or into the stage
// itself), with mbarriers per slot and stage (Feed); the other warps split
// each landed tile into big and small tiles (in place when TMA wrote the
// stage) and, where a product needs one, a transposed copy, then mark the
// stage ready. The split is on
// every stage's path: with one splitting warpgroup the kernels ran 1.4-1.5x
// slower than with three (sweep_flash_f32). The last two warpgroups
// (the consumers) both own the block's 64 rows and take alternate stages,
// each summing a partial result in f32 registers; at the end the second
// hands its sum to the first through shared memory, which adds it (always
// in that order) and writes the rows.
// Per stage a consumer issues the two score products (S and dP, or S^T and
// dP^T) with both operands split in shared memory, turns S into P (exp2
// with scale * log2 e folded in) and dP into dS = P (dP scale - delta scale)
// in registers, splits P and dS per k-step of 8 into register A fragments,
// and issues the gradient products with them.
// tf32 wgmma reads shared memory K-major only (its transpose bit exists for
// 16-bit types alone), and four products reduce over the rows of the tile
// they read: O = P V (over keys), dQ = dS K (over keys), dV = P^T dO and
// dK = dS^T Q (over q rows). Each takes way (a): the split pass writes a
// transposed, swizzled big and small copy of that tile (V^T; K^T; dO^T and
// Q^T), so the reduction runs along its rows. It keeps every product in one
// shape (A = the 64 owned rows, N = D), where the other way (computing dQ^T
// = K^T dS^T with K^T as register fragments) would need D to be a multiple
// of 64 and dS in shared memory. The transposed copy also absorbs the tf32
// A fragment's layout: an m64nNk8 accumulator holds columns 2t and 2t + 1
// of each 8 in thread t, the A fragment wants k = t and t + 4, so column
// 8g + p of a transposed tile holds key (or q row) 8g + 2p for p < 4 and
// 8g + 2(p - 4) + 1 for p >= 4, and P and dS become A fragments without a
// shuffle. No atomics: each block writes only its own rows, and the
// partial sums meet in a fixed order, so two calls give the same bits.
// Causal: the key loop stops at the diagonal (forward, dQ) and the q loop
// starts at it (dK/dV); keys past Tk and q rows past Tq are masked or
// zero-filled.
//
// Head dim 256 (A_SPLIT 0 in F32Tiles): the block's own rows, split, would
// take 256 KB of shared memory (Q and dO, or K and V, big and small), so
// they stay as TMA loaded them, raw f32 (128 KB), and each consumer splits
// them into register A fragments four k-steps at a time, issues those
// k-steps' products with the fragments and waits for them before the next
// four (mma3_raw); the stages hold 8 keys or q rows.
// Its dK/dV's two [64 x 256] accumulators would not fit in a consumer's
// registers beside the rest: it runs twice (DKV_PASSES 2), a dV pass and a
// dK pass, each recomputing S^T and P^T with one accumulator and splitting
// only the tiles its products read.
//
// The forward differs in its block (FwdPlan): 128 q rows of one head, each
// consumer warpgroup owning 64 of them, both reading every stage (a stage
// is released by the eight consumer warps), so each split tile serves twice
// the products; a stage is K split in place and V's transposed copy alone
// (V's natural split is never read). Per stage a consumer issues S = Q K^T,
// keeps a running max and sum for each of its rows in registers (a row with
// no key seen yet keeps base 0), rescales its O accumulator by exp2(m_old -
// m_new) once the last P V is in, and issues O += P V with P's split A
// fragments. At the end o = O / l and lse = (m + log2 l) / log2 e. The
// traits may give it 64-row blocks instead (FWD_ROWS): the two consumers on
// alternate stages of the same rows, their (m, l, O) merged in a fixed
// order at the end.
//
// Mixed operand dtypes (ROUND): operands of several dtypes (bf16, f16, f32)
// run on these kernels, cast up to f32 by the caller (exactly: a bf16 or
// f16 value is its own tf32 big part, its small part zero). The Pallas
// kernels round P and dS to specific operands' dtypes before the products
// that take them (the forward's P to v's, dQ's dS to k's, dK/dV's P to dO's
// and dS to q's), so the kernels take a rounding type for P and one for dS
// (Round: none, bf16 or f16; round_p, round_ds) and round in registers
// before the split. The rounding is a template parameter: the f32 library
// built from this file instantiates ROUND = false, whose code is the plain
// f32 kernels', and flash_attention_mixed.cu includes it for ROUND = true.
//
// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises. The
// signatures are flash_attention.cu's (out_f32 is taken and ignored: the
// outputs are f32) with the rounding types after out_f32 (both 0 unless the
// library was built with RT_ROUNDED).

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "flash_wide.cuh"
#include "hopper.cuh"

// Whether this library's entry points round P and dS (the mixed-dtype
// route: flash_attention_mixed.cu sets it) or not (the f32 operands').
#ifndef RT_ROUNDED
#define RT_ROUNDED 0
#endif

namespace {

// ---------------------------------------------------------------------------
// 3xTF32 on wgmma (see the note at the top): the pieces all three share.
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128;
constexpr int ROWS_OWNED = 64;  // result rows of a block: one wgmma M
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have on an H100
constexpr float LOG2E = 1.4426950408889634f;

// Per head dim: keys per dQ stage (DQ_BK), q rows per dK/dV stage
// (DKV_BQ), the two ring depths (STAGES), the raw slots in front of each
// ring (RAW; 0: TMA lands in the stage itself and the split works in
// place), and the loading warpgroups of both (LOADER_WGS). A stage holds
// six (dQ) or eight (dK/dV) f32 tiles (big and small, natural and
// transposed), so head dim 128 takes 16 keys and 8 q rows a stage. The
// forward's own line: q rows a block (FWD_ROWS: 128, the two consumers on
// every stage; or 64, on alternate stages), keys a stage (FWD_BK), its ring
// (FWD_STAGES, FWD_RAW) and loading warpgroups (FWD_LOADER_WGS); a stage is
// four tiles (K big and small, V^T big and small) and Q's rows take 64 KB
// of a 128-row block at head dim 64, 128 KB at 128. Chosen by timing
// variants on an H100 (python3 -m ray_tpu_torch.sweep_flash_f32, device
// time at B 8, T 1024, gpt2-small's width): raw slots let TMA run ahead of
// the split pass, which otherwise waits for a stage to be released and then
// for its loads to land (dK/dV 4% faster at head dims 64 and 3% at 128;
// dQ at 64 gains nothing and keeps a third stage instead); three loading
// warpgroups split faster than two (dQ 6%, dK/dV 11% at head dim 64) but
// leave the consumers 168 registers, too few for head dim 128's dK/dV
// accumulators. The forward's line (the same sweep, device time): 128-row
// blocks beat 64-row ones where a head's rows fill the card (Dh 64: 0.197
// against 0.260 ms; Dh 128: 0.235 against 0.278), and lose at the f32
// ring's Dh 32 blocks (B 2, H 4, 1,024 rows: 64 blocks for 132 SMs; 0.0305
// against 0.0204 ms); 64 keys a stage at Dh 64 (0.169 ms against 0.197 at
// 32) needs two loading warpgroups, whose consumers' 208 registers hold its
// P fragments without a spill; head dim 128 keeps 16 keys (8: 0.353 ms).
// A_SPLIT: the block's own rows split in shared memory (1), or kept raw and
// split into register fragments a group of k-steps at a time (0: head dim
// 256, see the note at the top); DKV_PASSES: dK/dV in one pass or two.
// tests/test_torch_flash_f32_split.py reads this block.
template <int D>
struct F32Tiles;
template <>
struct F32Tiles<16> {
  static constexpr int DQ_BK = 64, DQ_STAGES = 4, DQ_RAW = 2, DKV_BQ = 32, DKV_STAGES = 4, DKV_RAW = 2;
  static constexpr int LOADER_WGS = 3;
  static constexpr int FWD_ROWS = 128, FWD_BK = 64, FWD_STAGES = 4, FWD_RAW = 2, FWD_LOADER_WGS = 3;
  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;
};
template <>
struct F32Tiles<32> {
  static constexpr int DQ_BK = 64, DQ_STAGES = 3, DQ_RAW = 2, DKV_BQ = 32, DKV_STAGES = 4, DKV_RAW = 2;
  static constexpr int LOADER_WGS = 3;
  static constexpr int FWD_ROWS = 64, FWD_BK = 64, FWD_STAGES = 3, FWD_RAW = 2, FWD_LOADER_WGS = 3;
  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;
};
template <>
struct F32Tiles<64> {
  static constexpr int DQ_BK = 32, DQ_STAGES = 3, DQ_RAW = 0, DKV_BQ = 32, DKV_STAGES = 2, DKV_RAW = 2;
  static constexpr int LOADER_WGS = 3;
  static constexpr int FWD_ROWS = 128, FWD_BK = 64, FWD_STAGES = 2, FWD_RAW = 0, FWD_LOADER_WGS = 2;
  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;
};
template <>
struct F32Tiles<128> {
  static constexpr int DQ_BK = 16, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 2, DKV_RAW = 2;
  static constexpr int LOADER_WGS = 2;
  static constexpr int FWD_ROWS = 128, FWD_BK = 16, FWD_STAGES = 2, FWD_RAW = 2, FWD_LOADER_WGS = 2;
  static constexpr int A_SPLIT = 1, DKV_PASSES = 1;
};
// Head dim 256: raw rows of the block (128 KB: Q and dO, K and V, or the
// forward's 128 q rows), 8 keys or q rows a stage (dQ: K, V and K^T split,
// 48 KB; dK/dV: six tiles of a pass, 48 KB; the forward: K and V^T split and
// V as loaded, 40 KB), two stages landing in place, one loading warpgroup
// (the consumers get 224 registers, the loaders 56: a [64 x 256]
// accumulator is 128).
template <>
struct F32Tiles<256> {
  static constexpr int DQ_BK = 8, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 2, DKV_RAW = 0;
  static constexpr int LOADER_WGS = 1;
  static constexpr int FWD_ROWS = 128, FWD_BK = 8, FWD_STAGES = 2, FWD_RAW = 0, FWD_LOADER_WGS = 1;
  static constexpr int A_SPLIT = 0, DKV_PASSES = 2;
};

// A block's warpgroups: LOADER_WGS_ loading (warp 0 issues the TMA loads,
// the other warps split) and two consumers. setmaxnreg moves registers
// from the loaders to the consumers; the block holds what it started with,
// ENTRY_REGS a thread (ptxas's count under __launch_bounds__(THREADS, 1)),
// so the consumers can take only what the loaders give up, or
// setmaxnreg.inc waits for ever.
template <int LOADER_WGS_>
struct Roles {
  static constexpr int LOADER_WGS = LOADER_WGS_;
  static constexpr int THREADS = (LOADER_WGS + 2) * WG_THREADS;
  static constexpr int SPLIT_THREADS = LOADER_WGS * WG_THREADS - 32;
  static constexpr int ENTRY_REGS = 65536 / THREADS / 8 * 8;
  // One loading warpgroup (head dim 256) keeps 56: its TMA warp issues
  // eight boxes a tile, and at 48 ptxas spilled there (24 bytes); the
  // consumers still get 224 (228 rounded down to 8).
  static constexpr int LOADER_REGS = LOADER_WGS == 1 ? 56 : 48;
  static constexpr int CONSUMER_REGS_FIT =
      (ENTRY_REGS * THREADS - LOADER_WGS * WG_THREADS * LOADER_REGS) / (2 * WG_THREADS) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_FIT < 240 ? CONSUMER_REGS_FIT : 240;
};

// The 1024-byte aligned start of dynamic shared memory (the 128B swizzle
// repeats every 1024 bytes; TMA and wgmma agree on it from there).
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// Tiles of BK keys that rows up to last_row need (causal: to the diagonal).
template <int BK>
__device__ __forceinline__ int key_tiles(int last_row, int Tk, int causal) {
  return ((causal ? min(Tk, last_row + 1) : Tk) + BK - 1) / BK;
}

// The leading key tiles that need no mask for q rows from first_row on.
template <int BK>
__device__ __forceinline__ int plain_tiles(int first_row, int Tk, int causal) {
  return causal ? min(Tk / BK, (first_row + 1) / BK) : Tk / BK;
}

// The split pass, run by NT threads (u = 0 .. NT - 1).
// A whole tile: x of `src` -> big and small at the same offset of `big` and
// `small` (`src` may be `big`: in place).
template <int BYTES, int NT>
__device__ __forceinline__ void split_tile(const float* src, float* big, float* small, int u) {
  for (int e = u; e < BYTES / 16; e += NT) {
    const float4 x = reinterpret_cast<const float4*>(src)[e];
    uint4 b, s;
    hopper::tf32_split(x.x, b.x, s.x);
    hopper::tf32_split(x.y, b.y, s.y);
    hopper::tf32_split(x.z, b.z, s.z);
    hopper::tf32_split(x.w, b.w, s.w);
    reinterpret_cast<uint4*>(big)[e] = b;
    reinterpret_cast<uint4*>(small)[e] = s;
  }
}

// A tile T [R, C] of `src` split as split_tile does, and its transpose TileF<R, C>
// [C, R] written big and small: row c, position 8g + p holds T's row 8g + 2p
// (p < 4) or 8g + 2(p - 4) + 1 (p >= 4), column c. A thread takes one column
// c and the four rows of one parity in one group of 8: four scalar reads
// (the lanes of a warp read neighbouring columns of one row) and one 16-byte
// store per transposed tile (eight lanes, eight rows of it: the swizzle puts
// them in distinct banks). NATURAL = false writes the transposed copy alone
// (`big` and `small` unused): the forward never reads V's natural split.
template <class T, int NT, bool NATURAL = true>
__device__ __forceinline__ void split_tile_t(const float* src, float* big, float* small, float* tbig,
                                             float* tsmall, int u) {
  using TT = hopper::TileF<T::N_ROWS, T::N_COLS>;
  constexpr int C = T::N_COLS;
  const uint8_t* xb = reinterpret_cast<const uint8_t*>(src);
  uint8_t* bb = reinterpret_cast<uint8_t*>(big);
  uint8_t* sb = reinterpret_cast<uint8_t*>(small);
  for (int e = u; e < T::N_ROWS / 4 * C; e += NT) {
    const int c = e % C, h = (e / C) % 2, g = e / (2 * C);
    uint32_t b[4], s[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint32_t off = T::offset(8 * g + h + 2 * i, c);
      hopper::tf32_split(*reinterpret_cast<const float*>(xb + off), b[i], s[i]);
      if constexpr (NATURAL) {
        *reinterpret_cast<uint32_t*>(bb + off) = b[i];
        *reinterpret_cast<uint32_t*>(sb + off) = s[i];
      }
    }
    const uint32_t to = TT::offset(c, 8 * g + 4 * h);
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(tbig) + to) = make_uint4(b[0], b[1], b[2], b[3]);
    *reinterpret_cast<uint4*>(reinterpret_cast<uint8_t*>(tsmall) + to) = make_uint4(s[0], s[1], s[2], s[3]);
  }
}

// The split pass's end of a tile: its writes ordered before the tensor
// cores' reads (async proxy), then one arrival each on `ready`.
__device__ __forceinline__ void split_done(uint64_t* ready) {
  hopper::fence_proxy_async();
  hopper::mbar_arrive_if(ready, true);
}

// The barriers of a ring of STAGES stages fed through RAW raw slots (RAW =
// 0: TMA writes the stage itself). Tile j's loads land in load slot j % NL
// (raw slot, or stage) and complete `full`; the split pass reads them,
// writes stage j % STAGES once its consumer has released it (`empty`),
// frees the raw slot (`freed`) and marks the stage `ready`.
template <int STAGES, int RAW>
struct Feed {
  static constexpr int NL = RAW > 0 ? RAW : STAGES;  // load slots
  static constexpr int BARRIERS = 2 * NL + 2 * STAGES;
  uint64_t *full, *freed, *ready, *empty;

  __device__ explicit Feed(uint64_t* bars)
      : full(bars), freed(bars + NL), ready(bars + 2 * NL), empty(bars + 2 * NL + STAGES) {}
  __device__ void init(int split_threads, int consumer_warps) const {
    for (int l = 0; l < NL; ++l) {
      hopper::mbar_init(&full[l], 1);
      hopper::mbar_init(&freed[l], split_threads);
    }
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&ready[s], split_threads);
      hopper::mbar_init(&empty[s], consumer_warps);
    }
  }
  // The TMA thread, before tile j's loads: returns the barrier they complete.
  __device__ uint64_t* load_slot(int j, int bytes) const {
    const int l = j % NL;
    hopper::mbar_wait(RAW > 0 ? &freed[l] : &empty[l], ((j / NL) & 1) ^ 1);
    hopper::mbar_arrive_expect_tx(&full[l], bytes);
    return &full[l];
  }
  // The split pass, before tile j: its loads have landed and its stage is free.
  __device__ void split_begin(int j) const {
    hopper::mbar_wait(&full[j % NL], (j / NL) & 1);
    if constexpr (RAW > 0) hopper::mbar_wait(&empty[j % STAGES], ((j / STAGES) & 1) ^ 1);
  }
  __device__ void split_end(int j) const {
    hopper::fence_proxy_async();
    if constexpr (RAW > 0) hopper::mbar_arrive_if(&freed[j % NL], true);
    hopper::mbar_arrive_if(&ready[j % STAGES], true);
  }
};

// One arrival per warp on an "empty" barrier, from lane 0 once the whole
// warp is here.
__device__ __forceinline__ void warp_release(uint64_t* bar) {
  __syncwarp();
  hopper::mbar_arrive_if(bar, threadIdx.x % 32 == 0);
}

// d (+)= A B over 8 KSTEPS columns, A and B split in shared memory (TA and
// TB K-major): per k-step big.small, small.big, then big.big. The first
// product of the first step overwrites d.
template <int N, int KSTEPS, class TA, class TB>
__device__ __forceinline__ void mma3_ss(float (&d)[N / 2], uint64_t a_big, uint64_t a_small, uint64_t b_big,
                                        uint64_t b_small) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t ka = TA::k_step(kk), kb = TB::k_step(kk);
    hopper::WgmmaTF32<N>::ss(d, a_big + ka, b_small + kb, kk > 0);
    hopper::WgmmaTF32<N>::ss(d, a_small + ka, b_big + kb, 1);
    hopper::WgmmaTF32<N>::ss(d, a_big + ka, b_big + kb, 1);
  }
}

// d += A B, A split in registers (one fragment a k-step), B split in
// shared memory (TB K-major), in the same order.
template <int N, int KSTEPS, class TB>
__device__ __forceinline__ void mma3_rs(float (&d)[N / 2], const uint32_t (&a_big)[KSTEPS][4],
                                        const uint32_t (&a_small)[KSTEPS][4], uint64_t b_big, uint64_t b_small) {
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const uint64_t kb = TB::k_step(kk);
    hopper::WgmmaTF32<N>::rs(d, a_big[kk], b_small + kb, 1);
    hopper::WgmmaTF32<N>::rs(d, a_small[kk], b_big + kb, 1);
    hopper::WgmmaTF32<N>::rs(d, a_big[kk], b_big + kb, 1);
  }
}

// d (+)= A B over 8 KSTEPS columns, A raw f32 in shared memory (TA, this
// warpgroup's 64 rows: warp w takes rows 16w..16w + 15), B split in shared
// memory (TB K-major). Four k-steps (one 32-float sub-tile of A, 32
// registers of fragments) at a time: each thread reads its A fragment
// elements, (g, t), (g + 8, t), (g, t + 4) and (g + 8, t + 4) of each
// k-step, splits them into big and small in registers, and the warpgroup
// issues those k-steps' products in mma3_ss's order and waits for them
// before the fragments are overwritten. The first product overwrites d;
// nothing is left in flight.
template <int N, int KSTEPS, class TA, class TB>
__device__ __forceinline__ void mma3_raw(float (&d)[N / 2], const float* a, uint64_t b_big, uint64_t b_small,
                                         int warp, int lane) {
  constexpr int G = 4;
  static_assert(KSTEPS % G == 0, "whole groups of four k-steps");
  const uint8_t* base = reinterpret_cast<const uint8_t*>(a);
  const int r = 16 * warp + (lane >> 2), t = lane & 3;
#pragma unroll 1
  for (int g0 = 0; g0 < KSTEPS; g0 += G) {
    uint32_t big[G][4], small[G][4];
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const int col = 8 * (g0 + kk) + t;
      hopper::tf32_split(*reinterpret_cast<const float*>(base + TA::offset(r, col)), big[kk][0], small[kk][0]);
      hopper::tf32_split(*reinterpret_cast<const float*>(base + TA::offset(r + 8, col)), big[kk][1], small[kk][1]);
      hopper::tf32_split(*reinterpret_cast<const float*>(base + TA::offset(r, col + 4)), big[kk][2], small[kk][2]);
      hopper::tf32_split(*reinterpret_cast<const float*>(base + TA::offset(r + 8, col + 4)), big[kk][3],
                         small[kk][3]);
    }
    hopper::fence_regs(d);
    hopper::fence_regs(big);
    hopper::fence_regs(small);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < G; ++kk) {
      const uint64_t kb = TB::k_step(g0 + kk);
      hopper::WgmmaTF32<N>::rs(d, big[kk], b_small + kb, g0 + kk > 0);
      hopper::WgmmaTF32<N>::rs(d, small[kk], b_big + kb, 1);
      hopper::WgmmaTF32<N>::rs(d, big[kk], b_big + kb, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(d);
    hopper::fence_regs(big);
    hopper::fence_regs(small);
  }
}


// Chunk j of an m64nN accumulator (this thread: rows g and g + 8, columns
// 8j + 2t and 8j + 2t + 1) as the tf32 A fragment of k-step j, split:
// a0..a3 sit at (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4), so position
// t holds column 2t and t + 4 column 2t + 1 -- the permutation the
// transposed tiles carry. With ROUND, each value is rounded to `to` first
// (a bf16 or f16 value splits exactly: its small part is 0).
template <int N, bool ROUND>
__device__ __forceinline__ void split_a_frags(uint32_t (&big)[N / 8][4], uint32_t (&small)[N / 8][4],
                                              const float (&c)[N / 2], int to) {
#pragma unroll
  for (int j = 0; j < N / 8; ++j) {
    hopper::tf32_split(hopper::rounded<ROUND>(c[4 * j + 0], to), big[j][0], small[j][0]);
    hopper::tf32_split(hopper::rounded<ROUND>(c[4 * j + 2], to), big[j][1], small[j][1]);
    hopper::tf32_split(hopper::rounded<ROUND>(c[4 * j + 1], to), big[j][2], small[j][2]);
    hopper::tf32_split(hopper::rounded<ROUND>(c[4 * j + 3], to), big[j][3], small[j][3]);
  }
}

// The partial sums of the two consumer warpgroups (c = 0, 1) meet: c = 1
// parks its accumulator in `park` (a tile no product reads any more, room
// for 128 x N floats), c = 0 adds it to its own. Named barrier 1, both
// consumer warpgroups.
template <int N>
__device__ __forceinline__ void meet(float (&acc)[N], float* park, int c, int tid) {
  hopper::bar_sync(1, 2 * WG_THREADS);  // every product of both warpgroups is in
  if (c == 1) {
#pragma unroll
    for (int r = 0; r < N; ++r) park[r * WG_THREADS + tid] = acc[r];
  }
  hopper::bar_sync(1, 2 * WG_THREADS);
  if (c == 0) {
#pragma unroll
    for (int r = 0; r < N; ++r) acc[r] += park[r * WG_THREADS + tid];
  }
}

// The forward's online softmax of one key tile (from k0) for this thread's
// rows a and a + 8 (its S accumulator sc, [64 q x BK keys]): s = S scale
// log2 e, masked to -inf (kMask: causal, past Tk); the running max m (log2
// units) across the row's four threads, and base (0 while a row has seen
// no key); P = exp2(s - base) in place; l = l alpha + this thread's sum of
// P, and O (acc) rescaled by alpha = exp2(m_old - base).
template <bool kMask, int BK, int D>
__device__ __forceinline__ void softmax_tile(float (&sc)[BK / 2], float (&acc)[D / 2], float& m_a, float& m_b,
                                             float& l_a, float& l_b, int k0, int Tk, int row_a, int t, float sl2,
                                             int causal) {
  const int row_b = row_a + 8;
  float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float sa = sc[4 * j + e] * sl2, sb = sc[4 * j + 2 + e] * sl2;
      if constexpr (kMask) {
        const int col = k0 + 8 * j + 2 * t + e;
        if (col >= Tk || (causal && col > row_a)) sa = -INFINITY;
        if (col >= Tk || (causal && col > row_b)) sb = -INFINITY;
      }
      sc[4 * j + e] = sa;
      sc[4 * j + 2 + e] = sb;
      mx_a = fmaxf(mx_a, sa);
      mx_b = fmaxf(mx_b, sb);
    }
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {  // the row's four threads
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a;  // a row with no key seen yet
  const float base_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float al_a = hopper::ex2(m_a - base_a), al_b = hopper::ex2(m_b - base_b);
  m_a = mn_a;
  m_b = mn_b;
  float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float pa = hopper::ex2(sc[4 * j + e] - base_a), pb = hopper::ex2(sc[4 * j + 2 + e] - base_b);
      sc[4 * j + e] = pa;
      sc[4 * j + 2 + e] = pb;
      sum_a += pa;
      sum_b += pb;
    }
  }
  l_a = l_a * al_a + sum_a;
  l_b = l_b * al_b + sum_b;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= al_a;
    acc[4 * j + 1] *= al_a;
    acc[4 * j + 2] *= al_b;
    acc[4 * j + 3] *= al_b;
  }
}

// The forward's two consumer warpgroups, each with a partial (O, m, l) of
// the same 64 rows (on alternate stages), meet: c = 1 parks its own in
// `park` (room for (D / 2 + 4) x 128 floats no product reads any more),
// c = 0 merges it into its own, in that order. Named barrier 1, both
// consumer warpgroups.
template <int D>
__device__ __forceinline__ void merge_rows(float (&acc)[D / 2], float& m_a, float& m_b, float& l_a, float& l_b,
                                           float* park, int c, int tid) {
  hopper::bar_sync(1, 2 * WG_THREADS);  // every product of both warpgroups is in
  if (c == 1) {
#pragma unroll
    for (int r = 0; r < D / 2; ++r) park[r * WG_THREADS + tid] = acc[r];
    park[(D / 2) * WG_THREADS + tid] = m_a;
    park[(D / 2 + 1) * WG_THREADS + tid] = m_b;
    park[(D / 2 + 2) * WG_THREADS + tid] = l_a;
    park[(D / 2 + 3) * WG_THREADS + tid] = l_b;
  }
  hopper::bar_sync(1, 2 * WG_THREADS);
  if (c == 1) return;
  const float m1_a = park[(D / 2) * WG_THREADS + tid], m1_b = park[(D / 2 + 1) * WG_THREADS + tid];
  const float mn_a = fmaxf(m_a, m1_a), mn_b = fmaxf(m_b, m1_b);
  const float base_a = mn_a == -INFINITY ? 0.f : mn_a, base_b = mn_b == -INFINITY ? 0.f : mn_b;
  const float a0 = hopper::ex2(m_a - base_a), a1 = hopper::ex2(m1_a - base_a);
  const float b0 = hopper::ex2(m_b - base_b), b1 = hopper::ex2(m1_b - base_b);
  l_a = l_a * a0 + park[(D / 2 + 2) * WG_THREADS + tid] * a1;
  l_b = l_b * b0 + park[(D / 2 + 3) * WG_THREADS + tid] * b1;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] = acc[4 * j] * a0 + park[(4 * j) * WG_THREADS + tid] * a1;
    acc[4 * j + 1] = acc[4 * j + 1] * a0 + park[(4 * j + 1) * WG_THREADS + tid] * a1;
    acc[4 * j + 2] = acc[4 * j + 2] * b0 + park[(4 * j + 2) * WG_THREADS + tid] * b1;
    acc[4 * j + 3] = acc[4 * j + 3] * b0 + park[(4 * j + 3) * WG_THREADS + tid] * b1;
  }
  m_a = mn_a;
  m_b = mn_b;
}

// A warpgroup's [64 x D] f32 accumulator to rows [row0, row0 + 64) and
// columns [col0, col0 + D) of a contiguous [T, dh] matrix (dh even; col0
// a slice's first column), rows past T and columns past dh not written.
template <int D>
__device__ __forceinline__ void store_rows(float* dst, const float (&acc)[D / 2], int row0, int T, int dh,
                                           int tid, int col0 = 0) {
  const int lane = tid % 32, r = row0 + 16 * (tid / 32) + (lane >> 2), c = col0 + 2 * (lane & 3);
  float* p = dst + (size_t)r * dh + c;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (r < T && 8 * j + c < dh) *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[4 * j], acc[4 * j + 1]);
    if (r + 8 < T && 8 * j + c < dh)
      *reinterpret_cast<float2*>(p + 8 * dh + 8 * j) = make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
}

// The forward's end for a warpgroup's 64 rows from row0: each row's sum l
// over its four threads, o = O / l to rows [row0, row0 + 64) and columns
// from col0 of a contiguous [T, dh] o (store_rows), and with `write_lse`
// lse = (m + log2 l) / log2 e (natural log) for the rows before T.
template <int D>
__device__ __forceinline__ void finish_rows(float (&acc)[D / 2], float m_a, float m_b, float l_a, float l_b, float* o,
                                            float* lse, int row0, int T, int dh, int tid, int col0, bool write_lse) {
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float inv_a = 1.f / l_a, inv_b = 1.f / l_b;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    acc[4 * j] *= inv_a;
    acc[4 * j + 1] *= inv_a;
    acc[4 * j + 2] *= inv_b;
    acc[4 * j + 3] *= inv_b;
  }
  store_rows<D>(o, acc, row0, T, dh, tid, col0);
  const int lane = tid % 32, row_a = row0 + 16 * (tid / 32) + (lane >> 2);
  if (write_lse && lane % 4 == 0) {
    if (row_a < T) lse[row_a] = (m_a + log2f(l_a)) / LOG2E;
    if (row_a + 8 < T) lse[row_a + 8] = (m_b + log2f(l_b)) / LOG2E;
  }
}

// ---------------------------------------------------------------------------
// dQ = dS K with P = exp(q k^T scale - lse) and dS = P (dO v^T - delta)
// scale. Replaces _dq_kernel (ray_tpu/ops/flash_attention.py:135-165) on
// f32 inputs. A block owns 64 q rows; its Q and dO are split once; each
// stage holds BK keys of K and V split, and K^T split (for dQ = dS K, whose
// reduction runs over keys). Consumer c takes key tiles c, c + 2, ...
// ---------------------------------------------------------------------------
template <int D>
struct DqPlan {
  static constexpr int BK = F32Tiles<D>::DQ_BK, STAGES = F32Tiles<D>::DQ_STAGES, RAW = F32Tiles<D>::DQ_RAW;
  static constexpr bool A_SPLIT = F32Tiles<D>::A_SPLIT;
  using TA = hopper::TileF<D, ROWS_OWNED>;  // Q or dO of the block's rows, big or small (or raw)
  using TK = hopper::TileF<D, BK>;          // a stage's K or V, big or small
  using TT = hopper::TileF<BK, D>;          // a stage's K^T, big or small
  using F = Feed<STAGES, RAW>;
  // Q, Q small, dO, dO small (A_SPLIT 0: Q and dO raw); the ring, a stage
  // being K, K small, V, V small, K^T, K^T small; the raw slots, K and V as
  // loaded; the mbarriers (full and ready of Q/dO, then the feed's).
  static constexpr int A_BYTES = (A_SPLIT ? 4 : 2) * TA::BYTES;
  static constexpr int STAGE_BYTES = 4 * TK::BYTES + 2 * TT::BYTES;
  static constexpr int RAW_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW * 2 * TK::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS);  // + alignment slack
  static_assert(STAGES >= 2 && (RAW == 0 || RAW >= 2), "TMA rings of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "dQ's shared memory does not fit");
};

template <int D, bool ROUND>
__global__ void __launch_bounds__(Roles<F32Tiles<D>::LOADER_WGS>::THREADS, 1)
flash_f32_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                    const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                    int Tq, int Tk, int dh, float scale, int causal, int round_ds) {
  using P = DqPlan<D>;
  using TA = typename P::TA;
  using TK = typename P::TK;
  using TT = typename P::TT;
  using R = Roles<F32Tiles<D>::LOADER_WGS>;
  constexpr int BK = P::BK, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sq = reinterpret_cast<float*>(base);
  float* sq_s = sq + TA::BYTES / 4;  // (A_SPLIT only, as dO small)
  float* sdo = sq + (P::A_SPLIT ? 2 : 1) * TA::BYTES / 4;
  float* sdo_s = sdo + TA::BYTES / 4;
  // Stage s: K, K small, V, V small, K^T, K^T small.
  auto ring = [&](int s, int part) {
    const int at = part < 4 ? part * TK::BYTES : 4 * TK::BYTES + (part - 4) * TT::BYTES;
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + at);
  };
  // Where tile i's K and V land: a raw slot, or the stage's K and V.
  auto loaded = [&](int i, int part) {
    return P::RAW > 0 ? reinterpret_cast<float*>(base + P::RAW_OFF + ((i % P::RAW) * 2 + part / 2) * TK::BYTES)
                      : ring(i % STAGES, part);
  };
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const typename P::F feed(ready_a + 1);
  // Causal: the longest rows first (blocks start in order of blockIdx.y).
  const int bh = blockIdx.x, qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS_OWNED, n_k = key_tiles<BK>(q0 + ROWS_OWNED - 1, Tk, causal);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, WG_THREADS / 32);  // a stage is released by the warps of the one warpgroup that took it
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, 2 * TA::BYTES);
      hopper::tma_load_tile<TA>(sq, &tm_q, full_a, q0, bh);
      hopper::tma_load_tile<TA>(sdo, &tm_do, full_a, q0, bh);
      for (int i = 0; i < n_k; ++i) {
        uint64_t* bar = feed.load_slot(i, 2 * TK::BYTES);
        hopper::tma_load_tile<TK>(loaded(i, 0), &tm_k, bar, i * BK, bh);
        hopper::tma_load_tile<TK>(loaded(i, 2), &tm_v, bar, i * BK, bh);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      hopper::mbar_wait(full_a, 0);
      if constexpr (P::A_SPLIT) {
        split_tile<TA::BYTES, NT>(sq, sq, sq_s, u);
        split_tile<TA::BYTES, NT>(sdo, sdo, sdo_s, u);
      }
      split_done(ready_a);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        feed.split_begin(i);
        split_tile_t<TK, NT>(loaded(i, 0), ring(s, 0), ring(s, 1), ring(s, 4), ring(s, 5), u);
        split_tile<TK::BYTES, NT>(loaded(i, 2), ring(s, 2), ring(s, 3), u);
        feed.split_end(i);
      }
    }
  } else {  // consumers: both own the 64 rows, c takes key tiles c, c + 2, ...
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
    const float sl2 = scale * LOG2E;
    // This thread's rows' lse (log2 units) and delta scale; zero past Tq,
    // where Q and dO are zero-filled, so dS is zero there.
    const float* lse_bh = lse + (size_t)bh * Tq;
    const float* delta_bh = delta + (size_t)bh * Tq;
    const float l2_a = row_a < Tq ? lse_bh[row_a] * LOG2E : 0.f;
    const float l2_b = row_b < Tq ? lse_bh[row_b] * LOG2E : 0.f;
    const float dl_a = row_a < Tq ? delta_bh[row_a] * scale : 0.f;
    const float dl_b = row_b < Tq ? delta_bh[row_b] * scale : 0.f;
    float acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const uint64_t q_b = TA::desc(sq), q_s = TA::desc(sq_s), do_b = TA::desc(sdo), do_s = TA::desc(sdo_s);
    auto ktile = [&](auto masked, int i) {
      const int s = i % STAGES, k0 = i * BK;
      hopper::mbar_wait(&feed.ready[s], (i / STAGES) & 1);
      float sc[BK / 2], dp[BK / 2];  // S (then P) and dP (then dS), [64 q x BK keys]
      hopper::fence_regs(acc);
      if constexpr (P::A_SPLIT) {
        hopper::wgmma_fence();
        mma3_ss<BK, D / 8, TA, TK>(sc, q_b, q_s, TK::desc(ring(s, 0)), TK::desc(ring(s, 1)));
        hopper::wgmma_commit();
        mma3_ss<BK, D / 8, TA, TK>(dp, do_b, do_s, TK::desc(ring(s, 2)), TK::desc(ring(s, 3)));
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // S is in; dP may still run
      } else {  // both in when these return
        mma3_raw<BK, D / 8, TA, TK>(sc, sq, TK::desc(ring(s, 0)), TK::desc(ring(s, 1)), warp, lane);
        mma3_raw<BK, D / 8, TA, TK>(dp, sdo, TK::desc(ring(s, 2)), TK::desc(ring(s, 3)), warp, lane);
      }
      hopper::fence_regs(sc);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          float pa = hopper::ex2(fmaf(sc[4 * j + e], sl2, -l2_a));
          float pb = hopper::ex2(fmaf(sc[4 * j + 2 + e], sl2, -l2_b));
          if constexpr (decltype(masked)::value) {
            if (col >= Tk || (causal && col > row_a)) pa = 0.f;
            if (col >= Tk || (causal && col > row_b)) pb = 0.f;
          }
          sc[4 * j + e] = pa;
          sc[4 * j + 2 + e] = pb;
        }
      }
      hopper::fence_regs(sc);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          dp[4 * j + e] = sc[4 * j + e] * fmaf(dp[4 * j + e], scale, -dl_a);  // dS
          dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * fmaf(dp[4 * j + 2 + e], scale, -dl_b);
        }
      }
      uint32_t ds_b[BK / 8][4], ds_s[BK / 8][4];
      split_a_frags<BK, ROUND>(ds_b, ds_s, dp, round_ds);
      hopper::fence_regs(acc);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      hopper::wgmma_fence();
      mma3_rs<D, BK / 8, TT>(acc, ds_b, ds_s, TT::desc(ring(s, 4)), TT::desc(ring(s, 5)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      warp_release(&feed.empty[s]);
    };
    // The tiles that need a mask (the diagonal's, the ragged end's) run in
    // a loop of their own.
    const int n_plain = min(plain_tiles<BK>(q0, Tk, causal), n_k);
    int i = c;
    for (; i < n_plain; i += 2) ktile(std::false_type{}, i);
    for (; i < n_k; i += 2) ktile(std::true_type{}, i);
    meet(acc, sq, c, tid);  // Q's tile: no product reads it now
    if (c == 0) store_rows<D>(dq + (size_t)bh * Tq * dh, acc, q0, Tq, dh, tid);
  }
}

// ---------------------------------------------------------------------------
// dK = dS^T q scale and dV = P^T dO, over the q rows that see the block's
// 64 keys (causal: from the diagonal on). Replaces _dkv_kernel
// (ray_tpu/ops/flash_attention.py:168-205) on f32 inputs. The block's K and
// V are split once; each stage holds BQ q rows of Q and dO split, Q^T and
// dO^T split (for dK = dS^T Q and dV = P^T dO, whose reductions run over q
// rows), and the rows' lse and delta. Consumer c takes the block's q tiles
// c, c + 2, ... counted from the first.
// ---------------------------------------------------------------------------
template <int D>
struct DkvPlan {
  static constexpr int BQ = F32Tiles<D>::DKV_BQ, STAGES = F32Tiles<D>::DKV_STAGES, RAW = F32Tiles<D>::DKV_RAW;
  static constexpr bool A_SPLIT = F32Tiles<D>::A_SPLIT;
  static constexpr int PASSES = F32Tiles<D>::DKV_PASSES;
  using TA = hopper::TileF<D, ROWS_OWNED>;  // K or V of the block's keys, big or small (or raw)
  using TQ = hopper::TileF<D, BQ>;          // a stage's Q or dO, big or small
  using TT = hopper::TileF<BQ, D>;          // a stage's Q^T or dO^T, big or small
  using F = Feed<STAGES, RAW>;
  // K, K small, V, V small (A_SPLIT 0: K and V raw); the ring, a stage
  // being Q, Q small, dO, dO small, Q^T, Q^T small, dO^T, dO^T small (a dV
  // pass: Q, Q small, dO as loaded, -, dO^T, dO^T small; a dK pass: Q, Q
  // small, dO, dO small, Q^T, Q^T small); the raw slots, Q and dO as loaded;
  // each stage's lse and delta; the mbarriers.
  static constexpr int A_BYTES = (A_SPLIT ? 4 : 2) * TA::BYTES;
  static constexpr int STAGE_BYTES = 4 * TQ::BYTES + (PASSES == 1 ? 4 : 2) * TT::BYTES;
  static constexpr int RAW_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int ROWS_OFF = RAW_OFF + RAW * 2 * TQ::BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS);  // + alignment slack
  static_assert(STAGES >= 2 && (RAW == 0 || RAW >= 2), "TMA rings of at least two stages");
  static_assert(PASSES == 1 || PASSES == 2, "dK/dV in one pass or two");
  static_assert(BYTES <= SMEM_LIMIT, "dK/dV's shared memory does not fit");
};

// PASS 0: dK and dV; 1: dV alone; 2: dK alone (DKV_PASSES 2).
template <int D, int PASS, bool ROUND>
__global__ void __launch_bounds__(Roles<F32Tiles<D>::LOADER_WGS>::THREADS, 1)
flash_f32_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                     const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                     float* __restrict__ dv, int Tq, int Tk, int dh, float scale, int causal, int round_p,
                     int round_ds) {
  using P = DkvPlan<D>;
  using TA = typename P::TA;
  using TQ = typename P::TQ;
  using TT = typename P::TT;
  using R = Roles<F32Tiles<D>::LOADER_WGS>;
  constexpr int BQ = P::BQ, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  constexpr bool DO_DK = PASS != 1, DO_DV = PASS != 2;
  static_assert((PASS == 0) == (P::PASSES == 1), "one pass, or a dV pass and a dK pass");
  // The stage parts the gradient products read: dO^T's and Q^T's.
  constexpr int DOT_PART = PASS == 0 ? 6 : 4, QT_PART = 4;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sk = reinterpret_cast<float*>(base);
  float* sk_s = sk + TA::BYTES / 4;  // (A_SPLIT only, as V small)
  float* sv = sk + (P::A_SPLIT ? 2 : 1) * TA::BYTES / 4;
  float* sv_s = sv + TA::BYTES / 4;
  // Stage s: Q, Q small, dO, dO small, Q^T, Q^T small, dO^T, dO^T small
  // (a pass of two: the six parts its products read, see DkvPlan).
  auto ring = [&](int s, int part) {
    const int at = part < 4 ? part * TQ::BYTES : 4 * TQ::BYTES + (part - 4) * TT::BYTES;
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + at);
  };
  // Where tile j's Q and dO land: a raw slot, or the stage's Q and dO.
  auto loaded = [&](int j, int part) {
    return P::RAW > 0 ? reinterpret_cast<float*>(base + P::RAW_OFF + ((j % P::RAW) * 2 + part / 2) * TQ::BYTES)
                      : ring(j % STAGES, part);
  };
  float* slse = reinterpret_cast<float*>(base + P::ROWS_OFF);  // [STAGES][BQ], log2 units
  float* sdelta = slse + STAGES * BQ;                          // [STAGES][BQ], times scale
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const typename P::F feed(ready_a + 1);
  const int bh = blockIdx.x, k0 = blockIdx.y * ROWS_OWNED;  // causal: key tile 0 sees the most rows
  const int n_qs = (Tq + BQ - 1) / BQ, i_begin = causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, WG_THREADS / 32);
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, 2 * TA::BYTES);
      hopper::tma_load_tile<TA>(sk, &tm_k, full_a, k0, bh);
      hopper::tma_load_tile<TA>(sv, &tm_v, full_a, k0, bh);
      for (int i = i_begin; i < n_qs; ++i) {
        const int j = i - i_begin;
        uint64_t* bar = feed.load_slot(j, 2 * TQ::BYTES);
        hopper::tma_load_tile<TQ>(loaded(j, 0), &tm_q, bar, i * BQ, bh);
        hopper::tma_load_tile<TQ>(loaded(j, 2), &tm_do, bar, i * BQ, bh);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      const float* lse_bh = lse + (size_t)bh * Tq;
      const float* delta_bh = delta + (size_t)bh * Tq;
      hopper::mbar_wait(full_a, 0);
      if constexpr (P::A_SPLIT) {
        split_tile<TA::BYTES, NT>(sk, sk, sk_s, u);
        split_tile<TA::BYTES, NT>(sv, sv, sv_s, u);
      }
      split_done(ready_a);
      for (int i = i_begin; i < n_qs; ++i) {
        const int j = i - i_begin, s = j % STAGES;
        feed.split_begin(j);
        if constexpr (PASS == 0) {
          split_tile_t<TQ, NT>(loaded(j, 0), ring(s, 0), ring(s, 1), ring(s, 4), ring(s, 5), u);
          split_tile_t<TQ, NT>(loaded(j, 2), ring(s, 2), ring(s, 3), ring(s, 6), ring(s, 7), u);
        } else if constexpr (PASS == 1) {  // S^T reads Q, dV reads dO^T
          split_tile<TQ::BYTES, NT>(loaded(j, 0), ring(s, 0), ring(s, 1), u);
          split_tile_t<TQ, NT, false>(loaded(j, 2), nullptr, nullptr, ring(s, 4), ring(s, 5), u);
        } else {  // S^T reads Q, dP^T dO, dK Q^T
          split_tile_t<TQ, NT>(loaded(j, 0), ring(s, 0), ring(s, 1), ring(s, 4), ring(s, 5), u);
          split_tile<TQ::BYTES, NT>(loaded(j, 2), ring(s, 2), ring(s, 3), u);
        }
        for (int r = u; r < BQ; r += NT) {  // zero past Tq, where Q and dO are zero-filled
          const int row = i * BQ + r;
          slse[s * BQ + r] = row < Tq ? lse_bh[row] * LOG2E : 0.f;
          sdelta[s * BQ + r] = row < Tq ? delta_bh[row] * scale : 0.f;
        }
        feed.split_end(j);
      }
    }
  } else {  // consumers: both own the 64 keys, c takes q tiles i_begin + c, + 2, ...
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
    const float sl2 = scale * LOG2E;
    float dk_acc[DO_DK ? D / 2 : 1], dv_acc[DO_DV ? D / 2 : 1];
#pragma unroll
    for (int r = 0; r < (DO_DK ? D / 2 : 1); ++r) dk_acc[r] = 0.f;
#pragma unroll
    for (int r = 0; r < (DO_DV ? D / 2 : 1); ++r) dv_acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const uint64_t k_b = TA::desc(sk), k_s = TA::desc(sk_s), v_b = TA::desc(sv), v_s = TA::desc(sv_s);
    auto qtile = [&](auto masked, int i) {
      const int j = i - i_begin, s = j % STAGES, q0 = i * BQ;
      const float* ls = slse + s * BQ;
      [[maybe_unused]] const float* ds = sdelta + s * BQ;  // (read by the dK pass)
      hopper::mbar_wait(&feed.ready[s], (j / STAGES) & 1);
      float st[BQ / 2], dpt[BQ / 2];  // S^T (then P^T) and dP^T (then dS^T), [64 keys x BQ q]
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      if constexpr (P::A_SPLIT) {
        hopper::wgmma_fence();
        mma3_ss<BQ, D / 8, TA, TQ>(st, k_b, k_s, TQ::desc(ring(s, 0)), TQ::desc(ring(s, 1)));
        hopper::wgmma_commit();
        if constexpr (DO_DK) {
          mma3_ss<BQ, D / 8, TA, TQ>(dpt, v_b, v_s, TQ::desc(ring(s, 2)), TQ::desc(ring(s, 3)));
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // S^T is in; dP^T may still run
        } else {
          hopper::wgmma_wait<0>();
        }
      } else {  // both in when these return
        mma3_raw<BQ, D / 8, TA, TQ>(st, sk, TQ::desc(ring(s, 0)), TQ::desc(ring(s, 1)), warp, lane);
        if constexpr (DO_DK)
          mma3_raw<BQ, D / 8, TA, TQ>(dpt, sv, TQ::desc(ring(s, 2)), TQ::desc(ring(s, 3)), warp, lane);
      }
      hopper::fence_regs(st);
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const float2 L2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qcol = q0 + 8 * jj + 2 * t + e;
          const float L = e ? L2.y : L2.x;
          float pa = hopper::ex2(fmaf(st[4 * jj + e], sl2, -L));
          float pb = hopper::ex2(fmaf(st[4 * jj + 2 + e], sl2, -L));
          if constexpr (decltype(masked)::value) {
            if (qcol >= Tq || (causal && key_a > qcol)) pa = 0.f;
            if (qcol >= Tq || (causal && key_b > qcol)) pb = 0.f;
          }
          st[4 * jj + e] = pa;
          st[4 * jj + 2 + e] = pb;
        }
      }
      hopper::fence_regs(st);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dpt);
      if constexpr (DO_DK) {
#pragma unroll
        for (int jj = 0; jj < BQ / 8; ++jj) {
          const float2 dl2 = *reinterpret_cast<const float2*>(ds + 8 * jj + 2 * t);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float dls = e ? dl2.y : dl2.x;
            dpt[4 * jj + e] = st[4 * jj + e] * fmaf(dpt[4 * jj + e], scale, -dls);  // dS^T
            dpt[4 * jj + 2 + e] = st[4 * jj + 2 + e] * fmaf(dpt[4 * jj + 2 + e], scale, -dls);
          }
        }
      }
      uint32_t p_b[DO_DV ? BQ / 8 : 1][4], p_s[DO_DV ? BQ / 8 : 1][4];
      uint32_t ds_b[DO_DK ? BQ / 8 : 1][4], ds_s[DO_DK ? BQ / 8 : 1][4];
      if constexpr (DO_DV) split_a_frags<BQ, ROUND>(p_b, p_s, st, round_p);
      if constexpr (DO_DK) split_a_frags<BQ, ROUND>(ds_b, ds_s, dpt, round_ds);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      hopper::wgmma_fence();
      if constexpr (DO_DV)
        mma3_rs<D, BQ / 8, TT>(dv_acc, p_b, p_s, TT::desc(ring(s, DOT_PART)), TT::desc(ring(s, DOT_PART + 1)));
      if constexpr (DO_DK)
        mma3_rs<D, BQ / 8, TT>(dk_acc, ds_b, ds_s, TT::desc(ring(s, QT_PART)), TT::desc(ring(s, QT_PART + 1)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      warp_release(&feed.empty[s]);
    };
    // Masked tiles in loops of their own: causal, those whose first row is
    // before the block's last key; then the one holding the ragged end.
    const int diag_end = causal ? min(n_qs, (k0 + ROWS_OWNED - 1) / BQ + 1) : i_begin;
    const int plain_end = max(diag_end, Tq / BQ);
    int i = i_begin + c;
    for (; i < diag_end; i += 2) qtile(std::true_type{}, i);
    for (; i < plain_end; i += 2) qtile(std::false_type{}, i);
    for (; i < n_qs; i += 2) qtile(std::true_type{}, i);
    // K's tiles (K and V raw: K's) park the partial sums: no product reads them now
    if constexpr (DO_DK) meet(dk_acc, sk, c, tid);
    if constexpr (DO_DV) meet(dv_acc, DO_DK ? sk_s : sk, c, tid);
    if (c == 0) {
      if constexpr (DO_DK) store_rows<D>(dk + (size_t)bh * Tk * dh, dk_acc, k0, Tk, dh, tid);
      if constexpr (DO_DV) store_rows<D>(dv + (size_t)bh * Tk * dh, dv_acc, k0, Tk, dh, tid);
    }
  }
}

// ---------------------------------------------------------------------------
// o = softmax(q k^T scale) v, normalised, and lse = the row logsumexp
// (natural log), online over key tiles. Replaces _fwd_kernel
// (ray_tpu/ops/flash_attention.py:72-132) on f32 inputs. A block owns ROWS q
// rows of one head (64 a consumer warpgroup when ROWS is 128); its Q is
// split once; each stage holds BK keys of K split, and V^T split (for O =
// P V, whose reduction runs over keys).
// ---------------------------------------------------------------------------
template <int D>
struct FwdPlan {
  static constexpr int ROWS = F32Tiles<D>::FWD_ROWS, BK = F32Tiles<D>::FWD_BK;
  static constexpr int STAGES = F32Tiles<D>::FWD_STAGES, RAW = F32Tiles<D>::FWD_RAW;
  // ROWS 128: consumer c owns rows 64c.., both read every stage; ROWS 64:
  // both own the 64 rows, c takes key tiles c, c + 2, ...
  static constexpr bool SHARED = ROWS == 2 * ROWS_OWNED;
  static constexpr bool A_SPLIT = F32Tiles<D>::A_SPLIT;
  static constexpr int Q_TILES = ROWS / ROWS_OWNED;
  using TA = hopper::TileF<D, ROWS_OWNED>;  // 64 rows of Q, big or small (or raw)
  using TK = hopper::TileF<D, BK>;          // a stage's K, big or small (and V as loaded)
  using TT = hopper::TileF<BK, D>;          // a stage's V^T, big or small
  using F = Feed<STAGES, RAW>;
  // Q big, a tile per 64 rows, then Q small (A_SPLIT 0: Q raw); the ring, a
  // stage being K, K small, V^T, V^T small (and V as loaded, without raw
  // slots); the raw slots, K and V as loaded; the mbarriers (full and ready
  // of Q, then the feed's).
  static constexpr int A_BYTES = (A_SPLIT ? 2 : 1) * Q_TILES * TA::BYTES;
  static constexpr int STAGE_BYTES = 2 * TK::BYTES + 2 * TT::BYTES + (RAW == 0 ? TK::BYTES : 0);
  static constexpr int RAW_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW * 2 * TK::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS);  // + alignment slack
  static_assert(ROWS == ROWS_OWNED || SHARED, "blocks of 64 or 128 q rows");
  static_assert(STAGES >= 2 && (RAW == 0 || RAW >= 2), "TMA rings of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "the forward's shared memory does not fit");
};

template <int D, bool ROUND>
__global__ void __launch_bounds__(Roles<F32Tiles<D>::FWD_LOADER_WGS>::THREADS, 1)
flash_f32_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o, float* __restrict__ lse,
                     int Tq, int Tk, int dh, float scale, int causal, int round_p) {
  using P = FwdPlan<D>;
  using TA = typename P::TA;
  using TK = typename P::TK;
  using TT = typename P::TT;
  using R = Roles<F32Tiles<D>::FWD_LOADER_WGS>;
  constexpr int BK = P::BK, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  static_assert(TK::BYTES == TT::BYTES, "a stage's tiles are of one size");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sq = reinterpret_cast<float*>(base);
  float* sq_s = sq + P::Q_TILES * TA::BYTES / 4;
  // Stage s: K, K small, V^T, V^T small, V as loaded (no raw slots).
  auto ring = [&](int s, int part) {
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + part * TK::BYTES);
  };
  // Where tile i's K (part 0) and V (part 1) land: a raw slot, or the stage.
  auto loaded = [&](int i, int part) {
    return P::RAW > 0 ? reinterpret_cast<float*>(base + P::RAW_OFF + ((i % P::RAW) * 2 + part) * TK::BYTES)
                      : ring(i % STAGES, part ? 4 : 0);
  };
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const typename P::F feed(ready_a + 1);
  // Causal: the longest rows first (blocks start in order of blockIdx.y).
  const int bh = blockIdx.x, qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * P::ROWS, n_k = key_tiles<BK>(q0 + P::ROWS - 1, Tk, causal);
  // Q's 64-row tiles that hold a row before Tq: only those are loaded.
  const int q_tiles = min(P::Q_TILES, (Tq - q0 + ROWS_OWNED - 1) / ROWS_OWNED);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, (P::SHARED ? 2 : 1) * WG_THREADS / 32);  // shared: both warpgroups release each stage
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, q_tiles * TA::BYTES);
      for (int h = 0; h < q_tiles; ++h)
        hopper::tma_load_tile<TA>(sq + h * TA::BYTES / 4, &tm_q, full_a, q0 + h * ROWS_OWNED, bh);
      for (int i = 0; i < n_k; ++i) {
        uint64_t* bar = feed.load_slot(i, 2 * TK::BYTES);
        hopper::tma_load_tile<TK>(loaded(i, 0), &tm_k, bar, i * BK, bh);
        hopper::tma_load_tile<TK>(loaded(i, 1), &tm_v, bar, i * BK, bh);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      hopper::mbar_wait(full_a, 0);
      if constexpr (P::A_SPLIT) {
        for (int h = 0; h < q_tiles; ++h)
          split_tile<TA::BYTES, NT>(sq + h * TA::BYTES / 4, sq + h * TA::BYTES / 4, sq_s + h * TA::BYTES / 4, u);
      }
      split_done(ready_a);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        feed.split_begin(i);
        split_tile<TK::BYTES, NT>(loaded(i, 0), ring(s, 0), ring(s, 1), u);
        split_tile_t<TK, NT, false>(loaded(i, 1), nullptr, nullptr, ring(s, 2), ring(s, 3), u);
        feed.split_end(i);
      }
    }
  } else {  // consumers
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int r0 = q0 + (P::SHARED ? c * ROWS_OWNED : 0);  // this warpgroup's first row
    const int row_a = r0 + 16 * warp + g;
    const float sl2 = scale * LOG2E;
    // O, and per row the running max (log2 units) and this thread's part of
    // the running sum (its columns; the four threads of a row add theirs at
    // the end).
    float acc[D / 2], m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const int h = P::SHARED ? c : 0;
    const uint64_t q_b = TA::desc(sq + h * TA::BYTES / 4), q_s = TA::desc(sq_s + h * TA::BYTES / 4);
    auto ktile = [&](auto masked, int i) {
      const int s = i % STAGES, k0 = i * BK;
      hopper::mbar_wait(&feed.ready[s], (i / STAGES) & 1);
      float sc[BK / 2];  // S (then P), [64 q x BK keys]
      hopper::fence_regs(acc);
      if constexpr (P::A_SPLIT) {
        hopper::wgmma_fence();
        mma3_ss<BK, D / 8, TA, TK>(sc, q_b, q_s, TK::desc(ring(s, 0)), TK::desc(ring(s, 1)));
        hopper::wgmma_commit();
        hopper::wgmma_wait<0>();
      } else {
        mma3_raw<BK, D / 8, TA, TK>(sc, sq + h * TA::BYTES / 4, TK::desc(ring(s, 0)), TK::desc(ring(s, 1)), warp,
                                    lane);
      }
      hopper::fence_regs(sc);
      // The last tile's P V is in (its wait ended the last call): O is rescaled.
      softmax_tile<decltype(masked)::value, BK, D>(sc, acc, m_a, m_b, l_a, l_b, k0, Tk, row_a, t, sl2, causal);
      uint32_t p_b[BK / 8][4], p_s[BK / 8][4];
      split_a_frags<BK, ROUND>(p_b, p_s, sc, round_p);
      hopper::fence_regs(acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::wgmma_fence();
      mma3_rs<D, BK / 8, TT>(acc, p_b, p_s, TT::desc(ring(s, 2)), TT::desc(ring(s, 3)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      warp_release(&feed.empty[s]);
    };
    // A stage this warpgroup has no rows for (shared, causal: past its
    // diagonal; or all its rows past Tq): released all the same.
    auto skip = [&](int i) {
      hopper::mbar_wait(&feed.ready[i % STAGES], (i / STAGES) & 1);
      warp_release(&feed.empty[i % STAGES]);
    };
    // The tiles that need a mask (the diagonal's, the ragged end's) run in
    // a loop of their own.
    constexpr int STEP = P::SHARED ? 1 : 2;
    const int n_mine = !P::SHARED ? n_k : r0 < Tq ? key_tiles<BK>(r0 + ROWS_OWNED - 1, Tk, causal) : 0;
    const int n_plain = min(plain_tiles<BK>(r0, Tk, causal), n_mine);
    int i = P::SHARED ? 0 : c;
    for (; i < n_plain; i += STEP) ktile(std::false_type{}, i);
    for (; i < n_mine; i += STEP) ktile(std::true_type{}, i);
    for (; i < n_k; i += STEP) skip(i);
    if constexpr (!P::SHARED) {
      // The two partial results of the rows meet in Q's tiles (no product
      // reads them now).
      merge_rows<D>(acc, m_a, m_b, l_a, l_b, sq, c, tid);
      if (c == 1) return;
    }
    finish_rows<D>(acc, m_a, m_b, l_a, l_b, o + (size_t)bh * Tq * dh, lse + (size_t)bh * Tq, r0, Tq, dh, tid, 0,
                   true);
  }
}

// ---------------------------------------------------------------------------
// dQ and dK/dV above head dim 256: a cluster of column slices. Replaces
// _dq_kernel and _dkv_kernel (ray_tpu/ops/flash_attention.py:135, :168) on
// f32 inputs (and mixes) at head dims 257-1024, where a [64 x Dh] f32
// accumulator no longer fits a warpgroup's registers. A cluster of W =
// ceil(Dh / SLICE) blocks (3 to MAX_SLICES) serves one (head, 64 rows);
// block w (its rank in the cluster) owns the columns [w SLICE, (w + 1)
// SLICE) of every operand and of its results, and is the head dim 128
// kernel above on that slice: its 64 rows split once in shared memory,
// stages of 16 keys (dQ) or 8 q rows (dK/dV) loaded by TMA at the slice's
// column offset (columns past Dh arrive as zeros) and split, with way (a)'s
// transposed copies, two consumer warpgroups on alternate stages, 3xTF32
// wgmma. Per stage a consumer contracts the scores (S and dP, or S^T and
// dP^T) over its own slice only, writes those partial sums to an exchange
// slot of its shared memory and arrives on the matching barrier of every
// block of the cluster (one arrival per warp and block, released at
// cluster scope); once all W blocks' partials of that stage are in, it
// reads them through distributed shared memory and adds them in rank order
// w = 0 .. W - 1, so every block holds bitwise the same S, P and dS, with
// no atomics and the same bits on every call (a block's own partial is
// itself a sum in f32 of SCORE_STEPS k-steps' products at a time: the
// tensor cores' accumulator rounds toward zero). Then each block applies dQ
// += dS K (or dV += P^T dO and dK += dS^T Q) on its slice: the slice a
// block contracts is the slice it writes, so each column of Q, K, V and dO
// is loaded once a stage across the cluster and the products are the
// function's own 6 (dQ) or 8 (dK/dV) FLOPs per kept pair and head-dim
// element, with no recompute. A stage's exchange slot is its natural small
// tile of V (dQ) or dO (dK/dV), which only the score products read and
// which holds exactly the two [64 x N] partials: no shared memory of its
// own, so dQ keeps 16-key stages. Each block's readers arrive on the
// slot's second barrier once they have read it, and the split pass waits
// for all of them (cluster scope) before it writes that tile for the
// stage's next round. The clusters of one launch are (bh x W, row blocks)
// blocks along x. Bound: the function's FLOPs at 165 TFLOP/s (3xTF32), as
// the instances'; the exchange's reads of the other blocks' partials cost
// a quarter of dQ's time at Dh 384 (PERF.md). Above 1024 (more slices than
// a portable cluster holds), dQ and dK/dV take the column-window kernels
// of flash_wide.cuh: a choice of shape by head dim.
// ---------------------------------------------------------------------------

// The slices' traits: the columns a block owns, the cluster's portable
// limit, per kernel the stage rows, ring depth and raw slots, the loading
// warpgroups, the blocks whose partials a consumer reads at once (their
// loads in flight together), and the k-steps of a partial of the scores
// before it is added in f32 (slice_scores). Chosen by timing variants on an
// H100 (python3 -m ray_tpu_torch.sweep_flash_f32 --variants slices,
// PERF.md; f32 Dh 384): dQ's 16-key stages beat 8 keys with three or four
// stages (0.74 against 0.95 and 0.98 ms); dK/dV's third stage, TMA writing
// it in place, beats two with raw slots (1.07 against 1.17 ms): the split
// pass waits for the cluster's reads of a stage before it writes the
// stage's exchange tile again, and a third stage hides that; four blocks'
// partials read at once beat two (0.74 against 0.78 ms for dQ). Scores
// added every two k-steps cost no time against one chain a slice and take
// the mix's dk gap at Dh 320 from 9.8e-5 to 5.4e-5 (f32's limit: 1e-4).
// tests/test_torch_flash_f32_split.py reads this block.
struct SliceTiles {
  static constexpr int SLICE = 128, MAX_SLICES = 8;
  static constexpr int DQ_BK = 16, DQ_STAGES = 2, DQ_RAW = 0, DKV_BQ = 8, DKV_STAGES = 3, DKV_RAW = 0;
  static constexpr int LOADER_WGS = 2, READ_BLOCKS = 4, SCORE_STEPS = 2;
};

// A consumer's partial scores over its slice, PARTS products at once (the
// forward's S; dQ's S and dP, or dK/dV's S^T and dP^T): d[x] = A[x] B[x]
// over the slice's SLICE / 8 k-steps, A and B split in shared memory
// (mma3_ss's operands and order), STEPS k-steps into a partial the first
// product overwrites, which is then added to d[x] in f32. The tensor cores
// round their accumulator toward zero, and chained over a slice's 16
// k-steps those roundings pile up one way: in the mixed library a dS a
// few f32 ulps off rounds to another bf16 in more places (flash_wide.cuh's
// product_rows adds each k-step's products the same way). One group's
// products run while the last group's are added; nothing is left in
// flight.
template <int N, int PARTS, int SLICE, int STEPS, class TA, class TB>
__device__ __forceinline__ void slice_scores(float (&d)[PARTS][N / 2], const uint64_t (&a_big)[PARTS],
                                             const uint64_t (&a_small)[PARTS], const uint64_t (&b_big)[PARTS],
                                             const uint64_t (&b_small)[PARTS]) {
  constexpr int G = STEPS, GROUPS = SLICE / 8 / G;
  static_assert(GROUPS * G * 8 == SLICE, "whole groups of k-steps");
  float p[2][PARTS][N / 2];
#pragma unroll
  for (int x = 0; x < PARTS; ++x)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) d[x][i] = 0.f;
#pragma unroll
  for (int g = 0; g <= GROUPS; ++g) {
    if (g < GROUPS) {
#pragma unroll
      for (int x = 0; x < PARTS; ++x) hopper::fence_regs(p[g & 1][x]);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < G; ++kk) {
        const uint64_t ka = TA::k_step(g * G + kk), kb = TB::k_step(g * G + kk);
#pragma unroll
        for (int x = 0; x < PARTS; ++x) {
          hopper::WgmmaTF32<N>::ss(p[g & 1][x], a_big[x] + ka, b_small[x] + kb, kk > 0);
          hopper::WgmmaTF32<N>::ss(p[g & 1][x], a_small[x] + ka, b_big[x] + kb, 1);
          hopper::WgmmaTF32<N>::ss(p[g & 1][x], a_big[x] + ka, b_big[x] + kb, 1);
        }
      }
      hopper::wgmma_commit();
    }
    if (g > 0) {
      if (g < GROUPS)
        hopper::wgmma_wait<1>();
      else
        hopper::wgmma_wait<0>();
#pragma unroll
      for (int x = 0; x < PARTS; ++x) {
        float(&q)[N / 2] = p[(g - 1) & 1][x];
        hopper::fence_regs(q);
#pragma unroll
        for (int i = 0; i < N / 2; ++i) d[x][i] += q[i];
      }
    }
  }
}

// The partial scores of the slices, exchanged through the cluster
// (hopper::cluster_sum at this file's traits): a consumer's PARTS [64 x N]
// partials in a dead [N x SLICE] tile of the stage (as many bytes).
template <int N, int PARTS>
__device__ __forceinline__ void exchange(float (&p)[PARTS][N / 2], float* slot, uint64_t* full, uint64_t* done,
                                         uint32_t parity, int tid, uint32_t blocks) {
  hopper::cluster_sum<N, PARTS, SliceTiles::READ_BLOCKS, SliceTiles::MAX_SLICES>(p, slot, full, done, parity, tid,
                                                                                blocks, hopper::cluster_rank());
}

// The split pass, before it writes a stage's exchange slot for tile j:
// every block has read the slot's partials of tile j - STAGES.
template <int STAGES>
__device__ __forceinline__ void slot_free(uint64_t* done, int j) {
  if (j >= STAGES) hopper::mbar_wait_cluster(&done[j % STAGES], ((j / STAGES) & 1) ^ 1);
}

// dQ's slices: Q, Q small, dO, dO small of the block's 64 rows (its slice);
// the ring, a stage being K, K small, V, V small (then the exchange slot),
// K^T, K^T small of 16 keys; the raw slots; the mbarriers (Q/dO's full and
// ready, the feed's, the exchange's full and done a stage).
struct SliceDqPlan {
  static constexpr int D = SliceTiles::SLICE, BK = SliceTiles::DQ_BK, STAGES = SliceTiles::DQ_STAGES,
                       RAW = SliceTiles::DQ_RAW;
  using TA = hopper::TileF<D, ROWS_OWNED>;
  using TK = hopper::TileF<D, BK>;
  using TT = hopper::TileF<BK, D>;
  using F = Feed<STAGES, RAW>;
  static constexpr int A_BYTES = 4 * TA::BYTES;
  static constexpr int STAGE_BYTES = 4 * TK::BYTES + 2 * TT::BYTES;
  static constexpr int RAW_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BAR_OFF = RAW_OFF + RAW * 2 * TK::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS + 2 * STAGES);  // + alignment slack
  static_assert(2 * ROWS_OWNED * BK * 4 == TK::BYTES, "a stage's V small holds the exchange");
  static_assert(STAGES >= 2 && (RAW == 0 || RAW >= 2), "TMA rings of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "dQ's slices' shared memory does not fit");
};

template <bool ROUND>
__global__ void __launch_bounds__(Roles<SliceTiles::LOADER_WGS>::THREADS, 1)
flash_f32_dq_slices_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                           const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dq,
                           int Tq, int Tk, int dh, float scale, int causal, int round_ds) {
  using P = SliceDqPlan;
  using TA = P::TA;
  using TK = P::TK;
  using TT = P::TT;
  using R = Roles<SliceTiles::LOADER_WGS>;
  constexpr int D = P::D, BK = P::BK, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sq = reinterpret_cast<float*>(base);
  float* sq_s = sq + TA::BYTES / 4;
  float* sdo = sq + 2 * TA::BYTES / 4;
  float* sdo_s = sdo + TA::BYTES / 4;
  auto ring = [&](int s, int part) {  // K, K small, V, V small, K^T, K^T small
    const int at = part < 4 ? part * TK::BYTES : 4 * TK::BYTES + (part - 4) * TT::BYTES;
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + at);
  };
  auto loaded = [&](int i, int part) {
    return P::RAW > 0 ? reinterpret_cast<float*>(base + P::RAW_OFF + ((i % P::RAW) * 2 + part / 2) * TK::BYTES)
                      : ring(i % STAGES, part);
  };
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const P::F feed(ready_a + 1);
  uint64_t* xfull = ready_a + 1 + P::F::BARRIERS;  // a stage's: every block's partials are in
  uint64_t* xdone = xfull + STAGES;                // every block has read this one's
  const uint32_t blocks = hopper::cluster_size();
  const int bh = blockIdx.x / blocks, col0 = hopper::cluster_rank() * D;
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS_OWNED, n_k = key_tiles<BK>(q0 + ROWS_OWNED - 1, Tk, causal);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, WG_THREADS / 32);
    for (int x = 0; x < 2 * STAGES; ++x) hopper::mbar_init(&xfull[x], 4 * blocks);
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // every block's barriers exist before another block arrives on them

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, 2 * TA::BYTES);
      hopper::tma_load_tile<TA>(sq, &tm_q, full_a, q0, bh, col0);
      hopper::tma_load_tile<TA>(sdo, &tm_do, full_a, q0, bh, col0);
      for (int i = 0; i < n_k; ++i) {
        uint64_t* bar = feed.load_slot(i, 2 * TK::BYTES);
        hopper::tma_load_tile<TK>(loaded(i, 0), &tm_k, bar, i * BK, bh, col0);
        hopper::tma_load_tile<TK>(loaded(i, 2), &tm_v, bar, i * BK, bh, col0);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      hopper::mbar_wait(full_a, 0);
      split_tile<TA::BYTES, NT>(sq, sq, sq_s, u);
      split_tile<TA::BYTES, NT>(sdo, sdo, sdo_s, u);
      split_done(ready_a);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        feed.split_begin(i);
        split_tile_t<TK, NT>(loaded(i, 0), ring(s, 0), ring(s, 1), ring(s, 4), ring(s, 5), u);
        slot_free<STAGES>(xdone, i);
        split_tile<TK::BYTES, NT>(loaded(i, 2), ring(s, 2), ring(s, 3), u);
        feed.split_end(i);
      }
    }
    hopper::cluster_sync();  // no block leaves while another may still read its exchange slots
  } else {  // consumers: both own the 64 rows, c takes key tiles c, c + 2, ...
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
    const float sl2 = scale * LOG2E;
    const float* lse_bh = lse + (size_t)bh * Tq;
    const float* delta_bh = delta + (size_t)bh * Tq;
    const float l2_a = row_a < Tq ? lse_bh[row_a] * LOG2E : 0.f;
    const float l2_b = row_b < Tq ? lse_bh[row_b] * LOG2E : 0.f;
    const float dl_a = row_a < Tq ? delta_bh[row_a] * scale : 0.f;
    const float dl_b = row_b < Tq ? delta_bh[row_b] * scale : 0.f;
    float acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const uint64_t q_b = TA::desc(sq), q_s = TA::desc(sq_s), do_b = TA::desc(sdo), do_s = TA::desc(sdo_s);
    auto ktile = [&](auto masked, int i) {
      const int s = i % STAGES, k0 = i * BK;
      hopper::mbar_wait(&feed.ready[s], (i / STAGES) & 1);
      float sd[2][BK / 2];  // this slice's S and dP, then the cluster's; S -> P, dP -> dS
      float(&sc)[BK / 2] = sd[0];
      float(&dp)[BK / 2] = sd[1];
      hopper::fence_regs(acc);
      slice_scores<BK, 2, D, SliceTiles::SCORE_STEPS, TA, TK>(
          sd, {q_b, do_b}, {q_s, do_s}, {TK::desc(ring(s, 0)), TK::desc(ring(s, 2))},
          {TK::desc(ring(s, 1)), TK::desc(ring(s, 3))});
      exchange<BK, 2>(sd, ring(s, 3), &xfull[s], &xdone[s], (i / STAGES) & 1, tid, blocks);
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = k0 + 8 * j + 2 * t + e;
          float pa = hopper::ex2(fmaf(sc[4 * j + e], sl2, -l2_a));
          float pb = hopper::ex2(fmaf(sc[4 * j + 2 + e], sl2, -l2_b));
          if constexpr (decltype(masked)::value) {
            if (col >= Tk || (causal && col > row_a)) pa = 0.f;
            if (col >= Tk || (causal && col > row_b)) pb = 0.f;
          }
          dp[4 * j + e] = pa * fmaf(dp[4 * j + e], scale, -dl_a);  // dS
          dp[4 * j + 2 + e] = pb * fmaf(dp[4 * j + 2 + e], scale, -dl_b);
        }
      }
      uint32_t ds_b[BK / 8][4], ds_s[BK / 8][4];
      split_a_frags<BK, ROUND>(ds_b, ds_s, dp, round_ds);
      hopper::fence_regs(acc);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      hopper::wgmma_fence();
      mma3_rs<D, BK / 8, TT>(acc, ds_b, ds_s, TT::desc(ring(s, 4)), TT::desc(ring(s, 5)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      warp_release(&feed.empty[s]);
    };
    const int n_plain = min(plain_tiles<BK>(q0, Tk, causal), n_k);
    int i = c;
    for (; i < n_plain; i += 2) ktile(std::false_type{}, i);
    for (; i < n_k; i += 2) ktile(std::true_type{}, i);
    meet(acc, sq, c, tid);  // Q's tile: no product reads it now
    if (c == 0) store_rows<D>(dq + (size_t)bh * Tq * dh, acc, q0, Tq, dh, tid, col0);
    hopper::cluster_sync();
  }
}

// dK/dV's slices: K, K small, V, V small of the block's 64 keys (its
// slice); the ring, a stage being Q, Q small, dO, dO small (then the
// exchange slot), Q^T, Q^T small, dO^T, dO^T small of 8 q rows; the raw
// slots, Q and dO as loaded; each stage's lse and delta; the mbarriers.
struct SliceDkvPlan {
  static constexpr int D = SliceTiles::SLICE, BQ = SliceTiles::DKV_BQ, STAGES = SliceTiles::DKV_STAGES,
                       RAW = SliceTiles::DKV_RAW;
  using TA = hopper::TileF<D, ROWS_OWNED>;
  using TQ = hopper::TileF<D, BQ>;
  using TT = hopper::TileF<BQ, D>;
  using F = Feed<STAGES, RAW>;
  static constexpr int A_BYTES = 4 * TA::BYTES;
  static constexpr int STAGE_BYTES = 4 * TQ::BYTES + 4 * TT::BYTES;
  static constexpr int RAW_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int ROWS_OFF = RAW_OFF + RAW * 2 * TQ::BYTES;
  static constexpr int BAR_OFF = ROWS_OFF + STAGES * 2 * BQ * 4;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS + 2 * STAGES);  // + alignment slack
  static_assert(2 * ROWS_OWNED * BQ * 4 == TQ::BYTES, "a stage's dO small holds the exchange");
  static_assert(STAGES >= 2 && (RAW == 0 || RAW >= 2), "TMA rings of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "dK/dV's slices' shared memory does not fit");
};

template <bool ROUND>
__global__ void __launch_bounds__(Roles<SliceTiles::LOADER_WGS>::THREADS, 1)
flash_f32_dkv_slices_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                            const float* __restrict__ lse, const float* __restrict__ delta, float* __restrict__ dk,
                            float* __restrict__ dv, int Tq, int Tk, int dh, float scale, int causal, int round_p,
                            int round_ds) {
  using P = SliceDkvPlan;
  using TA = P::TA;
  using TQ = P::TQ;
  using TT = P::TT;
  using R = Roles<SliceTiles::LOADER_WGS>;
  constexpr int D = P::D, BQ = P::BQ, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sk = reinterpret_cast<float*>(base);
  float* sk_s = sk + TA::BYTES / 4;
  float* sv = sk + 2 * TA::BYTES / 4;
  float* sv_s = sv + TA::BYTES / 4;
  auto ring = [&](int s, int part) {  // Q, Q small, dO, dO small, Q^T, Q^T small, dO^T, dO^T small
    const int at = part < 4 ? part * TQ::BYTES : 4 * TQ::BYTES + (part - 4) * TT::BYTES;
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + at);
  };
  auto loaded = [&](int j, int part) {
    return P::RAW > 0 ? reinterpret_cast<float*>(base + P::RAW_OFF + ((j % P::RAW) * 2 + part / 2) * TQ::BYTES)
                      : ring(j % STAGES, part);
  };
  float* slse = reinterpret_cast<float*>(base + P::ROWS_OFF);  // [STAGES][BQ], log2 units
  float* sdelta = slse + STAGES * BQ;                          // [STAGES][BQ], times scale
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const P::F feed(ready_a + 1);
  uint64_t* xfull = ready_a + 1 + P::F::BARRIERS;  // a stage's: every block's partials are in
  uint64_t* xdone = xfull + STAGES;                // every block has read this one's
  const uint32_t blocks = hopper::cluster_size();
  const int bh = blockIdx.x / blocks, col0 = hopper::cluster_rank() * D;
  const int k0 = blockIdx.y * ROWS_OWNED;  // causal: key tile 0 sees the most rows
  const int n_qs = (Tq + BQ - 1) / BQ, i_begin = causal ? k0 / BQ : 0;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, WG_THREADS / 32);
    for (int x = 0; x < 2 * STAGES; ++x) hopper::mbar_init(&xfull[x], 4 * blocks);
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, 2 * TA::BYTES);
      hopper::tma_load_tile<TA>(sk, &tm_k, full_a, k0, bh, col0);
      hopper::tma_load_tile<TA>(sv, &tm_v, full_a, k0, bh, col0);
      for (int i = i_begin; i < n_qs; ++i) {
        const int j = i - i_begin;
        uint64_t* bar = feed.load_slot(j, 2 * TQ::BYTES);
        hopper::tma_load_tile<TQ>(loaded(j, 0), &tm_q, bar, i * BQ, bh, col0);
        hopper::tma_load_tile<TQ>(loaded(j, 2), &tm_do, bar, i * BQ, bh, col0);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      const float* lse_bh = lse + (size_t)bh * Tq;
      const float* delta_bh = delta + (size_t)bh * Tq;
      hopper::mbar_wait(full_a, 0);
      split_tile<TA::BYTES, NT>(sk, sk, sk_s, u);
      split_tile<TA::BYTES, NT>(sv, sv, sv_s, u);
      split_done(ready_a);
      for (int i = i_begin; i < n_qs; ++i) {
        const int j = i - i_begin, s = j % STAGES;
        feed.split_begin(j);
        split_tile_t<TQ, NT>(loaded(j, 0), ring(s, 0), ring(s, 1), ring(s, 4), ring(s, 5), u);
        slot_free<STAGES>(xdone, j);
        split_tile_t<TQ, NT>(loaded(j, 2), ring(s, 2), ring(s, 3), ring(s, 6), ring(s, 7), u);
        for (int r = u; r < BQ; r += NT) {  // zero past Tq, where Q and dO are zero-filled
          const int row = i * BQ + r;
          slse[s * BQ + r] = row < Tq ? lse_bh[row] * LOG2E : 0.f;
          sdelta[s * BQ + r] = row < Tq ? delta_bh[row] * scale : 0.f;
        }
        feed.split_end(j);
      }
    }
    hopper::cluster_sync();
  } else {  // consumers: both own the 64 keys, c takes q tiles i_begin + c, + 2, ...
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
    const float sl2 = scale * LOG2E;
    float dk_acc[D / 2], dv_acc[D / 2];
#pragma unroll
    for (int r = 0; r < D / 2; ++r) dk_acc[r] = dv_acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const uint64_t k_b = TA::desc(sk), k_s = TA::desc(sk_s), v_b = TA::desc(sv), v_s = TA::desc(sv_s);
    auto qtile = [&](auto masked, int i) {
      const int j = i - i_begin, s = j % STAGES, q0 = i * BQ;
      const float* ls = slse + s * BQ;
      const float* ds = sdelta + s * BQ;
      hopper::mbar_wait(&feed.ready[s], (j / STAGES) & 1);
      float sd[2][BQ / 2];  // this slice's S^T and dP^T, then the cluster's; -> P^T, dS^T
      float(&st)[BQ / 2] = sd[0];
      float(&dpt)[BQ / 2] = sd[1];
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      slice_scores<BQ, 2, D, SliceTiles::SCORE_STEPS, TA, TQ>(
          sd, {k_b, v_b}, {k_s, v_s}, {TQ::desc(ring(s, 0)), TQ::desc(ring(s, 2))},
          {TQ::desc(ring(s, 1)), TQ::desc(ring(s, 3))});
      exchange<BQ, 2>(sd, ring(s, 3), &xfull[s], &xdone[s], (j / STAGES) & 1, tid, blocks);
#pragma unroll
      for (int jj = 0; jj < BQ / 8; ++jj) {
        const float2 L2 = *reinterpret_cast<const float2*>(ls + 8 * jj + 2 * t);
        const float2 dl2 = *reinterpret_cast<const float2*>(ds + 8 * jj + 2 * t);
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int qcol = q0 + 8 * jj + 2 * t + e;
          const float L = e ? L2.y : L2.x, dls = e ? dl2.y : dl2.x;
          float pa = hopper::ex2(fmaf(st[4 * jj + e], sl2, -L));
          float pb = hopper::ex2(fmaf(st[4 * jj + 2 + e], sl2, -L));
          if constexpr (decltype(masked)::value) {
            if (qcol >= Tq || (causal && key_a > qcol)) pa = 0.f;
            if (qcol >= Tq || (causal && key_b > qcol)) pb = 0.f;
          }
          st[4 * jj + e] = pa;  // P^T
          st[4 * jj + 2 + e] = pb;
          dpt[4 * jj + e] = pa * fmaf(dpt[4 * jj + e], scale, -dls);  // dS^T
          dpt[4 * jj + 2 + e] = pb * fmaf(dpt[4 * jj + 2 + e], scale, -dls);
        }
      }
      uint32_t p_b[BQ / 8][4], p_s[BQ / 8][4], ds_b[BQ / 8][4], ds_s[BQ / 8][4];
      split_a_frags<BQ, ROUND>(p_b, p_s, st, round_p);
      split_a_frags<BQ, ROUND>(ds_b, ds_s, dpt, round_ds);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      hopper::wgmma_fence();
      mma3_rs<D, BQ / 8, TT>(dv_acc, p_b, p_s, TT::desc(ring(s, 6)), TT::desc(ring(s, 7)));
      mma3_rs<D, BQ / 8, TT>(dk_acc, ds_b, ds_s, TT::desc(ring(s, 4)), TT::desc(ring(s, 5)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::fence_regs(ds_b);
      hopper::fence_regs(ds_s);
      warp_release(&feed.empty[s]);
    };
    const int diag_end = causal ? min(n_qs, (k0 + ROWS_OWNED - 1) / BQ + 1) : i_begin;
    const int plain_end = max(diag_end, Tq / BQ);
    int i = i_begin + c;
    for (; i < diag_end; i += 2) qtile(std::true_type{}, i);
    for (; i < plain_end; i += 2) qtile(std::false_type{}, i);
    for (; i < n_qs; i += 2) qtile(std::true_type{}, i);
    meet(dk_acc, sk, c, tid);  // K's tiles park the partial sums: no product reads them now
    meet(dv_acc, sk_s, c, tid);
    if (c == 0) {
      store_rows<D>(dk + (size_t)bh * Tk * dh, dk_acc, k0, Tk, dh, tid, col0);
      store_rows<D>(dv + (size_t)bh * Tk * dh, dv_acc, k0, Tk, dh, tid, col0);
    }
    hopper::cluster_sync();
  }
}

// ---------------------------------------------------------------------------
// The forward above head dim 256: a cluster of column slices. Replaces
// _fwd_kernel (ray_tpu/ops/flash_attention.py:72) on f32 inputs (and
// mixes) at head dims 257-1024, as the slices above replace dQ and dK/dV:
// a cluster of W = ceil(Dh / SLICE) blocks serves one (head, 64 q rows),
// block w owns the columns [w SLICE, (w + 1) SLICE) of Q, K, V and O, and
// is the head dim 128 forward on that slice with 64-row blocks (both
// consumer warpgroups own the rows and take alternate stages, their (m, l,
// O) merged in a fixed order at the end): its Q slice is loaded by TMA once
// and split; each stage holds BK keys of its K and V slices, loaded by TMA
// at the slice's column offset (columns past Dh arrive as zeros), K split
// in place and V's transposed split written beside V as loaded. Per stage
// a consumer contracts S over its own slice only (3xTF32, SCORE_STEPS
// k-steps a partial), and the cluster's partials meet through distributed
// shared memory (hopper::cluster_sum: summed in rank order, so every block
// holds bitwise the same S); the exchange slot is the stage's V as loaded,
// which the split pass has read by then, and the TMA thread loads that
// tile again only once every block has read it. Each stage's exchange runs
// beside the other consumer's products on the other stage. Then every
// block runs the same online softmax in exp2 units (masked at the diagonal
// and past Tk), rounds P to v's dtype (ROUND) and adds P V on its own
// slice: each column of Q, K and V is loaded once a stage across the
// cluster, and the products are the function's own 4 FLOPs per kept pair
// and head-dim element, with no recompute of S (the column windows
// computed S once per window). Each block writes its own columns of O;
// block 0 writes lse; no atomics, so two calls give the same bits. Bound:
// as the instances', the FLOPs at 165 TFLOP/s. Above SLICE x MAX_SLICES the
// forward takes the column windows.
// ---------------------------------------------------------------------------

// The forward slices' traits: the columns a block owns and the cluster's
// portable limit, keys a stage, ring depth, loading warpgroups, the blocks
// whose partials a consumer reads at once, and the k-steps of a partial of
// S before it is added in f32. Chosen by timing variants on an H100
// (python3 -m ray_tpu_torch.sweep_flash_f32 --variants fwd32, PERF.md; T
// 1024, causal, B 8, H 2, f32 Dh 384 / 512 and the mix at 320): 32 keys a
// stage took 0.389 / 0.541 / 0.441 ms against 0.554 / 0.749 / 0.607 with
// 16 (0.450 / 0.615 / 0.504 with 16 keys and three stages); 128-row blocks,
// both consumers on every stage of 16 keys, 0.461-0.468 / 0.619-0.627 /
// 0.516-0.525; reduce-scatter (64-row blocks of 16 keys) 0.638-0.643 /
// 0.827-0.830 / 0.685; SCORE_STEPS 1 and 4, READ_BLOCKS 2 and 8 within 5%
// or slower. tests/test_torch_flash_fwd_slices.py reads this block.
struct FwdSliceTiles {
  static constexpr int SLICE = 128, MAX_SLICES = 8;
  static constexpr int BK = 32, STAGES = 2, LOADER_WGS = 2, READ_BLOCKS = 4, SCORE_STEPS = 2;
};

// The forward's slices: Q and Q small of the block's 64 rows; the ring, a
// stage being K, K small, V^T, V^T small of BK keys and V as loaded (then
// the exchange slot: a [64 x BK] partial); the mbarriers (Q's full and
// ready, the feed's, the exchange's full and done per stage).
struct SliceFwdPlan {
  using T = FwdSliceTiles;
  static constexpr int D = T::SLICE, BK = T::BK, STAGES = T::STAGES;
  using TA = hopper::TileF<D, ROWS_OWNED>;
  using TK = hopper::TileF<D, BK>;
  using TT = hopper::TileF<BK, D>;
  using F = Feed<STAGES, 0>;
  static constexpr int A_BYTES = 2 * TA::BYTES;
  static constexpr int STAGE_BYTES = 5 * TK::BYTES;
  static constexpr int BAR_OFF = A_BYTES + STAGES * STAGE_BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + F::BARRIERS + 2 * STAGES);  // + alignment slack
  static_assert(ROWS_OWNED * BK * 4 <= TK::BYTES, "a stage's V as loaded holds the exchange");
  static_assert(TK::BYTES == TT::BYTES, "a stage's tiles are of one size");
  static_assert(STAGES >= 2, "a TMA ring of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "the forward's slices' shared memory does not fit");
};

template <bool ROUND>
__global__ void __launch_bounds__(Roles<FwdSliceTiles::LOADER_WGS>::THREADS, 1)
flash_f32_fwd_slices_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v, float* __restrict__ o,
                            float* __restrict__ lse, int Tq, int Tk, int dh, float scale, int causal, int round_p) {
  using P = SliceFwdPlan;
  using TA = P::TA;
  using TK = P::TK;
  using TT = P::TT;
  using R = Roles<FwdSliceTiles::LOADER_WGS>;
  constexpr int D = P::D, BK = P::BK, STAGES = P::STAGES, NT = R::SPLIT_THREADS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  float* sq = reinterpret_cast<float*>(base);
  float* sq_s = sq + TA::BYTES / 4;
  // Stage s: K, K small, V^T, V^T small, V as loaded (the exchange slot).
  auto ring = [&](int s, int part) {
    return reinterpret_cast<float*>(base + P::A_BYTES + s * P::STAGE_BYTES + part * TK::BYTES);
  };
  uint64_t* full_a = reinterpret_cast<uint64_t*>(base + P::BAR_OFF);
  uint64_t* ready_a = full_a + 1;
  const P::F feed(ready_a + 1);
  uint64_t* xfull = ready_a + 1 + P::F::BARRIERS;  // a stage's: every block's partials are in
  uint64_t* xdone = xfull + STAGES;                // every block has read this one's
  const uint32_t blocks = hopper::cluster_size(), rank = hopper::cluster_rank();
  const int bh = blockIdx.x / blocks, col0 = rank * D;
  // Causal: the longest rows first (blocks start in order of blockIdx.y).
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS_OWNED, n_k = key_tiles<BK>(q0 + ROWS_OWNED - 1, Tk, causal);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_a, 1);
    hopper::mbar_init(ready_a, NT);
    feed.init(NT, WG_THREADS / 32);  // a stage is released by the warps of the one warpgroup that took it
    for (int x = 0; x < 2 * STAGES; ++x) hopper::mbar_init(&xfull[x], 4 * blocks);
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // every block's barriers exist before another block arrives on them

  const int wg = threadIdx.x / WG_THREADS;
  if (wg < R::LOADER_WGS) {
    hopper::setmaxnreg_dec<R::LOADER_REGS>();
    if (threadIdx.x == 0) {  // TMA
      hopper::mbar_arrive_expect_tx(full_a, TA::BYTES);
      hopper::tma_load_tile<TA>(sq, &tm_q, full_a, q0, bh, col0);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        // V as loaded is the stage's exchange slot: every block has read
        // the partials of tile i - STAGES in it
        if (i >= STAGES) hopper::mbar_wait_cluster(&xdone[s], ((i / STAGES) & 1) ^ 1);
        uint64_t* bar = feed.load_slot(i, 2 * TK::BYTES);
        hopper::tma_load_tile<TK>(ring(s, 0), &tm_k, bar, i * BK, bh, col0);
        hopper::tma_load_tile<TK>(ring(s, 4), &tm_v, bar, i * BK, bh, col0);
      }
    } else if (threadIdx.x >= 32) {  // the split pass
      const int u = threadIdx.x - 32;
      hopper::mbar_wait(full_a, 0);
      split_tile<TA::BYTES, NT>(sq, sq, sq_s, u);
      split_done(ready_a);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        feed.split_begin(i);
        split_tile<TK::BYTES, NT>(ring(s, 0), ring(s, 0), ring(s, 1), u);
        split_tile_t<TK, NT, false>(ring(s, 4), nullptr, nullptr, ring(s, 2), ring(s, 3), u);
        feed.split_end(i);
      }
    }
    hopper::cluster_sync();  // no block leaves while another may still read its exchange slots
  } else {  // consumers: both own the 64 rows, c takes key tiles c, c + 2, ...
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - R::LOADER_WGS, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int row_a = q0 + 16 * warp + g;
    const float sl2 = scale * LOG2E;
    float acc[D / 2], m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
#pragma unroll
    for (int r = 0; r < D / 2; ++r) acc[r] = 0.f;

    hopper::mbar_wait(ready_a, 0);
    const uint64_t q_b = TA::desc(sq), q_s = TA::desc(sq_s);
    auto ktile = [&](auto masked, int i) {
      const int s = i % STAGES, k0 = i * BK;
      hopper::mbar_wait(&feed.ready[s], (i / STAGES) & 1);
      float sp[1][BK / 2];  // this slice's S, then the cluster's; -> P
      float(&sc)[BK / 2] = sp[0];
      hopper::fence_regs(acc);
      slice_scores<BK, 1, D, FwdSliceTiles::SCORE_STEPS, TA, TK>(sp, {q_b}, {q_s}, {TK::desc(ring(s, 0))},
                                                                 {TK::desc(ring(s, 1))});
      hopper::cluster_sum<BK, 1, FwdSliceTiles::READ_BLOCKS, FwdSliceTiles::MAX_SLICES>(
          sp, ring(s, 4), &xfull[s], &xdone[s], (i / STAGES) & 1, tid, blocks, rank);
      softmax_tile<decltype(masked)::value, BK, D>(sc, acc, m_a, m_b, l_a, l_b, k0, Tk, row_a, t, sl2, causal);
      uint32_t p_b[BK / 8][4], p_s[BK / 8][4];
      split_a_frags<BK, ROUND>(p_b, p_s, sc, round_p);
      hopper::fence_regs(acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      hopper::wgmma_fence();
      mma3_rs<D, BK / 8, TT>(acc, p_b, p_s, TT::desc(ring(s, 2)), TT::desc(ring(s, 3)));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(p_b);
      hopper::fence_regs(p_s);
      warp_release(&feed.empty[s]);
    };
    const int n_plain = min(plain_tiles<BK>(q0, Tk, causal), n_k);
    int i = c;
    for (; i < n_plain; i += 2) ktile(std::false_type{}, i);
    for (; i < n_k; i += 2) ktile(std::true_type{}, i);
    // The two partial results of the rows meet in Q's tiles (no product
    // reads them now).
    merge_rows<D>(acc, m_a, m_b, l_a, l_b, sq, c, tid);
    if (c == 0)  // o = O / l on this slice; lse from block 0
      finish_rows<D>(acc, m_a, m_b, l_a, l_b, o + (size_t)bh * Tq * dh, lse + (size_t)bh * Tq, q0, Tq, dh, tid, col0,
                     rank == 0);
    hopper::cluster_sync();
  }
}

// One launch of a slices kernel: a grid of (bh x blocks, row blocks of
// `rows_a_block`), in clusters of `blocks` along x.
template <int LOADER_WGS, class... Params, class... Args>
int launch_clusters(void (*kernel)(Params...), int bh, int rows, int rows_a_block, int blocks, int smem,
                    cudaStream_t st, Args&&... args) {
  return hopper::launch_cluster(kernel, dim3(bh * blocks, (rows + rows_a_block - 1) / rows_a_block),
                                Roles<LOADER_WGS>::THREADS, blocks, smem, st, std::forward<Args>(args)...);
}

template <bool ROUND>
int launch_fwd_slices(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq, int tk,
                      int dh, float scale, int causal, int round_p, cudaStream_t st) {
  using P = SliceFwdPlan;
  CUtensorMap mq, mk, mv;
  constexpr CUtensorMapDataType f32 = hopper::tma_type<float>();
  if (!hopper::rows_map(&mq, q, bh, tq, dh, P::D, ROWS_OWNED, f32, true) ||
      !hopper::rows_map(&mk, k, bh, tk, dh, P::D, P::BK, f32, true) ||
      !hopper::rows_map(&mv, v, bh, tk, dh, P::D, P::BK, f32, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = hopper::slice_blocks<FwdSliceTiles>(dh);
  return launch_clusters<FwdSliceTiles::LOADER_WGS>(flash_f32_fwd_slices_kernel<ROUND>, bh, tq, ROWS_OWNED, blocks,
                                                    P::BYTES, st, mq, mk, mv, static_cast<float*>(o),
                                                    static_cast<float*>(lse), tq, tk, dh, scale, causal, round_p);
}

template <bool ROUND>
int launch_dq_slices(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int bh, int tq, int tk, int dh, float scale, int causal,
                     int round_ds, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  constexpr int bk = SliceDqPlan::BK;
  constexpr int S = SliceTiles::SLICE;
  constexpr CUtensorMapDataType f32 = hopper::tma_type<float>();
  if (!hopper::rows_map(&mq, q, bh, tq, dh, S, ROWS_OWNED, f32, true) ||
      !hopper::rows_map(&mk, k, bh, tk, dh, S, bk, f32, true) || !hopper::rows_map(&mv, v, bh, tk, dh, S, bk, f32, true) ||
      !hopper::rows_map(&mdo, dout, bh, tq, dh, S, ROWS_OWNED, f32, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = hopper::slice_blocks<SliceTiles>(dh);
  return launch_clusters<SliceTiles::LOADER_WGS>(flash_f32_dq_slices_kernel<ROUND>, bh, tq, ROWS_OWNED, blocks,
                                                 SliceDqPlan::BYTES, st, mq, mk, mv, mdo,
                                                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                                                 static_cast<float*>(dq), tq, tk, dh, scale, causal, round_ds);
}

template <bool ROUND>
int launch_dkv_slices(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int bh, int tq, int tk, int dh, float scale, int causal,
                      int round_p, int round_ds, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  constexpr int bq = SliceDkvPlan::BQ;
  constexpr int S = SliceTiles::SLICE;
  constexpr CUtensorMapDataType f32 = hopper::tma_type<float>();
  if (!hopper::rows_map(&mq, q, bh, tq, dh, S, bq, f32, true) ||
      !hopper::rows_map(&mk, k, bh, tk, dh, S, ROWS_OWNED, f32, true) ||
      !hopper::rows_map(&mv, v, bh, tk, dh, S, ROWS_OWNED, f32, true) ||
      !hopper::rows_map(&mdo, dout, bh, tq, dh, S, bq, f32, true))
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = hopper::slice_blocks<SliceTiles>(dh);
  return launch_clusters<SliceTiles::LOADER_WGS>(flash_f32_dkv_slices_kernel<ROUND>, bh, tk, ROWS_OWNED, blocks,
                                                 SliceDkvPlan::BYTES, st, mq, mk, mv, mdo,
                                                 static_cast<const float*>(lse), static_cast<const float*>(delta),
                                                 static_cast<float*>(dk), static_cast<float*>(dv), tq, tk, dh, scale,
                                                 causal, round_p, round_ds);
}

// Calls launch(instance head dim) with the head dim, as an
// std::integral_constant, of the instance that serves head dim d (the
// narrowest of 16, 32, 64, 128 and 256 that holds it; above 256, SLICES
// where the kernel's clusters take d (`slices`, its blocks there: the
// forward up to FwdSliceTiles' limit, dQ and dK/dV up to SliceTiles'): a
// cluster of column slices; else WIDE: the column-window kernels of
// flash_wide.cuh; d a multiple of 4); cudaErrorInvalidValue for a d none
// takes, or for a rounding type that is not a hopper::Round, or not
// ROUND_NONE where this library does not round.
constexpr int WIDE = 0, SLICES = -1;
template <class F>
static int by_head_dim(int d, int slices, int round_p, int round_ds, F launch) {
  for (int r : {round_p, round_ds})
    if (r < hopper::ROUND_NONE || r > hopper::ROUND_F16 || (!RT_ROUNDED && r != hopper::ROUND_NONE))
      return static_cast<int>(cudaErrorInvalidValue);
  if (d < 1 || d % 4 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 16) return launch(std::integral_constant<int, 16>{});
  if (d <= 32) return launch(std::integral_constant<int, 32>{});
  if (d <= 64) return launch(std::integral_constant<int, 64>{});
  if (d <= 128) return launch(std::integral_constant<int, 128>{});
  if (d <= 256) return launch(std::integral_constant<int, 256>{});
  if (slices > 0) return launch(std::integral_constant<int, SLICES>{});
  return launch(std::integral_constant<int, WIDE>{});
}

constexpr CUtensorMapDataType F32 = hopper::tma_type<float>();
constexpr bool ROUNDED = RT_ROUNDED;

template <int D>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq, int tk, int dh,
               float scale, int causal, int round_p, cudaStream_t st) {
  using P = FwdPlan<D>;
  CUtensorMap mq, mk, mv;
  if (!hopper::rows_map(&mq, q, bh, tq, dh, D, ROWS_OWNED, F32) || !hopper::rows_map(&mk, k, bh, tk, dh, D, P::BK, F32) ||
      !hopper::rows_map(&mv, v, bh, tk, dh, D, P::BK, F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(flash_f32_fwd_kernel<D, ROUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  const dim3 grid(bh, (tq + P::ROWS - 1) / P::ROWS);
  flash_f32_fwd_kernel<D, ROUNDED><<<grid, Roles<F32Tiles<D>::FWD_LOADER_WGS>::THREADS, P::BYTES, st>>>(
      mq, mk, mv, static_cast<float*>(o), static_cast<float*>(lse), tq, tk, dh, scale, causal, round_p);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
              const void* delta, void* dq, int bh, int tq, int tk, int dh, float scale, int causal,
              int round_ds, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  constexpr int bk = DqPlan<D>::BK, smem = DqPlan<D>::BYTES;
  if (!hopper::rows_map(&mq, q, bh, tq, dh, D, ROWS_OWNED, F32) || !hopper::rows_map(&mk, k, bh, tk, dh, D, bk, F32) ||
      !hopper::rows_map(&mv, v, bh, tk, dh, D, bk, F32) || !hopper::rows_map(&mdo, dout, bh, tq, dh, D, ROWS_OWNED, F32))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncSetAttribute(flash_f32_dq_kernel<D, ROUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(bh, (tq + ROWS_OWNED - 1) / ROWS_OWNED);
  flash_f32_dq_kernel<D, ROUNDED><<<grid, Roles<F32Tiles<D>::LOADER_WGS>::THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dq),
      tq, tk, dh, scale, causal, round_ds);
  return static_cast<int>(cudaGetLastError());
}

// One launch of dK/dV's pass PASS (0: both gradients; 1: dV; 2: dK).
template <int D, int PASS>
int launch_dkv_pass(const CUtensorMap& mq, const CUtensorMap& mk, const CUtensorMap& mv, const CUtensorMap& mdo,
                    const void* lse, const void* delta, void* dk, void* dv, int bh, int tq, int tk, int dh,
                    float scale, int causal, int round_p, int round_ds, cudaStream_t st) {
  constexpr int smem = DkvPlan<D>::BYTES;
  cudaFuncSetAttribute(flash_f32_dkv_kernel<D, PASS, ROUNDED>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid(bh, (tk + ROWS_OWNED - 1) / ROWS_OWNED);
  flash_f32_dkv_kernel<D, PASS, ROUNDED><<<grid, Roles<F32Tiles<D>::LOADER_WGS>::THREADS, smem, st>>>(
      mq, mk, mv, mdo, static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<float*>(dk),
      static_cast<float*>(dv), tq, tk, dh, scale, causal, round_p, round_ds);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int tq, int tk, int dh, float scale, int causal,
               int round_p, int round_ds, cudaStream_t st) {
  CUtensorMap mq, mk, mv, mdo;
  constexpr int bq = DkvPlan<D>::BQ;
  if (!hopper::rows_map(&mq, q, bh, tq, dh, D, bq, F32) || !hopper::rows_map(&mk, k, bh, tk, dh, D, ROWS_OWNED, F32) ||
      !hopper::rows_map(&mv, v, bh, tk, dh, D, ROWS_OWNED, F32) || !hopper::rows_map(&mdo, dout, bh, tq, dh, D, bq, F32))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (DkvPlan<D>::PASSES == 1) {
    return launch_dkv_pass<D, 0>(mq, mk, mv, mdo, lse, delta, dk, dv, bh, tq, tk, dh, scale, causal, round_p,
                                 round_ds, st);
  } else {
    const int err = launch_dkv_pass<D, 1>(mq, mk, mv, mdo, lse, delta, dk, dv, bh, tq, tk, dh, scale, causal,
                                          round_p, round_ds, st);
    if (err != 0) return err;
    return launch_dkv_pass<D, 2>(mq, mk, mv, mdo, lse, delta, dk, dv, bh, tq, tk, dh, scale, causal, round_p,
                                 round_ds, st);
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes): flash_attention.cu's signatures, on
// contiguous f32 [bh, T, d] operands and f32 [bh, Tq] lse/delta, with the
// rounding types of P and dS (Round) after out_f32; d, a multiple of 4, runs
// on the instance that holds it, or above 256 on the clusters of slices (the
// three functions up to 1024) or the column-window kernels.
// ---------------------------------------------------------------------------
extern "C" const char* rt_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// The forward slices' dynamic shared memory a block (SliceFwdPlan::BYTES).
extern "C" int rt_fwd_slices_smem_bytes() { return SliceFwdPlan::BYTES; }

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                            int tq, int tk, int d, float scale, int causal, int, int round_p, int round_ds,
                            void* stream) {
  return by_head_dim(d, hopper::slice_blocks<FwdSliceTiles>(d), round_p, round_ds, [&](auto dd) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value == SLICES)
      return launch_fwd_slices<ROUNDED>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, round_p, st);
    else if constexpr (decltype(dd)::value == WIDE)
      return wide::launch_fwd<float, float, ROUNDED>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, round_p, st);
    else
      return launch_fwd<decltype(dd)::value>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, round_p, st);
  });
}

extern "C" int rt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                           int d, float scale, int causal, int, int round_p, int round_ds, void* stream) {
  return by_head_dim(d, hopper::slice_blocks<SliceTiles>(d), round_p, round_ds, [&](auto dd) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value == SLICES)
      return launch_dq_slices<ROUNDED>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, round_ds, st);
    else if constexpr (decltype(dd)::value == WIDE)
      return wide::launch_dq<float, float, ROUNDED>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal,
                                                    round_ds, st);
    else
      return launch_dq<decltype(dd)::value>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal, round_ds,
                                            st);
  });
}

extern "C" int rt_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                            int tk, int d, float scale, int causal, int, int round_p, int round_ds,
                            void* stream) {
  return by_head_dim(d, hopper::slice_blocks<SliceTiles>(d), round_p, round_ds, [&](auto dd) {
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value == SLICES)
      return launch_dkv_slices<ROUNDED>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, causal, round_p,
                                        round_ds, st);
    else if constexpr (decltype(dd)::value == WIDE)
      return wide::launch_dkv<float, float, ROUNDED>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale,
                                                     causal, round_p, round_ds, st);
    else
      return launch_dkv<decltype(dd)::value>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale, causal,
                                             round_p, round_ds, st);
  });
}
