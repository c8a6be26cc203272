// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Operands are folded to [BH, T, Dh] row-major 16-bit elements, bf16 or f16
// (E, a template parameter of every kernel: the library built from this file
// instantiates bf16, flash_attention_f16.cu includes it for f16), lse and
// delta are [BH, Tq] f32. Scores and all accumulators are f32; P and dS are
// rounded to E (to nearest even, f16 keeping its subnormals) where they
// become a product's operand, as the Pallas kernels cast them to the
// operands' dtype. Each kernel is
// instantiated for head dims D = 16, 32, 64, 128 and 256, and a head dim Dh
// between two of them (a multiple of 8: TMA's rows are 16-byte strided) runs
// on the next one up: its tensor maps have the true width and the
// instance's boxes, so TMA fills the columns past Dh with zeros in shared
// memory (the bytes read from HBM stay Dh's), the zero columns leave S, P,
// dP and every gradient's real columns as they are, and the outputs' maps
// (or f32 row stores) write only Dh columns. Each kernel is also
// instantiated for two output types (OutRows): E, the train path's, and
// f32, for ring attention's block entries; only the store of the output
// rows differs.
//
// All three kernels are persistent and warp-specialised (hopper.cuh): one
// block per SM walks a static list of work tiles; a producer warp streams
// tiles by TMA into a ring of shared-memory stages, and two consumer
// warpgroups run wgmma on them, the score tile never leaving registers (the
// f32 accumulator of one product, packed to E, is the register A operand
// of the next). A tile in shared memory is read K-major or, through the
// transpose bit, MN-major, so no transposed copy is made. The backward
// kernels use no atomics: each block owns the rows of the gradient it
// writes, so the result does not depend on run order.
//
// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "flash_wide.cuh"
#include "hopper.cuh"

// The operand type of this library's entry points: bf16, or what the file
// that includes this one sets (flash_attention_f16.cu: __half).
#ifndef RT_OPERAND
#define RT_OPERAND __nv_bfloat16
#endif

namespace {

// ---------------------------------------------------------------------------
// Shared by the three kernels: warp-specialised persistent blocks. Warpgroup 0 is the producer (TMA loads; it gives its registers up
// with setmaxnreg), warpgroups 1..N consume with wgmma. One block per SM
// walks over a static list of work tiles, so the next tile's loads overlap
// the last one's epilogue.
// ---------------------------------------------------------------------------
constexpr int WG_THREADS = 128;
template <int N>  // consumer warpgroups
struct Roles {
  static constexpr int THREADS = (N + 1) * WG_THREADS;
  static constexpr int CONSUMER_WARPS = N * WG_THREADS / 32;
  static constexpr int PRODUCER_REGS = 24;
  // The rest of the SM's 65,536 registers, split among the consumers (a
  // multiple of 8, at most 240): 240 for two consumer warpgroups, 160 for
  // three. The block starts with 65,536 / THREADS each (168 or 128).
  static constexpr int CONSUMER_REGS_FIT =
      (65536 - WG_THREADS * PRODUCER_REGS) / (N * WG_THREADS) / 8 * 8;
  static constexpr int CONSUMER_REGS = CONSUMER_REGS_FIT < 240 ? CONSUMER_REGS_FIT : 240;
};
// Each block keeps one SM to itself: the register split above assumes all
// of the SM's registers, and the dynamic shared memory is raised to this
// floor so a second block never shares the SM.
constexpr int ONE_BLOCK_PER_SM_SMEM = 120 * 1024;
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// Tile sizes and ring depths, chosen by sweeps on the card (PERF.md section
// 6). The ring depths are re-timed by python3 -m
// ray_tpu_torch.sweep_flash_tiles, which rebuilds the library with -D
// overrides of the RT_ macros (the _128 ones for head dim 128); nothing
// else sets them. tests/test_torch_flash_tiles.py reads this block.
#ifndef RT_FWD_STAGES
#define RT_FWD_STAGES 3
#endif
#ifndef RT_DKV_STAGES
#define RT_DKV_STAGES 4
#endif
#ifndef RT_DQ_STAGES
#define RT_DQ_STAGES 4
#endif
#ifndef RT_FWD_STAGES_128
#define RT_FWD_STAGES_128 2
#endif
#ifndef RT_DKV_STAGES_128
#define RT_DKV_STAGES_128 4
#endif
#ifndef RT_DQ_STAGES_128
#define RT_DQ_STAGES_128 4
#endif
constexpr int FWD_WGS = 2;            // consumer warpgroups of the forward, 64 q rows each
constexpr int FWD_BQ = 64 * FWD_WGS;  // q rows per work tile
constexpr int DKV_BK = 128;           // keys per work tile (two consumer warpgroups x 64)
constexpr int DQ_WGS = 2;             // consumer warpgroups of dQ, 64 q rows each
constexpr int DQ_BQ = 64 * DQ_WGS;    // q rows per work tile
constexpr int SMEM_LIMIT = 232448;    // dynamic shared memory a block may have on an H100
// Per head dim: keys per K/V stage (FWD_BK, DQ_BK), q rows per Q/dO stage
// (DKV_BQ), the three ring depths, the forward's Q buffers (FWD_Q_BUFS:
// two let the producer load the next work tile's Q early), whether a dK/dV
// consumer holds its K and V rows as register A operands (DKV_KV_IN_REGS)
// or reads them from shared memory, whether a dQ consumer holds its Q and
// dO rows so (DQ_QDO_IN_REGS), and the passes of dK/dV (DKV_PASSES: 1, both
// gradients at once; 2, dV and then dK, each pass recomputing S^T and P^T).
template <int D>
struct Tiles {  // head dims 16, 32 and 64
  static constexpr int FWD_BK = 128, FWD_STAGES = RT_FWD_STAGES, FWD_Q_BUFS = 2;
  static constexpr int DKV_BQ = 64, DKV_STAGES = RT_DKV_STAGES, DKV_KV_IN_REGS = 1, DKV_PASSES = 1;
  static constexpr int DQ_BK = 64, DQ_STAGES = RT_DQ_STAGES, DQ_QDO_IN_REGS = 1;
};
// Head dim 128: rows of 256 bytes double every tile, so the forward's
// ring is two stages deep (three would need 288 KiB), and the backward
// kernels halve the tile their scores cover, which keeps them within 240
// registers a consumer thread: dK/dV takes 32 q rows a stage and reads K
// and V from shared memory (its two [64 x 128] f32 accumulators are 128
// registers), dQ 32 keys a stage.
template <>
struct Tiles<128> {
  static constexpr int FWD_BK = 128, FWD_STAGES = RT_FWD_STAGES_128, FWD_Q_BUFS = 2;
  static constexpr int DKV_BQ = 32, DKV_STAGES = RT_DKV_STAGES_128, DKV_KV_IN_REGS = 0, DKV_PASSES = 1;
  static constexpr int DQ_BK = 32, DQ_STAGES = RT_DQ_STAGES_128, DQ_QDO_IN_REGS = 1;
};
// Head dim 256: rows of 512 bytes double every tile again. The forward's
// 128-row Q tile is 64 KiB, so it has one Q buffer and 64-key K/V stages
// (64 KiB a stage, two of them). dQ keeps Q and dO (128 KiB) in shared
// memory as both products' A operands, since their register copies (128
// registers) would not fit beside its [64 x 256] f32 accumulator (128), and
// streams 32-key stages. dK/dV's two [64 x 256] accumulators would take 256
// registers a thread, over the 240 a consumer has: it runs as two passes
// (dV, then dK), each recomputing S^T and P^T and holding one accumulator,
// with 32 q rows a stage and K and V read from shared memory. The outputs
// go out through 128-column staging tiles in two parts. Every ring is two
// stages deep: a third stage would pass SMEM_LIMIT, so no macro sets them.
template <>
struct Tiles<256> {
  static constexpr int FWD_BK = 64, FWD_STAGES = 2, FWD_Q_BUFS = 1;
  static constexpr int DKV_BQ = 32, DKV_STAGES = 2, DKV_KV_IN_REGS = 0, DKV_PASSES = 2;
  static constexpr int DQ_BK = 32, DQ_STAGES = 2, DQ_QDO_IN_REGS = 0;
};

// The 1024-byte aligned start of dynamic shared memory (the 128B swizzle
// repeats every 1024 bytes, and TMA and wgmma agree on it from there).
__device__ __forceinline__ uint8_t* smem_base(uint8_t* raw) {
  return raw + ((1024 - (hopper::smem_u32(raw) & 1023)) & 1023);
}

// The work tiles of one persistent block, in order: units u = blockIdx.x,
// blockIdx.x + gridDim.x, ... of n_units = per_head * bh. Without causal
// masking every tile of a head costs the same and a unit is one tile. With
// it, tile j of n costs in proportion to j + 1 (forward and dQ: q tile j sees j
// + 1 key tiles) or to n - j (dK/dV: key tile j is seen by the q tiles from j
// on), so a unit pairs tiles p and n - 1 - p, whose costs add up to the
// same for every unit, and runs the longer one first. Units of one head are
// adjacent, so the blocks that share a head's K/V (or Q/dO) run together
// and find it in L2.
struct WorkList {
  int n, per_head, n_units, causal, longest_high, u, second;

  __device__ WorkList(int n_tiles, int bh, int causal_, int longest_is_high)
      : n(n_tiles), causal(causal_), longest_high(longest_is_high), u(blockIdx.x), second(0) {
    per_head = causal ? (n + 1) / 2 : n;
    n_units = per_head * bh;
  }

  // The next (bh, tile) of this block, or false when it has none left.
  __device__ bool next(int& bh, int& tile) {
    if (u >= n_units) return false;
    bh = u / per_head;
    const int p = u % per_head;
    if (!causal) {
      tile = p;
      u += gridDim.x;
      return true;
    }
    const int hi = n - 1 - p, longer = longest_high ? hi : p, shorter = longest_high ? p : hi;
    if (second) {
      tile = shorter;
      second = 0;
      u += gridDim.x;
    } else {
      tile = longer;
      if (hi != p) second = 1;
      else u += gridDim.x;
    }
    return true;
  }
};

inline int units_of(int n_tiles, int bh, int causal) {
  return (causal ? (n_tiles + 1) / 2 : n_tiles) * bh;
}

// The N consumer warpgroups take turns at the tensor cores, in order: each
// issues its products between begin() and end(), and end() hands the turn
// to the next, so one warpgroup's softmax runs while another's products
// do. Warpgroup 0 starts; every begin() is matched by the previous one's
// end(), and finish() takes the one turn left over, so no barrier is left
// half arrived (each warpgroup takes the same number of turns). Named
// barriers 1..N, 256 threads each.
template <int N>
struct TakeTurns {
  int c;  // this consumer warpgroup, 0 .. N-1
  __device__ __forceinline__ void start() const {
    if (c == N - 1) hopper::bar_arrive(1, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void begin() const {
    hopper::bar_sync(1 + c, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void end() const {
    hopper::bar_arrive(1 + (c + 1) % N, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void finish() const {
    if (c == 0) hopper::bar_sync(1, 2 * WG_THREADS);
  }
  __device__ __forceinline__ void skip() const {  // a turn without products
    begin();
    end();
  }
};

// One arrival per consumer warp on an "empty" barrier (when `pred`), from
// lane 0 once the whole warp is here. Branch-free: code between a wgmma's
// issue and its wait must not branch, or the compiler waits for the wgmma
// at the branch.
__device__ __forceinline__ void warp_release(uint64_t* bar, bool pred = true) {
  __syncwarp();
  hopper::mbar_arrive_if(bar, pred && threadIdx.x % 32 == 0);
}

// A warpgroup's output staging tile: [64 rows, D columns] up to D = 128; a
// wider output (D = 256) goes out through it in parts of 128 columns.
template <int D>
using StageTile = hopper::Tile<(D > 128 ? 128 : D), 64>;

// Store a warpgroup's [64 x D] f32 accumulator, scaled per row and cast to
// E, to rows [row0, row0 + 64) of head bh by TMA (rows past T, and
// columns past the map's width, are not written): each thread writes its
// pairs into the warpgroup's swizzled staging tile in shared memory, one
// thread issues the store, part by part. Named barrier `bar` (this
// warpgroup's 128 threads) guards the staging tile, which the previous
// store must have finished reading.
template <int D, typename E>
__device__ __forceinline__ void store_tile(void* stage, const CUtensorMap* map,
                                           const float (&acc)[D / 2], float mul_a, float mul_b,
                                           int row0, int bh, int tid, int bar) {
  using T = StageTile<D>;
  const int lane = tid % 32, r = 16 * (tid / 32) + (lane >> 2), t = lane & 3;
  uint8_t* base = reinterpret_cast<uint8_t*>(stage);
#pragma unroll
  for (int part = 0; part < D / T::D; ++part) {
    if (tid == 0) hopper::tma_store_wait_read();
    hopper::bar_sync(bar, WG_THREADS);
#pragma unroll
    for (int j = 0; j < T::D / 8; ++j) {
      const int col = 8 * j + 2 * t, a = 4 * (part * T::D / 8 + j);
      *reinterpret_cast<uint32_t*>(base + T::offset(r, col)) =
          hopper::pack2<E>(acc[a] * mul_a, acc[a + 1] * mul_a);
      *reinterpret_cast<uint32_t*>(base + T::offset(r + 8, col)) =
          hopper::pack2<E>(acc[a + 2] * mul_b, acc[a + 3] * mul_b);
    }
    hopper::fence_proxy_async();
    hopper::bar_sync(bar, WG_THREADS);
    if (tid == 0) {
#pragma unroll
      for (int h = 0; h < T::SUB; ++h)
        hopper::tma_store_rows(map, base + h * T::SUB_BYTES, row0, bh, part * T::D + h * T::W);
    }
  }
}

// Where a kernel writes its output rows, by output type (each kernel is
// instantiated for both). The operand type E (bf16 or f16), the train path's
// outputs: by TMA from the warpgroup's staging tile (store_tile). f32, the outputs of ring
// attention's block entries (ops/flash_attention.py flash_fwd_block,
// flash_bwd_block), which the ring merges in f32: plain float2 stores from
// the accumulator registers, rows past T and columns past the tensor's
// head dim not written. Each warp's store fills eight whole 32-byte sectors
// (at an instance's own width), and the f32 instantiation leaves the
// shared-memory layout, the tensor maps and the code of the 16-bit one as
// they are (its staging tile goes unused).
template <int D, typename OutT>
struct OutRows {  // OutT: the operands' 16-bit type
  CUtensorMap map;  // rows_map over [bh, T, Dh], boxes of 64 rows (StageTile<D>'s)
  __device__ __forceinline__ void store(void* stage, const float (&acc)[D / 2], float mul_a,
                                        float mul_b, int row0, int bh, int tid, int bar) const {
    store_tile<D, OutT>(stage, &map, acc, mul_a, mul_b, row0, bh, tid, bar);
  }
};

template <int D>
struct OutRows<D, float> {
  float* ptr;  // contiguous [bh, T, dh]
  int T, dh;   // dh: the tensor's head dim, at most D (an even number)
  __device__ __forceinline__ void store(void*, const float (&acc)[D / 2], float mul_a, float mul_b,
                                        int row0, int bh, int tid, int) const {
    const int lane = tid % 32, r = row0 + 16 * (tid / 32) + (lane >> 2), c = 2 * (lane & 3);
    float* dst = ptr + ((size_t)bh * T + r) * dh + c;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      if (r < T && 8 * j + c < dh)
        *reinterpret_cast<float2*>(dst + 8 * j) = make_float2(acc[4 * j] * mul_a, acc[4 * j + 1] * mul_a);
      if (r + 8 < T && 8 * j + c < dh)
        *reinterpret_cast<float2*>(dst + 8 * dh + 8 * j) =
            make_float2(acc[4 * j + 2] * mul_b, acc[4 * j + 3] * mul_b);
    }
  }
};

// Chunks 2kk, 2kk + 1 of an m64nN accumulator as the E A fragments of the
// next product (see hopper.cuh): P and dS rounded to the operand type.
template <int N, typename E>
__device__ __forceinline__ void pack_a_frags(uint32_t (&a)[N / 16][4], const float (&c)[N / 2]) {
#pragma unroll
  for (int kk = 0; kk < N / 16; ++kk) {
    a[kk][0] = hopper::pack2<E>(c[8 * kk + 0], c[8 * kk + 1]);
    a[kk][1] = hopper::pack2<E>(c[8 * kk + 2], c[8 * kk + 3]);
    a[kk][2] = hopper::pack2<E>(c[8 * kk + 4], c[8 * kk + 5]);
    a[kk][3] = hopper::pack2<E>(c[8 * kk + 6], c[8 * kk + 7]);
  }
}

// ---------------------------------------------------------------------------
// Forward. Replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:72-132).
//
// Bound on an H100 SXM at the train step's shapes (BH 384, T 1024, D 64,
// causal): 4*BH*T*T*D/2 = 51.5 GFLOP against 989 TFLOP/s bf16 (52 us) and
// 3 inputs + o + lse = 203 MB against 3.35 TB/s (61 us): bytes by a little,
// and the two are close, so the kernel has to keep both the tensor cores
// and the loads busy. At head dim 64 the softmax's exponentials (one MUFU
// op per score, 16 per clock per SM) take as long as the products.
// Design: a work tile is (bh, FWD_BQ q rows), 64 per consumer warpgroup.
// The producer loads the tile's Q once and streams 128-key K and V tiles
// through TMA into a ring of FWD_STAGES stages (full and empty mbarriers
// per stage). Q has two buffers of its own (one at head dim 256), so the
// producer runs on into the next work tile (its Q and first K/V tiles)
// while this one finishes.
// Each consumer warpgroup computes S = Q K^T by wgmma (both operands in
// shared memory, K-major), the online softmax in registers with exp2 and
// scale * log2(e) folded into one FFMA, and O += P V by wgmma with P as the
// register A operand (the S accumulator packed to E) and V read MN-major
// through the transpose bit. S of key tile i and P V of key tile i - 1 go
// out together, one turn per key tile, and the warpgroups take turns at
// issuing (TakeTurns), so one warpgroup's softmax runs while the other's
// products do. Both consumers read the same K/V stage and release it with
// one arrival per warp. Causal: the key loop stops at the diagonal, only
// tiles crossing the diagonal or the ragged end are masked, and a
// warpgroup whose rows all lie past Tq skips its tiles. The output goes out
// by TMA from a staging tile.
// ---------------------------------------------------------------------------
template <int D>
struct FwdSmem {
  static constexpr int BK = Tiles<D>::FWD_BK, STAGES = Tiles<D>::FWD_STAGES, QB = Tiles<D>::FWD_Q_BUFS;
  using TQ = hopper::Tile<D, FWD_BQ>;  // Q of a work tile
  using TK = hopper::Tile<D, BK>;      // a K or V stage
  using TO = StageTile<D>;             // a warpgroup's output staging tile
  static constexpr int Q_BYTES = TQ::BYTES, KV_BYTES = TK::BYTES;
  // Q once or twice (this work tile's and the next one's), the K/V ring,
  // and the output staging tiles (one per consumer warpgroup).
  static constexpr int K_OFF = QB * Q_BYTES, V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int O_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = O_OFF + FWD_WGS * TO::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 * QB + 3 * STAGES);  // + alignment slack
  static constexpr int LAUNCH = BYTES > ONE_BLOCK_PER_SM_SMEM ? BYTES : ONE_BLOCK_PER_SM_SMEM;
  static_assert(STAGES >= 2 && (QB == 1 || QB == 2), "a ring of at least two stages, one or two Q buffers");
  static_assert(LAUNCH <= SMEM_LIMIT, "the forward's shared memory does not fit");
};

// Key tiles of BK keys that a q range [first, last] needs (causal: up to
// its last row); forward and dQ.
template <int BK>
__device__ __forceinline__ int key_tiles(int last_row, int Tk, int causal) {
  return ((causal ? min(Tk, last_row + 1) : Tk) + BK - 1) / BK;
}

// The leading key tiles that need no mask for q rows from `first_row` on:
// past them a tile crosses the diagonal (causal) or the ragged end of the
// keys, and so do all later tiles.
template <int BK>
__device__ __forceinline__ int plain_tiles(int first_row, int Tk, int causal) {
  return causal ? min(Tk / BK, (first_row + 1) / BK) : Tk / BK;
}

// The online softmax of one key tile (starting at k0) for this thread's
// rows a and b. fwd_max masks the tile (kMask: causal, ragged end), takes
// the new running max m (of s * scale * log2 e) across the four lanes that
// hold a row, and returns in alpha the factor that rescales what was
// accumulated against the old max. fwd_exp turns sc into P = 2^(s sl2 - m)
// in place and adds its row sums to l.
template <bool kMask, int BK>
__device__ __forceinline__ void fwd_max(float (&sc)[BK / 2], float& m_a, float& m_b,
                                        float& alpha_a, float& alpha_b, int k0, int Tk, int row_a,
                                        int t, float sl2, int causal) {
  const int row_b = row_a + 8;
  if constexpr (kMask) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + 8 * j + 2 * t + e;
        if (col >= Tk || (causal && col > row_a)) sc[4 * j + e] = -INFINITY;
        if (col >= Tk || (causal && col > row_b)) sc[4 * j + 2 + e] = -INFINITY;
      }
    }
  }
  // Four partial maxima per row: short dependency chains. The first tile
  // holds key 0, which every row sees, so the running max is finite from
  // the first tile on.
  float pm_a[4], pm_b[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) pm_a[u] = pm_b[u] = -INFINITY;
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    pm_a[j % 4] = fmaxf(pm_a[j % 4], fmaxf(sc[4 * j], sc[4 * j + 1]));
    pm_b[j % 4] = fmaxf(pm_b[j % 4], fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
  }
  float mx_a = fmaxf(fmaxf(pm_a[0], pm_a[1]), fmaxf(pm_a[2], pm_a[3]));
  float mx_b = fmaxf(fmaxf(pm_b[0], pm_b[1]), fmaxf(pm_b[2], pm_b[3]));
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
    mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
  }
  const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
  alpha_a = hopper::ex2(m_a - mn_a);
  alpha_b = hopper::ex2(m_b - mn_b);
  m_a = mn_a;
  m_b = mn_b;
}

template <int BK>
__device__ __forceinline__ void fwd_exp(float (&sc)[BK / 2], float m_a, float m_b, float& l_a,
                                        float& l_b, float alpha_a, float alpha_b, float sl2) {
  float ps_a[4] = {0.f, 0.f, 0.f, 0.f}, ps_b[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    sc[4 * j + 0] = hopper::ex2(fmaf(sc[4 * j + 0], sl2, -m_a));
    sc[4 * j + 1] = hopper::ex2(fmaf(sc[4 * j + 1], sl2, -m_a));
    sc[4 * j + 2] = hopper::ex2(fmaf(sc[4 * j + 2], sl2, -m_b));
    sc[4 * j + 3] = hopper::ex2(fmaf(sc[4 * j + 3], sl2, -m_b));
    ps_a[j % 4] += sc[4 * j] + sc[4 * j + 1];
    ps_b[j % 4] += sc[4 * j + 2] + sc[4 * j + 3];
  }
  l_a = l_a * alpha_a + ((ps_a[0] + ps_a[1]) + (ps_a[2] + ps_a[3]));
  l_b = l_b * alpha_b + ((ps_b[0] + ps_b[1]) + (ps_b[2] + ps_b[3]));
}

template <int D, typename E, typename OutT>
__global__ void __launch_bounds__(Roles<FWD_WGS>::THREADS, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ OutRows<D, OutT> out_o,
                 float* __restrict__ lse, int bh_count, int Tq, int Tk, float scale, int causal) {
  using S = FwdSmem<D>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using R = Roles<FWD_WGS>;
  constexpr int FWD_BK = S::BK, FWD_STAGES = S::STAGES, QB = S::QB, W = TQ::W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  E* sq = reinterpret_cast<E*>(base);  // [QB][FWD_BQ * D]
  E* sk = reinterpret_cast<E*>(base + S::K_OFF);
  E* sv = reinterpret_cast<E*>(base + S::V_OFF);
  E* so = reinterpret_cast<E*>(base + S::O_OFF);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + S::BAR_OFF);  // [QB]
  uint64_t* empty_q = full_q + QB;                                    // [QB]
  uint64_t* full_k = empty_q + QB;
  uint64_t* full_v = full_k + FWD_STAGES;
  uint64_t* empty = full_v + FWD_STAGES;
  const int n_qt = (Tq + FWD_BQ - 1) / FWD_BQ;

  if (threadIdx.x == 0) {
    for (int b = 0; b < QB; ++b) {
      hopper::mbar_init(&full_q[b], 1);
      hopper::mbar_init(&empty_q[b], R::CONSUMER_WARPS);
    }
    for (int s = 0; s < FWD_STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], R::CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  WorkList works(n_qt, bh_count, causal, /*longest_is_high=*/1);
  int bh, qt, wc = 0, it = 0;  // work tiles and K/V stages this block has gone through
  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<R::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (; works.next(bh, qt); ++wc) {
        const int q0 = qt * FWD_BQ, n_k = key_tiles<FWD_BK>(q0 + FWD_BQ - 1, Tk, causal);
        const int b = wc % QB;
        hopper::mbar_wait(&empty_q[b], ((wc / QB) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_q[b], S::Q_BYTES);
        hopper::tma_load_tile<TQ>(sq + b * FWD_BQ * D, &tm_q, &full_q[b], q0, bh);
        for (int i = 0; i < n_k; ++i, ++it) {
          const int s = it % FWD_STAGES;
          hopper::mbar_wait(&empty[s], ((it / FWD_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full_k[s], S::KV_BYTES);
          hopper::tma_load_tile<TK>(sk + s * FWD_BK * D, &tm_k, &full_k[s], i * FWD_BK, bh);
          hopper::mbar_arrive_expect_tx(&full_v[s], S::KV_BYTES);
          hopper::tma_load_tile<TK>(sv + s * FWD_BK * D, &tm_v, &full_v[s], i * FWD_BK, bh);
        }
      }
    }
  } else {  // consumers: 64 q rows each
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    const TakeTurns<FWD_WGS> turns{c};
    turns.start();
    for (; works.next(bh, qt); ++wc) {
      const int q0 = qt * FWD_BQ, wq0 = q0 + 64 * c;  // this warpgroup's first row
      const int row_a = wq0 + 16 * warp + g, row_b = row_a + 8;
      const int n_k = key_tiles<FWD_BK>(q0 + FWD_BQ - 1, Tk, causal);
      // The key tiles its rows see (none for rows all past Tq).
      const int n_own = wq0 < Tq ? key_tiles<FWD_BK>(wq0 + 63, Tk, causal) : 0;
      float m_a = -INFINITY, m_b = -INFINITY;  // running max of s * scale * log2(e)
      float l_a = 0.f, l_b = 0.f;              // this thread's share of the normaliser
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      const int b = wc % QB;
      const uint64_t desc_q = TQ::desc(sq + b * FWD_BQ * D + 64 * c * W);
      hopper::mbar_wait(&full_q[b], (wc / QB) & 1);
      // Pipelined: S of key tile i and P V of key tile i - 1 go out in one
      // turn; P V runs on while this warpgroup takes the row maxima of tile
      // i (the compiler waits for it at their lane shuffles). The tiles that
      // need a mask run in a loop of their own: a branch between a wgmma's
      // issue and its wait makes the compiler wait for the wgmma there.
      const int it0 = it, n_plain = plain_tiles<FWD_BK>(wq0, Tk, causal);
      uint32_t pa[FWD_BK / 16][4];  // P of the last tile in E (cast before p@v, as in JAX)
      auto stage = [&](int i) { return (it0 + i) % FWD_STAGES; };
      auto parity = [&](int i) { return ((it0 + i) / FWD_STAGES) & 1; };
      auto issue_pv = [&](int i) {  // O += P V of key tile i, not waited for
        const E* vs = sv + stage(i) * FWD_BK * D;
#pragma unroll
        for (int kk = 0; kk < FWD_BK / 16; ++kk)
          hopper::Wgmma<D, E>::rs(acc, pa[kk], TK::mn(vs, kk * 16));
        hopper::wgmma_commit();
      };
      auto tile = [&](auto masked, auto after_first, int i) {
        constexpr bool kAfterFirst = decltype(after_first)::value;  // a P V to issue with S
        float sc[FWD_BK / 2], alpha_a, alpha_b;
        hopper::mbar_wait(&full_k[stage(i)], parity(i));
        if constexpr (kAfterFirst) hopper::mbar_wait(&full_v[stage(i - 1)], parity(i - 1));
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        turns.begin();
        hopper::wgmma_fence();
        const uint64_t desc_k = TK::desc(sk + stage(i) * FWD_BK * D);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk)
          hopper::Wgmma<FWD_BK, E>::ss(sc, desc_q + TQ::k_step(kk), desc_k + TK::k_step(kk), kk > 0);
        hopper::wgmma_commit();
        if constexpr (kAfterFirst) issue_pv(i - 1);
        turns.end();
        if constexpr (kAfterFirst)
          hopper::wgmma_wait<1>();  // S is in; P V may still run
        else
          hopper::wgmma_wait<0>();
        hopper::fence_regs(sc);
        fwd_max<decltype(masked)::value, FWD_BK>(sc, m_a, m_b, alpha_a, alpha_b, i * FWD_BK, Tk,
                                                 row_a, t, sl2, causal);
        fwd_exp<FWD_BK>(sc, m_a, m_b, l_a, l_b, alpha_a, alpha_b, sl2);
        hopper::fence_regs(sc);  // the exponentials stay before the wait
        if constexpr (kAfterFirst) {
          hopper::wgmma_wait<0>();
          hopper::fence_regs(acc);
          hopper::fence_regs(pa);
          warp_release(&empty[stage(i - 1)]);
#pragma unroll
          for (int j = 0; j < D / 8; ++j) {
            acc[4 * j] *= alpha_a;
            acc[4 * j + 1] *= alpha_a;
            acc[4 * j + 2] *= alpha_b;
            acc[4 * j + 3] *= alpha_b;
          }
        }
        pack_a_frags<FWD_BK, E>(pa, sc);
      };
      // Each warpgroup takes n_k + 1 turns per work tile: one per key tile
      // and one for the last P V.
      if (n_own > 0) {
        if (n_plain > 0)
          tile(std::false_type{}, std::false_type{}, 0);
        else
          tile(std::true_type{}, std::false_type{}, 0);
        int i = 1;
        for (; i < min(n_plain, n_own); ++i) tile(std::false_type{}, std::true_type{}, i);
        for (; i < n_own; ++i) tile(std::true_type{}, std::true_type{}, i);
        hopper::mbar_wait(&full_v[stage(n_own - 1)], parity(n_own - 1));
        hopper::fence_regs(acc);
        hopper::fence_regs(pa);
        turns.begin();
        hopper::wgmma_fence();
        issue_pv(n_own - 1);
        turns.end();
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        warp_release(&empty[stage(n_own - 1)]);
      } else {
        turns.skip();
      }
      it += n_own;
      // Key tiles past this warpgroup's rows (causal, the other warpgroup's
      // diagonal): release them once they have landed.
      for (int i = n_own; i < n_k; ++i, ++it) {
        const int s = it % FWD_STAGES;
        hopper::mbar_wait(&full_v[s], (it / FWD_STAGES) & 1);
        warp_release(&empty[s]);
        turns.skip();
      }
      warp_release(&empty_q[b]);  // the producer may load Q of the work tile QB on

#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      out_o.store(so + c * S::TO::BYTES / 2, acc, 1.f / l_a, 1.f / l_b, wq0, bh, tid, 1 + FWD_WGS + c);
      if (t == 0) {  // lse in natural log: (m + log2 l) ln 2
        float* lse_bh = lse + (size_t)bh * Tq;
        if (row_a < Tq) lse_bh[row_a] = (m_a + log2f(l_a)) * LN2;
        if (row_b < Tq) lse_bh[row_b] = (m_b + log2f(l_b)) * LN2;
      }
    }
    turns.finish();
    if (tid == 0) hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// dK/dV. Replaces _dkv_kernel (ray_tpu/ops/flash_attention.py:168-205).
//
// Bound on an H100 SXM at the train step's shapes (causal): four products
// (S^T, dP^T, dV = P^T dO, dK = dS^T Q) = 103 GFLOP against 989 TFLOP/s
// (104 us); q, k, v, dO, lse, delta in and dk, dv out = 305 MB against
// 3.35 TB/s (91 us): operations.
// Design: a work tile is (bh, 128 keys), the transposed problem of dQ. The
// producer warp loads the tile's K and V once by TMA (the consumers copy
// their rows into registers at once and release the buffer, so the next
// work tile's K and V load while this one runs), then
// streams 64-row Q and dO tiles by TMA into a ring of
// DKV_STAGES stages, with the tiles' lse and delta copied beside them by
// cp.async (their rows are not 16-byte strided, so TMA cannot take them):
// the stage's full barrier waits for the bytes and for the 32 lanes' copy
// arrivals. Each consumer warpgroup owns 64 keys: S^T = K Q^T and
// dP^T = V dO^T by wgmma with its K and V rows as register A operands
// (read from shared memory once per work tile, which leaves the ring's
// tiles the only operands the products stream from shared memory) and Q
// and dO K-major from shared memory, P^T =
// exp2(S^T scale log2 e - lse log2 e) and dS^T in registers, then
// dV += P^T dO and dK += dS^T Q by wgmma with P^T and dS^T as register A
// operands and dO and Q read MN-major through the transpose bit -- the
// same shared-memory tiles the first two products read K-major. The
// gradient products of one q tile are left running while the next tile's
// first two are issued. dK and dV accumulate in f32 registers of the block
// that owns the keys: no atomics, no dependence on run order. Causal: q
// tiles from the diagonal on; a warpgroup whose keys all lie after a tile's
// rows skips it. (Taking turns at the tensor cores, as the forward does,
// made this kernel slower on the card.) Head dim 128 (Tiles<128>): Q/dO
// stages of 32 rows, and S^T and dP^T read K and V from shared memory (both
// operands there), since their register copies (64 registers) would not fit
// beside the two [64 x 128] accumulators; the K/V buffer is released when
// the work tile's last product is in, so the next one's K and V load then.
// Head dim 256 (DKV_PASSES 2): the kernel runs twice, PASS 1 computing dV
// alone (S^T and P^T, then dV += P^T dO) and PASS 2 dK alone (S^T, dP^T, dS^T,
// then dK += dS^T Q), each with one [64 x 256] accumulator and one set of
// staging tiles.
// ---------------------------------------------------------------------------
template <int D>
struct DkvSmem {
  static constexpr int BQ = Tiles<D>::DKV_BQ, STAGES = Tiles<D>::DKV_STAGES;
  static constexpr int OUTS = Tiles<D>::DKV_PASSES == 1 ? 2 : 1;  // outputs a pass writes
  using TK = hopper::Tile<D, DKV_BK>;  // K or V of a work tile
  using TQ = hopper::Tile<D, BQ>;      // a Q or dO stage
  using TO = StageTile<D>;             // a warpgroup's dK or dV staging tile
  static constexpr int KV_BYTES = TK::BYTES, QS_BYTES = TQ::BYTES;
  // K and V, the Q/dO ring, the ring's lse and delta, and the dK/dV
  // staging tiles (dK's and dV's, or one set a pass).
  static constexpr int K_OFF = 0, V_OFF = KV_BYTES, Q_OFF = 2 * KV_BYTES;
  static constexpr int DO_OFF = Q_OFF + STAGES * QS_BYTES;
  static constexpr int LSE_OFF = DO_OFF + STAGES * QS_BYTES;
  static constexpr int DELTA_OFF = LSE_OFF + STAGES * BQ * 4;
  static constexpr int DK_OFF = (DELTA_OFF + STAGES * BQ * 4 + 1023) / 1024 * 1024;
  static constexpr int DV_OFF = DK_OFF + (OUTS - 1) * 2 * TO::BYTES;
  static constexpr int BAR_OFF = DV_OFF + 2 * TO::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + 2 * STAGES);
  static constexpr int LAUNCH = BYTES > ONE_BLOCK_PER_SM_SMEM ? BYTES : ONE_BLOCK_PER_SM_SMEM;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(LAUNCH <= SMEM_LIMIT, "dK/dV's shared memory does not fit");
};

// The first q tile (of BQ rows) that can see key k0 (causal, Tq == Tk).
template <int BQ>
__device__ __forceinline__ int dkv_first_q_tile(int k0, int causal) {
  return causal ? k0 / BQ : 0;
}

// PASS 0: dK and dV; 1: dV alone; 2: dK alone (DKV_PASSES 2).
template <int D, typename E, typename OutT, int PASS>
__global__ void __launch_bounds__(Roles<2>::THREADS, 1)
flash_dkv_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                 const __grid_constant__ OutRows<D, OutT> out_dk,
                 const __grid_constant__ OutRows<D, OutT> out_dv,
                 const float* __restrict__ lse, const float* __restrict__ delta, int bh_count,
                 int Tq, int Tk, float scale, int causal) {
  using S = DkvSmem<D>;
  using TK = typename S::TK;
  using TQ = typename S::TQ;
  using R = Roles<2>;
  constexpr int DKV_BQ = S::BQ, DKV_STAGES = S::STAGES, W = TK::W;
  constexpr bool KV_IN_REGS = Tiles<D>::DKV_KV_IN_REGS, DO_DK = PASS != 1, DO_DV = PASS != 2;
  static_assert((PASS == 0) == (Tiles<D>::DKV_PASSES == 1), "one pass, or a dV pass and a dK pass");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  E* sk = reinterpret_cast<E*>(base + S::K_OFF);  // [DKV_BK * D]
  E* sv = reinterpret_cast<E*>(base + S::V_OFF);  // [DKV_BK * D]
  E* sq = reinterpret_cast<E*>(base + S::Q_OFF);
  E* sdo = reinterpret_cast<E*>(base + S::DO_OFF);
  float* slse = reinterpret_cast<float*>(base + S::LSE_OFF);
  float* sdelta = reinterpret_cast<float*>(base + S::DELTA_OFF);
  E* sdk = reinterpret_cast<E*>(base + S::DK_OFF);
  E* sdv = reinterpret_cast<E*>(base + S::DV_OFF);
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(base + S::BAR_OFF);
  uint64_t* empty_kv = full_kv + 1;
  uint64_t* full = empty_kv + 1;
  uint64_t* empty = full + DKV_STAGES;
  const int n_kt = (Tk + DKV_BK - 1) / DKV_BK, n_qs = (Tq + DKV_BQ - 1) / DKV_BQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_kv, 1);
    hopper::mbar_init(empty_kv, R::CONSUMER_WARPS);
    for (int s = 0; s < DKV_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1 + 32);  // the TMA arrival + the producer lanes' cp.async arrivals
      hopper::mbar_init(&empty[s], R::CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  WorkList works(n_kt, bh_count, causal, /*longest_is_high=*/0);
  int bh, kt, wc = 0, it = 0;  // work tiles and Q/dO stages this block has gone through
  if (wg == 0) {  // producer: warp 0
    hopper::setmaxnreg_dec<R::PRODUCER_REGS>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      for (; works.next(bh, kt); ++wc) {
        const int k0 = kt * DKV_BK;
        const float* lse_bh = lse + (size_t)bh * Tq;
        const float* delta_bh = delta + (size_t)bh * Tq;
        hopper::mbar_wait(empty_kv, (wc & 1) ^ 1);
        if (lane == 0) {
          hopper::mbar_arrive_expect_tx(full_kv, 2 * S::KV_BYTES);
          hopper::tma_load_tile<TK>(sk, &tm_k, full_kv, k0, bh);
          hopper::tma_load_tile<TK>(sv, &tm_v, full_kv, k0, bh);
        }
        for (int i = dkv_first_q_tile<DKV_BQ>(k0, causal); i < n_qs; ++i, ++it) {
          const int s = it % DKV_STAGES, q0 = i * DKV_BQ;
          hopper::mbar_wait(&empty[s], ((it / DKV_STAGES) & 1) ^ 1);
          if (lane == 0) {
            hopper::mbar_arrive_expect_tx(&full[s], 2 * S::QS_BYTES);
            hopper::tma_load_tile<TQ>(sq + s * DKV_BQ * D, &tm_q, &full[s], q0, bh);
            hopper::tma_load_tile<TQ>(sdo + s * DKV_BQ * D, &tm_do, &full[s], q0, bh);
          }
          for (int r = lane; r < DKV_BQ; r += 32) {
            const bool in = q0 + r < Tq;
            hopper::cp_async_4(&slse[s * DKV_BQ + r], lse_bh + (in ? q0 + r : 0), in);
            hopper::cp_async_4(&sdelta[s * DKV_BQ + r], delta_bh + (in ? q0 + r : 0), in);
          }
          hopper::cp_async_arrive(&full[s]);
        }
      }
    }
  } else {  // consumers: 64 keys each
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    for (; works.next(bh, kt); ++wc) {
      const int k0 = kt * DKV_BK, wk0 = k0 + 64 * c;  // wk0: this warpgroup's first key
      const int key_a = wk0 + 16 * warp + g, key_b = key_a + 8;
      const int i_begin = dkv_first_q_tile<DKV_BQ>(k0, causal);
      // Causal: the first q tile with a row at or after this warpgroup's
      // first key; the tiles before it see none of its keys.
      const int i_own = dkv_first_q_tile<DKV_BQ>(wk0, causal);
      float dk_acc[DO_DK ? D / 2 : 1], dv_acc[DO_DV ? D / 2 : 1];
#pragma unroll
      for (int i = 0; i < (DO_DK ? D / 2 : 1); ++i) dk_acc[i] = 0.f;
#pragma unroll
      for (int i = 0; i < (DO_DV ? D / 2 : 1); ++i) dv_acc[i] = 0.f;

      hopper::mbar_wait(full_kv, wc & 1);
      // K and V of this warpgroup's keys as register A operands, for the
      // whole work tile; the producer may load the next work tile's. At
      // head dim 128 they are read from shared memory instead, and the
      // buffer is released at the end of the work tile.
      uint32_t ka[KV_IN_REGS ? D / 16 : 1][4], va[KV_IN_REGS ? D / 16 : 1][4];
      const uint64_t desc_ks = TK::desc(sk + 64 * c * W), desc_vs = TK::desc(sv + 64 * c * W);
      if constexpr (KV_IN_REGS) {
        hopper::load_a_rows<TK>(ka, sk + 64 * c * W, warp, lane);
        hopper::load_a_rows<TK>(va, sv + 64 * c * W, warp, lane);
        warp_release(empty_kv);
      }
      for (int i = i_begin; i < i_own; ++i, ++it) {  // release them once landed
        const int s = it % DKV_STAGES;
        hopper::mbar_wait(&full[s], (it / DKV_STAGES) & 1);
        warp_release(&empty[s]);
      }
      // Pipelined: the gradient products of q tile i (dV += P^T dO, dK +=
      // dS^T Q) are issued without a wait; the wait for S^T of tile i + 1
      // covers them, so the tensor cores run them while this warpgroup
      // takes the next stage and issues its products. The tiles that need
      // a mask (the diagonal's, the ragged last one) run in loops of their
      // own: no branch may sit between a wgmma's issue and its wait.
      uint32_t pa[DO_DV ? DKV_BQ / 16 : 1][4], da[DO_DK ? DKV_BQ / 16 : 1][4];  // P^T, dS^T cast to E first
      int prev = -1;  // the stage whose gradient products may still run
      auto qtile = [&](auto masked, int i) {
        const int s = (it + i - i_own) % DKV_STAGES, q0 = i * DKV_BQ;
        const E* qs = sq + s * DKV_BQ * D;
        const E* dos = sdo + s * DKV_BQ * D;
        const float* ls = slse + s * DKV_BQ;
        [[maybe_unused]] const float* ds = sdelta + s * DKV_BQ;  // (read when dK is computed)
        hopper::mbar_wait(&full[s], ((it + i - i_own) / DKV_STAGES) & 1);

        float st[DKV_BQ / 2], dpt[DKV_BQ / 2];  // S^T and dP^T, [64 keys x DKV_BQ q]
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        const uint64_t desc_qs = TQ::desc(qs), desc_dos = TQ::desc(dos);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (KV_IN_REGS)
            hopper::Wgmma<DKV_BQ, E>::rsk(st, ka[kk], desc_qs + TQ::k_step(kk), kk > 0);
          else
            hopper::Wgmma<DKV_BQ, E>::ss(st, desc_ks + TK::k_step(kk), desc_qs + TQ::k_step(kk), kk > 0);
        }
        hopper::wgmma_commit();
        if constexpr (DO_DK) {
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            if constexpr (KV_IN_REGS)
              hopper::Wgmma<DKV_BQ, E>::rsk(dpt, va[kk], desc_dos + TQ::k_step(kk), kk > 0);
            else
              hopper::Wgmma<DKV_BQ, E>::ss(dpt, desc_vs + TK::k_step(kk), desc_dos + TQ::k_step(kk), kk > 0);
          }
          hopper::wgmma_commit();
          hopper::wgmma_wait<1>();  // the last tile's gradients and S^T are in; dP^T may still run
        } else {
          hopper::wgmma_wait<0>();  // the last tile's dV and S^T are in
        }
        hopper::fence_regs(st);
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);

#pragma unroll
        for (int j = 0; j < DKV_BQ / 8; ++j) {
          const float2 L2 = *reinterpret_cast<const float2*>(ls + 8 * j + 2 * t);
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int qcol = q0 + 8 * j + 2 * t + e;
            const float L = (e ? L2.y : L2.x) * LOG2E;
            float pa_ = hopper::ex2(fmaf(st[4 * j + e], sl2, -L));
            float pb_ = hopper::ex2(fmaf(st[4 * j + 2 + e], sl2, -L));
            if constexpr (decltype(masked)::value) {
              if (qcol >= Tq || (causal && key_a > qcol)) pa_ = 0.f;
              if (qcol >= Tq || (causal && key_b > qcol)) pb_ = 0.f;
            }
            st[4 * j + e] = pa_;
            st[4 * j + 2 + e] = pb_;
          }
        }
        hopper::fence_regs(st);  // P^T stays before the wait (the compiler may not sink it)
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dpt);
        // (released only now: the release's warp barrier would make the
        // compiler wait for dP^T before P^T)
        warp_release(&empty[prev < 0 ? 0 : prev], prev >= 0);
        if constexpr (DO_DK) {
#pragma unroll
          for (int j = 0; j < DKV_BQ / 8; ++j) {
            const float2 dl2 = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t);
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float dls = (e ? dl2.y : dl2.x) * scale;
              dpt[4 * j + e] = st[4 * j + e] * fmaf(dpt[4 * j + e], scale, -dls);  // dS
              dpt[4 * j + 2 + e] = st[4 * j + 2 + e] * fmaf(dpt[4 * j + 2 + e], scale, -dls);
            }
          }
          pack_a_frags<DKV_BQ, E>(da, dpt);
        }
        if constexpr (DO_DV) pack_a_frags<DKV_BQ, E>(pa, st);
        hopper::fence_regs(dv_acc);
        hopper::fence_regs(dk_acc);
        hopper::fence_regs(pa);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        if constexpr (DO_DV) {
#pragma unroll
          for (int kk = 0; kk < DKV_BQ / 16; ++kk)
            hopper::Wgmma<D, E>::rs(dv_acc, pa[kk], TQ::mn(dos, kk * 16));
        }
        if constexpr (DO_DK) {
#pragma unroll
          for (int kk = 0; kk < DKV_BQ / 16; ++kk)
            hopper::Wgmma<D, E>::rs(dk_acc, da[kk], TQ::mn(qs, kk * 16));
        }
        hopper::wgmma_commit();
        prev = s;
      };
      // Masks: causal, the tiles whose first row is before this warpgroup's
      // last key; then the tile that holds the ragged end of the q rows.
      const int diag_end = causal ? max(i_own, min(n_qs, (wk0 + 63) / DKV_BQ + 1)) : i_own;
      const int plain_end = max(diag_end, Tq / DKV_BQ);
      int i = i_own;
      for (; i < diag_end; ++i) qtile(std::true_type{}, i);
      for (; i < plain_end; ++i) qtile(std::false_type{}, i);
      for (; i < n_qs; ++i) qtile(std::true_type{}, i);
      it += n_qs - i_own;
      hopper::wgmma_wait<0>();
      hopper::fence_regs(dv_acc);
      hopper::fence_regs(dk_acc);
      hopper::fence_regs(pa);
      hopper::fence_regs(da);
      warp_release(&empty[prev < 0 ? 0 : prev], prev >= 0);
      if constexpr (!KV_IN_REGS) warp_release(empty_kv);  // the last product that read K and V is in
      // dS = P (dP scale - delta scale) took the scale before its E
      // rounding, as the Pallas kernel's dS does (1/sqrt(Dh) is a power of
      // two only at head dims 16 and 64).
      if constexpr (DO_DK) out_dk.store(sdk + c * S::TO::BYTES / 2, dk_acc, 1.f, 1.f, wk0, bh, tid, 3 + c);
      if constexpr (DO_DV) out_dv.store(sdv + c * S::TO::BYTES / 2, dv_acc, 1.f, 1.f, wk0, bh, tid, 3 + c);
    }
    if (tid == 0) hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// dQ. Replaces _dq_kernel (ray_tpu/ops/flash_attention.py:135-165).
//
// Bound on an H100 SXM at the train step's shapes (BH 384, T 1024, D 64,
// causal): three products (S = QK^T, dP = dO V^T, dQ = dS K) = 77 GFLOP
// against 989 TFLOP/s (78 us); q, k, v, dO, lse, delta in and dq out = 255
// MB against 3.35 TB/s (76 us): operations by a little.
// Design: the forward's structure with one more product. A work tile is (bh,
// DQ_BQ q rows), 64 per consumer warpgroup; causal units pair tiles p and
// n - 1 - p as the forward's do. The producer warp loads the tile's Q and dO
// once by TMA (the consumers copy their rows into registers at once and
// release the buffer, so the next work tile's Q and dO load while this one
// runs), then streams 64-key K and V tiles into a ring of DQ_STAGES stages.
// Each consumer warpgroup reads its rows' lse and delta once per work tile
// and, per key tile, computes S = Q K^T and dP = dO V^T by wgmma with Q and
// dO as register A operands and K and V K-major from shared memory, P =
// exp2(S scale log2 e - lse log2 e) in one FFMA and one MUFU op per score,
// and dS = P (dP scale - delta scale) (one FFMA: the scale comes in before
// dS is rounded, as in the Pallas kernel) packed to E A fragments; dQ +=
// dS K by wgmma reads the same K tile MN-major through the transpose bit. S
// of key tile i, dQ of tile i - 1 and dP of tile i go out together, so the
// exponentials of tile i can start while dQ(i - 1) and dP(i) run; the stage
// of tile i - 1 is released after the wait that covers its dQ. dQ
// accumulates in f32 registers of the block that owns the rows. Causal: the
// key loop stops at the
// diagonal; the warpgroup whose rows end earlier releases the key tile past
// its rows without computing, and one whose rows all lie past Tq skips its
// tiles. Only the diagonal and ragged-end tiles are masked, in a loop of
// their own. dQ goes out by TMA from a staging tile. Head dim 256
// (DQ_QDO_IN_REGS 0): S and dP read Q and dO from shared memory, where they
// stay until the work tile's last product is in.
// ---------------------------------------------------------------------------
template <int D>
struct DqSmem {
  static constexpr int BK = Tiles<D>::DQ_BK, STAGES = Tiles<D>::DQ_STAGES;
  using TQ = hopper::Tile<D, DQ_BQ>;  // Q or dO of a work tile
  using TK = hopper::Tile<D, BK>;     // a K or V stage
  using TO = StageTile<D>;            // a warpgroup's dQ staging tile
  static constexpr int Q_BYTES = TQ::BYTES, KV_BYTES = TK::BYTES;
  // Q and dO of one work tile, the K/V ring, and the dQ staging tiles (one
  // per consumer warpgroup).
  static constexpr int DO_OFF = Q_BYTES, K_OFF = 2 * Q_BYTES;
  static constexpr int V_OFF = K_OFF + STAGES * KV_BYTES;
  static constexpr int DQ_OFF = V_OFF + STAGES * KV_BYTES;
  static constexpr int BAR_OFF = DQ_OFF + DQ_WGS * TO::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (2 + 2 * STAGES);  // + alignment slack
  static constexpr int LAUNCH = BYTES > ONE_BLOCK_PER_SM_SMEM ? BYTES : ONE_BLOCK_PER_SM_SMEM;
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(LAUNCH <= SMEM_LIMIT, "dQ's shared memory does not fit");
};

template <int D, typename E, typename OutT>
__global__ void __launch_bounds__(Roles<DQ_WGS>::THREADS, 1)
flash_dq_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                const __grid_constant__ CUtensorMap tm_v, const __grid_constant__ CUtensorMap tm_do,
                const __grid_constant__ OutRows<D, OutT> out_dq, const float* __restrict__ lse,
                const float* __restrict__ delta, int bh_count, int Tq, int Tk, float scale,
                int causal) {
  using S = DqSmem<D>;
  using TQ = typename S::TQ;
  using TK = typename S::TK;
  using R = Roles<DQ_WGS>;
  constexpr int DQ_BK = S::BK, DQ_STAGES = S::STAGES, W = TQ::W;
  constexpr bool QDO_IN_REGS = Tiles<D>::DQ_QDO_IN_REGS;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  E* sq = reinterpret_cast<E*>(base);  // [DQ_BQ * D]
  E* sdo = reinterpret_cast<E*>(base + S::DO_OFF);
  E* sk = reinterpret_cast<E*>(base + S::K_OFF);
  E* sv = reinterpret_cast<E*>(base + S::V_OFF);
  E* sdq = reinterpret_cast<E*>(base + S::DQ_OFF);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + S::BAR_OFF);
  uint64_t* empty_q = full_q + 1;
  uint64_t* full = empty_q + 1;
  uint64_t* empty = full + DQ_STAGES;
  const int n_qt = (Tq + DQ_BQ - 1) / DQ_BQ;

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    hopper::mbar_init(empty_q, R::CONSUMER_WARPS);
    for (int s = 0; s < DQ_STAGES; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], R::CONSUMER_WARPS);
    }
    hopper::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / WG_THREADS;
  WorkList works(n_qt, bh_count, causal, /*longest_is_high=*/1);
  int bh, qt, wc = 0, it = 0;  // work tiles and K/V stages this block has gone through
  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<R::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      for (; works.next(bh, qt); ++wc) {
        const int q0 = qt * DQ_BQ, n_k = key_tiles<DQ_BK>(q0 + DQ_BQ - 1, Tk, causal);
        hopper::mbar_wait(empty_q, (wc & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(full_q, 2 * S::Q_BYTES);
        hopper::tma_load_tile<TQ>(sq, &tm_q, full_q, q0, bh);
        hopper::tma_load_tile<TQ>(sdo, &tm_do, full_q, q0, bh);
        for (int i = 0; i < n_k; ++i, ++it) {
          const int s = it % DQ_STAGES;
          hopper::mbar_wait(&empty[s], ((it / DQ_STAGES) & 1) ^ 1);
          hopper::mbar_arrive_expect_tx(&full[s], 2 * S::KV_BYTES);
          hopper::tma_load_tile<TK>(sk + s * DQ_BK * D, &tm_k, &full[s], i * DQ_BK, bh);
          hopper::tma_load_tile<TK>(sv + s * DQ_BK * D, &tm_v, &full[s], i * DQ_BK, bh);
        }
      }
    }
  } else {  // consumers: 64 q rows each
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const float sl2 = scale * LOG2E;
    for (; works.next(bh, qt); ++wc) {
      const int q0 = qt * DQ_BQ, wq0 = q0 + 64 * c;  // this warpgroup's first row
      const int row_a = wq0 + 16 * warp + g, row_b = row_a + 8;
      const int n_k = key_tiles<DQ_BK>(q0 + DQ_BQ - 1, Tk, causal);
      // The key tiles its rows see (none for rows all past Tq).
      const int n_own = wq0 < Tq ? key_tiles<DQ_BK>(wq0 + 63, Tk, causal) : 0;
      // This thread's two rows' lse (in log2 units) and delta; zero past Tq,
      // where Q and dO are zero-filled, so dS is zero there.
      const float* lse_bh = lse + (size_t)bh * Tq;
      const float* delta_bh = delta + (size_t)bh * Tq;
      const float l2_a = row_a < Tq ? lse_bh[row_a] * LOG2E : 0.f;
      const float l2_b = row_b < Tq ? lse_bh[row_b] * LOG2E : 0.f;
      const float dl_a = row_a < Tq ? delta_bh[row_a] * scale : 0.f;  // delta scale
      const float dl_b = row_b < Tq ? delta_bh[row_b] * scale : 0.f;
      float acc[D / 2];
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

      // Q and dO of this warpgroup's rows as register A operands, for the
      // whole work tile; the producer may load the next work tile's. At
      // head dim 256 they are read from shared memory instead, and the
      // buffer is released at the end of the work tile.
      hopper::mbar_wait(full_q, wc & 1);
      uint32_t qa[QDO_IN_REGS ? D / 16 : 1][4], doa[QDO_IN_REGS ? D / 16 : 1][4];
      const uint64_t desc_qs = TQ::desc(sq + 64 * c * W), desc_dos = TQ::desc(sdo + 64 * c * W);
      if constexpr (QDO_IN_REGS) {
        hopper::load_a_rows<TQ>(qa, sq + 64 * c * W, warp, lane);
        hopper::load_a_rows<TQ>(doa, sdo + 64 * c * W, warp, lane);
        warp_release(empty_q);
      }

      // Pipelined: S of key tile i, dQ of tile i - 1 and dP of tile i go out
      // together; the wait for S leaves the other two running while the
      // exponentials start (ptxas waits for them after the first few, at
      // the first use of dP). The tiles that need a mask (the diagonal's,
      // the ragged last one) run in a loop of their own: no branch may sit
      // between a wgmma's issue and its wait.
      uint32_t da[DQ_BK / 16][4];  // dS of the last tile, cast to E first
      auto stage = [&](int i) { return (it + i) % DQ_STAGES; };
      auto parity = [&](int i) { return ((it + i) / DQ_STAGES) & 1; };
      auto issue_dq = [&](int i) {  // dQ += dS K of key tile i, not waited for
        const E* ks = sk + stage(i) * DQ_BK * D;
#pragma unroll
        for (int kk = 0; kk < DQ_BK / 16; ++kk)
          hopper::Wgmma<D, E>::rs(acc, da[kk], TK::mn(ks, kk * 16));
        hopper::wgmma_commit();
      };
      auto ktile = [&](auto masked, auto after_first, int i) {
        constexpr bool kAfterFirst = decltype(after_first)::value;  // a dQ product to issue
        const int s = stage(i), k0 = i * DQ_BK;
        hopper::mbar_wait(&full[s], parity(i));
        float sc[DQ_BK / 2], dp[DQ_BK / 2];  // S (then P) and dP, [64 q x 64 keys]
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        const uint64_t desc_k = TK::desc(sk + s * DQ_BK * D);
        const uint64_t desc_v = TK::desc(sv + s * DQ_BK * D);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (QDO_IN_REGS)
            hopper::Wgmma<DQ_BK, E>::rsk(sc, qa[kk], desc_k + TK::k_step(kk), kk > 0);
          else
            hopper::Wgmma<DQ_BK, E>::ss(sc, desc_qs + TQ::k_step(kk), desc_k + TK::k_step(kk), kk > 0);
        }
        hopper::wgmma_commit();
        if constexpr (kAfterFirst) issue_dq(i - 1);
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          if constexpr (QDO_IN_REGS)
            hopper::Wgmma<DQ_BK, E>::rsk(dp, doa[kk], desc_v + TK::k_step(kk), kk > 0);
          else
            hopper::Wgmma<DQ_BK, E>::ss(dp, desc_dos + TQ::k_step(kk), desc_v + TK::k_step(kk), kk > 0);
        }
        hopper::wgmma_commit();
        if constexpr (kAfterFirst)
          hopper::wgmma_wait<2>();  // S is in; dQ(i - 1) and dP may still run
        else
          hopper::wgmma_wait<1>();
        hopper::fence_regs(sc);
#pragma unroll
        for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = k0 + 8 * j + 2 * t + e;
            float pa_ = hopper::ex2(fmaf(sc[4 * j + e], sl2, -l2_a));
            float pb_ = hopper::ex2(fmaf(sc[4 * j + 2 + e], sl2, -l2_b));
            if constexpr (decltype(masked)::value) {
              if (col >= Tk || (causal && col > row_a)) pa_ = 0.f;
              if (col >= Tk || (causal && col > row_b)) pb_ = 0.f;
            }
            sc[4 * j + e] = pa_;
            sc[4 * j + 2 + e] = pb_;
          }
        }
        hopper::fence_regs(sc);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(dp);
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
        if constexpr (kAfterFirst) warp_release(&empty[stage(i - 1)]);
#pragma unroll
        for (int j = 0; j < DQ_BK / 8; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            dp[4 * j + e] = sc[4 * j + e] * fmaf(dp[4 * j + e], scale, -dl_a);  // dS
            dp[4 * j + 2 + e] = sc[4 * j + 2 + e] * fmaf(dp[4 * j + 2 + e], scale, -dl_b);
          }
        }
        pack_a_frags<DQ_BK, E>(da, dp);
      };
      // Each warpgroup takes its n_own key tiles, then the last dQ product.
      const int n_plain = min(plain_tiles<DQ_BK>(wq0, Tk, causal), n_own);
      if (n_own > 0) {
        if (n_plain > 0)
          ktile(std::false_type{}, std::false_type{}, 0);
        else
          ktile(std::true_type{}, std::false_type{}, 0);
        int i = 1;
        for (; i < n_plain; ++i) ktile(std::false_type{}, std::true_type{}, i);
        for (; i < n_own; ++i) ktile(std::true_type{}, std::true_type{}, i);
        hopper::fence_regs(acc);
        hopper::fence_regs(da);
        hopper::wgmma_fence();
        issue_dq(n_own - 1);
        hopper::wgmma_wait<0>();
        hopper::fence_regs(acc);
        warp_release(&empty[stage(n_own - 1)]);
      }
      it += n_own;
      // Key tiles past this warpgroup's rows (causal, the other warpgroup's
      // diagonal): release them once they have landed.
      for (int i = n_own; i < n_k; ++i, ++it) {
        const int s = it % DQ_STAGES;
        hopper::mbar_wait(&full[s], (it / DQ_STAGES) & 1);
        warp_release(&empty[s]);
      }
      if constexpr (!QDO_IN_REGS) warp_release(empty_q);  // the last product that read Q and dO is in
      out_dq.store(sdq + c * S::TO::BYTES / 2, acc, 1.f, 1.f, wq0, bh, tid, 1 + c);
    }
    if (tid == 0) hopper::tma_store_wait();
  }
}

// ---------------------------------------------------------------------------
// The forward above head dim 256: a cluster of column slices. Replaces
// _fwd_kernel (ray_tpu/ops/flash_attention.py:72) on bf16 or f16 inputs at
// head dims 257 to SLICE x MAX_SLICES, where a [64 x Dh] f32 accumulator no
// longer fits a warpgroup's registers. A cluster of W = ceil(Dh / SLICE)
// blocks serves one (head, ROWS q rows); block w (its rank) owns the
// columns [w SLICE, (w + 1) SLICE) of Q, K, V and O. TMA loads its Q slice
// once and streams its K and V slices (zero-filled past Dh) through a ring
// of STAGES stages (full and empty mbarriers per stage), one producer warp
// issuing; each consumer warpgroup owns 64 of the block's rows and reads
// every stage. Per stage a consumer contracts S = Q K^T over its own slice
// only (wgmma, f32 accumulator, both operands K-major in shared memory),
// hands that partial to the same warpgroup of every block of the cluster
// and sums the W partials in rank order (hopper::cluster_sum), so every
// block holds bitwise the same S; the exchange slot is the stage's K tile,
// which no product reads once both warpgroups' score products are in (a
// [64 x BK] f32 partial each: the tile's bytes at a slice of 256 columns),
// and the producer loads that tile again only once every block has read
// it. Then the online softmax in exp2 units of the instanced forward
// (fwd_max, fwd_exp: masked at the diagonal and past Tk), P rounded to E
// as the register A operand, and O += P V on the block's own slice with V
// read MN-major through the transpose bit. Each column of Q, K and V is
// loaded once a stage across the cluster and the products are the
// function's own 4 FLOPs per kept pair and head-dim element, with no
// recompute of S (the column windows computed S once a window). Each block
// writes its own columns of O (E, or f32 for the ring's block entries)
// from its registers; block 0 writes lse; no atomics, so two calls give the
// same bits. Bound on an H100: the bytes (q, k, v in, o out) at 3.35 TB/s
// or the FLOPs at 989 TFLOP/s, whichever is larger; the exchange (the
// other blocks' partials read a stage, and the wait for them) is on every
// stage's path. Above SLICE x MAX_SLICES the forward takes the column
// windows of flash_wide.cuh.
// ---------------------------------------------------------------------------

// The slices' traits: the columns a block owns (a wgmma N of the value
// product) and the cluster's portable limit, the q rows of a block (64 a
// consumer warpgroup), keys a stage, ring depth, the blocks whose partials
// a consumer reads at once (four float4s of each at a time, of a thread's
// BK / 8, hopper::cluster_sum). Clusters of up to four blocks (Dh 1024;
// wider head dims take the column windows): with up to eight, the
// exchange's reads unrolled beside the [64 x 256] accumulator spilled 12
// bytes (all eight float4s at once); with four, two or four float4s at
// once do not spill and take the same time, eight spill 12.
// Chosen by timing variants on an H100
// (python3 -m ray_tpu_torch.sweep_flash_f32 --variants fwd16, PERF.md;
// bf16, T 1024, causal, Dh 264 / 384 / 768 / 512 / 1024): 64 keys a stage
// in slices of 256 columns, the partials in K, took 0.568 / 0.374 / 0.412 /
// 0.125 / 0.176 ms, where 32 keys (three or four stages) took 0.745-0.765 /
// 0.501-0.518 / 0.520-0.527 / 0.135-0.144 / 0.207-0.216: half the
// exchanges a key; slices of 128 columns took 1.015-1.017 / 0.684-0.697 /
// 1.655-1.658 (64 keys, slots of their own; twice the blocks, each reading
// twice the partials) and 1.508 / 1.002 / 2.056 with one warpgroup of 64
// rows; reduce-scatter 0.932-0.938 / 0.632-0.634 and starting the second
// warpgroup a tile behind the first 0.741 / 0.504 (32 keys); two blocks
// read at once within 2%, with 168-188 bytes of spills.
// tests/test_torch_flash_fwd_slices.py reads this block.
struct FwdSliceTiles {
  static constexpr int SLICE = 256, MAX_SLICES = 4;
  static constexpr int ROWS = 128, BK = 64, STAGES = 2, READ_BLOCKS = 1;
};

// Q of the block's rows; the ring of K and V stages (K then holding the
// stage's exchange: a [64 x BK] f32 partial per consumer warpgroup); the
// mbarriers (Q's full; per stage K's and V's full and empty; the exchange's
// full and done per consumer warpgroup and stage).
struct SliceFwdSmem {
  using T = FwdSliceTiles;
  static constexpr int D = T::SLICE, ROWS = T::ROWS, BK = T::BK, STAGES = T::STAGES, WGS = ROWS / 64;
  using TQ = hopper::Tile<D, ROWS>;
  using TK = hopper::Tile<D, BK>;
  static constexpr int X_BYTES = 64 * BK * 4;  // a warpgroup's partial scores
  static constexpr int K_OFF = TQ::BYTES, V_OFF = K_OFF + STAGES * TK::BYTES;
  static constexpr int BAR_OFF = V_OFF + STAGES * TK::BYTES;
  static constexpr int BYTES = 1024 + BAR_OFF + 8 * (1 + 3 * STAGES + 2 * WGS * STAGES);  // + alignment slack
  static_assert(D == 128 || D == 256, "slices of 128 or 256 columns");
  static_assert(ROWS == 64 || ROWS == 128, "one or two consumer warpgroups");
  static_assert(WGS * X_BYTES <= TK::BYTES, "a stage's K tile holds the partials of its warpgroups");
  static_assert(STAGES >= 2, "a ring of at least two stages");
  static_assert(BYTES <= SMEM_LIMIT, "the forward's slices' shared memory does not fit");
};

// A warpgroup's [64 x D] f32 accumulator, scaled per row, to rows [row0,
// row0 + 64) and columns [col0, col0 + D) of a contiguous [T, dh] matrix of
// OutT (E, rounded to nearest even, or f32), rows past T and columns past dh
// not written (dh even).
template <int D, typename OutT>
__device__ __forceinline__ void store_slice(OutT* dst, const float (&acc)[D / 2], float mul_a, float mul_b, int row0,
                                            int T, int dh, int col0, int tid) {
  const int lane = tid % 32, r = row0 + 16 * (tid / 32) + (lane >> 2), c = col0 + 2 * (lane & 3);
  OutT* p = dst + (size_t)r * dh + c;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    if (8 * j + c >= dh) continue;
    if constexpr (std::is_same<OutT, float>::value) {
      if (r < T) *reinterpret_cast<float2*>(p + 8 * j) = make_float2(acc[4 * j] * mul_a, acc[4 * j + 1] * mul_a);
      if (r + 8 < T)
        *reinterpret_cast<float2*>(p + 8 * dh + 8 * j) = make_float2(acc[4 * j + 2] * mul_b, acc[4 * j + 3] * mul_b);
    } else {
      if (r < T) *reinterpret_cast<uint32_t*>(p + 8 * j) = hopper::pack2<OutT>(acc[4 * j] * mul_a, acc[4 * j + 1] * mul_a);
      if (r + 8 < T)
        *reinterpret_cast<uint32_t*>(p + 8 * dh + 8 * j) =
            hopper::pack2<OutT>(acc[4 * j + 2] * mul_b, acc[4 * j + 3] * mul_b);
    }
  }
}

// The key tiles warpgroup c of a block at q0 computes (its rows' diagonal;
// none for rows all past Tq): the same in every block of the cluster.
template <int BK>
__device__ __forceinline__ int own_tiles(int q0, int c, int Tq, int Tk, int causal) {
  const int r0 = q0 + 64 * c;
  return r0 < Tq ? key_tiles<BK>(r0 + 63, Tk, causal) : 0;
}

template <typename E, typename OutT>
__global__ void __launch_bounds__(Roles<FwdSliceTiles::ROWS / 64>::THREADS, 1)
flash_fwd_slices_kernel(const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v, OutT* __restrict__ o, float* __restrict__ lse,
                        int Tq, int Tk, int dh, float scale, int causal) {
  using S = SliceFwdSmem;
  using TQ = S::TQ;
  using TK = S::TK;
  using R = Roles<S::WGS>;
  constexpr int D = S::D, BK = S::BK, STAGES = S::STAGES, ROWS = S::ROWS, WGS = S::WGS, W = TQ::W;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_base(smem_raw);
  E* sq = reinterpret_cast<E*>(base);
  E* sk = reinterpret_cast<E*>(base + S::K_OFF);
  E* sv = reinterpret_cast<E*>(base + S::V_OFF);
  uint64_t* full_q = reinterpret_cast<uint64_t*>(base + S::BAR_OFF);
  uint64_t* full_k = full_q + 1;
  uint64_t* full_v = full_k + STAGES;
  uint64_t* empty = full_v + STAGES;
  uint64_t* xfull = empty + STAGES;       // [WGS][STAGES]: every block's partials are in
  uint64_t* xdone = xfull + WGS * STAGES;  // [WGS][STAGES]: every block has read this one's
  const uint32_t blocks = hopper::cluster_size(), rank = hopper::cluster_rank();
  const int bh = blockIdx.x / blocks, col0 = rank * D;
  // Causal: the longest rows first (blocks start in order of blockIdx.y).
  const int qt = causal ? gridDim.y - 1 - blockIdx.y : blockIdx.y;
  const int q0 = qt * ROWS, n_k = key_tiles<BK>(q0 + ROWS - 1, Tk, causal);

  if (threadIdx.x == 0) {
    hopper::mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init(&full_k[s], 1);
      hopper::mbar_init(&full_v[s], 1);
      hopper::mbar_init(&empty[s], R::CONSUMER_WARPS);
    }
    for (int x = 0; x < 2 * WGS * STAGES; ++x) hopper::mbar_init(&xfull[x], 4 * blocks);
    hopper::fence_barrier_init();
  }
  hopper::cluster_sync();  // every block's barriers exist before another block arrives on them

  const int wg = threadIdx.x / WG_THREADS;
  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<R::PRODUCER_REGS>();
    if (threadIdx.x == 0) {
      hopper::mbar_arrive_expect_tx(full_q, TQ::BYTES);
      hopper::tma_load_tile<TQ>(sq, &tm_q, full_q, q0, bh, col0);
      for (int i = 0; i < n_k; ++i) {
        const int s = i % STAGES;
        hopper::mbar_wait(&empty[s], ((i / STAGES) & 1) ^ 1);
        // K is the stage's exchange slot: every block has read the
        // partials each warpgroup left there for tile i - STAGES
        for (int c = 0; c < WGS; ++c)
          if (i >= STAGES && i - STAGES < own_tiles<BK>(q0, c, Tq, Tk, causal))
            hopper::mbar_wait_cluster(&xdone[c * STAGES + s], ((i / STAGES) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full_k[s], TK::BYTES);
        hopper::tma_load_tile<TK>(sk + s * BK * D, &tm_k, &full_k[s], i * BK, bh, col0);
        hopper::mbar_arrive_expect_tx(&full_v[s], TK::BYTES);
        hopper::tma_load_tile<TK>(sv + s * BK * D, &tm_v, &full_v[s], i * BK, bh, col0);
      }
    }
    hopper::cluster_sync();  // no block leaves while another may still read its exchange slots
  } else {  // consumers: 64 q rows each, every stage
    hopper::setmaxnreg_inc<R::CONSUMER_REGS>();
    const int c = wg - 1, tid = threadIdx.x - wg * WG_THREADS;
    const int warp = tid / 32, lane = tid % 32, g = lane >> 2, t = lane & 3;
    const int wq0 = q0 + 64 * c;  // this warpgroup's first row
    const int row_a = wq0 + 16 * warp + g, row_b = row_a + 8;
    const float sl2 = scale * LOG2E;
    const int n_own = own_tiles<BK>(q0, c, Tq, Tk, causal);
    // The tiles every warpgroup computes: warpgroup 0's under a causal mask,
    // none where warpgroup 1's rows all lie past Tq.
    const int n_both = min(own_tiles<BK>(q0, 0, Tq, Tk, causal), own_tiles<BK>(q0, WGS - 1, Tq, Tk, causal));
    const int n_plain = min(plain_tiles<BK>(wq0, Tk, causal), n_own);
    float m_a = -INFINITY, m_b = -INFINITY;  // running max of s * scale * log2(e)
    float l_a = 0.f, l_b = 0.f;              // this thread's share of the normaliser
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    hopper::mbar_wait(full_q, 0);
    auto tile = [&](auto masked, int i) {
      const int s = i % STAGES, x = c * STAGES + s;
      float sp[1][BK / 2], alpha_a, alpha_b;  // this slice's S, then the cluster's; -> P
      float(&sc)[BK / 2] = sp[0];
      hopper::mbar_wait(&full_k[s], (i / STAGES) & 1);
      E* ks = sk + s * BK * D;
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk)
        hopper::Wgmma<BK, E>::ss(sc, TQ::desc(sq + 64 * c * W) + TQ::k_step(kk), TK::desc(ks) + TK::k_step(kk),
                                 kk > 0);
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(sc);
      // every warpgroup's score product has read K before K holds partials
      if (WGS > 1 && i < n_both) hopper::bar_sync(1, WGS * WG_THREADS);
      hopper::cluster_sum<BK, 1, FwdSliceTiles::READ_BLOCKS, FwdSliceTiles::MAX_SLICES>(
          sp, reinterpret_cast<uint8_t*>(ks) + c * S::X_BYTES, &xfull[x], &xdone[x], (i / STAGES) & 1, tid, blocks,
          rank);
      fwd_max<decltype(masked)::value, BK>(sc, m_a, m_b, alpha_a, alpha_b, i * BK, Tk, row_a, t, sl2, causal);
      fwd_exp<BK>(sc, m_a, m_b, l_a, l_b, alpha_a, alpha_b, sl2);
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        acc[4 * j] *= alpha_a;
        acc[4 * j + 1] *= alpha_a;
        acc[4 * j + 2] *= alpha_b;
        acc[4 * j + 3] *= alpha_b;
      }
      uint32_t pa[BK / 16][4];  // P in E (cast before p@v, as in JAX)
      pack_a_frags<BK, E>(pa, sc);
      hopper::mbar_wait(&full_v[s], (i / STAGES) & 1);
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      const E* vs = sv + s * BK * D;
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk) hopper::Wgmma<D, E>::rs(acc, pa[kk], TK::mn(vs, kk * 16));
      hopper::wgmma_commit();
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      warp_release(&empty[s]);
    };
    int i = 0;
    for (; i < n_plain; ++i) tile(std::false_type{}, i);
    for (; i < n_own; ++i) tile(std::true_type{}, i);
    // Key tiles past this warpgroup's rows (causal, the other warpgroup's
    // diagonal): released once they have landed, with no exchange.
    for (; i < n_k; ++i) {
      const int s = i % STAGES;
      hopper::mbar_wait(&full_v[s], (i / STAGES) & 1);
      warp_release(&empty[s]);
    }
    if (n_own > 0) {
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
        l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
      }
      store_slice<D, OutT>(o + (size_t)bh * Tq * dh, acc, 1.f / l_a, 1.f / l_b, wq0, Tq, dh, col0, tid);
      if (rank == 0 && t == 0) {  // lse in natural log: (m + log2 l) ln 2
        float* lse_bh = lse + (size_t)bh * Tq;
        if (row_a < Tq) lse_bh[row_a] = (m_a + log2f(l_a)) * LN2;
        if (row_b < Tq) lse_bh[row_b] = (m_b + log2f(l_b)) * LN2;
      }
    }
    hopper::cluster_sync();
  }
}

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Pointers are device pointers of
// contiguous [bh, T, d] tensors (RT_OPERAND operands, bf16 or f16; outputs
// of that type, or f32 when out_f32 is set) and f32 [bh, Tq] lse/delta; the stream is the caller's
// cudaStream_t. d is the tensors' head dim, a multiple of 8: up to 256 it
// runs on the instance of the narrowest head dim of 16, 32, 64, 128 and 256
// that holds it, above 256 on the forward's clusters of column slices (up
// to FwdSliceTiles' limit) or the column-window kernels of flash_wide.cuh;
// scale is the caller's (1 / sqrt(d)). Each returns cudaGetLastError() after
// the launch (cudaErrorInvalidValue for a head dim no kernel takes, or a
// tensor map cuTensorMapEncodeTiled refuses).
// ---------------------------------------------------------------------------
extern "C" const char* rt_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

// Persistent grids: one block per SM of the current device, or fewer when
// there is less work.
static int persistent_grid(int n_units) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return n_units < sms ? n_units : sms;
}

// Calls launch(instance head dim, output type) with the instance's head dim
// as an std::integral_constant and the output type (the operands' E, or
// f32) as a Type tag, for the instance that serves head dim d (above 256,
// SLICES where the kernel's clusters take d (`slices`, its blocks there:
// the forward up to FwdSliceTiles' limit; 0 for dQ and dK/dV), a cluster of
// column slices; else WIDE, the column-window kernels);
// cudaErrorInvalidValue for a d none takes.
constexpr int WIDE = 0, SLICES = -1;
template <class T>
struct Type {
  using type = T;
};
template <class E, class F>
static int by_head_dim(int d, int slices, int out_f32, F launch) {
  auto with = [&](auto dd) { return out_f32 ? launch(dd, Type<float>{}) : launch(dd, Type<E>{}); };
  if (d < 1 || d % 8 != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 16) return with(std::integral_constant<int, 16>{});
  if (d <= 32) return with(std::integral_constant<int, 32>{});
  if (d <= 64) return with(std::integral_constant<int, 64>{});
  if (d <= 128) return with(std::integral_constant<int, 128>{});
  if (d <= 256) return with(std::integral_constant<int, 256>{});
  if (slices > 0) return with(std::integral_constant<int, SLICES>{});
  return with(std::integral_constant<int, WIDE>{});
}

// The output rows of a [bh, T, dh] tensor at p, as OutRows describes them.
template <int D, typename E>
static bool out_rows(OutRows<D, E>& out, void* p, int bh, int T, int dh) {
  return hopper::rows_map(&out.map, p, bh, T, dh, D, 64, hopper::tma_type<E>());
}
template <int D>
static bool out_rows(OutRows<D, float>& out, void* p, int, int T, int dh) {
  out.ptr = static_cast<float*>(p);
  out.T = T;
  out.dh = dh;
  return true;
}

template <int D, typename E, typename OutT>
static int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                      int tq, int tk, int dh, float scale, int causal, cudaStream_t st) {
  CUtensorMap tq_map, tk_map, tv_map;
  OutRows<D, OutT> o_rows;
  constexpr int bk = FwdSmem<D>::BK;
  if (!hopper::rows_map(&tq_map, q, bh, tq, dh, D, FWD_BQ, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tk_map, k, bh, tk, dh, D, bk, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tv_map, v, bh, tk, dh, D, bk, hopper::tma_type<E>()) || !out_rows(o_rows, o, bh, tq, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = FwdSmem<D>::LAUNCH, threads = Roles<FWD_WGS>::THREADS;
  cudaFuncSetAttribute(flash_fwd_kernel<D, E, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int grid = persistent_grid(units_of((tq + FWD_BQ - 1) / FWD_BQ, bh, causal));
  flash_fwd_kernel<D, E, OutT><<<grid, threads, smem, st>>>(tq_map, tk_map, tv_map, o_rows,
                                                            static_cast<float*>(lse), bh, tq, tk,
                                                            scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <typename E, typename OutT>
static int launch_fwd_slices(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq,
                             int tk, int dh, float scale, int causal, cudaStream_t st) {
  using S = SliceFwdSmem;
  CUtensorMap tq_map, tk_map, tv_map;
  if (!hopper::rows_map(&tq_map, q, bh, tq, dh, S::D, S::ROWS, hopper::tma_type<E>(), true) ||
      !hopper::rows_map(&tk_map, k, bh, tk, dh, S::D, S::BK, hopper::tma_type<E>(), true) ||
      !hopper::rows_map(&tv_map, v, bh, tk, dh, S::D, S::BK, hopper::tma_type<E>(), true) || dh % 2 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = hopper::slice_blocks<FwdSliceTiles>(dh);
  return hopper::launch_cluster(flash_fwd_slices_kernel<E, OutT>, dim3(bh * blocks, (tq + S::ROWS - 1) / S::ROWS),
                                Roles<S::WGS>::THREADS, blocks, S::BYTES, st, tq_map, tk_map, tv_map,
                                static_cast<OutT*>(o), static_cast<float*>(lse), tq, tk, dh, scale, causal);
}

// The forward slices' dynamic shared memory a block (SliceFwdSmem::BYTES).
extern "C" int rt_fwd_slices_smem_bytes() { return SliceFwdSmem::BYTES; }

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                            int tq, int tk, int d, float scale, int causal, int out_f32,
                            void* stream) {
  return by_head_dim<RT_OPERAND>(d, hopper::slice_blocks<FwdSliceTiles>(d), out_f32, [&](auto dd, auto out) {
    using OutT = typename decltype(out)::type;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value == SLICES)
      return launch_fwd_slices<RT_OPERAND, OutT>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
    else if constexpr (decltype(dd)::value == WIDE)
      return wide::launch_fwd<RT_OPERAND, OutT, false>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, 0, st);
    else
      return launch_fwd<decltype(dd)::value, RT_OPERAND, OutT>(q, k, v, o, lse, bh, tq, tk, d, scale, causal, st);
  });
}

template <int D, typename E, typename OutT>
static int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                     const void* delta, void* dq, int bh, int tq, int tk, int dh, float scale,
                     int causal, cudaStream_t st) {
  CUtensorMap tq_map, tk_map, tv_map, tdo_map;
  OutRows<D, OutT> dq_rows;
  constexpr int bk = DqSmem<D>::BK;
  if (!hopper::rows_map(&tq_map, q, bh, tq, dh, D, DQ_BQ, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tk_map, k, bh, tk, dh, D, bk, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tv_map, v, bh, tk, dh, D, bk, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tdo_map, dout, bh, tq, dh, D, DQ_BQ, hopper::tma_type<E>()) || !out_rows(dq_rows, dq, bh, tq, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = DqSmem<D>::LAUNCH, threads = Roles<DQ_WGS>::THREADS;
  cudaFuncSetAttribute(flash_dq_kernel<D, E, OutT>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int grid = persistent_grid(units_of((tq + DQ_BQ - 1) / DQ_BQ, bh, causal));
  flash_dq_kernel<D, E, OutT><<<grid, threads, smem, st>>>(tq_map, tk_map, tv_map, tdo_map, dq_rows,
                                                           static_cast<const float*>(lse),
                                                           static_cast<const float*>(delta), bh, tq,
                                                           tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                           int d, float scale, int causal, int out_f32, void* stream) {
  return by_head_dim<RT_OPERAND>(d, 0, out_f32, [&](auto dd, auto out) {
    using OutT = typename decltype(out)::type;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value <= WIDE)  // windows; slices 0: never SLICES
      return wide::launch_dq<RT_OPERAND, OutT, false>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale, causal,
                                                       0, st);
    else
      return launch_dq<decltype(dd)::value, RT_OPERAND, OutT>(q, k, v, dout, lse, delta, dq, bh, tq, tk, d, scale,
                                                              causal, st);
  });
}

// One launch of dK/dV's pass PASS (0: both gradients; 1: dV; 2: dK).
template <int D, typename E, typename OutT, int PASS>
static int launch_dkv_pass(const CUtensorMap& tq_map, const CUtensorMap& tk_map, const CUtensorMap& tv_map,
                           const CUtensorMap& tdo_map, const OutRows<D, OutT>& dk_rows,
                           const OutRows<D, OutT>& dv_rows, const void* lse, const void* delta, int bh,
                           int tq, int tk, float scale, int causal, cudaStream_t st) {
  constexpr int smem = DkvSmem<D>::LAUNCH, threads = Roles<2>::THREADS;
  cudaFuncSetAttribute(flash_dkv_kernel<D, E, OutT, PASS>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const int grid = persistent_grid(units_of((tk + DKV_BK - 1) / DKV_BK, bh, causal));
  flash_dkv_kernel<D, E, OutT, PASS><<<grid, threads, smem, st>>>(
      tq_map, tk_map, tv_map, tdo_map, dk_rows, dv_rows, static_cast<const float*>(lse),
      static_cast<const float*>(delta), bh, tq, tk, scale, causal);
  return static_cast<int>(cudaGetLastError());
}

template <int D, typename E, typename OutT>
static int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
                      const void* delta, void* dk, void* dv, int bh, int tq, int tk, int dh, float scale,
                      int causal, cudaStream_t st) {
  CUtensorMap tq_map, tk_map, tv_map, tdo_map;
  OutRows<D, OutT> dk_rows, dv_rows;
  constexpr int bq = DkvSmem<D>::BQ;
  if (!hopper::rows_map(&tq_map, q, bh, tq, dh, D, bq, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tk_map, k, bh, tk, dh, D, DKV_BK, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tv_map, v, bh, tk, dh, D, DKV_BK, hopper::tma_type<E>()) ||
      !hopper::rows_map(&tdo_map, dout, bh, tq, dh, D, bq, hopper::tma_type<E>()) || !out_rows(dk_rows, dk, bh, tk, dh) ||
      !out_rows(dv_rows, dv, bh, tk, dh))
    return static_cast<int>(cudaErrorInvalidValue);
  if constexpr (Tiles<D>::DKV_PASSES == 1) {
    return launch_dkv_pass<D, E, OutT, 0>(tq_map, tk_map, tv_map, tdo_map, dk_rows, dv_rows, lse, delta, bh, tq,
                                       tk, scale, causal, st);
  } else {
    const int err = launch_dkv_pass<D, E, OutT, 1>(tq_map, tk_map, tv_map, tdo_map, dk_rows, dv_rows, lse, delta,
                                                bh, tq, tk, scale, causal, st);
    if (err != 0) return err;
    return launch_dkv_pass<D, E, OutT, 2>(tq_map, tk_map, tv_map, tdo_map, dk_rows, dv_rows, lse, delta, bh, tq,
                                       tk, scale, causal, st);
  }
}

extern "C" int rt_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                            int tk, int d, float scale, int causal, int out_f32, void* stream) {
  return by_head_dim<RT_OPERAND>(d, 0, out_f32, [&](auto dd, auto out) {
    using OutT = typename decltype(out)::type;
    const cudaStream_t st = static_cast<cudaStream_t>(stream);
    if constexpr (decltype(dd)::value <= WIDE)  // windows; slices 0: never SLICES
      return wide::launch_dkv<RT_OPERAND, OutT, false>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d, scale,
                                                        causal, 0, 0, st);
    else
      return launch_dkv<decltype(dd)::value, RT_OPERAND, OutT>(q, k, v, dout, lse, delta, dk, dv, bh, tq, tk, d,
                                                               scale, causal, st);
  });
}
