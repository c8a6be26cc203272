// Flash attention at head dims above 256 (sm_90a): forward, dQ and dK/dV
// by column windows. Included by flash_attention.cu (16-bit operands E, bf16
// or f16) and flash_attention_f32.cu (f32 operands, and with ROUND the mixed
// dtypes), whose entry points send every head dim above 256 here; each of
// the four libraries so holds the three kernels for its operands.
//
// They replace the Pallas kernels _fwd_kernel, _dq_kernel and _dkv_kernel
// (ray_tpu/ops/flash_attention.py:72, :135, :168), which take any head dim
// (their BlockSpecs are (None, block, D) with D the operands' own), where
// the instanced kernels of the two sources stop at 256: one of their [64 x
// D] f32 accumulators takes D / 2 registers a thread, and the rows of a
// block's own tiles no longer fit in shared memory. The functions are the
// Pallas kernels', with their rounding points: P rounded to v's dtype
// before P V (forward), dS to k's before dS K (dQ), P to dO's before P^T dO
// and dS to q's before dS^T Q (dK/dV); the 16-bit operands' kernels round to
// E, the f32 ones to ROUND's runtime type (none, bf16 or f16); the scale is
// the caller's, 1 / sqrt(the true head dim).
//
// Design. Every kernel writes a [rows x D] result (O, dQ: q rows; dK, dV:
// keys) as windows of output columns: window w holds columns [w WIN, (w +
// 1) WIN) (WIN 256 for O and dQ, 128 for dK and dV, whose two accumulators
// a thread holds at once), and a block owns one (head, 64 rows, window):
// the window is a grid dimension (z), so at Dh 768 with one head the
// windows of a row block run on different SMs at once. Each window
// recomputes what its columns need over the whole head dim: S = Q K^T (and
// dP = dO V^T, or S^T and dP^T in dK/dV), contracted in chunks of 128
// bytes of each row (64 16-bit or 32 f32 columns), and only its own columns
// of the products that write the result (P V, dS K, P^T dO, dS^T Q). The
// chunks stream through two shared-memory buffers by cp.async (16-byte
// copies, zero-filled past T and past D), one chunk in flight while the
// previous one is multiplied; the value tile of a key (or q) tile, [keys x
// WIN] of V (forward), K (dQ), or Q and dO (dK/dV), comes after the last
// chunk. The chunks run in the same order in every window, with the same
// code and the same data, so every window computes bitwise the same S, P
// and dS, and the columns of one result agree with each other.
// Products: mma.sync on the tensor cores, a warp's 16 rows at a time (four
// warps, 64 rows a block): m16n8k16 on bf16 or f16 operands with f32
// accumulation, and 3xTF32 on f32 operands (each operand split into big =
// tf32(x) and small = tf32(x - big) in registers, big.small + small.big +
// big.big into one f32 accumulator, flash_attention_f32.cu's order) with
// m16n8k8. The S (or dP) accumulator of one product is the register A
// operand of the next (P, dS), as in the instanced kernels; in 3xTF32 the
// keys of a k-step are taken in the order the accumulator holds them (k
// slots t and t + 4 hold keys 2t and 2t + 1), and the B operand read in the
// same order, so no shuffle. The forward keeps the instanced kernels'
// online softmax in exp2 units (every window runs it the same way; window 0
// writes lse). The backward kernels use no atomics: each block writes only
// its own rows and columns, so two calls give the same bits.
// Bound on an H100 SXM: the function's FLOPs (4, 6 and 8 per kept (q, key)
// pair and head-dim element) at 989 TFLOP/s (16-bit) or 165 (3xTF32), or
// its bytes at 3.35 TB/s; the windows' recompute of S (and dP) adds
// products the bound does not count (1.5x the forward's at Dh 384, 2x at
// 768). A simple kernel: synchronous mma.sync, the reloaded
// chunks and the recompute keep it well above that bound (PERF.md).

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {
namespace wide {

constexpr int THREADS = 128;               // four warps, 16 rows each
constexpr int ROWS = 64;                   // a block's own rows: q rows (forward, dQ) or keys (dK/dV)
constexpr int CHUNK_BYTES = 128;           // a contraction chunk of one row: 64 16-bit or 32 f32 columns
constexpr int CHUNK_STRIDE = CHUNK_BYTES + 16;  // padded rows: fragment reads free of bank conflicts
constexpr int FWD_WIN = 256, DQ_WIN = 256, DKV_WIN = 128;  // output columns a window
constexpr int FWD_BK = 64, DQ_BK = 32, DKV_BQ = 32;        // keys (forward, dQ) or q rows (dK/dV) a tile
// The f32 forward's key tile: its 3xTF32 operands' splits and the score
// chunks' partial sums leave no room for 64 keys' scores beside a [16 x
// 256] accumulator (ptxas spilled at 64).
constexpr int FWD_BK_F32 = 32;
template <class E>
__host__ __device__ constexpr int fwd_bk() { return sizeof(E) == 4 ? FWD_BK_F32 : FWD_BK; }
constexpr float LOG2E = 1.4426950408889634f, LN2 = 0.6931471805599453f;

__host__ __device__ constexpr int windows(int d, int win) { return (d + win - 1) / win; }
// A value tile's row: a window of E, padded by 16 bytes (a row stride of 4
// mod 32 banks).
template <class E, int WIN>
__host__ __device__ constexpr int value_stride() { return WIN * (int)sizeof(E) + 16; }

__device__ __forceinline__ void cp16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(hopper::smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Rows [row0, row0 + rows) x columns [col0, col0 + cols) of one head's
// [T, D] rows into a shared tile of `stride` bytes a row, by 16-byte
// copies of the whole block; rows past T and columns past D are zero-filled
// (D and cols are multiples of 16 bytes of E).
template <class E>
__device__ __forceinline__ void load_rows(uint8_t* dst, int stride, const E* head, int T, int D, int row0,
                                          int rows, int col0, int cols) {
  constexpr int PER = 16 / sizeof(E);
  const int segs = cols / PER;
  for (int i = threadIdx.x; i < rows * segs; i += THREADS) {
    const int r = i / segs, c = col0 + (i - r * segs) * PER, row = row0 + r;
    const bool ok = row < T && c < D;
    cp16(dst + r * stride + (c - col0) * (int)sizeof(E), ok ? head + (size_t)row * D + c : head, ok);
  }
}

__device__ __forceinline__ uint32_t lds32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }
__device__ __forceinline__ float ldsf(const uint8_t* p) { return *reinterpret_cast<const float*>(p); }

template <class E>
__device__ __forceinline__ void mma16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  if constexpr (std::is_same<E, __half>::value) {
    asm("mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    static_assert(std::is_same<E, __nv_bfloat16>::value, "bf16 or f16 operands");
    asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
        "{%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// An f32 A (four values) or B (two) fragment split for 3xTF32.
template <int N>
struct Split {
  uint32_t big[N], small[N];
};
template <int N>
__device__ __forceinline__ Split<N> split(const float (&x)[N]) {
  Split<N> s;
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::tf32_split(x[i], s.big[i], s.small[i]);
  return s;
}
__device__ __forceinline__ void mma3(float (&d)[4], const Split<4>& a, const Split<2>& b) {
  mma_tf32(d, a.big, b.small[0], b.small[1]);
  mma_tf32(d, a.small, b.big[0], b.big[1]);
  mma_tf32(d, a.big, b.big[0], b.big[1]);
}

// c[NT][4] += A B^T over one chunk: A the 16 rows of a row-major chunk tile
// at `a` (this warp's), B the NT x 8 rows of one at `b`; each thread holds
// rows g and g + 8 of the accumulator, columns 8j + 2t and 8j + 2t + 1 of
// n-tile j (the mma.sync layout). S = Q K^T, dP = dO V^T, S^T = K Q^T and
// dP^T = V dO^T all take this shape.
template <class E, int NT>
__device__ __forceinline__ void product_rows(float (&c)[NT][4], const uint8_t* a, const uint8_t* b) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(E) == 2) {
#pragma unroll
    for (int kk = 0; kk < CHUNK_BYTES / 32; ++kk) {  // k-steps of 16 columns (32 bytes)
      const int col = 32 * kk + 4 * t;               // byte of columns 16kk + 2t, + 1
      const uint32_t fa[4] = {lds32(a + g * CHUNK_STRIDE + col), lds32(a + (g + 8) * CHUNK_STRIDE + col),
                              lds32(a + g * CHUNK_STRIDE + col + 16),
                              lds32(a + (g + 8) * CHUNK_STRIDE + col + 16)};
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        const uint8_t* row = b + (8 * j + g) * CHUNK_STRIDE + col;
        mma16<E>(c[j], fa, lds32(row), lds32(row + 16));
      }
    }
  } else {
#pragma unroll
    for (int kk = 0; kk < CHUNK_BYTES / 32; ++kk) {  // k-steps of 8 columns (32 bytes)
      const int col = 32 * kk + 4 * t;               // byte of column 8kk + t
      const float xa[4] = {ldsf(a + g * CHUNK_STRIDE + col), ldsf(a + (g + 8) * CHUNK_STRIDE + col),
                           ldsf(a + g * CHUNK_STRIDE + col + 16), ldsf(a + (g + 8) * CHUNK_STRIDE + col + 16)};
      const Split<4> fa = split(xa);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        // the k-step's three products into a zeroed partial, added to c in
        // f32: the tensor cores add a product into their accumulator
        // rounding toward zero, and chained into c over the hundreds of
        // k-steps of a long head dim those roundings pile up one way (lse
        // sat 1.1e-5 from the f32 plain version's at Dh 512 on an H100, over
        // the f32 limit of 1e-5); c's additions round to nearest
        const uint8_t* row = b + (8 * j + g) * CHUNK_STRIDE + col;
        const float xb[2] = {ldsf(row), ldsf(row + 16)};
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma3(part, fa, split(xb));
#pragma unroll
        for (int i = 0; i < 4; ++i) c[j][i] += part[i];
      }
    }
  }
}

// acc[NW][4] += C X over KEYS rows: C this warp's [16 x KEYS] accumulator
// (P or dS, rounded into the operands' type first: E, or hopper::rounded's
// `to`), X
// the value tile at `x` ([KEYS x WIN] of E, `stride` bytes a row), for the
// window's first `ncols` columns only (its n-tiles past them stay as they
// are). P V, dS K, P^T dO and dS^T Q take this shape.
template <class E, bool ROUND, int KEYS, int WIN>
__device__ __forceinline__ void product_values(float (&acc)[WIN / 8][4], const float (&c)[KEYS / 8][4],
                                               const uint8_t* x, int stride, int ncols, int to) {
  const int lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  if constexpr (sizeof(E) == 2) {
    // keys 16kk .. 16kk + 15 (n-tiles 2kk and 2kk + 1 of C) as the A
    // fragment; B by ldmatrix.trans, two n-tiles at a time: lanes 0-15 give
    // the rows of columns 16p .. 16p + 7, lanes 16-31 of 16p + 8 ..
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint32_t fa[4] = {hopper::pack2<E>(c[2 * kk][0], c[2 * kk][1]),
                              hopper::pack2<E>(c[2 * kk][2], c[2 * kk][3]),
                              hopper::pack2<E>(c[2 * kk + 1][0], c[2 * kk + 1][1]),
                              hopper::pack2<E>(c[2 * kk + 1][2], c[2 * kk + 1][3])};
      const uint8_t* rows = x + (16 * kk + (lane & 15)) * stride + 16 * (lane >> 4);
#pragma unroll
      for (int p = 0; p < WIN / 16; ++p) {
        if (16 * p < ncols) {
          uint32_t b0, b1, b2, b3;
          asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
                       : "=r"(b0), "=r"(b1), "=r"(b2), "=r"(b3)
                       : "r"(hopper::smem_u32(rows + 32 * p))
                       : "memory");
          mma16<E>(acc[2 * p], fa, b0, b1);
          if (16 * p + 8 < ncols) mma16<E>(acc[2 * p + 1], fa, b2, b3);
        }
      }
    }
  } else {
    // keys 8kk .. 8kk + 7 (n-tile kk of C): k slot t holds key 2t and slot
    // t + 4 key 2t + 1, in A (as C holds them) and in B alike
#pragma unroll
    for (int kk = 0; kk < KEYS / 8; ++kk) {
      const float xa[4] = {hopper::rounded<ROUND>(c[kk][0], to), hopper::rounded<ROUND>(c[kk][2], to),
                           hopper::rounded<ROUND>(c[kk][1], to), hopper::rounded<ROUND>(c[kk][3], to)};
      const Split<4> fa = split(xa);
      const uint8_t* rows = x + (8 * kk + 2 * t) * stride + 4 * g;
#pragma unroll
      for (int j = 0; j < WIN / 8; ++j) {
        if (8 * j < ncols) {
          const float xb[2] = {ldsf(rows + 32 * j), ldsf(rows + stride + 32 * j)};
          mma3(acc[j], fa, split(xb));
        }
      }
    }
  }
}

// Rows row_a and row_a + 8 of a warp's [16 x WIN] accumulator, scaled by
// mul_a and mul_b, into columns [w0, w0 + ncols) of one head's [T, D] rows
// of OutT (E, or f32); rows past T are not written.
template <class E, class OutT, int WIN>
__device__ __forceinline__ void store_rows(OutT* head, const float (&acc)[WIN / 8][4], float mul_a, float mul_b,
                                           int row_a, int T, int D, int w0, int ncols) {
  const int t = threadIdx.x % 4;
#pragma unroll
  for (int j = 0; j < WIN / 8; ++j) {
    const int col = 8 * j + 2 * t;
    if (col >= ncols) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row_a + 8 * h;
      const float mul = h ? mul_b : mul_a;
      if (row >= T) continue;
      OutT* dst = head + (size_t)row * D + w0 + col;
      if constexpr (std::is_same<OutT, float>::value)
        *reinterpret_cast<float2*>(dst) = make_float2(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
      else
        *reinterpret_cast<uint32_t*>(dst) = hopper::pack2<E>(acc[j][2 * h] * mul, acc[j][2 * h + 1] * mul);
    }
  }
}

// Shared memory of each kernel: two chunk buffers (the rows of every
// operand a chunk contracts), then the value tile(s).
template <class E>
struct FwdPlan {  // a buffer: 64 Q rows, a key tile's K rows; the V window
  static constexpr int BUF = (ROWS + fwd_bk<E>()) * CHUNK_STRIDE, V_OFF = 2 * BUF;
  static constexpr int BYTES = V_OFF + fwd_bk<E>() * value_stride<E, FWD_WIN>();
};
template <class E>
struct DqPlan {  // a buffer: 64 Q rows, 64 dO rows, 32 K rows, 32 V rows; the K window
  static constexpr int BUF = (2 * ROWS + 2 * DQ_BK) * CHUNK_STRIDE, K_OFF = 2 * BUF;
  static constexpr int BYTES = K_OFF + DQ_BK * value_stride<E, DQ_WIN>();
};
template <class E>
struct DkvPlan {  // a buffer: 64 K rows, 64 V rows, 32 Q rows, 32 dO rows; the Q and dO windows
  static constexpr int BUF = (2 * ROWS + 2 * DKV_BQ) * CHUNK_STRIDE, Q_OFF = 2 * BUF;
  static constexpr int DO_OFF = Q_OFF + DKV_BQ * value_stride<E, DKV_WIN>();
  static constexpr int BYTES = DO_OFF + DKV_BQ * value_stride<E, DKV_WIN>();
};

// ---------------------------------------------------------------------------
// Forward: a block owns (head, 64 q rows, a window of O's columns) and walks
// the key tiles of 64 keys (32 on f32 operands) up to the diagonal (causal)
// or Tk.
// ---------------------------------------------------------------------------
template <class E, class OutT, bool ROUND>
__global__ void __launch_bounds__(THREADS)
    flash_wide_fwd_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                          OutT* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, int D, float scale,
                          int causal, int round_p) {
  using P = FwdPlan<E>;
  constexpr int BK = fwd_bk<E>(), WIN = FWD_WIN, CC = CHUNK_BYTES / sizeof(E), VS = value_stride<E, WIN>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;  // the longest (causal) first
  const int bh = blockIdx.y, w0 = blockIdx.z * WIN, ncols = min(WIN, D - w0);
  const E* qh = q + (size_t)bh * Tq * D;
  const E* kh = k + (size_t)bh * Tk * D;
  const E* vh = v + (size_t)bh * Tk * D;
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  const int n_chunks = (D + CC - 1) / CC;
  const int n_k = ((causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk) + BK - 1) / BK;
  const float sl2 = scale * LOG2E;
  uint8_t* vt = smem + P::V_OFF;

  int loaded = 0, taken = 0;  // chunk loads started and consumed, in the order the two buffers take them
  auto load_chunk = [&](int kt, int c) {
    uint8_t* buf = smem + (loaded++ & 1) * P::BUF;
    load_rows<E>(buf, CHUNK_STRIDE, qh, Tq, D, q0, ROWS, c * CC, CC);
    load_rows<E>(buf + ROWS * CHUNK_STRIDE, CHUNK_STRIDE, kh, Tk, D, kt * BK, BK, c * CC, CC);
    commit();
  };

  float acc[WIN / 8][4] = {};
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.f, l_b = 0.f;
  load_chunk(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    float s[BK / 8][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(kt, c + 1);
      } else {  // the V window of this key tile
        load_rows<E>(vt, VS, vh, Tk, D, kt * BK, BK, w0, ncols);
        commit();
      }
      wait_group<1>();
      __syncthreads();
      const uint8_t* buf = smem + (taken++ & 1) * P::BUF;
      product_rows<E, BK / 8>(s, buf + 16 * warp * CHUNK_STRIDE, buf + ROWS * CHUNK_STRIDE);
      __syncthreads();
    }
    const bool more = kt + 1 < n_k;
    if (more) load_chunk(kt + 1, 0);
    // online softmax of the tile (masked past Tk and, causal, past the row)
    float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kt * BK + 8 * j + 2 * t + e;
        if (col >= Tk || (causal && col > row_a)) s[j][e] = -INFINITY;
        if (col >= Tk || (causal && col > row_b)) s[j][2 + e] = -INFINITY;
        mx_a = fmaxf(mx_a, s[j][e]);
        mx_b = fmaxf(mx_b, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float mn_a = fmaxf(m_a, mx_a * sl2), mn_b = fmaxf(m_b, mx_b * sl2);
    const float alpha_a = hopper::ex2(m_a - mn_a), alpha_b = hopper::ex2(m_b - mn_b);
    m_a = mn_a;
    m_b = mn_b;
    float ps_a = 0.f, ps_b = 0.f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      s[j][0] = hopper::ex2(fmaf(s[j][0], sl2, -m_a));
      s[j][1] = hopper::ex2(fmaf(s[j][1], sl2, -m_a));
      s[j][2] = hopper::ex2(fmaf(s[j][2], sl2, -m_b));
      s[j][3] = hopper::ex2(fmaf(s[j][3], sl2, -m_b));
      ps_a += s[j][0] + s[j][1];
      ps_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + ps_a;
    l_b = l_b * alpha_b + ps_b;
#pragma unroll
    for (int j = 0; j < WIN / 8; ++j) {
      acc[j][0] *= alpha_a;
      acc[j][1] *= alpha_a;
      acc[j][2] *= alpha_b;
      acc[j][3] *= alpha_b;
    }
    if (more)
      wait_group<1>();
    else
      wait_group<0>();
    __syncthreads();
    product_values<E, ROUND, BK, WIN>(acc, s, vt, VS, ncols, round_p);
    __syncthreads();
  }
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  store_rows<E, OutT, WIN>(o + (size_t)bh * Tq * D, acc, 1.f / l_a, 1.f / l_b, row_a, Tq, D, w0, ncols);
  if (blockIdx.z == 0 && t == 0) {  // lse in natural log: (m + log2 l) ln 2
    if (row_a < Tq) lse[(size_t)bh * Tq + row_a] = (m_a + log2f(l_a)) * LN2;
    if (row_b < Tq) lse[(size_t)bh * Tq + row_b] = (m_b + log2f(l_b)) * LN2;
  }
}

// ---------------------------------------------------------------------------
// dQ: a block owns (head, 64 q rows, a window of dQ's columns) and walks the
// key tiles of 32 keys up to the diagonal (causal) or Tk: S and dP over the
// whole head dim, P = exp2(S scale log2 e - lse log2 e), dS = P (dP scale -
// delta scale), dQ += dS K on its window.
// ---------------------------------------------------------------------------
template <class E, class OutT, bool ROUND>
__global__ void __launch_bounds__(THREADS)
    flash_wide_dq_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                         const E* __restrict__ dout, const float* __restrict__ lse,
                         const float* __restrict__ delta, OutT* __restrict__ dq, int Tq, int Tk, int D,
                         float scale, int causal, int round_ds) {
  using P = DqPlan<E>;
  constexpr int BK = DQ_BK, WIN = DQ_WIN, CC = CHUNK_BYTES / sizeof(E), VS = value_stride<E, WIN>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * ROWS;
  const int bh = blockIdx.y, w0 = blockIdx.z * WIN, ncols = min(WIN, D - w0);
  const E* qh = q + (size_t)bh * Tq * D;
  const E* doh = dout + (size_t)bh * Tq * D;
  const E* kh = k + (size_t)bh * Tk * D;
  const E* vh = v + (size_t)bh * Tk * D;
  const int row_a = q0 + 16 * warp + g, row_b = row_a + 8;
  const int n_chunks = (D + CC - 1) / CC;
  const int n_k = ((causal ? min(Tk, min(q0 + ROWS, Tq)) : Tk) + BK - 1) / BK;
  const float sl2 = scale * LOG2E;
  // this thread's two rows' lse (log2 units) and delta scale; zero past Tq
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* delta_bh = delta + (size_t)bh * Tq;
  const float l2_a = row_a < Tq ? lse_bh[row_a] * LOG2E : 0.f, l2_b = row_b < Tq ? lse_bh[row_b] * LOG2E : 0.f;
  const float dl_a = row_a < Tq ? delta_bh[row_a] * scale : 0.f, dl_b = row_b < Tq ? delta_bh[row_b] * scale : 0.f;
  uint8_t* kt_win = smem + P::K_OFF;

  int loaded = 0, taken = 0;
  auto load_chunk = [&](int kt, int c) {
    uint8_t* buf = smem + (loaded++ & 1) * P::BUF;
    load_rows<E>(buf, CHUNK_STRIDE, qh, Tq, D, q0, ROWS, c * CC, CC);
    load_rows<E>(buf + ROWS * CHUNK_STRIDE, CHUNK_STRIDE, doh, Tq, D, q0, ROWS, c * CC, CC);
    load_rows<E>(buf + 2 * ROWS * CHUNK_STRIDE, CHUNK_STRIDE, kh, Tk, D, kt * BK, BK, c * CC, CC);
    load_rows<E>(buf + (2 * ROWS + BK) * CHUNK_STRIDE, CHUNK_STRIDE, vh, Tk, D, kt * BK, BK, c * CC, CC);
    commit();
  };

  float acc[WIN / 8][4] = {};
  load_chunk(0, 0);
  for (int kt = 0; kt < n_k; ++kt) {
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(kt, c + 1);
      } else {  // the K window of this key tile
        load_rows<E>(kt_win, VS, kh, Tk, D, kt * BK, BK, w0, ncols);
        commit();
      }
      wait_group<1>();
      __syncthreads();
      const uint8_t* buf = smem + (taken++ & 1) * P::BUF;
      product_rows<E, BK / 8>(s, buf + 16 * warp * CHUNK_STRIDE, buf + 2 * ROWS * CHUNK_STRIDE);
      product_rows<E, BK / 8>(dp, buf + (ROWS + 16 * warp) * CHUNK_STRIDE, buf + (2 * ROWS + BK) * CHUNK_STRIDE);
      __syncthreads();
    }
    const bool more = kt + 1 < n_k;
    if (more) load_chunk(kt + 1, 0);
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = kt * BK + 8 * j + 2 * t + e;
        float pa = hopper::ex2(fmaf(s[j][e], sl2, -l2_a));
        float pb = hopper::ex2(fmaf(s[j][2 + e], sl2, -l2_b));
        if (col >= Tk || (causal && col > row_a)) pa = 0.f;
        if (col >= Tk || (causal && col > row_b)) pb = 0.f;
        s[j][e] = pa * fmaf(dp[j][e], scale, -dl_a);  // dS
        s[j][2 + e] = pb * fmaf(dp[j][2 + e], scale, -dl_b);
      }
    }
    if (more)
      wait_group<1>();
    else
      wait_group<0>();
    __syncthreads();
    product_values<E, ROUND, BK, WIN>(acc, s, kt_win, VS, ncols, round_ds);
    __syncthreads();
  }
  store_rows<E, OutT, WIN>(dq + (size_t)bh * Tq * D, acc, 1.f, 1.f, row_a, Tq, D, w0, ncols);
}

// ---------------------------------------------------------------------------
// dK/dV: a block owns (head, 64 keys, a window of dK's and dV's columns) and
// walks the q tiles of 32 rows from the diagonal (causal) or 0: S^T and dP^T
// over the whole head dim, P^T and dS^T with each q row's lse and delta,
// dV += P^T dO and dK += dS^T Q on its window.
// ---------------------------------------------------------------------------
template <class E, class OutT, bool ROUND>
__global__ void __launch_bounds__(THREADS)
    flash_wide_dkv_kernel(const E* __restrict__ q, const E* __restrict__ k, const E* __restrict__ v,
                          const E* __restrict__ dout, const float* __restrict__ lse,
                          const float* __restrict__ delta, OutT* __restrict__ dk, OutT* __restrict__ dv, int Tq,
                          int Tk, int D, float scale, int causal, int round_p, int round_ds) {
  using P = DkvPlan<E>;
  constexpr int BQ = DKV_BQ, WIN = DKV_WIN, CC = CHUNK_BYTES / sizeof(E), VS = value_stride<E, WIN>();
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, g = lane >> 2, t = lane & 3;
  const int k0 = blockIdx.x * ROWS;  // the longest (causal: the first keys) first
  const int bh = blockIdx.y, w0 = blockIdx.z * WIN, ncols = min(WIN, D - w0);
  const E* qh = q + (size_t)bh * Tq * D;
  const E* doh = dout + (size_t)bh * Tq * D;
  const E* kh = k + (size_t)bh * Tk * D;
  const E* vh = v + (size_t)bh * Tk * D;
  const float* lse_bh = lse + (size_t)bh * Tq;
  const float* delta_bh = delta + (size_t)bh * Tq;
  const int key_a = k0 + 16 * warp + g, key_b = key_a + 8;
  const int n_chunks = (D + CC - 1) / CC;
  const int first = causal ? k0 / BQ : 0, n_q = (Tq + BQ - 1) / BQ;
  const float sl2 = scale * LOG2E;
  uint8_t* q_win = smem + P::Q_OFF;
  uint8_t* do_win = smem + P::DO_OFF;

  int loaded = 0, taken = 0;
  auto load_chunk = [&](int it, int c) {
    uint8_t* buf = smem + (loaded++ & 1) * P::BUF;
    load_rows<E>(buf, CHUNK_STRIDE, kh, Tk, D, k0, ROWS, c * CC, CC);
    load_rows<E>(buf + ROWS * CHUNK_STRIDE, CHUNK_STRIDE, vh, Tk, D, k0, ROWS, c * CC, CC);
    load_rows<E>(buf + 2 * ROWS * CHUNK_STRIDE, CHUNK_STRIDE, qh, Tq, D, it * BQ, BQ, c * CC, CC);
    load_rows<E>(buf + (2 * ROWS + BQ) * CHUNK_STRIDE, CHUNK_STRIDE, doh, Tq, D, it * BQ, BQ, c * CC, CC);
    commit();
  };

  float dk_acc[WIN / 8][4] = {}, dv_acc[WIN / 8][4] = {};
  load_chunk(first, 0);
  for (int it = first; it < n_q; ++it) {
    float st[BQ / 8][4] = {}, dpt[BQ / 8][4] = {};
    for (int c = 0; c < n_chunks; ++c) {
      if (c + 1 < n_chunks) {
        load_chunk(it, c + 1);
      } else {  // the Q and dO windows of this q tile
        load_rows<E>(q_win, VS, qh, Tq, D, it * BQ, BQ, w0, ncols);
        load_rows<E>(do_win, VS, doh, Tq, D, it * BQ, BQ, w0, ncols);
        commit();
      }
      wait_group<1>();
      __syncthreads();
      const uint8_t* buf = smem + (taken++ & 1) * P::BUF;
      product_rows<E, BQ / 8>(st, buf + 16 * warp * CHUNK_STRIDE, buf + 2 * ROWS * CHUNK_STRIDE);
      product_rows<E, BQ / 8>(dpt, buf + (ROWS + 16 * warp) * CHUNK_STRIDE, buf + (2 * ROWS + BQ) * CHUNK_STRIDE);
      __syncthreads();
    }
    const bool more = it + 1 < n_q;
    if (more) load_chunk(it + 1, 0);
#pragma unroll
    for (int j = 0; j < BQ / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int qcol = it * BQ + 8 * j + 2 * t + e;
        const bool in = qcol < Tq;
        const float L = in ? lse_bh[qcol] * LOG2E : 0.f, dl = in ? delta_bh[qcol] * scale : 0.f;
        float pa = hopper::ex2(fmaf(st[j][e], sl2, -L));
        float pb = hopper::ex2(fmaf(st[j][2 + e], sl2, -L));
        if (!in || (causal && key_a > qcol)) pa = 0.f;
        if (!in || (causal && key_b > qcol)) pb = 0.f;
        st[j][e] = pa;  // P^T
        st[j][2 + e] = pb;
        dpt[j][e] = pa * fmaf(dpt[j][e], scale, -dl);  // dS^T
        dpt[j][2 + e] = pb * fmaf(dpt[j][2 + e], scale, -dl);
      }
    }
    if (more)
      wait_group<1>();
    else
      wait_group<0>();
    __syncthreads();
    product_values<E, ROUND, BQ, WIN>(dv_acc, st, do_win, VS, ncols, round_p);
    product_values<E, ROUND, BQ, WIN>(dk_acc, dpt, q_win, VS, ncols, round_ds);
    __syncthreads();
  }
  store_rows<E, OutT, WIN>(dk + (size_t)bh * Tk * D, dk_acc, 1.f, 1.f, key_a, Tk, D, w0, ncols);
  store_rows<E, OutT, WIN>(dv + (size_t)bh * Tk * D, dv_acc, 1.f, 1.f, key_a, Tk, D, w0, ncols);
}

// ---------------------------------------------------------------------------
// Launches: a grid of (row blocks, heads, windows), 128 threads a block, on
// the caller's stream; cudaErrorInvalidValue for a head dim whose rows are
// not 16-byte strided, an empty tensor or more heads than a grid holds.
// ---------------------------------------------------------------------------
template <class E>
inline bool takes(int bh, int tq, int tk, int d) {
  return d >= 1 && d % (16 / (int)sizeof(E)) == 0 && bh >= 1 && bh <= 65535 && tq >= 1 && tk >= 1;
}

template <class E, class OutT, bool ROUND>
int launch_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh, int tq, int tk, int d,
               float scale, int causal, int round_p, cudaStream_t st) {
  if (!takes<E>(bh, tq, tk, d)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = FwdPlan<E>::BYTES;
  cudaFuncSetAttribute(flash_wide_fwd_kernel<E, OutT, ROUND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((tq + ROWS - 1) / ROWS, bh, windows(d, FWD_WIN));
  flash_wide_fwd_kernel<E, OutT, ROUND><<<grid, THREADS, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), static_cast<OutT*>(o),
      static_cast<float*>(lse), tq, tk, d, scale, causal, round_p);
  return static_cast<int>(cudaGetLastError());
}

template <class E, class OutT, bool ROUND>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, const void* lse, const void* delta,
              void* dq, int bh, int tq, int tk, int d, float scale, int causal, int round_ds, cudaStream_t st) {
  if (!takes<E>(bh, tq, tk, d)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = DqPlan<E>::BYTES;
  cudaFuncSetAttribute(flash_wide_dq_kernel<E, OutT, ROUND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((tq + ROWS - 1) / ROWS, bh, windows(d, DQ_WIN));
  flash_wide_dq_kernel<E, OutT, ROUND><<<grid, THREADS, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<OutT*>(dq), tq, tk, d, scale,
      causal, round_ds);
  return static_cast<int>(cudaGetLastError());
}

template <class E, class OutT, bool ROUND>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, const void* lse,
               const void* delta, void* dk, void* dv, int bh, int tq, int tk, int d, float scale, int causal,
               int round_p, int round_ds, cudaStream_t st) {
  if (!takes<E>(bh, tq, tk, d)) return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = DkvPlan<E>::BYTES;
  cudaFuncSetAttribute(flash_wide_dkv_kernel<E, OutT, ROUND>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const dim3 grid((tk + ROWS - 1) / ROWS, bh, windows(d, DKV_WIN));
  flash_wide_dkv_kernel<E, OutT, ROUND><<<grid, THREADS, smem, st>>>(
      static_cast<const E*>(q), static_cast<const E*>(k), static_cast<const E*>(v), static_cast<const E*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta), static_cast<OutT*>(dk),
      static_cast<OutT*>(dv), tq, tk, d, scale, causal, round_p, round_ds);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace wide
}  // namespace
