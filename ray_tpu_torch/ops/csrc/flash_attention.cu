// Flash attention for Hopper (sm_90a): forward, dQ and dK/dV kernels.
//
// Operands are folded to [BH, T, D] row-major bf16 (D = head dim, 16 or 64),
// lse and delta are [BH, Tq] f32. Scores and all accumulators are f32; the
// products run on the tensor cores through mma.sync m16n8k16 (bf16 in, f32
// accumulate). One thread block = 4 warps; each warp owns 16 rows of its
// block's 64-row tile, and the softmax of a row lives in the registers of
// the four lanes that hold it (no score tile ever goes to memory).
//
// Layout of one m16n8k16 product, per lane (g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a0 = A[g][2t..2t+1],   a1 = A[g+8][2t..2t+1],
//                         a2 = A[g][2t+8..+9],   a3 = A[g+8][2t+8..+9]
//   B (16x8, "col"):      b0 = B[2t..2t+1][g],   b1 = B[2t+8..+9][g]
//   C (16x8 f32):         c0,c1 = C[g][2t..2t+1], c2,c3 = C[g+8][2t..2t+1]
// Two neighbouring C tiles of a score row are therefore exactly one A
// fragment of the next product (P@V, dS@K, ...) once packed to bf16.
//
// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BQ = 64;        // query rows per tile (4 warps x 16 rows)
constexpr int BK = 64;        // key rows per tile
constexpr int NTHREADS = 128;
constexpr int PAD = 8;        // row padding (bf16): keeps fragment loads free of bank conflicts
constexpr float NEG_INF = -1e30f;  // the JAX kernel's mask value

__device__ __forceinline__ void mma16816(float c[4], const uint32_t a[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t lds32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two f32 -> one register of two bf16, the first in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Rows [row0, row0 + 64) of a [T, D] matrix into smem dst[64][D + PAD];
// rows past T are zero. 16-byte loads, neighbouring threads on
// neighbouring addresses.
template <int D>
__device__ __forceinline__ void load_rows(bf16 (*dst)[D + PAD], const bf16* __restrict__ src,
                                          int row0, int T) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    *reinterpret_cast<uint4*>(&dst[r][col]) = val;
  }
}

// The same rows, stored transposed: dst[D][64 + PAD], dst[d][r] = src[row0 + r][d].
// A product whose contraction runs over rows (P@V, dS@K, P^T@dO, dS^T@Q)
// reads its B fragments from this copy.
template <int D>
__device__ __forceinline__ void load_rows_t(bf16 (*dst)[64 + PAD], const bf16* __restrict__ src,
                                            int row0, int T) {
  constexpr int CPR = D / 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += NTHREADS) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < T) val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
    for (int i = 0; i < 8; ++i) dst[col + i][r] = e[i];
  }
}

// A fragments of this warp's 16 rows (starting at smem row r0) of a
// [64][D + PAD] tile, one per 16-wide chunk of D.
template <int D>
__device__ __forceinline__ void load_a_frags(uint32_t a[D / 16][4], bf16 (*src)[D + PAD], int r0,
                                             int g, int t) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    a[kc][0] = lds32(&src[r0 + g][kc * 16 + 2 * t]);
    a[kc][1] = lds32(&src[r0 + g + 8][kc * 16 + 2 * t]);
    a[kc][2] = lds32(&src[r0 + g][kc * 16 + 8 + 2 * t]);
    a[kc][3] = lds32(&src[r0 + g + 8][kc * 16 + 8 + 2 * t]);
  }
}

// acc[16 x 64] = A[16 x D] . B^T where B is a [64][D + PAD] tile: the
// 16x64 score (or dP) tile of one warp, 8 C tiles of 16x8.
template <int D>
__device__ __forceinline__ void rows_times_tile_t(float acc[8][4], const uint32_t a[D / 16][4],
                                                  bf16 (*b)[D + PAD], int g, int t) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      mma16816(acc[j], a[kc], lds32(&b[j * 8 + g][kc * 16 + 2 * t]),
               lds32(&b[j * 8 + g][kc * 16 + 8 + 2 * t]));
  }
}

// acc[16 x D] += P[16 x 64] . X[64 x D], P given as this warp's 8 C tiles
// (rounded to bf16 here), X as its transposed tile xt[D][64 + PAD].
template <int D>
__device__ __forceinline__ void tile_times_rows(float acc[D / 8][4], const float p[8][4],
                                                bf16 (*xt)[64 + PAD], int g, int t) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {
        pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
        pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]), pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn)
      mma16816(acc[dn], pa, lds32(&xt[dn * 8 + g][kk * 16 + 2 * t]),
               lds32(&xt[dn * 8 + g][kk * 16 + 8 + 2 * t]));
  }
}

// Write this warp's [16 x D] f32 accumulator rows (row_a = row g, row_b =
// row g + 8, both global) to out[T, D] as bf16, dropping rows past T.
template <int D>
__device__ __forceinline__ void store_rows(bf16* __restrict__ out, const float acc[D / 8][4],
                                           int row_a, int T, int t, float mul_a, float mul_b) {
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int col = dn * 8 + 2 * t;
    if (row_a < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)row_a * D + col) =
          __floats2bfloat162_rn(acc[dn][0] * mul_a, acc[dn][1] * mul_a);
    if (row_a + 8 < T)
      *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row_a + 8) * D + col) =
          __floats2bfloat162_rn(acc[dn][2] * mul_b, acc[dn][3] * mul_b);
  }
}

// ---------------------------------------------------------------------------
// Forward. Replaces _fwd_kernel (ray_tpu/ops/flash_attention.py:72-132).
//
// Bound on an H100 SXM at the train step's shapes (BH 384, T 1024, D 64,
// causal): 4*BH*T*T*D/2 = 51.5 GFLOP against 989 TFLOP/s bf16 (52 us) and
// 3 inputs + o + lse = 203 MB against 3.35 TB/s (61 us): bytes by a little,
// and the two are close, so the kernel has to keep both the tensor cores
// and the loads busy.
// Design: one block per (bh, 64-row q tile) -- 6144 blocks at the train
// shape, so every SM holds several. The q tile stays in registers as mma A
// fragments; an in-block loop over 64-key tiles (staged in shared memory)
// replaces the TPU's sequential "arbitrary" grid axis, with the running
// max, normaliser and output accumulator in f32 registers. Causal: the loop
// stops at the diagonal tile, and only tiles that cross the diagonal or the
// ragged end of the keys are masked. Each Q/K/V byte is read from device
// memory once per (q tile, k tile) pair that needs it; K/V reuse across q
// tiles is left to L2 (50 MB holds a whole head's K/V many times over).
// Not yet done: cp.async/TMA double buffering and wgmma (later work).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 bf16* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, float scale,
                 int causal) {
  __shared__ __align__(16) bf16 Qs[BQ][D + PAD];
  __shared__ __align__(16) bf16 Ks[BK][D + PAD];
  __shared__ __align__(16) bf16 Vt[D][BK + PAD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  o += (size_t)bh * Tq * D;
  lse += (size_t)bh * Tq;

  load_rows<D>(Qs, q, q0, Tq);
  __syncthreads();
  uint32_t qa[D / 16][4];
  load_a_frags<D>(qa, Qs, warp * 16, g, t);

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;  // this lane's two query rows
  float m_a = NEG_INF, m_b = NEG_INF;  // running row max
  float l_a = 0.f, l_b = 0.f;          // this lane's share of the normaliser
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();  // every warp is done with the previous K/V tile
    load_rows<D>(Ks, k, k0, Tk);
    load_rows_t<D>(Vt, v, k0, Tk);
    __syncthreads();

    float s[8][4];
    rows_times_tile_t<D>(s, qa, Ks, g, t);
    const bool masked = (k0 + BK > Tk) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t + e;
        s[j][e] *= scale;
        s[j][2 + e] *= scale;
        if (masked) {
          if (col >= Tk || (causal && col > row_a)) s[j][e] = NEG_INF;
          if (col >= Tk || (causal && col > row_b)) s[j][2 + e] = NEG_INF;
        }
      }
    }

    // Online softmax. The first tile always holds key 0, which every row
    // sees, so the running max is a real score from the first tile on.
    float mx_a = m_a, mx_b = m_b;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx_a = fmaxf(mx_a, fmaxf(s[j][0], s[j][1]));
      mx_b = fmaxf(mx_b, fmaxf(s[j][2], s[j][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
      mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
    }
    const float alpha_a = expf(m_a - mx_a), alpha_b = expf(m_b - mx_b);
    m_a = mx_a;
    m_b = mx_b;
    float rs_a = 0.f, rs_b = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[j][0] = expf(s[j][0] - m_a);
      s[j][1] = expf(s[j][1] - m_a);
      s[j][2] = expf(s[j][2] - m_b);
      s[j][3] = expf(s[j][3] - m_b);
      rs_a += s[j][0] + s[j][1];
      rs_b += s[j][2] + s[j][3];
    }
    l_a = l_a * alpha_a + rs_a;
    l_b = l_b * alpha_b + rs_b;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha_a;
      acc[dn][1] *= alpha_a;
      acc[dn][2] *= alpha_b;
      acc[dn][3] *= alpha_b;
    }
    tile_times_rows<D>(acc, s, Vt, g, t);  // p cast to bf16 before p@v, as the JAX kernel does
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  store_rows<D>(o, acc, row_a, Tq, t, 1.f / l_a, 1.f / l_b);
  if (t == 0) {
    if (row_a < Tq) lse[row_a] = m_a + logf(l_a);
    if (row_b < Tq) lse[row_b] = m_b + logf(l_b);
  }
}

// ---------------------------------------------------------------------------
// dQ. Replaces _dq_kernel (ray_tpu/ops/flash_attention.py:135-165).
//
// Bound on an H100 SXM at the train step's shapes (causal): three products
// (S = QK^T, dP = dO V^T, dQ = dS K) = 77 GFLOP against 989 TFLOP/s (78 us);
// q, k, v, dO, lse, delta in and dq out = 255 MB against 3.35 TB/s (76 us):
// operations by a little.
// Design: one block per (bh, 64-row q tile); Q and dO stay in registers as A
// fragments, lse and delta as two scalars per lane. A loop over 64-key
// tiles (to the diagonal when causal) recomputes P = exp(S - lse) and dS in
// registers and accumulates dQ in f32 registers, so each block owns its
// rows of dQ: no atomics, and the result does not depend on run order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                const bf16* __restrict__ dout, const float* __restrict__ lse,
                const float* __restrict__ delta, bf16* __restrict__ dq, int Tq, int Tk,
                float scale, int causal) {
  __shared__ __align__(16) bf16 Qs[BQ][D + PAD];   // Q tile, then dO tile
  __shared__ __align__(16) bf16 Ks[BK][D + PAD];
  __shared__ __align__(16) bf16 Vs[BK][D + PAD];
  __shared__ __align__(16) bf16 Kt[D][BK + PAD];

  const int bh = blockIdx.y, q0 = blockIdx.x * BQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  dout += (size_t)bh * Tq * D;
  dq += (size_t)bh * Tq * D;
  lse += (size_t)bh * Tq;
  delta += (size_t)bh * Tq;

  uint32_t qa[D / 16][4], da[D / 16][4];
  load_rows<D>(Qs, q, q0, Tq);
  __syncthreads();
  load_a_frags<D>(qa, Qs, warp * 16, g, t);
  __syncthreads();
  load_rows<D>(Qs, dout, q0, Tq);
  __syncthreads();
  load_a_frags<D>(da, Qs, warp * 16, g, t);

  const int row_a = q0 + warp * 16 + g, row_b = row_a + 8;
  const float lse_a = row_a < Tq ? lse[row_a] : 0.f, lse_b = row_b < Tq ? lse[row_b] : 0.f;
  const float dl_a = row_a < Tq ? delta[row_a] : 0.f, dl_b = row_b < Tq ? delta[row_b] : 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  const int k_end = causal ? min(Tk, q0 + BQ) : Tk;
  for (int k0 = 0; k0 < k_end; k0 += BK) {
    __syncthreads();
    load_rows<D>(Ks, k, k0, Tk);
    load_rows<D>(Vs, v, k0, Tk);
    load_rows_t<D>(Kt, k, k0, Tk);
    __syncthreads();

    float s[8][4], dp[8][4];
    rows_times_tile_t<D>(s, qa, Ks, g, t);
    rows_times_tile_t<D>(dp, da, Vs, g, t);
    const bool masked = (k0 + BK > Tk) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = k0 + j * 8 + 2 * t + e;
        float sa = s[j][e] * scale, sb = s[j][2 + e] * scale;
        if (masked) {
          if (col >= Tk || (causal && col > row_a)) sa = NEG_INF;
          if (col >= Tk || (causal && col > row_b)) sb = NEG_INF;
        }
        const float pa = expf(sa - lse_a), pb = expf(sb - lse_b);
        s[j][e] = pa * (dp[j][e] - dl_a) * scale;  // dS, cast to bf16 before dS@K
        s[j][2 + e] = pb * (dp[j][2 + e] - dl_b) * scale;
      }
    }
    tile_times_rows<D>(acc, s, Kt, g, t);
  }
  store_rows<D>(dq, acc, row_a, Tq, t, 1.f, 1.f);
}

// ---------------------------------------------------------------------------
// dK/dV. Replaces _dkv_kernel (ray_tpu/ops/flash_attention.py:168-205).
//
// Bound on an H100 SXM at the train step's shapes (causal): four products
// (S^T, dP^T, dV = P^T dO, dK = dS^T Q) = 103 GFLOP against 989 TFLOP/s
// (104 us); q, k, v, dO, lse, delta in and dk, dv out = 305 MB against
// 3.35 TB/s (91 us): operations.
// Design: one block per (bh, 64-row key tile), the transposed problem of
// dQ: K and V stay in registers as A fragments and the block loops over
// 64-row q tiles from the diagonal on (causal), recomputing S^T = K Q^T and
// P^T = exp(S^T - lse) with lse and delta staged per q tile in shared
// memory. dK and dV accumulate in f32 registers of the block that owns the
// key rows: no atomics, no dependence on run order.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                 const bf16* __restrict__ dout, const float* __restrict__ lse,
                 const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
                 int Tq, int Tk, float scale, int causal) {
  __shared__ __align__(16) bf16 Qs[BQ][D + PAD];   // K tile at the start
  __shared__ __align__(16) bf16 Ds[BQ][D + PAD];   // V tile at the start
  __shared__ __align__(16) bf16 Qt[D][BQ + PAD];
  __shared__ __align__(16) bf16 Dt[D][BQ + PAD];
  __shared__ float lse_s[BQ], delta_s[BQ];

  const int bh = blockIdx.y, k0 = blockIdx.x * BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  q += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  dout += (size_t)bh * Tq * D;
  dk += (size_t)bh * Tk * D;
  dv += (size_t)bh * Tk * D;
  lse += (size_t)bh * Tq;
  delta += (size_t)bh * Tq;

  uint32_t ka[D / 16][4], va[D / 16][4];
  load_rows<D>(Qs, k, k0, Tk);
  load_rows<D>(Ds, v, k0, Tk);
  __syncthreads();
  load_a_frags<D>(ka, Qs, warp * 16, g, t);
  load_a_frags<D>(va, Ds, warp * 16, g, t);

  const int key_a = k0 + warp * 16 + g, key_b = key_a + 8;  // this lane's two key rows
  float dk_acc[D / 8][4], dv_acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    dk_acc[dn][0] = dk_acc[dn][1] = dk_acc[dn][2] = dk_acc[dn][3] = 0.f;
    dv_acc[dn][0] = dv_acc[dn][1] = dv_acc[dn][2] = dv_acc[dn][3] = 0.f;
  }

  // Causal (Tq == Tk): q rows below k0 see none of this block's keys.
  const int q_begin = causal ? (k0 / BQ) * BQ : 0;
  for (int q0 = q_begin; q0 < Tq; q0 += BQ) {
    __syncthreads();
    load_rows<D>(Qs, q, q0, Tq);
    load_rows<D>(Ds, dout, q0, Tq);
    load_rows_t<D>(Qt, q, q0, Tq);
    load_rows_t<D>(Dt, dout, q0, Tq);
    for (int i = threadIdx.x; i < BQ; i += NTHREADS) {
      lse_s[i] = q0 + i < Tq ? lse[q0 + i] : 0.f;
      delta_s[i] = q0 + i < Tq ? delta[q0 + i] : 0.f;
    }
    __syncthreads();

    float p[8][4], dp[8][4];
    rows_times_tile_t<D>(p, ka, Qs, g, t);  // S^T [keys, q]
    const bool masked = (q0 + BQ > Tq) || (causal && k0 + BK - 1 > q0);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = j * 8 + 2 * t + e, qcol = q0 + ql;
        float sa = p[j][e] * scale, sb = p[j][2 + e] * scale;
        if (masked) {
          if (qcol >= Tq || (causal && key_a > qcol)) sa = NEG_INF;
          if (qcol >= Tq || (causal && key_b > qcol)) sb = NEG_INF;
        }
        p[j][e] = expf(sa - lse_s[ql]);
        p[j][2 + e] = expf(sb - lse_s[ql]);
      }
    }
    tile_times_rows<D>(dv_acc, p, Dt, g, t);  // dV += P^T dO, P cast to bf16 first
    rows_times_tile_t<D>(dp, va, Ds, g, t);   // dP^T [keys, q]
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ql = j * 8 + 2 * t + e;
        dp[j][e] = p[j][e] * (dp[j][e] - delta_s[ql]) * scale;
        dp[j][2 + e] = p[j][2 + e] * (dp[j][2 + e] - delta_s[ql]) * scale;
      }
    }
    tile_times_rows<D>(dk_acc, dp, Qt, g, t);  // dK += dS^T Q
  }
  store_rows<D>(dk, dk_acc, key_a, Tk, t, 1.f, 1.f);
  store_rows<D>(dv, dv_acc, key_a, Tk, t, 1.f, 1.f);
}

inline dim3 grid_of(int rows, int bh) { return dim3((rows + 63) / 64, bh); }

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes). Pointers are device pointers of
// contiguous bf16 [bh, T, d] tensors and f32 [bh, Tq] lse/delta; the stream is
// the caller's cudaStream_t. Each returns cudaGetLastError() after the launch.
// ---------------------------------------------------------------------------
extern "C" const char* rt_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                            int tq, int tk, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v);
  if (d == 16)
    flash_fwd_kernel<16><<<grid_of(tq, bh), NTHREADS, 0, st>>>(Q, K, V, static_cast<bf16*>(o),
                                                               static_cast<float*>(lse), tq, tk,
                                                               scale, causal);
  else if (d == 64)
    flash_fwd_kernel<64><<<grid_of(tq, bh), NTHREADS, 0, st>>>(Q, K, V, static_cast<bf16*>(o),
                                                               static_cast<float*>(lse), tq, tk,
                                                               scale, causal);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                           int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *DO = static_cast<const bf16*>(dout);
  const float *L = static_cast<const float*>(lse), *DL = static_cast<const float*>(delta);
  if (d == 16)
    flash_dq_kernel<16><<<grid_of(tq, bh), NTHREADS, 0, st>>>(Q, K, V, DO, L, DL,
                                                              static_cast<bf16*>(dq), tq, tk,
                                                              scale, causal);
  else if (d == 64)
    flash_dq_kernel<64><<<grid_of(tq, bh), NTHREADS, 0, st>>>(Q, K, V, DO, L, DL,
                                                              static_cast<bf16*>(dq), tq, tk,
                                                              scale, causal);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rt_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                            int tk, int d, float scale, int causal, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bf16 *Q = static_cast<const bf16*>(q), *K = static_cast<const bf16*>(k),
             *V = static_cast<const bf16*>(v), *DO = static_cast<const bf16*>(dout);
  const float *L = static_cast<const float*>(lse), *DL = static_cast<const float*>(delta);
  if (d == 16)
    flash_dkv_kernel<16><<<grid_of(tk, bh), NTHREADS, 0, st>>>(
        Q, K, V, DO, L, DL, static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, scale, causal);
  else if (d == 64)
    flash_dkv_kernel<64><<<grid_of(tk, bh), NTHREADS, 0, st>>>(
        Q, K, V, DO, L, DL, static_cast<bf16*>(dk), static_cast<bf16*>(dv), tq, tk, scale, causal);
  else
    return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
