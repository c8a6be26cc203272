// Flash attention for f32 operands (sm_90a): forward, dQ and dK/dV.
//
// The same three functions as flash_attention.cu, on f32 [BH, T, D]
// operands (D = head dim: 16, 32, 64 or 128): they replace the Pallas
// kernels _fwd_kernel, _dq_kernel and _dkv_kernel
// (ray_tpu/ops/flash_attention.py:72, :135, :168) where those run on f32
// inputs (the ring's f32 path, an f32 model). Scores, softmax and every
// product are f32, P and dS stay f32 (the Pallas kernels' casts to the
// operands' dtype are no-ops in f32), lse, delta and all outputs are f32.
// The products are plain f32 FMAs: TF32 would keep about three decimal
// digits, and the JAX package holds its f32 kernels to 1e-5 (forward) and
// 1e-4 (gradients) of reference attention.
//
// Bound on an H100 SXM: the products, 4 (forward), 6 (dQ) and 8 (dK/dV)
// FLOPs per (q, key) pair the mask keeps and per head-dim element, against
// the f32 FMA peak outside the tensor cores (67 TFLOP/s); the bytes are
// twice the bf16 kernels' and still far below that: operations.
// Design (simple, not yet fast): a block of 256 threads owns 64 rows of the
// result (q rows: forward and dQ; keys: dK/dV) of one head and walks over
// 64-row tiles of the other side, both staged in shared memory. Thread (ty,
// tx) of a 16 x 16 grid computes a 4 x 4 patch of each 64 x 64 score tile
// (rows ty + 16 i, columns tx + 16 j: the 16 threads of a row are one half
// warp, so row maxima and sums are four shuffles), writes P (or dS) back to
// shared memory, and accumulates D / 16 columns of its four result rows.
// Rows of shared memory are padded to D + 1 floats, so the 16 columns a half
// warp reads fall in 16 banks. The key loop stops at the diagonal (causal);
// keys past Tk and q rows past Tq are masked or zero-filled. No atomics:
// each block owns the rows it writes.
//
// Every C entry point launches on the caller's stream and returns
// cudaGetLastError(); nothing here allocates or synchronises. The
// signatures are flash_attention.cu's (out_f32 is taken and ignored: the
// outputs are f32).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;  // a 16 x 16 grid
constexpr int BM = 64;        // result rows of a block
constexpr int BN = 64;        // rows of a visiting tile
constexpr int PN = BN + 1;    // padded row of a score tile in shared memory

template <int D>
struct Smem {
  static constexpr int LD = D + 1;  // padded row of an operand tile
  static constexpr int TILE = BM * LD;
};

// Rows [row0, row0 + 64) of a [T, D] matrix into a padded tile, zeros past T.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* __restrict__ src, int row0, int T) {
  constexpr int LD = Smem<D>::LD, V = D / 4;
  for (int i = threadIdx.x; i < BM * V; i += THREADS) {
    const int r = i / V, c = 4 * (i % V);
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < T) x = *reinterpret_cast<const float4*>(src + (size_t)(row0 + r) * D + c);
    float* d = dst + r * LD + c;
    d[0] = x.x;
    d[1] = x.y;
    d[2] = x.z;
    d[3] = x.w;
  }
}

// s[i][j] = sum_d a[ty + 16 i][d] * b[tx + 16 j][d] over two padded tiles.
template <int D>
__device__ __forceinline__ void scores(float (&s)[4][4], const float* a, const float* b, int ty, int tx) {
  constexpr int LD = Smem<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = a[(ty + 16 * i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(x[i], y[j], s[i][j]);
  }
}

// acc[i][c] += sum_n p[ty + 16 i][n] * m[n][tx + 16 c] (p a padded score
// tile, m a padded operand tile).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[4][D / 16], const float* p, const float* m, int ty,
                                           int tx) {
  constexpr int LD = Smem<D>::LD;
#pragma unroll 4
  for (int n = 0; n < BN; ++n) {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = p[(ty + 16 * i) * PN + n];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const float y = m[n * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(x[i], y, acc[i][c]);
    }
  }
}

// Sum or max over the 16 threads of a row (one half warp).
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

// Visiting tiles of 64 a block of 64 rows from row0 needs (causal: to its
// last row).
__device__ __forceinline__ int tiles_to(int row0, int T, int causal) {
  return ((causal ? min(T, row0 + BM) : T) + BN - 1) / BN;
}

// ---------------------------------------------------------------------------
// Forward: o = softmax(q k^T scale) v, lse = the row logsumexp, online over
// key tiles.
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     float* __restrict__ o, float* __restrict__ lse, int Tq, int Tk, float scale,
                     int causal) {
  extern __shared__ float sm[];
  float* sq = sm;
  float* sk = sq + Smem<D>::TILE;
  float* sv = sk + Smem<D>::TILE;
  float* sp = sv + Smem<D>::TILE;  // [BM][PN]
  const int bh = blockIdx.y, q0 = blockIdx.x * BM, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  q += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  load_tile<D>(sq, q, q0, Tq);

  float m[4], l[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_k = tiles_to(q0, Tk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();  // the last tile's K, V and P are read
    load_tile<D>(sk, k, k0, Tk);
    load_tile<D>(sv, v, k0, Tk);
    __syncthreads();
    float s[4][4];
    scores<D>(s, sq, sk, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        s[i][j] = (col >= Tk || (causal && col > row)) ? -INFINITY : s[i][j] * scale;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float base = m_new == -INFINITY ? 0.f : m_new;  // a row with no key seen yet
      const float alpha = expf(m[i] - base);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - base);
        sp[(ty + 16 * i) * PN + tx + 16 * j] = p;
        sum += p;
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < D / 16; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();
    accumulate<D>(acc, sp, sv, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
    const float inv = 1.f / l[i];
#pragma unroll
    for (int c = 0; c < D / 16; ++c) o[((size_t)bh * Tq + row) * D + tx + 16 * c] = acc[i][c] * inv;
    if (tx == 0) lse[(size_t)bh * Tq + row] = m[i] + logf(l[i]);
  }
}

// ---------------------------------------------------------------------------
// dQ = dS k scale, P = exp(q k^T scale - lse), dS = P (dO v^T - delta).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                    const float* __restrict__ dout, const float* __restrict__ lse,
                    const float* __restrict__ delta, float* __restrict__ dq, int Tq, int Tk, float scale,
                    int causal) {
  extern __shared__ float sm[];
  float* sq = sm;
  float* sdo = sq + Smem<D>::TILE;
  float* sk = sdo + Smem<D>::TILE;
  float* sv = sk + Smem<D>::TILE;
  float* sp = sv + Smem<D>::TILE;  // dS, [BM][PN]
  const int bh = blockIdx.y, q0 = blockIdx.x * BM, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  q += (size_t)bh * Tq * D;
  dout += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  load_tile<D>(sq, q, q0, Tq);
  load_tile<D>(sdo, dout, q0, Tq);

  float L[4], dl[4], acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    L[i] = row < Tq ? lse[(size_t)bh * Tq + row] : 0.f;
    dl[i] = row < Tq ? delta[(size_t)bh * Tq + row] : 0.f;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) acc[i][c] = 0.f;
  }
  const int n_k = tiles_to(q0, Tk, causal);
  for (int kt = 0; kt < n_k; ++kt) {
    const int k0 = kt * BN;
    __syncthreads();
    load_tile<D>(sk, k, k0, Tk);
    load_tile<D>(sv, v, k0, Tk);
    __syncthreads();
    float s[4][4], dp[4][4];
    scores<D>(s, sq, sk, ty, tx);
    scores<D>(dp, sdo, sv, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = k0 + tx + 16 * j;
        const float p = (col >= Tk || (causal && col > row)) ? 0.f : expf(s[i][j] * scale - L[i]);
        sp[(ty + 16 * i) * PN + tx + 16 * j] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    accumulate<D>(acc, sp, sk, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Tq) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dq[((size_t)bh * Tq + row) * D + tx + 16 * c] = acc[i][c] * scale;
  }
}

// ---------------------------------------------------------------------------
// dK = dS^T q scale and dV = P^T dO for 64 keys a block, over the q tiles
// that see them (causal: from the diagonal on).
// ---------------------------------------------------------------------------
template <int D>
__global__ void __launch_bounds__(THREADS, 1)
flash_f32_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
                     const float* __restrict__ dout, const float* __restrict__ lse,
                     const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
                     int Tq, int Tk, float scale, int causal) {
  extern __shared__ float sm[];
  float* sk = sm;
  float* sv = sk + Smem<D>::TILE;
  float* sq = sv + Smem<D>::TILE;
  float* sdo = sq + Smem<D>::TILE;
  float* spt = sdo + Smem<D>::TILE;  // P^T, [BM keys][PN]
  float* sdst = spt + BM * PN;       // dS^T
  float* slse = sdst + BM * PN;      // [BN]
  float* sdelta = slse + BN;         // [BN]
  const int bh = blockIdx.y, k0 = blockIdx.x * BM, ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  q += (size_t)bh * Tq * D;
  dout += (size_t)bh * Tq * D;
  k += (size_t)bh * Tk * D;
  v += (size_t)bh * Tk * D;
  lse += (size_t)bh * Tq;
  delta += (size_t)bh * Tq;
  load_tile<D>(sk, k, k0, Tk);
  load_tile<D>(sv, v, k0, Tk);

  float dk_acc[4][D / 16], dv_acc[4][D / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < D / 16; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;
  const int n_q = (Tq + BN - 1) / BN;
  for (int qt = causal ? k0 / BN : 0; qt < n_q; ++qt) {
    const int q0 = qt * BN;
    __syncthreads();
    load_tile<D>(sq, q, q0, Tq);
    load_tile<D>(sdo, dout, q0, Tq);
    if (threadIdx.x < BN) {
      const int row = q0 + threadIdx.x;
      slse[threadIdx.x] = row < Tq ? lse[row] : 0.f;
      sdelta[threadIdx.x] = row < Tq ? delta[row] : 0.f;
    }
    __syncthreads();
    float st[4][4], dpt[4][4];  // [key ty + 16 i][q row tx + 16 j]
    scores<D>(st, sk, sq, ty, tx);
    scores<D>(dpt, sv, sdo, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int key = k0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int n = tx + 16 * j, row = q0 + n;
        const float p = (row >= Tq || (causal && key > row)) ? 0.f : expf(st[i][j] * scale - slse[n]);
        spt[(ty + 16 * i) * PN + n] = p;
        sdst[(ty + 16 * i) * PN + n] = p * (dpt[i][j] - sdelta[n]);
      }
    }
    __syncthreads();
    accumulate<D>(dv_acc, spt, sdo, ty, tx);
    accumulate<D>(dk_acc, sdst, sq, ty, tx);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= Tk) continue;
#pragma unroll
    for (int c = 0; c < D / 16; ++c) {
      const size_t at = ((size_t)bh * Tk + key) * D + tx + 16 * c;
      dk[at] = dk_acc[i][c] * scale;
      dv[at] = dv_acc[i][c];
    }
  }
}

template <class F>
static int by_head_dim(int d, F launch) {
  switch (d) {
    case 16: return launch(std::integral_constant<int, 16>{});
    case 32: return launch(std::integral_constant<int, 32>{});
    case 64: return launch(std::integral_constant<int, 64>{});
    case 128: return launch(std::integral_constant<int, 128>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory of each kernel: operand tiles and score tiles.
template <int D>
constexpr int fwd_smem() { return (3 * Smem<D>::TILE + BM * PN) * 4; }
template <int D>
constexpr int dq_smem() { return (4 * Smem<D>::TILE + BM * PN) * 4; }
template <int D>
constexpr int dkv_smem() { return (4 * Smem<D>::TILE + 2 * BM * PN + 2 * BN) * 4; }
static_assert(dkv_smem<128>() <= 232448, "dK/dV's shared memory does not fit at head dim 128");

}  // namespace

// ---------------------------------------------------------------------------
// C entry points (loaded with ctypes): flash_attention.cu's signatures, on
// contiguous f32 [bh, T, d] operands and f32 [bh, Tq] lse/delta.
// ---------------------------------------------------------------------------
extern "C" const char* rt_cuda_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}

extern "C" int rt_flash_fwd(const void* q, const void* k, const void* v, void* o, void* lse, int bh,
                            int tq, int tk, int d, float scale, int causal, int, void* stream) {
  return by_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value, smem = fwd_smem<D>();
    cudaFuncSetAttribute(flash_f32_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((tq + BM - 1) / BM, bh);
    flash_f32_fwd_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<float*>(o), static_cast<float*>(lse), tq, tk, scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int rt_flash_dq(const void* q, const void* k, const void* v, const void* dout,
                           const void* lse, const void* delta, void* dq, int bh, int tq, int tk,
                           int d, float scale, int causal, int, void* stream) {
  return by_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value, smem = dq_smem<D>();
    cudaFuncSetAttribute(flash_f32_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((tq + BM - 1) / BM, bh);
    flash_f32_dq_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dq), tq, tk, scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}

extern "C" int rt_flash_dkv(const void* q, const void* k, const void* v, const void* dout,
                            const void* lse, const void* delta, void* dk, void* dv, int bh, int tq,
                            int tk, int d, float scale, int causal, int, void* stream) {
  return by_head_dim(d, [&](auto dd) {
    constexpr int D = decltype(dd)::value, smem = dkv_smem<D>();
    cudaFuncSetAttribute(flash_f32_dkv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    const dim3 grid((tk + BM - 1) / BM, bh);
    flash_f32_dkv_kernel<D><<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
        static_cast<const float*>(dout), static_cast<const float*>(lse),
        static_cast<const float*>(delta), static_cast<float*>(dk), static_cast<float*>(dv), tq, tk,
        scale, causal);
    return static_cast<int>(cudaGetLastError());
  });
}
