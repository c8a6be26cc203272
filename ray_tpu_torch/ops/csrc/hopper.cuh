// Hopper (sm_90a) building blocks for the port's kernels: TMA tensor maps
// and loads, mbarriers, wgmma (descriptors, the asynchronous products and
// their fences) and setmaxnreg. Plain inline PTX, no CUTLASS: each helper is
// one instruction or a short fixed sequence, named after what it issues.
//
// Shared-memory tiles are rows of D 16-bit elements (bf16 or f16, E below)
// as TMA writes them with the swizzle that matches their row length (32B, 64B and 128B for rows of 32,
// 64 and 128 bytes). A row of 256 or 512 bytes (D = 128, 256) is wider than
// a 128B swizzle atom and than the TMA box that swizzle allows, so such a
// tile is two or four [rows, 64] sub-tiles side by side (Tile<D, ROWS>). wgmma reads a tile
// as a K-major operand (D is the contraction) or as an MN-major one (the
// rows are the contraction, the transpose bit set), so no transposed copy is
// ever made. f32 tiles (TileF) have the same byte geometry with 32 floats to
// a 128-byte row; tf32 wgmma reads them K-major only (the transpose bit
// exists for 16-bit types alone). The 16-bit helpers are templates on the
// element type E, __nv_bfloat16 or __half: the two share wgmma's shapes,
// its f32 accumulation, TMA's 2-byte elements and the swizzles, and differ
// in the operand types wgmma's opcode names, the tensor map's data type and
// the rounding that packs f32 values into operands.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <stdint.h>

#include <type_traits>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------------------
// mbarriers. A full barrier completes when its arrivals are in and the bytes
// a TMA load announced have landed; wait() spins on the phase parity.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces `bytes` of TMA traffic to wait for.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Returns once the phase of parity `parity` has completed. The spin loop
// lives inside one asm statement: to the compiler the wait is straight-line
// code, so it keeps wgmma products in flight across it.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// One arrival on `bar` from the threads where `pred` holds, without a branch.
__device__ __forceinline__ void mbar_arrive_if(uint64_t* bar, bool pred) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(smem_u32(bar)),
      "r"(static_cast<uint32_t>(pred))
      : "memory");
}

// Named barriers (ids 1..15; 0 is __syncthreads): sync waits until `count`
// threads have arrived, itself included; arrive only counts this thread.
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---------------------------------------------------------------------------
// TMA: one thread asks for a [rows, D] box of a rank-3 [BH, T, D] tensor map;
// completion is reported to `bar` in bytes. Rows past T arrive as zeros.
// ---------------------------------------------------------------------------

__device__ __forceinline__ void tma_load_rows(void* dst, const CUtensorMap* map, uint64_t* bar,
                                              int row, int bh, int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}

// Plain asynchronous copies of 4 bytes (cp.async; zero-filled when `valid`
// is false), for data whose rows TMA cannot take. cp_async_arrive makes one
// arrival on `bar` once this thread's earlier copies have landed (the
// arrival is counted in the barrier's init count).
__device__ __forceinline__ void cp_async_4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// TMA store of a [rows, D] box from shared memory to a rank-3 tensor map
// (rows past T are not written), as one bulk group of this thread.
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map, const void* src, int row, int bh,
                                               int col = 0) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(col), "r"(row), "r"(bh)
      : "memory");
}
// Waits until this thread's bulk stores have read their shared memory.
__device__ __forceinline__ void tma_store_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
// Waits until this thread's bulk stores are complete.
__device__ __forceinline__ void tma_store_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}
// Orders this thread's shared-memory writes before later TMA reads of them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// Register budget of a warp-specialised block (one if/else on the role).
// ---------------------------------------------------------------------------

template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// ---------------------------------------------------------------------------
// wgmma. A shared-memory operand is named by a 64-bit descriptor: start
// address, leading and stride byte offsets (16-byte units) and the swizzle.
// ---------------------------------------------------------------------------

enum Swizzle : uint64_t { SW128 = 1, SW64 = 2, SW32 = 3 };

__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                              Swizzle sw) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(sw) << 62;
  return d;
}

// A [ROWS, D] tile of 16-bit elements in shared memory as TMA writes it (tma_load_tile).
// Its columns are cut into SUB sub-tiles of W columns, each a [ROWS, W]
// block of rows of at most 128 bytes, laid one after the other (D = 128
// has two, D = 256 four). Each sub-tile is swizzled by its row length (W = 16: 32B,
// 32: 64B, 64: 128B): the 16-byte chunks of a row are XORed with bits of
// the row, in 8-row swizzle atoms of 16 * W bytes. It must start on 1024
// bytes (the 128B swizzle repeats every 1024).
//  - K-major (the contraction runs along D): slice kk (16 columns) starts
//    32 bytes on within its sub-tile; every fifth slice of D = 128 or 256
//    starts the next sub-tile (desc() + k_step(kk));
//  - MN-major (the contraction runs along the rows, D is N): 16 rows from
//    row r0 start r0 * 2W bytes on (mn(tile, r0)); the next W columns of N
//    are a sub-tile on, the descriptor's leading byte offset.
template <int D_, int ROWS>
struct Tile {
  static constexpr int D = D_;
  static_assert(D == 16 || D == 32 || D == 64 || D == 128 || D == 256, "head dims 16, 32, 64, 128 and 256");
  static constexpr int W = D > 64 ? 64 : D;  // columns of a sub-tile
  static constexpr int SUB = D / W;          // sub-tiles side by side
  static constexpr int SUB_BYTES = ROWS * W * 2;
  static constexpr int BYTES = ROWS * D * 2;
  static constexpr Swizzle SW = W == 64 ? SW128 : W == 32 ? SW64 : SW32;
  static_assert(ROWS % 8 == 0 && SUB_BYTES % 1024 == 0, "sub-tiles start on 1024 bytes");

  static __device__ __forceinline__ uint64_t desc(const void* tile) {
    return gmma_desc(tile, SUB > 1 ? SUB_BYTES : 16, 16 * W, SW);
  }
  static __host__ __device__ constexpr uint64_t k_step(int kk) {
    return static_cast<uint64_t>(((kk % (W / 16)) * 32 + (kk / (W / 16)) * SUB_BYTES) >> 4);
  }
  static __device__ __forceinline__ uint64_t mn(const void* tile, int r0) {
    return desc(static_cast<const uint8_t*>(tile) + r0 * W * 2);
  }
  // Byte offset of element (row, col).
  static __device__ __forceinline__ uint32_t offset(int row, int col) {
    const uint32_t off = static_cast<uint32_t>(row * W + col % W) * 2;
    constexpr uint32_t mask = W * 2 / 16 - 1;  // the 16-byte chunks of a row, less one
    return (col / W) * SUB_BYTES + (off ^ (((off >> 7) & mask) << 4));
  }
};

// One thread's TMA loads of a whole tile T (Tile or TileF, E its element
// type; one box per sub-tile), rows [row, row + ROWS) of head bh; `bar` is
// told of all of its bytes at once.
template <class T, class E>
__device__ __forceinline__ void tma_load_tile(E* dst, const CUtensorMap* map, uint64_t* bar, int row, int bh) {
#pragma unroll
  for (int h = 0; h < T::SUB; ++h) tma_load_rows(dst + h * T::SUB_BYTES / sizeof(E), map, bar, row, bh, h * T::W);
}

// The TMA stores of a whole tile, rows [row, row + ROWS) of head bh.
template <class T>
__device__ __forceinline__ void tma_store_tile(const CUtensorMap* map, const void* src, int row, int bh) {
#pragma unroll
  for (int h = 0; h < T::SUB; ++h)
    tma_store_rows(map, static_cast<const uint8_t*>(src) + h * T::SUB_BYTES, row, bh, h * T::W);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers that an asynchronous wgmma writes (or reads) to this point
// of the program, so the compiler neither reads them early nor reuses them
// before the wait that precedes the call.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Accumulator layout of an m64nN f32 result, per thread of the warpgroup
// (warp w, g = lane / 4, t = lane % 4), for each 8-column chunk j:
//   d[4j + 0..1] = D[16w + g][8j + 2t .. +1],  d[4j + 2..3] = D[16w + g + 8][8j + 2t .. +1].
// The register A operand of m64k16 has the mma.m16n8k16 A layout per warp,
// so chunks 2kk and 2kk + 1 of one result, packed to E (pack2), are the A
// fragment of the next product's k-slice kk.
//
// The 16-bit products below are written once each, their operand types a
// macro argument, and RT_WGMMA_16 expands the one for E's types (PTX names
// them in the opcode: .bf16.bf16 or .f16.f16).
#define RT_WGMMA_16(E, ASM)                                                         \
  do {                                                                             \
    if constexpr (std::is_same<E, __half>::value) {                                \
      ASM(".f16.f16");                                                             \
    } else {                                                                       \
      static_assert(std::is_same<E, __nv_bfloat16>::value, "bf16 or f16 operands"); \
      ASM(".bf16.bf16");                                                           \
    }                                                                              \
  } while (0)

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory, both K-major.
template <class E>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                              \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" AB " {"                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                          \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "l"(a), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory, both K-major.
template <class E>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                              \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" AB " {"                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                          \
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"                                                                        \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "l"(a), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers (a[4], the m16n8k16 A layout per warp),
// B in shared memory, MN-major (transpose bit set).
template <class E>
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                     \
  asm volatile(                                                                                        \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                                     \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32" AB " {"                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                                                 \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                                                   \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (a[4], the m16n8k16 A layout per warp),
// B in shared memory, MN-major (transpose bit set).
template <class E>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                              \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" AB " {"                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                          \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B in shared memory, K-major.
template <class E>
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                              \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32" AB " {"                                                      \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"                          \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A and B in shared memory, both K-major.
template <class E>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                           \
  asm volatile(                                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" AB " {"                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                 \
      "}, %16, %17, p, 1, 1, 0, 0;\n}\n"                                                                     \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "l"(a), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A in registers, B in shared memory, MN-major.
template <class E>
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                           \
  asm volatile(                                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" AB " {"                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                 \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 32] (+)= A[64 x 16] . B[16 x 32], A in registers, B in shared memory, K-major.
template <class E>
__device__ __forceinline__ void wgmma_rs_n32_k(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                           \
  asm volatile(                                                                                              \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                           \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32" AB " {"                                                   \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"                                 \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"                                                       \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),      \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A in registers, B in shared memory,
// MN-major (the two 64-column halves of N a leading byte offset apart).
template <class E>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                              \
  asm volatile(                                                                                                 \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                              \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32" AB " {"                                                     \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                  \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                        \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                        \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"                          \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),         \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),   \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]), \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// D[64 x 256] (+)= A[64 x 16] . B[16 x 256], A in registers, B in shared memory,
// MN-major (the four 64-column quarters of N a leading byte offset apart).
template <class E>
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int accumulate) {
#define RT_ASM(AB)                                                                                                      \
  asm volatile(                                                                                                         \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"                                                                     \
      "wgmma.mma_async.sync.aligned.m64n256k16.f32" AB " {"                                                             \
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                                          \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "                                \
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "                                \
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "                                \
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "                                \
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "                                \
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "                    \
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"                  \
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"                                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                 \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),           \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),         \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),         \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),         \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),         \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),         \
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),         \
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),         \
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),         \
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),         \
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),     \
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]), \
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), \
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])  \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate))
  RT_WGMMA_16(E, RT_ASM);
#undef RT_ASM
}

// The register A operand of a warpgroup's 64 rows (this warp's 16 of them)
// of a tile T that TMA wrote, one fragment per 16-wide slice of D. `rows`
// points at the warpgroup's first row in the first sub-tile (tile + r0 * W).
template <class T>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[T::D / 16][4], const void* rows, int warp, int lane) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(rows);
  const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < T::D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(base + T::offset(r, 16 * kk + c));
    a[kk][1] = *reinterpret_cast<const uint32_t*>(base + T::offset(r + 8, 16 * kk + c));
    a[kk][2] = *reinterpret_cast<const uint32_t*>(base + T::offset(r, 16 * kk + 8 + c));
    a[kk][3] = *reinterpret_cast<const uint32_t*>(base + T::offset(r + 8, 16 * kk + 8 + c));
  }
}

// The products by their N, on E operands: ss takes A and B from shared
// memory, both K-major; rs takes A from registers and B MN-major, and
// accumulates; rsk takes A from registers and B K-major.
template <int N, class E> struct Wgmma;
template <class E> struct Wgmma<64, E> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_ss_n64<E>(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64<E>(d, a, b, 1); }
  static __device__ __forceinline__ void rsk(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_rs_n64_k<E>(d, a, b, acc); }
};
template <class E> struct Wgmma<128, E> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_ss_n128<E>(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n128<E>(d, a, b, 1); }
};
template <class E> struct Wgmma<256, E> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n256<E>(d, a, b, 1); }
};
template <class E> struct Wgmma<32, E> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) { wgmma_ss_n32<E>(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n32<E>(d, a, b, 1); }
  static __device__ __forceinline__ void rsk(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_rs_n32_k<E>(d, a, b, acc); }
};
template <class E> struct Wgmma<16, E> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n16<E>(d, a, b, 1); }
};


// ---------------------------------------------------------------------------
// f32 tiles and tf32 wgmma (the f32-operand kernels' 3xTF32 products).
// ---------------------------------------------------------------------------

// A [ROWS, COLS] f32 tile in shared memory, laid out as TMA writes it with
// the swizzle of its row length: sub-tiles of W = min(COLS, 32) floats (rows
// of 32, 64 or 128 bytes: 32B, 64B, 128B swizzle), SUB of them side by side.
// This is Tile's byte geometry, so a k-step of tf32 wgmma (8 floats, 32
// bytes) advances a K-major descriptor as Tile's 16-element step does. tf32
// wgmma reads shared memory K-major only: a tile is always read with COLS as
// the contraction. Each sub-tile must start on 1024 bytes.
template <int COLS, int ROWS>
struct TileF {
  static constexpr int N_ROWS = ROWS, N_COLS = COLS;
  static constexpr int W = COLS > 32 ? 32 : COLS;  // floats of a sub-tile row
  static constexpr int SUB = COLS / W;
  static constexpr int ROW_BYTES = W * 4;
  static constexpr int SUB_BYTES = ROWS * ROW_BYTES;
  static constexpr int BYTES = ROWS * COLS * 4;
  static constexpr Swizzle SW = ROW_BYTES == 128 ? SW128 : ROW_BYTES == 64 ? SW64 : SW32;
  static_assert(COLS == 8 || COLS == 16 || COLS % 32 == 0, "rows of 32, 64 or 128-byte sub-tiles");
  static_assert(ROWS % 8 == 0 && SUB_BYTES % 1024 == 0, "sub-tiles start on 1024 bytes");

  static __device__ __forceinline__ uint64_t desc(const float* tile) {
    return gmma_desc(tile, 16, 8 * ROW_BYTES, SW);
  }
  // k-step kk: columns [8 kk, 8 kk + 8).
  static __host__ __device__ constexpr uint64_t k_step(int kk) {
    return static_cast<uint64_t>(((kk % (W / 8)) * 32 + (kk / (W / 8)) * SUB_BYTES) >> 4);
  }
  // Byte offset of element (row, col); 16-byte aligned when col % 4 == 0.
  static __device__ __forceinline__ uint32_t offset(int row, int col) {
    const uint32_t off = static_cast<uint32_t>(row * ROW_BYTES + (col % W) * 4);
    constexpr uint32_t mask = ROW_BYTES / 16 - 1;
    return (col / W) * SUB_BYTES + (off ^ (((off >> 7) & mask) << 4));
  }
};

// x rounded to tf32 (10 mantissa bits, to nearest, ties away from zero), as
// an f32 bit pattern whose low 13 bits are zero: cvt.rna.tf32.f32's rounding
// for every finite x, in two integer instructions (half a tf32 ulp added to
// the magnitude, then the 13 bits cleared). cvt is a longer sequence on
// sm_90: with it the f32 flash backward kernels (whose split pass this is)
// ran 8-9% slower on an H100 (python3 -m ray_tpu_torch.sweep_flash_f32).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// 3xTF32: x = big + small with big = tf32(x) and small = tf32(x - big)
// (x - big is exact); big.big + big.small + small.big keeps about f32's
// accuracy (the dropped small.small is below 2^-22 of x y).
__device__ __forceinline__ void tf32_split(float x, uint32_t& big, uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// D[64 x 8] (+)= A[64 x 8] . B[8 x 8], tf32, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n8(float (&d)[4], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %6, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, %4, %5, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 8] . B[8 x 16], tf32, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n16(float (&d)[8], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, %8, %9, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 8] . B[8 x 16], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] . B[8 x 32], tf32, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n32(float (&d)[16], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 32] (+)= A[64 x 8] . B[8 x 32], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] . B[8 x 64], tf32, A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_tf32_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 8] . B[8 x 64], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 8] . B[8 x 128], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n128(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                                  int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 8] (+)= A[64 x 8] . B[8 x 8], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n8(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3"
      "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));}

// D[64 x 256] (+)= A[64 x 8] . B[8 x 256], tf32, A in registers (a[4]), B in shared memory, K-major.
__device__ __forceinline__ void wgmma_tf32_rs_n256(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

template <int N> struct WgmmaTF32;
// The tf32 products by their N: ss takes A and B from shared memory, rs A
// from registers; B K-major in both. The shapes the f32 kernels issue.
template <> struct WgmmaTF32<8> {
  static __device__ __forceinline__ void ss(float (&d)[4], uint64_t a, uint64_t b, int acc) { wgmma_tf32_ss_n8(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[4], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n8(d, a, b, acc); }
};

template <> struct WgmmaTF32<16> {
  static __device__ __forceinline__ void ss(float (&d)[8], uint64_t a, uint64_t b, int acc) { wgmma_tf32_ss_n16(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n16(d, a, b, acc); }
};

template <> struct WgmmaTF32<32> {
  static __device__ __forceinline__ void ss(float (&d)[16], uint64_t a, uint64_t b, int acc) { wgmma_tf32_ss_n32(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[16], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n32(d, a, b, acc); }
};

template <> struct WgmmaTF32<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_tf32_ss_n64(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n64(d, a, b, acc); }
};

template <> struct WgmmaTF32<128> {
  static __device__ __forceinline__ void rs(float (&d)[64], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n128(d, a, b, acc); }
};

template <> struct WgmmaTF32<256> {
  static __device__ __forceinline__ void rs(float (&d)[128], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_tf32_rs_n256(d, a, b, acc); }
};

// ---------------------------------------------------------------------------
// Small math
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two f32 values rounded to nearest (even) into E, lo in the low half: the
// cast of P and dS to an operand's type before a product. f16 keeps its
// subnormals (cvt.rn.f16x2.f32 without .ftz), as the Pallas kernels' casts
// do; dS is often that small.
template <class E>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (std::is_same<E, __half>::value) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    static_assert(std::is_same<E, __nv_bfloat16>::value, "bf16 or f16 operands");
    __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  }
}

// The rounding of P or dS before a product on f32 operands of the
// mixed-dtype route: to the nearest (even) bf16 or f16 value (f16 keeping
// its subnormals, as the Pallas kernels' casts do), or none (ROUND false:
// the f32 operands' route). `to` is uniform over the block: the select
// costs no branch.
enum Round : int { ROUND_NONE = 0, ROUND_BF16 = 1, ROUND_F16 = 2 };
template <bool ROUND>
__device__ __forceinline__ float rounded(float x, int to) {
  if constexpr (!ROUND) {
    return x;
  } else {
    const float b = __bfloat162float(__float2bfloat16_rn(x)), h = __half2float(__float2half_rn(x));
    return to == ROUND_BF16 ? b : to == ROUND_F16 ? h : x;
  }
}

// ---------------------------------------------------------------------------
// Host: tensor maps. cuTensorMapEncodeTiled is a driver function; the CUDA
// runtime hands out its entry point (asked for with the signature it has had
// since CUDA 12.0), so the kernel library links against nothing but the
// runtime. Encoded per call: the pointers differ from call to call.
// ---------------------------------------------------------------------------

inline PFN_cuTensorMapEncodeTiled_v12000 encode_tiled() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      p = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }();
  return fn;
}

// The tensor-map data type of an element type. TMA copies bytes, but the
// type is named, not derived from the element's size: bf16 and f16 are both
// two bytes.
template <class E>
constexpr CUtensorMapDataType tma_type() {
  if constexpr (std::is_same<E, float>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT32;
  else if constexpr (std::is_same<E, __half>::value) return CU_TENSOR_MAP_DATA_TYPE_FLOAT16;
  else {
    static_assert(std::is_same<E, __nv_bfloat16>::value, "f32, f16 or bf16 elements");
    return CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  }
}

// A rank-3 map over a contiguous [bh, T, width] tensor of `type` (bf16, f16
// or f32: tma_type<E>()), innermost first ({width, T, bh}), whose box is [box_rows, W]
// of one head, W the columns of a 128-byte row at most of the instance's
// head dim D (min(D, 64) 16-bit elements, a sub-tile of Tile<D, box_rows>; min(D, 32)
// f32, of TileF<D, box_rows>: D = 128 or 256 takes two to eight boxes a
// tile): rows past T are zero-filled within the head (a flat [bh * T, D]
// map would read the next head's rows instead), and so are the columns
// past `width` when the tensor is narrower than the instance (a head dim
// between two instances runs on the wider one: a box may lie wholly past
// the row's end, and TMA still writes its zeros and counts its bytes;
// stores through such a map write only the `width` columns). The row
// stride, width * elem_bytes, must be a multiple of 16 bytes. Swizzled by
// the box's row length: 32B, 64B or 128B.
inline bool rows_map(CUtensorMap* map, const void* ptr, int bh, int T, int width, int D, int box_rows,
                     CUtensorMapDataType type) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  const int elem_bytes = type == CU_TENSOR_MAP_DATA_TYPE_FLOAT32 ? 4
                         : type == CU_TENSOR_MAP_DATA_TYPE_FLOAT16 || type == CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 ? 2
                                                                                                                : 0;
  if (!encode || (D != 16 && D != 32 && D != 64 && D != 128 && D != 256) || elem_bytes == 0 || width < 1 ||
      width > D || (width * elem_bytes) % 16 != 0)
    return false;
  const int W = D * elem_bytes > 128 ? 128 / elem_bytes : D, row_bytes = W * elem_bytes;
  const cuuint64_t dims[3] = {(cuuint64_t)width, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)width * elem_bytes, (cuuint64_t)T * width * elem_bytes};
  const cuuint32_t box[3] = {(cuuint32_t)W, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUtensorMapSwizzle swizzle = row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                       : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, type, 3,
                const_cast<void*>(ptr), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
