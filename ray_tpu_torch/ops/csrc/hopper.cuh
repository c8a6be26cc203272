// Hopper (sm_90a) building blocks for the port's kernels: TMA tensor maps
// and loads, mbarriers, wgmma (descriptors, the asynchronous products and
// their fences) and setmaxnreg. Plain inline PTX, no CUTLASS: each helper is
// one instruction or a short fixed sequence, named after what it issues.
//
// Shared-memory tiles are rows of D bf16 as TMA writes them with the
// swizzle that matches their row length (128B for rows of 128 bytes, 32B for
// rows of 32 bytes). wgmma reads the same tile as a K-major operand (D is
// the contraction) or as an MN-major one (the rows are the contraction, the
// transpose bit set), so no transposed copy is ever made.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cudaTypedefs.h>  // PFN_cuTensorMapEncodeTiled_v12000
#include <stdint.h>

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
                                              int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(0), "r"(row), "r"(bh)
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
__device__ __forceinline__ void tma_store_rows(const CUtensorMap* map, const void* src, int row, int bh) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(0), "r"(row), "r"(bh)
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

// Byte offset of element (row, col) of a [rows, D] bf16 tile as TMA lays
// it out with the swizzle of desc_rows<D>: the 16-byte chunks of each row
// are XORed with bits of the row (128B swizzle: row % 8; 32B: (row / 4) % 2).
template <int D>
__device__ __forceinline__ uint32_t swizzled_offset(int row, int col) {
  const uint32_t off = static_cast<uint32_t>(row * D + col) * 2;
  constexpr uint32_t mask = D == 64 ? 7 : 1;
  return off ^ (((off >> 7) & mask) << 4);
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

enum Swizzle : uint64_t { SW128 = 1, SW32 = 3 };

__device__ __forceinline__ uint64_t gmma_desc(const void* p, uint32_t lbo_bytes, uint32_t sbo_bytes,
                                              Swizzle sw) {
  uint64_t d = (smem_u32(p) & 0x3FFFF) >> 4;
  d |= static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16;
  d |= static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32;
  d |= static_cast<uint64_t>(sw) << 62;
  return d;
}

// A tile of rows of D bf16 (D = 64: 128-byte rows, 128B swizzle; D = 16:
// 32-byte rows, 32B swizzle), 8-row swizzle atoms of 16 * D bytes.
//  - K-major (the contraction runs along D): the next 16-wide slice of D
//    starts 32 bytes on (add 2 to the descriptor per slice);
//  - MN-major (the contraction runs along the rows, D is N): one swizzle
//    atom spans all of D, and the next 16 rows start 32 * D bytes on.
template <int D>
__device__ __forceinline__ uint64_t desc_rows(const __nv_bfloat16* tile) {
  static_assert(D == 16 || D == 64, "rows of 32 or 128 bytes");
  return gmma_desc(tile, 16, 16 * D, D == 64 ? SW128 : SW32);
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
// so chunks 2kk and 2kk + 1 of one result, packed to bf16, are the A
// fragment of the next product's k-slice kk.

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b, int accumulate) {
  
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] . B[16 x 128], A and B in shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t a, uint64_t b, int accumulate) {
  
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(accumulate));
}

// D[64 x 16] += A[64 x 16] . B[16 x 16], A in registers (a[4], the m16n8k16 A layout per warp),
// B in shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n16(float (&d)[8], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7"
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] += A[64 x 16] . B[16 x 64], A in registers (a[4], the m16n8k16 A layout per warp),
// B in shared memory, MN-major (transpose bit set).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] . B[16 x 64], A in registers, B in shared memory, K-major.
__device__ __forceinline__ void wgmma_rs_n64_k(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}

// The register A operand of a warpgroup's 64 rows (this warp's 16 of them)
// of a [rows, D] tile that TMA wrote with the swizzle of desc_rows<D>, one
// fragment per 16-wide slice of D.
template <int D>
__device__ __forceinline__ void load_a_rows(uint32_t (&a)[D / 16][4], const __nv_bfloat16* tile, int warp,
                                            int lane) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(tile);
  const int r = 16 * warp + (lane >> 2), c = 2 * (lane & 3);
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    a[kk][0] = *reinterpret_cast<const uint32_t*>(base + swizzled_offset<D>(r, 16 * kk + c));
    a[kk][1] = *reinterpret_cast<const uint32_t*>(base + swizzled_offset<D>(r + 8, 16 * kk + c));
    a[kk][2] = *reinterpret_cast<const uint32_t*>(base + swizzled_offset<D>(r, 16 * kk + 8 + c));
    a[kk][3] = *reinterpret_cast<const uint32_t*>(base + swizzled_offset<D>(r + 8, 16 * kk + 8 + c));
  }
}

// The products by their N: ss takes A and B from shared memory, both
// K-major; rs takes A from registers and B MN-major, and accumulates; rsk
// takes A from registers and B K-major.
template <int N> struct Wgmma;
template <> struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[32], uint64_t a, uint64_t b, int acc) { wgmma_ss_n64(d, a, b, acc); }
  static __device__ __forceinline__ void rs(float (&d)[32], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n64(d, a, b, 1); }
  static __device__ __forceinline__ void rsk(float (&d)[32], const uint32_t (&a)[4], uint64_t b, int acc) { wgmma_rs_n64_k(d, a, b, acc); }
};
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[64], uint64_t a, uint64_t b, int acc) { wgmma_ss_n128(d, a, b, acc); }
};
template <> struct Wgmma<16> {
  static __device__ __forceinline__ void rs(float (&d)[8], const uint32_t (&a)[4], uint64_t b) { wgmma_rs_n16(d, a, b, 1); }
};

// ---------------------------------------------------------------------------
// Small math
// ---------------------------------------------------------------------------

__device__ __forceinline__ float ex2(float x) {  // 2^x, one MUFU op; ex2(-inf) = 0
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

// A rank-3 map over a contiguous bf16 [bh, T, D] tensor, innermost first
// ({D, T, bh}), whose box is [box_rows, D] of one head: rows past T are
// zero-filled within the head (a flat [bh * T, D] map would read the next
// head's rows instead). Swizzle 128B for D = 64, 32B for D = 16.
inline bool rows_map(CUtensorMap* map, const void* ptr, int bh, int T, int D, int box_rows) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_tiled();
  if (!encode || (D != 16 && D != 64)) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)D, (cuuint64_t)T, (cuuint64_t)bh};
  const cuuint64_t strides[2] = {(cuuint64_t)D * 2, (cuuint64_t)T * D * 2};
  const cuuint32_t box[3] = {(cuuint32_t)D, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                D == 64 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_32B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace hopper
