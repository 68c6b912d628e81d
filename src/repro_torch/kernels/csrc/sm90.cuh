// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (attention/csrc/attention_tc.cu, attention_bwd_tc.cu, ssd/csrc/ssd.cu,
// quadconv/csrc/quadconv.cu; each is compiled with -I pointing here):
// mbarriers with TMA copies (tensor-map tiles and 1-D bulk copies),
// 16-byte cp.async copies into the
// 128-byte-swizzled shared-memory layout that wgmma reads, the wgmma
// shared-memory descriptors, and the wgmma instructions themselves (bf16
// inputs, fp32 accumulators) as inline PTX.
//
// Tile layout.  A tile of R rows by DHP bf16 columns (DHP = 64, 128 or
// 192) is stored as DHP / 64 column blocks, each R rows of 128 bytes; block c
// starts at c * R * 128 bytes.  Inside a block, the 16-byte chunk j of row
// r sits at r * 128 + ((j ^ (r % 8)) * 16): CUTLASS's Swizzle<3,4,3>, the
// layout TMA writes with CU_TENSOR_MAP_SWIZZLE_128B.  Tiles start on
// 1024-byte boundaries, so the swizzle's phase is the address's own and a
// descriptor's base offset stays 0.
//
// Such a tile is read by wgmma in two ways (the descriptors' strides follow
// CUTLASS's canonical GMMA layouts, cute/atom/mma_traits_sm90_gmma.hpp):
// * K-major (rows are M or N, columns the reduction axis): rows 128 bytes
//   apart, 8-row groups SBO = 1024 bytes apart; the k-th 16-column step of
//   a column block starts 32 k bytes in;
// * MN-major (rows are the reduction axis, columns N; the transposed-B form
//   16-bit types allow): 64 columns per 128-byte row, the next 64 columns
//   LBO = R * 128 bytes on (the next column block), 8-row groups SBO = 1024
//   bytes apart; the k-th 16-row step starts 2048 k bytes in.

#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing links libcuda
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronously; ``src_bytes`` 0 writes zeros
// and reads nothing.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// 4 bytes global -> shared, asynchronously (zeros when ``src_bytes`` is 0).
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Makes this thread's completed generic-proxy writes to shared memory (the
// cp.async copies) visible to the async proxy that wgmma reads through;
// a barrier after it publishes them to the whole block.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// --- mbarriers and TMA -------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Makes initialised mbarriers visible to the async proxy (TMA).
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// One arrival that also announces ``bytes`` to come by TMA.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// One plain arrival (a consumer releasing a ring stage).
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// Spins until the barrier's phase ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// A 4-D tile of a tensor map into shared memory; its bytes complete on
// ``bar``.  Coordinates innermost first, in elements.
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// ``bytes`` contiguous bytes global -> shared by TMA (a 1-D bulk copy, no
// tensor map); they complete on ``bar``.  Addresses and size 16-byte
// aligned.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// 2^x on the special-function unit (flush-to-zero: 2^x < 2^-126 is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keeps the compiler from moving reads or writes of accumulator registers
// across the asynchronous wgmma window, and keeps A-operand registers live
// (unreused) until the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int L, int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[L][M][N]) {
#pragma unroll
  for (int i = 0; i < L; ++i)
#pragma unroll
    for (int j = 0; j < M; ++j)
#pragma unroll
      for (int k = 0; k < N; ++k)
        asm volatile("" : "+r"(r[i][j][k])::"memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle (layout type 1).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// K-major descriptor of the k-th 16-column step of a tile of ``rows`` rows
// (starting at row ``row0``, a multiple of 8).
__device__ __forceinline__ uint64_t desc_k_major(uint32_t tile, int rows,
                                                 int row0, int k) {
  return desc_sw128(tile + (k >> 2) * rows * 128 + row0 * 128 + (k & 3) * 32,
                    16, 1024);
}

// MN-major descriptor of the k-th 16-row step of a tile of ``rows`` rows.
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t tile, int rows,
                                                  int k) {
  return desc_sw128(tile + k * 2048, rows * 128, 1024);
}

// Byte offset of the 16-byte chunk c (columns [8 c, 8 c + 8)) of row r in a
// swizzled tile of kRows rows (the tile layout above).
template <int kRows>
__device__ __forceinline__ uint32_t swizzle_offset(int r, int c) {
  return (c >> 3) * (kRows * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

// 16 bytes registers -> shared memory (a generic-proxy write: publish it to
// wgmma with fence_proxy_async and a barrier, as a cp.async copy).
__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint32_t x,
                                             uint32_t y, uint32_t z,
                                             uint32_t w) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(x), "r"(y), "r"(z), "r"(w)
               : "memory");
}

// Rows [0, kRows) of a [rows, dh] bf16 matrix (row stride ``ld`` elements,
// 16-byte aligned rows) into a swizzled tile of kRows x DHP; rows from
// ``n_rows`` on and columns from ``dh`` on are zeros.  Every thread of the
// block takes its share of the 16-byte chunks.
template <int kRows, int DHP>
__device__ __forceinline__ void load_tile(uint32_t tile,
                                          const __nv_bfloat16* src,
                                          long long ld, int n_rows, int dh,
                                          int tid, int n_threads) {
  constexpr int kChunks = DHP / 8;
#pragma unroll 4
  for (int id = tid; id < kRows * kChunks; id += n_threads) {
    const int r = id / kChunks;
    const int c = id % kChunks;
    const bool ok = r < n_rows && c * 8 < dh;
    const __nv_bfloat16* g = ok ? src + r * ld + c * 8 : src;
    cp_async_16(tile + swizzle_offset<kRows>(r, c), g, ok ? 16 : 0);
  }
}

// Terms a fp32 value is split into for a bf16 product (8 significant bits
// each): x = t0 + t1 + t2 exactly for a normal fp32 x.
constexpr int kTerms = 3;

// The A fragments (m64 x k16, registers) of columns [16 k, 16 k + 16) of an
// m64 x nN fp32 accumulator, as kTerms bf16 fragments whose sum is the
// fp32 values: the accumulator's thread layout is the A operand's, so no
// data moves between threads, and kTerms wgmmas give the product of the
// fp32 values with only the fp32 accumulation's rounding, where one bf16
// rounding of A would move it by up to 2^-9.
template <int N>
__device__ __forceinline__ void split_a(uint32_t (&a)[kTerms][4],
                                        const float (&d)[N], int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float x = d[8 * k + 2 * i];        // the low half of each register
    float y = d[8 * k + 2 * i + 1];
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
      a[t][i] = *reinterpret_cast<const uint32_t*>(&h);
      x -= __low2float(h);
      y -= __high2float(h);
    }
  }
}

// D[64 x 64] (+)= A[64 x 16] * B[16 x 64], A (K-major) and B from shared
// memory through descriptors; trans_b 1 reads B as MN-major (N contiguous).
template <int kTransB>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t desc_a,
                                             uint64_t desc_b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate), "n"(kTransB));
}

// D[64 x 64] += A[64 x 16] * B[16 x 64], A from registers (the bf16
// fragment of an accumulator, see split_a), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(kTransB));
}

// D[64 x 128] += A[64 x 16] * B[16 x 128], A from registers (the bf16
// fragment of an accumulator, see split_a), B from shared memory.
template <int kTransB>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b,
                                              int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate), "n"(kTransB));
}

// acc = A B over 64 reduction rows: A as the kTerms bf16 fragments of
// each 16-column step (split_a), B a tile of 64 rows read MN-major
// (issued, not waited for).
template <int DHP>
__device__ __forceinline__ void issue_split_product(
    float (&acc)[DHP / 2], const uint32_t (&a)[4][kTerms][4], uint32_t sB) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint64_t db = desc_mn_major(sB, 64, kk);
#pragma unroll
    for (int t = 0; t < kTerms; ++t) {
      const int add = kk + t > 0;      // the first wgmma starts from zero
      if constexpr (DHP == 128)
        wgmma_rs_n128<1>(acc, a[kk][t], db, add);
      else
        wgmma_rs_n64<1>(acc, a[kk][t], db, add);
    }
  }
}

// acc += A B over 64 reduction rows, one 64-column block of B at a time
// (DHP / 64 rounds): each round's product is summed by the tensor cores
// into ``part`` (32 registers, not DHP / 2), waited for, and added to its
// columns of acc in fp32.  The wide head dims (DHP = 192) take it: a
// whole-width partial beside the accumulator and A's terms would pass 255
// registers a thread.  Waits for its own wgmmas; the caller fences ``a``
// and acc before it.
template <int DHP>
__device__ __forceinline__ void split_product_by_blocks(
    float (&acc)[DHP / 2], float (&part)[32], uint32_t (&a)[4][kTerms][4],
    uint32_t sB) {
#pragma unroll
  for (int cb = 0; cb < DHP / 64; ++cb) {
    fence_regs(part);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t db = desc_mn_major(sB + cb * 64 * 128, 64, kk);
#pragma unroll
      for (int t = 0; t < kTerms; ++t)
        wgmma_rs_n64<1>(part, a[kk][t], db, kk + t > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(part);
    fence_regs(a);
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[32 * cb + i] += part[i];
  }
}

}  // namespace sm90
