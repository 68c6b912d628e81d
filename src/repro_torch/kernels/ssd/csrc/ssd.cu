// Hand-written Hopper (sm_90a) kernels for the Mamba-2 SSD intra-chunk
// step, on the tensor cores (wgmma)
//
// For every chunk bc (batch x chunk folded) and head h, over the Q steps of
// the chunk (all fp32, as the reference is):
//
//     cum[i]      = sum_{l <= i} a[bc, l, h]
//     y[i, h, :]  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) xdt[j, h, :]
//     state[h]    = sum_j exp(cum_last - cum_j) xdt[j, h, :] (x) b_j
//
// They replace src/repro/kernels/ssd/kernel.py::ssd_intra (_kernel :30),
// whose grid step holds a whole chunk for a block of 8 heads in VMEM: the
// Q x Q scores and decay matrix (256 KB each at Q = 256) and the b and c
// tiles (128 KB each at N = 128) do not fit in a Hopper block's 227 KB of
// shared memory.  The inter-chunk recurrence stays in PyTorch
// (src/repro_torch/kernels/ssd/ops.py), as in the reference.
//
// Bound at the Mamba-2 prefill (B = 4, S = 2048 -> BC = 32, Q = 256,
// H = 64, P = 64, N = 128): ~18 GFLOP with the causal half skipped (the
// scores once a chunk, y and the state per head), 0.27 ms at the fp32 FMA
// rate, but ~0.05 ms as the split bf16 products below at the tensor-core
// rate; ~347 MB in and out, 0.104 ms at 3.35 TB/s.  So on the tensor cores
// the bytes bound it.  The design:
//
// * fp32 products at fp32 accuracy on bf16 tensor cores: each fp32 operand
//   x is split into hi = bf16(x) and lo = bf16(x - hi) (x - hi is exact),
//   and a product is hi.hi + hi.lo + lo.hi, three wgmmas with fp32
//   accumulators: 2^-16 relative at worst per product, where one bf16 (or
//   TF32) rounding of each operand, 2^-9 (2^-11), would not hold y and
//   the state within 1e-4 of their magnitude over 256-term sums.  bf16
//   terms, unlike TF32, can be read MN-major, so the xdt and b tiles serve
//   as B operands as they lie in memory;
// * ssd_scores_tc_kernel: the head-independent scores c_i . b_j^T are
//   built once a chunk, not once a head: a block owns one (bc, i tile,
//   j tile <= i tile) and writes its 64 x 64 tile (wgmma from shared
//   memory, N in chunks of 64, c and b split into hi and lo tiles as they
//   are staged) to a scratch buffer in the accumulator's layout, 16 KB a
//   tile, which stays in L2 for the y kernel;
// * ssd_y_tc_kernel: a block (one warpgroup) owns (bc, a 64-row tile of
//   queries i, a group of kHeads heads), the heaviest i tiles first.  Its
//   four warps each scan one head's a into cum (shared memory).  For each
//   64-column tile of j at or below the diagonal it reads the score tile
//   into registers and stages the group's xdt tiles (hi, lo).  Then, per
//   head, on the score fragments, W = scores * exp(cum_i - cum_j), masked
//   BEFORE the exp (a select to -inf, never a multiply by a 0/1 mask:
//   above the diagonal cum_i - cum_j > 0 and exp can overflow to inf, and
//   inf * 0 is NaN), goes in as the A operand from registers in two bf16
//   terms, and y_h += W xdt_h reads the head's xdt tile as the MN-major B
//   operand.  The group's y accumulators stay in registers over the whole
//   j loop (255 registers a thread, two blocks an SM);
// * ssd_state_tc_kernel: a block owns (bc, h, 128 columns of N); warp 0
//   scans the head's a with the same code (so cum is bit-identical to the
//   y kernel's); for each j tile it stages (xdt_h * exp(cum_last - cum))^T
//   K-major (rows p, columns j) and b MN-major, hi and lo, and the state is
//   [P, Q] x [Q, N] by wgmma from shared memory (128 registers, four
//   blocks an SM);
// * staging is latency-bound: every global read a thread makes for a tile
//   is issued before it stores any of them (a store to shared memory
//   orders the loads after it);
// * every output element has one owner and no atomics, so repeated runs
//   are bit-identical.
//
// Takes: fp32, contiguous xdt [BC, Q, H, P], a [BC, Q, H], b, c [BC, Q, N];
// P a multiple of 4 and at most 64; Q at most 4096; any N (ragged tiles of
// Q, P and N are zero-padded).  The Python wrapper checks all of it.

#include "sm90.cuh"

namespace {

using namespace sm90;

constexpr int kT = 64;            // tile edge: rows i and j, columns p, n
constexpr int kThreads = 128;     // one warpgroup
constexpr int kHeads = 4;         // heads a y block owns
constexpr int kMaxQ = 4096;
constexpr uint32_t kTile = kT * kT * 2;  // bytes of a 64 x 64 bf16 tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr uint32_t kMinusInf = 0xff800000u;  // -inf: ex2 of it is +0
static_assert(kHeads == kThreads / 32, "a warp scans each head's cum");

// In-place inclusive prefix sum of s[0, n) in shared memory by one warp:
// each lane sums a run of ceil(n / 32) elements in order, then the runs are
// offset by a shuffle scan of their totals.  Deterministic: the same n and
// values give the same bits in every block of both kernels.
__device__ void warp_inclusive_scan(float* s, int n, int lane) {
  const int per = (n + 31) / 32;
  const int lo = min(lane * per, n);
  const int hi = min(lo + per, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += s[i];
    s[i] = run;
  }
  float x = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  float before = __shfl_up_sync(0xffffffffu, x, 1);
  if (lane == 0) before = 0.f;
  for (int i = lo; i < hi; ++i) s[i] += before;
}

// Eight fp32 values from ``row`` at columns [col, col + 8); columns from
// ``limit`` on are zeros (``vec``: the row is 16-byte aligned).
__device__ __forceinline__ void load8(const float* row, int col, int limit,
                                      bool vec, float (&v)[8]) {
  if (vec && col + 8 <= limit) {
    const float4 x = *reinterpret_cast<const float4*>(row + col);
    const float4 y = *reinterpret_cast<const float4*>(row + col + 4);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
    v[4] = y.x; v[5] = y.y; v[6] = y.z; v[7] = y.w;
  } else {
#pragma unroll
    for (int e = 0; e < 8; ++e) v[e] = col + e < limit ? row[col + e] : 0.f;
  }
}

// Eight fp32 values as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi),
// into the 16-byte chunk at byte offset ``off`` of the hi and lo tiles.
__device__ __forceinline__ void store_split8(uint32_t hi, uint32_t lo,
                                             uint32_t off,
                                             const float (&v)[8]) {
  uint32_t h[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 t = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const __nv_bfloat162 r = __floats2bfloat162_rn(
        v[2 * i] - __low2float(t), v[2 * i + 1] - __high2float(t));
    h[i] = *reinterpret_cast<const uint32_t*>(&t);
    l[i] = *reinterpret_cast<const uint32_t*>(&r);
  }
  st_shared_v4(hi + off, h[0], h[1], h[2], h[3]);
  st_shared_v4(lo + off, l[0], l[1], l[2], l[3]);
}

// One 64 x 64 block of a row-major fp32 matrix: rows [0, 64) from
// ``src`` (row stride ``ld``), columns [col0, col0 + 64); rows from
// ``n_rows`` on and columns from ``limit`` on read as zeros.
struct Block {
  const float* src;
  long long ld;
  int n_rows, col0, limit;
};

// The block into a hi and a lo swizzled 64 x 64 bf16 tile (lo at
// hi + kTile).  A thread's four chunks are all loaded before any is stored,
// so their reads are in flight together (a store to shared memory orders
// the loads after it); one tile at a time, as the y kernel's registers
// allow.
__device__ __forceinline__ void load_split_tile(uint32_t hi, const Block& blk,
                                                bool vec, int tid) {
  constexpr int kPer = kT * 8 / kThreads;        // chunks a thread
  float v[kPer][8];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int r = (tid + k * kThreads) >> 3;
    load8(blk.src + r * blk.ld, blk.col0 + 8 * (tid & 7),
          r < blk.n_rows ? blk.limit : 0, vec, v[k]);
  }
#pragma unroll
  for (int k = 0; k < kPer; ++k)
    store_split8(hi, hi + kTile,
                 swizzle_offset<kT>((tid + k * kThreads) >> 3, tid & 7),
                 v[k]);
}

// The block's xdt tiles (rows j0.., the ng heads from h0) into hi and lo
// tiles at sX.
__device__ __forceinline__ void load_xdt_tiles(uint32_t sX, const float* xdt,
                                               int bc, int Q, int H, int P,
                                               int j0, int h0, int ng,
                                               bool vec, int tid) {
  const float* rows = xdt + (((size_t)bc * Q + j0) * H + h0) * P;
  for (int g = 0; g < ng; ++g)
    load_split_tile(sX + 2 * g * kTile,
                    {rows + g * P, (long long)H * P, Q - j0, 0, P}, vec, tid);
}

// cum[g][0, Q) of a[bc, :, h0 + g] for the block's ng heads into shared
// memory, one warp a head.
__device__ __forceinline__ void scan_heads(float* cum, const float* a, int bc,
                                           int Q, int H, int h0, int ng,
                                           int tid) {
  for (int idx = tid; idx < ng * Q; idx += kThreads) {
    const int l = idx / ng;
    const int g = idx - l * ng;
    cum[g * Q + l] = a[((size_t)bc * Q + l) * H + h0 + g];
  }
  __syncthreads();
  if (tid / 32 < ng) warp_inclusive_scan(cum + (tid / 32) * Q, Q, tid & 31);
  __syncthreads();
}

// The A fragments of W = scores * exp(cum_i - cum_j) for the k-th 16
// columns of the tile, as two bf16 terms (hi, lo), straight from the score
// fragments (the layout of sm90.cuh split_a): the decay is masked before
// the exp on the diagonal tile (columns past the row), as a select to
// -inf, whose exp2 is +0.
__device__ __forceinline__ void weights_a(uint32_t (&a)[2][4],
                                          const float (&s)[32],
                                          const float* cg, const float (&ci)[2],
                                          int j0, int row_w, int col_in,
                                          bool diag, int Q, int k) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row_w + 8 * (i & 1);                  // i - i0
    const int cl = 8 * (2 * k + (i >> 1)) + col_in;     // j - j0
    float w[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float cj = cg[min(j0 + cl + e, Q - 1)];
      const float d = (!diag || cl + e <= r) ? ci[i & 1] - cj
                                             : __uint_as_float(kMinusInf);
      w[e] = s[8 * k + 2 * i + e] * ex2(d * kLog2e);
    }
    const __nv_bfloat162 t = __floats2bfloat162_rn(w[0], w[1]);
    const __nv_bfloat162 u = __floats2bfloat162_rn(w[0] - __low2float(t),
                                                   w[1] - __high2float(t));
    a[0][i] = *reinterpret_cast<const uint32_t*>(&t);
    a[1][i] = *reinterpret_cast<const uint32_t*>(&u);
  }
}

// Score tiles (16 KB each) in the wgmma accumulator's layout: a thread's
// 32 values as eight float4, the k-th at k * kThreads + tid, so a warp's
// reads are contiguous.
constexpr int kScoreF4 = kT * kT / 4;            // float4 a tile

// The tile (it, jt), jt <= it, of a chunk's causal score tiles, numbered
// row by row.
__device__ __forceinline__ int pair_index(int it, int jt) {
  return it * (it + 1) / 2 + jt;
}

__global__ void __launch_bounds__(kThreads) ssd_scores_tc_kernel(
    const float* __restrict__ b, const float* __restrict__ c,
    float4* __restrict__ scores, int Q, int N, int vec_bc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sC = (smem_u32(smem_raw) + 1023u) & ~1023u;  // hi, lo
  const uint32_t sB = sC + 2 * kTile;                          // hi, lo
  const int tid = threadIdx.x;
  const int pair = blockIdx.x;
  const int bc = blockIdx.y;
  int it = 0;
  while (pair_index(it + 1, 0) <= pair) ++it;
  const int i0 = it * kT;
  const int j0 = (pair - pair_index(it, 0)) * kT;
  const float* c_rows = c + ((size_t)bc * Q + i0) * N;
  const float* b_rows = b + ((size_t)bc * Q + j0) * N;

  // c_i . b_j^T, N in chunks of 64 (the masked ones above the diagonal
  // too: the y kernel selects them away)
  float s[32];
#pragma unroll
  for (int e = 0; e < 32; ++e) s[e] = 0.f;
  for (int n0 = 0; n0 < N; n0 += kT) {
    __syncthreads();  // the last chunk's products are done with the tiles
    load_split_tile(sC, {c_rows, N, Q - i0, n0, N}, vec_bc, tid);
    load_split_tile(sB, {b_rows, N, Q - j0, n0, N}, vec_bc, tid);
    fence_proxy_async();
    __syncthreads();
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ch = desc_k_major(sC, kT, 0, kk);
      const uint64_t cl = desc_k_major(sC + kTile, kT, 0, kk);
      const uint64_t bh = desc_k_major(sB, kT, 0, kk);
      const uint64_t bl = desc_k_major(sB + kTile, kT, 0, kk);
      wgmma_ss_n64<0>(s, ch, bh, 1);
      wgmma_ss_n64<0>(s, ch, bl, 1);
      wgmma_ss_n64<0>(s, cl, bh, 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
  }
  float4* out = scores + ((size_t)bc * gridDim.x + pair) * kScoreF4;
#pragma unroll
  for (int k = 0; k < 8; ++k)
    out[k * kThreads + tid] =
        make_float4(s[4 * k], s[4 * k + 1], s[4 * k + 2], s[4 * k + 3]);
}

constexpr size_t y_smem_bytes(int Q) {
  // the group's xdt tiles (hi, lo), cum, and slack to align the tiles to
  // 1024 bytes
  return 1024 + 2 * kHeads * kTile + sizeof(float) * kHeads * Q;
}

__global__ void __launch_bounds__(kThreads, 2) ssd_y_tc_kernel(
    const float* __restrict__ xdt, const float* __restrict__ a,
    const float4* __restrict__ scores, float* __restrict__ y,
    float* __restrict__ cum_out, int Q, int H, int P, int vec_x) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sX = (raw + 1023u) & ~1023u;      // head g: hi, lo
  float* cum = reinterpret_cast<float*>(smem_raw + (sX + 2 * kHeads * kTile
                                                    - raw));  // [ng][Q]

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int it = gridDim.x - 1 - blockIdx.x;       // heaviest tiles first
  const int h0 = blockIdx.y * kHeads;
  const int bc = blockIdx.z;
  const int i0 = it * kT;
  const int ng = min(kHeads, H - h0);

  scan_heads(cum, a, bc, Q, H, h0, ng, tid);
  for (int idx = tid; idx < kT * ng; idx += kThreads) {
    const int r = idx / ng;
    const int g = idx - r * ng;
    if (i0 + r < Q)
      cum_out[((size_t)bc * Q + i0 + r) * H + h0 + g] = cum[g * Q + i0 + r];
  }

  // this thread's two rows of the tile, row_w and row_w + 8; columns
  // 8 j + col_in (the wgmma accumulator's layout)
  const int row_w = 16 * warp + (lane >> 2);
  const int col_in = 2 * (lane & 3);
  float acc[kHeads][32];                           // y of each head
#pragma unroll
  for (int g = 0; g < kHeads; ++g)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[g][e] = 0.f;

  const float4* tiles =
      scores + ((size_t)bc * pair_index(gridDim.x, 0) + pair_index(it, 0))
                   * kScoreF4;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    __syncthreads();  // the last j tile's products are done with sX
    // the tile's scores (their reads in flight while xdt is staged)
    float s[32];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const float4 v = tiles[(size_t)jt * kScoreF4 + k * kThreads + tid];
      s[4 * k] = v.x;
      s[4 * k + 1] = v.y;
      s[4 * k + 2] = v.z;
      s[4 * k + 3] = v.w;
    }
    load_xdt_tiles(sX, xdt, bc, Q, H, P, j0, h0, ng, vec_x, tid);
    fence_proxy_async();
    __syncthreads();

    // per head: W = scores * exp(cum_i - cum_j) (masked before the exp),
    // then y_h += W xdt_h with W from registers in two bf16 terms
    const bool diag = jt == it;
#pragma unroll
    for (int g = 0; g < kHeads; ++g) {
      if (g >= ng) break;
      const float* cg = cum + g * Q;
      const float ci[2] = {cg[min(i0 + row_w, Q - 1)],
                           cg[min(i0 + row_w + 8, Q - 1)]};
      uint32_t af[4][2][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        weights_a(af[kk], s, cg, ci, j0, row_w, col_in, diag, Q, kk);
      const uint32_t xh = sX + 2 * g * kTile;
      const uint32_t xl = xh + kTile;
      fence_regs(acc[g]);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n64<1>(acc[g], af[kk][0], desc_mn_major(xh, kT, kk), 1);
        wgmma_rs_n64<1>(acc[g], af[kk][0], desc_mn_major(xl, kT, kk), 1);
        wgmma_rs_n64<1>(acc[g], af[kk][1], desc_mn_major(xh, kT, kk), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc[g]);
      fence_regs(af);
    }
  }

  // y [BC, Q, H, P]
#pragma unroll
  for (int g = 0; g < kHeads; ++g) {
    if (g >= ng) break;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = i0 + row_w + 8 * r;
      if (row >= Q) continue;
      float* yrow = y + (((size_t)bc * Q + row) * H + h0 + g) * P;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int p = 8 * j + col_in;
        if (p < P)
          *reinterpret_cast<float2*>(yrow + p) =
              make_float2(acc[g][4 * j + 2 * r], acc[g][4 * j + 2 * r + 1]);
      }
    }
  }
}

constexpr size_t state_smem_bytes(int Q) {
  // (xdt * decay)^T (hi, lo), b's 128 columns (hi, lo: two tiles each),
  // cum, and slack to align the tiles to 1024 bytes
  return 1024 + 6 * kTile + sizeof(float) * Q;
}

__global__ void __launch_bounds__(kThreads, 4) ssd_state_tc_kernel(
    const float* __restrict__ xdt, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ state, int Q, int H,
    int P, int N, int vec_bc) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sA = (raw + 1023u) & ~1023u;      // xw^T: hi, lo
  const uint32_t sB = sA + 2 * kTile;              // b: hi (2 tiles), lo
  float* cum = reinterpret_cast<float*>(smem_raw + (sB + 4 * kTile - raw));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int n0 = blockIdx.x * 2 * kT;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;

  scan_heads(cum, a, bc, Q, H, h, 1, tid);
  const float last = cum[Q - 1];

  float acc[2][32];                                // columns n0 + 64 half
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int e = 0; e < 32; ++e) acc[half][e] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kT) {
    __syncthreads();  // the last tile's readers are done
    // b rows j0.., columns [n0, n0 + 128): two column blocks, MN-major B
    // (four of a thread's chunks loaded before any of them is stored)
    const float* b_rows = b + ((size_t)bc * Q + j0) * N;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float v[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int r = (tid + (4 * half + k) * kThreads) >> 4;
        load8(b_rows + (size_t)r * N, n0 + 8 * (tid & 15),
              r < Q - j0 ? N : 0, vec_bc, v[k]);
      }
#pragma unroll
      for (int k = 0; k < 4; ++k)
        store_split8(sB, sB + 2 * kTile,
                     swizzle_offset<kT>((tid + (4 * half + k) * kThreads) >> 4,
                                        tid & 15),
                     v[k]);
    }
    // (xdt * exp(cum_last - cum))^T: rows p, columns j, K-major A
    {
      const int p = tid & (kT - 1);
      float v[4][8];
#pragma unroll
      for (int k = 0; k < 4; ++k)
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = j0 + 8 * ((tid >> 6) + 2 * k) + e;
          v[k][e] = (p < P && j < Q)
                        ? xdt[(((size_t)bc * Q + j) * H + h) * P + p]
                        : 0.f;
        }
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ch = (tid >> 6) + 2 * k;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const int j = min(j0 + 8 * ch + e, Q - 1);
          v[k][e] *= ex2((last - cum[j]) * kLog2e);
        }
        store_split8(sA, sA + kTile, swizzle_offset<kT>(p, ch), v[k]);
      }
    }
    fence_proxy_async();
    __syncthreads();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t ah = desc_k_major(sA, kT, 0, kk);
      const uint64_t al = desc_k_major(sA + kTile, kT, 0, kk);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const uint32_t bh = sB + half * kTile;
        const uint32_t bl = bh + 2 * kTile;
        wgmma_ss_n64<1>(acc[half], ah, desc_mn_major(bh, kT, kk), 1);
        wgmma_ss_n64<1>(acc[half], ah, desc_mn_major(bl, kT, kk), 1);
        wgmma_ss_n64<1>(acc[half], al, desc_mn_major(bh, kT, kk), 1);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc[0]);
    fence_regs(acc[1]);
  }

  // state [BC, H, P, N]
  const int row_w = 16 * warp + (lane >> 2);
  const int col_in = 2 * (lane & 3);
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int p = row_w + 8 * r;
      if (p >= P) continue;
      float* srow = state + (((size_t)bc * H + h) * P + p) * N;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = n0 + half * kT + 8 * j + col_in + e;
          if (n < N) srow[n] = acc[half][4 * j + 2 * r + e];
        }
    }
}

}  // namespace

// ``scores``: scratch of BC * n (n + 1) / 2 * 64 * 64 floats, n = ceil(Q / 64)
// (the causal score tiles of every chunk).
extern "C" int ssd_intra(const void* xdt, const void* a, const void* b,
                         const void* c, void* y, void* state, void* cum,
                         void* scores, int BC, int Q, int H, int P, int N,
                         void* stream) {
  if (P % 4 || P > kT || Q < 1 || Q > kMaxQ || N < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto aligned = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec_x = aligned(xdt);
  const int vec_bc = N % 4 == 0 && aligned(b) && aligned(c);
  const int n_i = (Q + kT - 1) / kT;
  const size_t smem_c = 1024 + 4 * kTile;
  const size_t smem_y = y_smem_bytes(Q);
  const size_t smem_s = state_smem_bytes(Q);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scores_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem_c);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_y_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_y);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(ssd_state_tc_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem_s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(xdt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  float4* sc = static_cast<float4*>(scores);
  dim3 grid_c(n_i * (n_i + 1) / 2, BC);
  ssd_scores_tc_kernel<<<grid_c, kThreads, smem_c, s>>>(bf, cf, sc, Q, N,
                                                         vec_bc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_y(n_i, (H + kHeads - 1) / kHeads, BC);
  ssd_y_tc_kernel<<<grid_y, kThreads, smem_y, s>>>(
      xf, af, sc, static_cast<float*>(y), static_cast<float*>(cum), Q, H, P,
      vec_x);
  err = cudaGetLastError();
  if (err != cudaSuccess || N == 0) return static_cast<int>(err);
  dim3 grid_s((N + 2 * kT - 1) / (2 * kT), H, BC);
  ssd_state_tc_kernel<<<grid_s, kThreads, smem_s, s>>>(
      xf, af, bf, static_cast<float*>(state), Q, H, P, N, vec_bc);
  return static_cast<int>(cudaGetLastError());
}
