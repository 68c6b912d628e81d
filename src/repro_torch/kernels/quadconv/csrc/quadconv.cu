// Hand-written Hopper (sm_90a) kernel for the QuadConv quadrature contraction
//
//     out[b, j, o] = sum_{i, c} (w[i] * f[b, i, c]) * G[j, i, o, c]
//
// It replaces src/repro/kernels/quadconv/kernel.py::quadconv_matmul (_kernel),
// the TPU GEMM (F (.) w_K) @ G_m.  Unlike that wrapper, it reads G in its
// native [J, I, O, C] layout: the transpose to G_m [I*C, J*O]
// (src/repro/kernels/quadconv/ops.py:79) would copy G once more -- 4.29 GB at
// block 0 of the served encoder.
//
// Bound: at the batches the port runs (B <= 8) it does 2 * B flops per 4-byte
// element of G, far below the H100's fp32 balance (~20 flop per byte), and G
// is read once, so the kernel is a stream of G: block 0 of the served encoder
// (J = I = 4096, O = 16, C = 4) reads 4.29 GB, 1.28 ms at 3.35 TB/s.  The
// design's goal is the card's read rate at every shape, including those
// with few output points (J = 512 at O = C = 16 is 268 MB, 0.080 ms).
//
// Design: split-I, with G streamed by the Tensor Memory Accelerator.
// * Work items are (chunk s of the i axis, tile of kJTile output points j).
//   The chunk length L and the count S come from the wrapper's plan
//   (ops.py::_split_plan), which depends on (I, J, O, C) and the SM count,
//   never on B.  An item is K = L / rows ring stages (the last chunk's
//   K_last).  The W stages of all items, chunk-major (chunk, then tile, then
//   stage), are cut into ``grid`` equal runs, one per persistent block, so
//   every SM streams the same bytes, and a block's run stays within one or
//   two chunks.  The plan keeps a run at least K stages long, so a run's end
//   cuts an item in two pieces at most.  grid.y takes batch groups of
//   kMaxB rows, each walking the same runs (G is read once per group).
// * Warp 8 is the producer.  One lane streams G[j, i0:i1, :, :] of each
//   piece through a ring of ``stages`` shared-memory stages.  A stage holds
//   ``rows`` = 1024 / (O*C) rows of i for each of the tile's j: kJTile 1-D
//   bulk copies of 4 KB, which complete on the stage's "full" mbarrier.  The
//   consumer warps release a stage on its "empty" mbarrier.  The bytes in
//   flight (``stages`` x 16 KB an SM: 4-5 stages, what the staged f leaves
//   of the shared memory) do not depend on how many threads load.
// * Warps 0-7 consume.  Thread (p, v) owns row p of every stage and float4
//   lane v of that row (V = O*C/4 lanes, rows * V = 256 threads), and keeps
//   kJTile x kMaxB accumulators: each f value it reads serves kJTile rows of
//   G.  f[b, i0:i1, :] of the chunk and the group's rows b, and w[i0:i1],
//   are staged in shared memory when the block's run enters the chunk
//   (cp.async), outside the ring, under a named barrier that the producer
//   does not join, so G's stream never waits on it.  w scales the G row as
//   it is read: acc += (G * w[i]) . f[b].
// * Epilogue of a piece: each thread's accumulators are its rows' partial
//   sums; the C/4 lanes of one output channel, and the phases p that share a
//   warp, are summed with shuffles, the warps' (or phases') partials through
//   shared memory in a fixed order.  The piece's partial goes to slot 2 s
//   (the item's first piece) or 2 s + 1 (its second) of the workspace
//   ws [2 S, B, J, O]; a whole item writes zeros to its second slot.  A
//   second kernel (quadconv_sum_kernel, launched by the same C entry) sums
//   the 2 S slots in order.
//
// Measured on an H100 (PERF.md; kernels/quadconv/bench.py): these runs beat
// whole items round robin, which restage f every few items; staging f once
// a chunk beats copying its rows into every ring stage (eight 256-byte
// copies a stage at B = 8); rings deeper than 4-5 stages, or 8 KB a j a
// stage, gain nothing; the epilogues take 2-5% of the time once their
// shuffles pipeline (interleaved with the lane tests, ~2.5 us a piece).
//
// No floating-point atomics.  An output's summation order depends on (I, O,
// C) and the plan only, never on B, so a row's bits are the same at B = 1
// (three-step serving) and B = 8 (a drained continuous batch), and on a
// rerun.
//
// Takes: fp32; C % 4 == 0 and C <= 128; O * C a power of two in [4, 1024]
// (so a G row is a multiple of 16 bytes and a stage row group 4 KB); f, w,
// g 16-byte aligned and contiguous.  The Python wrapper checks all of it and
// sizes the shared memory (chunk, stages) within Hopper's 227 KB.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kMaxB = 8;           // batch rows per group
constexpr int kJTile = 4;          // output points j per work item
constexpr int kConsumerWarps = 8;
constexpr int kConsumers = 32 * kConsumerWarps;
constexpr int kThreads = kConsumers + 32;  // + the producer warp
constexpr int kStageFloats = 1024;         // floats of G per j per stage

// The consumer warps only (the producer never joins).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory");
}

// Stages [r0, r0 + len) (of the chunk's ``ks``) of item (s, t): a block's
// share of one work item.
struct Piece {
  int s, t, r0, len, ks;
};

// The piece that starts at unit ``u`` (units are ring stages, chunk-major:
// chunk s, then tile t, then stage r within the chunk) and ends at the
// item's end or at ``end``.
__device__ __forceinline__ Piece piece_at(long long u, long long end,
                                          int tiles, int K, int K_last,
                                          int S) {
  Piece pc;
  const long long per_chunk = (long long)tiles * K;
  pc.s = static_cast<int>(min(u / per_chunk, (long long)(S - 1)));
  const long long v = u - pc.s * per_chunk;
  pc.ks = pc.s == S - 1 ? K_last : K;
  pc.t = static_cast<int>(v / pc.ks);
  pc.r0 = static_cast<int>(v - (long long)pc.t * pc.ks);
  pc.len = static_cast<int>(min(end - u, (long long)(pc.ks - pc.r0)));
  return pc;
}

__global__ void __launch_bounds__(kThreads, 1) quadconv_contract_kernel(
    const float* __restrict__ f, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ ws, int B, int I,
    int J, int O, int C, int L, int S, int stages) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int OC = O * C;
  const int rows = kStageFloats / OC;  // rows of i per stage = phases p
  const int groups = min(rows, kConsumerWarps);  // partials per piece
  const int tiles = (J + kJTile - 1) / kJTile;
  const int K = L / rows;  // stages per chunk (the last chunk: K_last)
  const int K_last = (I - (S - 1) * L + rows - 1) / rows;
  const long long W = (long long)tiles * ((S - 1) * K + K_last);
  const long long beg = W * blockIdx.x / gridDim.x;
  const long long end = W * (blockIdx.x + 1) / gridDim.x;
  const int b0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - b0);
  // [stages][kJTile][kStageFloats] G | [kMaxB][L][C] f |
  // [groups][kJTile][kMaxB][O] partials | full[stages], empty[stages] | [L] w
  float* ring = reinterpret_cast<float*>(smem);
  float* fs = ring + stages * kJTile * kStageFloats;
  float* red = fs + kMaxB * L * C;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + groups * kJTile * kMaxB * O);
  uint64_t* empty = full + stages;
  float* wsm = reinterpret_cast<float*>(empty + stages);

  if (threadIdx.x == 0) {
    for (int q = 0; q < stages; ++q) {
      sm90::mbar_init(sm90::smem_u32(full + q), 1);
      sm90::mbar_init(sm90::smem_u32(empty + q), kConsumerWarps);
    }
    sm90::mbar_fence_init();
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp == kConsumerWarps) {  // the producer
    if (lane == 0) {
      int slot = 0, phase = 0;  // the ring's next stage and its round
      for (long long u = beg; u < end;) {
        const Piece pc = piece_at(u, end, tiles, K, K_last, S);
        const int j0 = pc.t * kJTile;
        const int nj = min(kJTile, J - j0);
        const int i0 = pc.s * L;
        const int n = min(I, i0 + L) - i0;
        for (int r = pc.r0; r < pc.r0 + pc.len; ++r) {
          sm90::mbar_wait(sm90::smem_u32(empty + slot), phase ^ 1);
          const uint32_t bytes = min(rows, n - r * rows) * OC * 4;
          const uint32_t bar = sm90::smem_u32(full + slot);
          sm90::mbar_expect_tx(bar, bytes * nj);
          for (int jj = 0; jj < nj; ++jj)
            sm90::bulk_load(
                sm90::smem_u32(ring + (slot * kJTile + jj) * kStageFloats),
                g + ((size_t)(j0 + jj) * I + i0 + r * rows) * OC, bytes, bar);
          if (++slot == stages) slot = 0, phase ^= 1;
        }
        u += pc.len;
      }
    }
    return;
  }

  const int tid = threadIdx.x;
  const int C4 = C >> 2;
  const int V = OC >> 2;
  const int p = tid / V;
  const int c4 = (tid % V) % C4;
  const int o = (tid % V) / C4;
  const int grp = V >= 32 ? p : warp;  // whose partial this thread adds to
  const bool writes = c4 == 0 && (V >= 32 || lane < V);
  const float4* ring4 = reinterpret_cast<const float4*>(ring);
  const float4* fs4 = reinterpret_cast<const float4*>(fs);
  const float4* f4 = reinterpret_cast<const float4*>(f);
  const uint32_t fs_u32 = sm90::smem_u32(fs);
  const uint32_t wsm_u32 = sm90::smem_u32(wsm);
  int slot = 0, phase = 0;
  int staged = -1;  // the chunk whose f and w are in shared memory
  for (long long u = beg; u < end;) {
    const Piece pc = piece_at(u, end, tiles, K, K_last, S);
    const int j0 = pc.t * kJTile;
    const int nj = min(kJTile, J - j0);
    const int i0 = pc.s * L;
    const int n = min(I, i0 + L) - i0;
    if (pc.s != staged) {  // every consumer is past the last epilogue
      const int per_b = n * C4;
      for (int idx = tid; idx < nb * per_b; idx += kConsumers) {
        const int b = idx / per_b;
        const int r = idx - b * per_b;
        sm90::cp_async_16(fs_u32 + (b * L * C4 + r) * 16,
                          f4 + ((size_t)(b0 + b) * I + i0) * C4 + r, 16);
      }
      for (int ii = tid; ii < n; ii += kConsumers)
        sm90::cp_async_4(wsm_u32 + ii * 4, w + i0 + ii, 4);
      sm90::cp_async_commit();
      sm90::cp_async_wait<0>();
      consumer_sync();
      staged = pc.s;
    }

    float acc[kJTile][kMaxB];
#pragma unroll
    for (int jj = 0; jj < kJTile; ++jj)
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) acc[jj][b] = 0.f;

    for (int r = pc.r0; r < pc.r0 + pc.len; ++r) {
      sm90::mbar_wait(sm90::smem_u32(full + slot), phase);
      const int row = r * rows + p;
      if (row < n) {
        const float4* st =
            ring4 + slot * (kJTile * kStageFloats / 4) + tid;
        float4 fv[kMaxB];
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          if (b < nb) fv[b] = fs4[(b * L + row) * C4 + c4];
        const float wi = wsm[row];
#pragma unroll
        for (int jj = 0; jj < kJTile; ++jj) {
          if (jj < nj) {
            float4 gv = st[jj * (kStageFloats / 4)];
            gv.x *= wi;
            gv.y *= wi;
            gv.z *= wi;
            gv.w *= wi;
#pragma unroll
            for (int b = 0; b < kMaxB; ++b) {
              if (b < nb) {
                float a = acc[jj][b];
                a = fmaf(gv.x, fv[b].x, a);
                a = fmaf(gv.y, fv[b].y, a);
                a = fmaf(gv.z, fv[b].z, a);
                a = fmaf(gv.w, fv[b].w, a);
                acc[jj][b] = a;
              }
            }
          }
        }
      }
      __syncwarp();
      if (lane == 0) sm90::mbar_arrive(sm90::smem_u32(empty + slot));
      if (++slot == stages) slot = 0, phase ^= 1;
    }

    // Lanes xor ``off`` apart hold other c4 of one channel (off < C4) or,
    // when a row is narrower than a warp, other phases (off >= V); between
    // them lie other channels o, which are not summed.  The test is outside
    // the accumulators' loops, so their 32 shuffles pipeline.
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      if (off < C4 || off >= V) {
#pragma unroll
        for (int jj = 0; jj < kJTile; ++jj)
#pragma unroll
          for (int b = 0; b < kMaxB; ++b)
            acc[jj][b] += __shfl_xor_sync(0xffffffffu, acc[jj][b], off);
      }
    }
    if (writes) {
#pragma unroll
      for (int jj = 0; jj < kJTile; ++jj)
#pragma unroll
        for (int b = 0; b < kMaxB; ++b)
          red[((grp * kJTile + jj) * kMaxB + b) * O + o] = acc[jj][b];
    }
    consumer_sync();
    // The item's first piece goes to slot 2 s, a second piece (the item
    // cut by the end of a block's share) to slot 2 s + 1; a whole item
    // writes zeros there.
    const int slot = 2 * pc.s + (pc.r0 > 0);
    const bool whole = pc.r0 == 0 && pc.len == pc.ks;
    const int per_grp = kJTile * kMaxB * O;
    for (int idx = tid; idx < per_grp; idx += kConsumers) {
      const int jj = idx / (kMaxB * O);
      const int b = idx / O % kMaxB;
      if (jj < nj && b < nb) {
        float sum = red[idx];
#pragma unroll
        for (int k = 1; k < kConsumerWarps; ++k)
          if (k < groups) sum += red[k * per_grp + idx];
        const size_t at =
            ((size_t)(slot * B + b0 + b) * J + j0 + jj) * O + idx % O;
        ws[at] = sum;
        if (whole) ws[at + (size_t)B * J * O] = 0.f;
      }
    }
    consumer_sync();  // red and the staged f, w are free again
    u += pc.len;
  }
}

// out[n] = sum over the slots s, in order, of ws[s, n] (n = B * J * O).
__global__ void quadconv_sum_kernel(const float* __restrict__ ws,
                                    float* __restrict__ out, long long n,
                                    int S) {
  for (long long k = blockIdx.x * (long long)blockDim.x + threadIdx.x; k < n;
       k += (long long)gridDim.x * blockDim.x) {
    float sum = ws[k];
    for (int s = 1; s < S; ++s) sum += ws[s * n + k];
    out[k] = sum;
  }
}

// Bytes of dynamic shared memory the kernel takes for a plan
// (ops.py::_smem_bytes computes the same to size ``stages``).
long long smem_bytes(int O, int C, int L, int stages) {
  const int rows = kStageFloats / (O * C);
  const int groups = rows < kConsumerWarps ? rows : kConsumerWarps;
  return 4LL * (stages * kJTile * kStageFloats + kMaxB * L * C + L +
                groups * kJTile * kMaxB * O) +
         16LL * stages;
}

}  // namespace

// One contraction: the split kernel on ``grid`` x ceil(B / kMaxB) blocks,
// then the sum over the 2 S slots of ws (2 S * B * J * O floats).
extern "C" int quadconv_contract(const void* f, const void* w, const void* g,
                                 void* out, void* ws, int B, int I, int J,
                                 int O, int C, int L, int S, int stages,
                                 int grid, void* stream) {
  const long long smem = smem_bytes(O, C, L, stages);
  cudaError_t err = cudaFuncSetAttribute(
      quadconv_contract_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 blocks(grid, (B + kMaxB - 1) / kMaxB);
  quadconv_contract_kernel<<<blocks, kThreads, smem, st>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(ws), B, I, J, O, C,
      L, S, stages);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long n = (long long)B * J * O;
  const int sum_blocks =
      static_cast<int>(n / 256 + 1 < 4096 ? n / 256 + 1 : 4096);
  quadconv_sum_kernel<<<sum_blocks, 256, 0, st>>>(
      static_cast<const float*>(ws), static_cast<float*>(out), n, 2 * S);
  return static_cast<int>(cudaGetLastError());
}
