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
// Bound: at the serving batch (B <= 8) it does 2 * B flops per element of G,
// far below the H100's fp32 balance (~20 flop per byte), so it is bound by
// reading G once.  Block 0 of the encoder (J = I = 4096, O = 16, C = 4) reads
// 4.29 GB, 1.28 ms at 3.35 TB/s; block 1 (J = I = 1024, O = C = 16) 1.07 GB,
// 0.32 ms.
//
// Design: a block of 256 threads owns 256 / V output points j, where
// V = O * C / 4 is the number of float4 lanes in one row G[j, i, :, :].  Each
// group of V threads streams its slice G[j] = [I, O*C] once, coalesced, as
// float4 with evict-first loads (no reuse).  The weighted field w[i] * f[b, i, :]
// for a tile of rows i is staged in shared memory once per block and shared by
// all its j (the TPU kernel fused the same multiply into its LHS load).  Each
// thread keeps kMaxB x 4 fp32 accumulators; at the end the four components and
// the C/4 lanes of one output channel are summed with warp shuffles.  grid.y
// tiles larger batches by kMaxB rows.
//
// A row's summation order depends on (I, O, C) only, never on B, so the bits
// of a response are the same at B = 1 (three-step serving) and B = 8 (a
// drained continuous batch).
//
// Takes: fp32; C % 4 == 0 and C <= 128; O * C a power of two in [4, 1024];
// f, g 16-byte aligned and contiguous.  The Python wrapper checks all of it.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxB = 8;          // batch rows per block
constexpr int kThreads = 256;
constexpr int kTileFloats = 1024;  // staged floats of w*f per batch row

__global__ void __launch_bounds__(kThreads) quadconv_contract_kernel(
    const float* __restrict__ f, const float* __restrict__ w,
    const float* __restrict__ g, float* __restrict__ out, int B, int I, int J,
    int O, int C) {
  extern __shared__ float4 fw[];  // [kMaxB][kTileFloats / 4]
  const int C4 = C >> 2;
  const int V = O * C4;
  const int lane = threadIdx.x % V;
  const int j = blockIdx.x * (kThreads / V) + threadIdx.x / V;
  const int jc = min(j, J - 1);  // groups past J still join the shuffles
  const int b0 = blockIdx.y * kMaxB;
  const int nb = min(kMaxB, B - b0);
  const int tile_i = kTileFloats / C;
  const int q = kTileFloats / 4;  // float4 per staged batch row
  const int cq = lane % C4;       // this lane's float4 within a row of f
  const float4* grow =
      reinterpret_cast<const float4*>(g) + (size_t)jc * I * V + lane;
  const float4* f4 = reinterpret_cast<const float4*>(f);

  float acc[kMaxB][4];
#pragma unroll
  for (int b = 0; b < kMaxB; ++b)
    acc[b][0] = acc[b][1] = acc[b][2] = acc[b][3] = 0.f;

  for (int i0 = 0; i0 < I; i0 += tile_i) {
    const int ti = min(tile_i, I - i0);
    __syncthreads();
    for (int idx = threadIdx.x; idx < nb * q; idx += kThreads) {
      const int b = idx / q;
      const int r = idx - b * q;
      const int ii = r / C4;
      if (ii < ti) {
        const float wi = w[i0 + ii];
        float4 v = f4[((size_t)(b0 + b) * I + i0) * C4 + r];
        v.x *= wi;
        v.y *= wi;
        v.z *= wi;
        v.w *= wi;
        fw[b * q + r] = v;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int ii = 0; ii < ti; ++ii) {
      const float4 gv = __ldcs(grow + (size_t)(i0 + ii) * V);
#pragma unroll
      for (int b = 0; b < kMaxB; ++b) {
        if (b < nb) {
          const float4 fv = fw[b * q + ii * C4 + cq];
          acc[b][0] = fmaf(gv.x, fv.x, acc[b][0]);
          acc[b][1] = fmaf(gv.y, fv.y, acc[b][1]);
          acc[b][2] = fmaf(gv.z, fv.z, acc[b][2]);
          acc[b][3] = fmaf(gv.w, fv.w, acc[b][3]);
        }
      }
    }
  }

  // Sum the four components, then the C/4 lanes of output channel o (they
  // are adjacent and C/4-aligned within one warp).
  const int o = lane / C4;
#pragma unroll
  for (int b = 0; b < kMaxB; ++b) {
    float p = (acc[b][0] + acc[b][1]) + (acc[b][2] + acc[b][3]);
    for (int off = C4 >> 1; off > 0; off >>= 1)
      p += __shfl_xor_sync(0xffffffffu, p, off);
    if (b < nb && j < J && cq == 0)
      out[((size_t)(b0 + b) * J + j) * O + o] = p;
  }
}

}  // namespace

extern "C" int quadconv_contract(const void* f, const void* w, const void* g,
                                 void* out, int B, int I, int J, int O, int C,
                                 void* stream) {
  const int V = O * C / 4;
  const int per_block = kThreads / V;
  dim3 grid((J + per_block - 1) / per_block, (B + kMaxB - 1) / kMaxB);
  const size_t smem = (size_t)kMaxB * kTileFloats * sizeof(float);
  quadconv_contract_kernel<<<grid, kThreads, smem,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f), static_cast<const float*>(w),
      static_cast<const float*>(g), static_cast<float*>(out), B, I, J, O, C);
  return static_cast<int>(cudaGetLastError());
}
