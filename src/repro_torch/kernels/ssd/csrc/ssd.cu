// Hand-written Hopper (sm_90a) kernels for the Mamba-2 SSD intra-chunk step
//
// For every chunk bc (batch x chunk folded) and head h, over the Q steps of
// the chunk (all fp32, as the reference is):
//
//     cum[i]      = sum_{l <= i} a[bc, l, h]
//     y[i, h, :]  = sum_{j <= i} (c_i . b_j) exp(cum_i - cum_j) xdt[j, h, :]
//     state[h]    = sum_j exp(cum_last - cum_j) xdt[j, h, :] (x) b_j
//
// They replace src/repro/kernels/ssd/kernel.py::ssd_intra (_kernel), whose
// grid step holds a whole chunk for a block of 8 heads in VMEM: the Q x Q
// scores and decay matrix (256 KB each at Q = 256) and the b and c tiles
// (128 KB each at N = 128) do not fit in a Hopper block's 227 KB of shared
// memory.  So here:
//
// * ssd_y_kernel: one block per (bc, h, 64-row tile of queries i).  It
//   scans a[bc, :, h] into cum in shared memory, then for each 64-column
//   tile of j at or below the diagonal builds the scores c_i . b_j over
//   64-wide tiles of N, weights them by exp(cum_i - cum_j) and multiplies
//   by the xdt tile.  The decay is masked BEFORE the exp (a select, never a
//   multiply by a 0/1 mask): above the diagonal cum_i - cum_j > 0 and exp
//   can overflow to inf, and inf * 0 would be NaN.  Tiles above the
//   diagonal are skipped whole.  The blocks of the 64 heads each rebuild
//   the head-independent scores tile: simple first, shared scores later.
// * ssd_state_kernel: one block per (bc, h, 64-wide tile of N), the chunk
//   state as a [P, Q] x [Q, N] product with the decay folded into xdt.
//
// Both compute cum with the same block scan, so the cum written by the first
// equals the one the second uses.  The inter-chunk recurrence stays in
// PyTorch (src/repro_torch/kernels/ssd/ops.py), as in the reference.
//
// Bound at the Mamba-2 prefill (B = 4, S = 2048 -> BC = 32, Q = 256, H = 64,
// P = 64, N = 128): ~340 MB in and out, 0.10 ms at 3.35 TB/s; ~26 GFLOP
// dense, ~18 with the causal half skipped, 0.27 ms at 67 TFLOP/s fp32.  So
// it is bound by operations.  Design against that bound: fp32 FMA on 64 x 64
// register-blocked tiles (each of 256 threads owns a 4 x 4 block), operands
// read from shared memory as float4 from rows padded by 4 floats, causal
// tiles skipped; 8,192 + 2,048 blocks fill the 132 SMs.  Rebuilding the
// scores per head costs another ~17 GFLOP: the first thing to cut.
//
// Takes: fp32, contiguous xdt [BC, Q, H, P], a [BC, Q, H], b, c [BC, Q, N];
// P a multiple of 4 and at most 64; Q at most 4096; any N.  The Python
// wrapper checks all of it.

#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // tile edge (rows i, columns j, N, P)
constexpr int kLd = kT + 4;     // padded shared-memory row
constexpr int kThreads = 256;
constexpr int kMaxQ = 4096;

// In-place inclusive prefix sum of s[0, n) in shared memory by the whole
// block: each thread sums a run of ceil(n / 256) elements in order, then the
// runs are offset by a warp-shuffle scan of their totals.  Deterministic.
__device__ void block_inclusive_scan(float* s, int n, float* warp_tot) {
  const int per = (n + kThreads - 1) / kThreads;
  const int lo = min(threadIdx.x * per, n);
  const int hi = min(lo + per, n);
  float run = 0.f;
  for (int i = lo; i < hi; ++i) {
    run += s[i];
    s[i] = run;
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float x = run;
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  if (warp == 0) {
    float t = lane < kThreads / 32 ? warp_tot[lane] : 0.f;
    for (int off = 1; off < 32; off <<= 1) {
      const float y = __shfl_up_sync(0xffffffffu, t, off);
      if (lane >= off) t += y;
    }
    if (lane < kThreads / 32) warp_tot[lane] = t;
  }
  __syncthreads();
  const float offset = (x - run) + (warp > 0 ? warp_tot[warp - 1] : 0.f);
  for (int i = lo; i < hi; ++i) s[i] += offset;
  __syncthreads();
}

// cum[0, Q) of a[bc, :, h] into shared memory.
__device__ void load_cum(float* cum, float* warp_tot, const float* a, int bc,
                         int Q, int H, int h) {
  for (int i = threadIdx.x; i < Q; i += kThreads)
    cum[i] = a[((size_t)bc * Q + i) * H + h];
  __syncthreads();
  block_inclusive_scan(cum, Q, warp_tot);
}

__global__ void __launch_bounds__(kThreads) ssd_y_kernel(
    const float* __restrict__ xdt, const float* __restrict__ a,
    const float* __restrict__ b, const float* __restrict__ c,
    float* __restrict__ y, float* __restrict__ cum_out, int Q, int H, int P,
    int N) {
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);  // [Q], Q rounded up to 4
  float* Cs = cum + ((Q + 3) & ~3);              // [kT][kLd] c rows i
  float* Bs = Cs + kT * kLd;                     // [kT][kLd] b rows j
  float* Ws = Bs + kT * kLd;                     // [kT][kLd] weighted scores
  float* Xs = Ws + kT * kLd;                     // [kT][kLd] xdt rows j
  __shared__ float warp_tot[kThreads / 32];

  const int n_it = gridDim.x;
  const int it = n_it - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int i0 = it * kT;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_cum(cum, warp_tot, a, bc, Q, H, h);
  for (int r = threadIdx.x; r < kT; r += kThreads)
    if (i0 + r < Q) cum_out[((size_t)bc * Q + i0 + r) * H + h] = cum[i0 + r];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  const float* cb = c + (size_t)bc * Q * N;
  const float* bb = b + (size_t)bc * Q * N;
  for (int jt = 0; jt <= it; ++jt) {
    const int j0 = jt * kT;
    // scores s[r][cc] = c_{i0 + ty + 16 r} . b_{j0 + tx + 16 cc}
    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) s[r][cc] = 0.f;
    for (int n0 = 0; n0 < N; n0 += kT) {
      __syncthreads();  // the previous tile's readers are done
      for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
        const int r = idx / kT;
        const int n = idx - r * kT;
        const bool in_n = n0 + n < N;
        Cs[r * kLd + n] = (in_n && i0 + r < Q)
                              ? cb[(size_t)(i0 + r) * N + n0 + n] : 0.f;
        Bs[r * kLd + n] = (in_n && j0 + r < Q)
                              ? bb[(size_t)(j0 + r) * N + n0 + n] : 0.f;
      }
      __syncthreads();
      for (int n = 0; n < kT; n += 4) {
        float4 cv[4], bv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          cv[r] = *reinterpret_cast<const float4*>(&Cs[(ty + 16 * r) * kLd + n]);
#pragma unroll
        for (int cc = 0; cc < 4; ++cc)
          bv[cc] = *reinterpret_cast<const float4*>(&Bs[(tx + 16 * cc) * kLd + n]);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int cc = 0; cc < 4; ++cc) {
            s[r][cc] = fmaf(cv[r].x, bv[cc].x, s[r][cc]);
            s[r][cc] = fmaf(cv[r].y, bv[cc].y, s[r][cc]);
            s[r][cc] = fmaf(cv[r].z, bv[cc].z, s[r][cc]);
            s[r][cc] = fmaf(cv[r].w, bv[cc].w, s[r][cc]);
          }
      }
    }
    // decay weights, masked before the exp
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const int j = j0 + tx + 16 * cc;
        Ws[(ty + 16 * r) * kLd + tx + 16 * cc] =
            (i < Q && j <= i) ? s[r][cc] * expf(cum[i] - cum[j]) : 0.f;
      }
    }
    const float* xb = xdt + ((size_t)bc * Q + j0) * H * P + (size_t)h * P;
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int r = idx / kT;
      const int p = idx - r * kT;
      Xs[r * kLd + p] =
          (p < P && j0 + r < Q) ? xb[(size_t)r * H * P + p] : 0.f;
    }
    __syncthreads();
    if (4 * tx < P) {
      for (int k = 0; k < kT; k += 4) {
        float4 w4[4];
#pragma unroll
        for (int r = 0; r < 4; ++r)
          w4[r] = *reinterpret_cast<const float4*>(&Ws[(ty + 16 * r) * kLd + k]);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(&Xs[(k + e) * kLd + 4 * tx]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const float w = e == 0 ? w4[r].x
                          : e == 1 ? w4[r].y
                          : e == 2 ? w4[r].z
                                   : w4[r].w;
            acc[r][0] = fmaf(w, x4.x, acc[r][0]);
            acc[r][1] = fmaf(w, x4.y, acc[r][1]);
            acc[r][2] = fmaf(w, x4.z, acc[r][2]);
            acc[r][3] = fmaf(w, x4.w, acc[r][3]);
          }
        }
      }
    }
  }

  if (4 * tx < P) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i < Q) {
        float* yrow = y + (((size_t)bc * Q + i) * H + h) * P + 4 * tx;
        *reinterpret_cast<float4*>(yrow) =
            make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads) ssd_state_kernel(
    const float* __restrict__ xdt, const float* __restrict__ a,
    const float* __restrict__ b, float* __restrict__ state, int Q, int H,
    int P, int N) {
  extern __shared__ float4 smem4[];
  float* cum = reinterpret_cast<float*>(smem4);
  float* Xw = cum + ((Q + 3) & ~3);  // [kT (j)][kLd (p)], decay folded in
  float* Bs = Xw + kT * kLd;          // [kT (j)][kLd (n)]
  __shared__ float warp_tot[kThreads / 32];

  const int n0 = blockIdx.x * kT;
  const int h = blockIdx.y;
  const int bc = blockIdx.z;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_cum(cum, warp_tot, a, bc, Q, H, h);
  const float last = cum[Q - 1];

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[r][e] = 0.f;

  for (int j0 = 0; j0 < Q; j0 += kT) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < kT * kT; idx += kThreads) {
      const int r = idx / kT;
      const int col = idx - r * kT;
      const int j = j0 + r;
      Xw[r * kLd + col] =
          (j < Q && col < P)
              ? xdt[(((size_t)bc * Q + j) * H + h) * P + col] *
                    expf(last - cum[j])
              : 0.f;
      Bs[r * kLd + col] = (j < Q && n0 + col < N)
                              ? b[((size_t)bc * Q + j) * N + n0 + col] : 0.f;
    }
    __syncthreads();
    for (int jj = 0; jj < kT; ++jj) {
      const float4 b4 = *reinterpret_cast<const float4*>(&Bs[jj * kLd + 4 * tx]);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float xw = Xw[jj * kLd + ty + 16 * r];
        acc[r][0] = fmaf(xw, b4.x, acc[r][0]);
        acc[r][1] = fmaf(xw, b4.y, acc[r][1]);
        acc[r][2] = fmaf(xw, b4.z, acc[r][2]);
        acc[r][3] = fmaf(xw, b4.w, acc[r][3]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int p = ty + 16 * r;
    if (p >= P) continue;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = n0 + 4 * tx + e;
      if (n < N) state[(((size_t)bc * H + h) * P + p) * N + n] = acc[r][e];
    }
  }
}

}  // namespace

extern "C" int ssd_intra(const void* xdt, const void* a, const void* b,
                         const void* c, void* y, void* state, void* cum,
                         int BC, int Q, int H, int P, int N, void* stream) {
  if (P % 4 || P > kT || Q < 1 || Q > kMaxQ)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t q_floats = (size_t)((Q + 3) & ~3);
  const size_t smem_y = sizeof(float) * (q_floats + 4 * kT * kLd);
  const size_t smem_s = sizeof(float) * (q_floats + 2 * kT * kLd);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_y_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_y);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaFuncSetAttribute(ssd_state_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_s);
  if (err != cudaSuccess) return static_cast<int>(err);
  const float* xf = static_cast<const float*>(xdt);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(b);
  const float* cf = static_cast<const float*>(c);
  dim3 grid_y((Q + kT - 1) / kT, H, BC);
  ssd_y_kernel<<<grid_y, kThreads, smem_y, s>>>(
      xf, af, bf, cf, static_cast<float*>(y), static_cast<float*>(cum), Q, H,
      P, N);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid_s((N + kT - 1) / kT, H, BC);
  ssd_state_kernel<<<grid_s, kThreads, smem_s, s>>>(
      xf, af, bf, static_cast<float*>(state), Q, H, P, N);
  return static_cast<int>(cudaGetLastError());
}
