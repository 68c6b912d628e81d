// Hand-written Hopper (sm_90a) kernels: the causal GQA flash-attention
// backward, FlashAttention-2 style, in two passes
//
//     P[i, j]  = exp(scale * q_i . k_j - lse_i)      (0 where masked)
//     dS[i, j] = P[i, j] * (do_i . v_j - D_i),  D_i = rowsum(do_i * o_i)
//     dq_i     = scale * sum_j dS[i, j] k_j                    (dq pass)
//     dv_j     = sum_i P[i, j] do_i,
//     dk_j     = scale * sum_i dS[i, j] q_i                    (dk/dv pass)
//
// They replace src/repro/kernels/attention/bwd.py::flash_attention_bwd, the
// TPU kernels _dq_kernel (grid (BH, i, j), dq carried in VMEM scratch across
// the kv axis) and _dkv_kernel (grid (BH, j, i), dk and dv carried across
// the q axis).  Hopper blocks run in parallel and in no order, so the
// carried axis becomes a loop inside the block:
//
// * dq: one block owns one (b, h, 64-row q tile) and loops over the kv
//   tiles up to the diagonal, heaviest q tiles first;
// * dk/dv: one block owns one (b, kv head, 64-row kv tile) and loops over
//   all G = H / K query heads of that kv head and, for each, over the q
//   tiles from the diagonal down.  So GQA needs neither the reference's
//   expanded K/V nor its group sum of dk/dv (ops.py:58-75): the block sums
//   the G heads into its own registers, and dk/dv are written once, in
//   [B, T, K, dh].
//
// Both recompute P from the log-sum-exp the forward kernel returns, and
// take D from the wrapper (a torch reduction, as bwd.py:121 is a jnp op
// outside the kernels).  Both follow the forward's conventions
// (attention.cu): the top-left causal mask qpos >= kpos with no T - S
// offset, scale applied to q before the dot (so dk = sum_i dS (scale q_i)
// with the scaled q tile), fp32 accumulation, and tiles above the
// diagonal skipped whole, loads included.
//
// Bound at the Phi-4-mini training shape (B = 1, S = T = 2048, H = 24,
// K = 8, dh = 128, bf16): one causal product is 2 B H dh S (S + 1) / 2 =
// 1.29e10 FLOP; dq does 3 (q.k, do.v, dS.k), dk/dv 4 (q.k, do.v, P.do,
// dS.q), 0.039 and 0.052 ms at the bf16 tensor-core peak, 0.58 and 0.77 ms
// at the fp32 rate these kernels compute at (fp32 FMA, no tensor cores);
// the bytes, ~40 MB a pass, take ~0.012 ms.  Design against the fp32
// bound, as the forward: 256 threads, each a 4 x 4 block of the 64 x 64
// logit tile and a 4 x 4 HH block of each 64 x dh accumulator in registers
// (HH = 2 column groups of 64 up to dh = 128, 4 up to 256), operands read
// from shared memory as float4 (rows padded by 4 floats).  The tiles are
// held in fp32: dq keeps q, do, k, v and dS (152.6 KB at dh = 128), dk/dv
// keeps k, v, q, do, P and dS (170.5 KB), one block per SM either way.
// Past dh = 128 that would pass the 227 KB a block may have, so the wide
// instances (HH = 4) share buffers and load a tile twice: dq keeps one
// buffer for k and v (k for S, then v for dP, then k again for dS k),
// dk/dv one for q and do (q for S, then do for dP and P^T do, then q
// again for dS^T q) and one for P and dS (217 KB each at dh = 256).  Both
// run only off the tensor-core route (fp32, and bf16 with any other dh):
// bf16 with dh a multiple of 16 up to 192 runs attention_bwd_tc.cu on the
// tensor cores (ops.tensor_core_route).
//
// Takes: fp32 or bf16 (all inputs alike), dh a multiple of 4 and at most
// 256, the last axis contiguous, lse and D fp32 contiguous [B, S, H]; any
// S and T (ragged tiles are masked).  The Python wrapper checks all of it
// and enforces the reference's shape contract (S and T multiples of
// min(128, S) and min(128, T)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per tile
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 256;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ float lane(float4 v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// 64 rows of one head into shared memory as fp32 (times ``mult``), zeros
// from row ``n_rows`` on.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int n_rows,
                                          int dh, float mult) {
  for (int idx = threadIdx.x; idx < 64 * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    dst[r * ld + d] =
        r < n_rows ? to_float(src[(long long)r * row_stride + d]) * mult
                   : 0.f;
  }
}

// 4 x 4 products of rows (ty + 16 i) of A with rows (tx + 16 j) of B over
// dh (both padded fp32 tiles in shared memory).
__device__ __forceinline__ void tile_dots(float (&acc)[4][4], const float* A,
                                          const float* B, int ld, int dh,
                                          int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  for (int d = 0; d < dh; d += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[i] = *reinterpret_cast<const float4*>(&A[(ty + 16 * i) * ld + d]);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(&B[(tx + 16 * j) * ld + d]);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = dot4(a[i], b[j], acc[i][j]);
  }
}

// acc[i][4 hh + e] += sum_kk W[ty + 16 i][kk] * X[kk][4 (tx + 16 hh) + e]:
// a 64 x 64 weight tile W (row length ldw) times a 64 x dh tile X.
template <int HH>
__device__ __forceinline__ void tile_axpy(float (&acc)[4][4 * HH],
                                          const float* W, int ldw,
                                          const float* X, int ld, int dh,
                                          int ty, int tx) {
  for (int kk = 0; kk < 64; kk += 4) {
    float4 w4[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w4[i] = *reinterpret_cast<const float4*>(&W[(ty + 16 * i) * ldw + kk]);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
#pragma unroll
      for (int hh = 0; hh < HH; ++hh) {
        const int col = 4 * (tx + 16 * hh);
        if (col < dh) {
          const float4 x4 =
              *reinterpret_cast<const float4*>(&X[(kk + e) * ld + col]);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float we = lane(w4[i], e);
            acc[i][4 * hh + 0] = fmaf(we, x4.x, acc[i][4 * hh + 0]);
            acc[i][4 * hh + 1] = fmaf(we, x4.y, acc[i][4 * hh + 1]);
            acc[i][4 * hh + 2] = fmaf(we, x4.z, acc[i][4 * hh + 2]);
            acc[i][4 * hh + 3] = fmaf(we, x4.w, acc[i][4 * hh + 3]);
          }
        }
      }
    }
  }
}

// rows (ty + 16 i) of a 64 x dh register block, times ``mult``, to a
// contiguous [.., rows, heads, dh] output
template <typename T, int HH>
__device__ __forceinline__ void store_rows(T* base, long long row_stride,
                                           int row0, int n_rows,
                                           const float (&acc)[4][4 * HH],
                                           float mult, int dh, int ty,
                                           int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty + 16 * i;
    if (row0 + r >= n_rows) continue;
    T* out = base + (long long)(row0 + r) * row_stride;
#pragma unroll
    for (int hh = 0; hh < HH; ++hh) {
      const int col = 4 * (tx + 16 * hh);
      if (col < dh) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          store(out + col + e, acc[i][4 * hh + e] * mult);
      }
    }
  }
}

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb,
      do_ss, do_sh;
};

// HH: the output's groups of 64 columns a thread holds (dh <= 64 HH);
// HH = 4 shares the k and v buffer (see the top)
template <typename T, int HH>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dq, int S, int T_len,
    int H, int K, int dh, Strides st, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = dh + 4;
  constexpr int ldp = kBK + 4;
  float* Qs = smem;                // [kBQ][ld], q * scale
  float* dOs = Qs + kBQ * ld;      // [kBQ][ld]
  constexpr bool kShare = HH > 2;
  float* Ks = dOs + kBQ * ld;      // [kBK][ld]
  float* Vs = kShare ? Ks : Ks + kBK * ld;  // [kBK][ld]
  float* dSs = Vs + kBK * ld;      // [kBQ][ldp]

  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(Qs, ld, q + b * st.q_sb + h * st.q_sh + (long long)q0 * st.q_ss,
            st.q_ss, S - q0, dh, scale);
  load_tile(dOs, ld,
            dout + b * st.do_sb + h * st.do_sh + (long long)q0 * st.do_ss,
            st.do_ss, S - q0, dh, 1.f);
  float lse_r[4], d_r[4], acc[4][4 * HH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const long long at = ((long long)b * S + row) * H + h;
    lse_r[i] = row < S ? lse[at] : 0.f;
    d_r[i] = row < S ? delta[at] : 0.f;
#pragma unroll
    for (int c = 0; c < 4 * HH; ++c) acc[i][c] = 0.f;
  }

  const T* kb = k + b * st.k_sb + kh * st.k_sh;
  const T* vb = v + b * st.v_sb + kh * st.v_sh;
  const int last_row = min(q0 + kBQ, S) - 1;
  const int n_k = (T_len + kBK - 1) / kBK;
  const int n_run = causal ? min(n_k, last_row / kBK + 1) : n_k;

  for (int kt = 0; kt < n_run; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's dS.K is done with Ks and dSs
    load_tile(Ks, ld, kb + (long long)k0 * st.k_ss, st.k_ss, T_len - k0, dh,
              1.f);
    if (!kShare)
      load_tile(Vs, ld, vb + (long long)k0 * st.v_ss, st.v_ss, T_len - k0,
                dh, 1.f);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dots(s, Qs, Ks, ld, dh, ty, tx);
    if (kShare) {     // v into k's buffer
      __syncthreads();
      load_tile(Vs, ld, vb + (long long)k0 * st.v_ss, st.v_ss, T_len - k0,
                dh, 1.f);
      __syncthreads();
    }
    tile_dots(dp, dOs, Vs, ld, dh, ty, tx);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        const bool keep =
            qpos < S && kpos < T_len && (!causal || qpos >= kpos);
        const float p = keep ? expf(s[i][j] - lse_r[i]) : 0.f;
        dSs[(ty + 16 * i) * ldp + tx + 16 * j] = p * (dp[i][j] - d_r[i]);
      }
    }
    if (kShare) {     // k back into its buffer
      __syncthreads();
      load_tile(Ks, ld, kb + (long long)k0 * st.k_ss, st.k_ss, T_len - k0,
                dh, 1.f);
    }
    __syncthreads();
    tile_axpy<HH>(acc, dSs, ldp, Ks, ld, dh, ty, tx);
  }

  // dq is contiguous [B, S, H, dh]
  store_rows<T, HH>(dq + ((long long)b * S * H + h) * dh, (long long)H * dh,
                    q0, S, acc, scale, dh, ty, tx);
}

// HH as the dq kernel's; HH = 4 shares the q and do buffer and the P and
// dS buffer (see the top)
template <typename T, int HH>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_dkv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
    int S, int T_len, int H, int K, int dh, Strides st, int causal,
    float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = dh + 4;
  constexpr int ldp = kBQ + 4;
  float* Ks = smem;                // [kBK][ld]
  float* Vs = Ks + kBK * ld;       // [kBK][ld]
  constexpr bool kShare = HH > 2;
  float* Qs = Vs + kBK * ld;       // [kBQ][ld], q * scale
  float* dOs = kShare ? Qs : Qs + kBQ * ld;    // [kBQ][ld]
  float* Ps = dOs + kBQ * ld;      // [kBK][ldp], P transposed: kv rows
  float* dSs = kShare ? Ps : Ps + kBK * ldp;   // [kBK][ldp]
  float* lse_s = dSs + kBK * ldp;  // [kBQ]
  float* d_s = lse_s + kBQ;        // [kBQ]

  const int kt = blockIdx.x;       // kv tile 0 has the most q tiles: first
  const int kh = blockIdx.y;
  const int b = blockIdx.z;
  const int G = H / K;
  const int k0 = kt * kBK;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  load_tile(Ks, ld, k + b * st.k_sb + kh * st.k_sh + (long long)k0 * st.k_ss,
            st.k_ss, T_len - k0, dh, 1.f);
  load_tile(Vs, ld, v + b * st.v_sb + kh * st.v_sh + (long long)k0 * st.v_ss,
            st.v_ss, T_len - k0, dh, 1.f);
  float dk_acc[4][4 * HH], dv_acc[4][4 * HH];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < 4 * HH; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;  // q tiles wholly above: skipped
  for (int g = 0; g < G; ++g) {
    const int h = kh * G + g;
    const T* qb = q + b * st.q_sb + h * st.q_sh;
    const T* dob = dout + b * st.do_sb + h * st.do_sh;
    for (int qt = qt0; qt < n_q; ++qt) {
      const int q0 = qt * kBQ;
      __syncthreads();  // the previous tile's sums are done with the tiles
      load_tile(Qs, ld, qb + (long long)q0 * st.q_ss, st.q_ss, S - q0, dh,
                scale);
      if (!kShare)
        load_tile(dOs, ld, dob + (long long)q0 * st.do_ss, st.do_ss, S - q0,
                  dh, 1.f);
      if (threadIdx.x < kBQ) {
        const int row = q0 + threadIdx.x;
        const long long at = ((long long)b * S + row) * H + h;
        lse_s[threadIdx.x] = row < S ? lse[at] : 0.f;
        d_s[threadIdx.x] = row < S ? delta[at] : 0.f;
      }
      __syncthreads();

      // logits transposed: kv rows ty + 16 i, q columns tx + 16 j
      float s[4][4], dp[4][4];
      tile_dots(s, Ks, Qs, ld, dh, ty, tx);
      if (kShare) {   // do into q's buffer
        __syncthreads();
        load_tile(dOs, ld, dob + (long long)q0 * st.do_ss, st.do_ss, S - q0,
                  dh, 1.f);
        __syncthreads();
      }
      tile_dots(dp, Vs, dOs, ld, dh, ty, tx);
      // P^T into Ps; dS^T into dSs, or (shared) kept in dp until P is used
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kpos = k0 + ty + 16 * i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = tx + 16 * j;
          const int qpos = q0 + c;
          const bool keep =
              qpos < S && kpos < T_len && (!causal || qpos >= kpos);
          const float p = keep ? expf(s[i][j] - lse_s[c]) : 0.f;
          Ps[(ty + 16 * i) * ldp + c] = p;
          dp[i][j] = p * (dp[i][j] - d_s[c]);
          if (!kShare) dSs[(ty + 16 * i) * ldp + c] = dp[i][j];
        }
      }
      __syncthreads();
      tile_axpy<HH>(dv_acc, Ps, ldp, dOs, ld, dh, ty, tx);
      if (kShare) {   // dS^T over P^T, q back into its buffer
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            dSs[(ty + 16 * i) * ldp + tx + 16 * j] = dp[i][j];
        load_tile(Qs, ld, qb + (long long)q0 * st.q_ss, st.q_ss, S - q0, dh,
                  scale);
        __syncthreads();
      }
      tile_axpy<HH>(dk_acc, dSs, ldp, Qs, ld, dh, ty, tx);
    }
  }

  // dk, dv are contiguous [B, T, K, dh]; Qs held scale * q, so dk is done
  const long long base = ((long long)b * T_len * K + kh) * dh;
  store_rows<T, HH>(dk + base, (long long)K * dh, k0, T_len, dk_acc, 1.f,
                    dh, ty, tx);
  store_rows<T, HH>(dv + base, (long long)K * dh, k0, T_len, dv_acc, 1.f,
                    dh, ty, tx);
}

// the kernels' shared memory: a wide instance (``share``) holds one tile
// buffer fewer, and dk/dv one P/dS buffer fewer
size_t dq_smem(int dh, bool share) {
  return sizeof(float) * ((size_t)(2 * kBQ + (share ? 1 : 2) * kBK) *
                              (dh + 4) +
                          kBQ * (kBK + 4));
}

size_t dkv_smem(int dh, bool share) {
  const int n = share ? 1 : 2;
  return sizeof(float) * ((size_t)(2 * kBK + n * kBQ) * (dh + 4) +
                          n * kBK * (kBQ + 4) + 2 * kBQ);
}

template <typename T, int HH>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int T_len, int H, int K, int dh, Strides st, int causal,
              float scale, cudaStream_t stream) {
  const size_t smem = dq_smem(dh, HH > 2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_kernel<T, HH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<T, HH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dq), S, T_len, H, K, dh, st, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HH>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv, int B,
               int S, int T_len, int H, int K, int dh, Strides st,
               int causal, float scale, cudaStream_t stream) {
  const size_t smem = dkv_smem(dh, HH > 2);
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_kernel<T, HH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((T_len + kBK - 1) / kBK, K, B);
  flash_bwd_dkv_kernel<T, HH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<const T*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<T*>(dk), static_cast<T*>(dv), S, T_len, H, K, dh, st,
      causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides (in elements) of q, k, v, do over (batch, row, head); the last
// axis is contiguous.  dq is written contiguous [B, S, H, dh].
extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int T_len,
    int H, int K, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, float scale, int is_bf16, void* stream) {
  if (dh > kMaxDh || dh % 4 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 128;
  const auto run = is_bf16 ? (wide ? &launch_dq<__nv_bfloat16, 4>
                                   : &launch_dq<__nv_bfloat16, 2>)
                           : (wide ? &launch_dq<float, 4>
                                   : &launch_dq<float, 2>);
  return run(q, k, v, dout, lse, delta, dq, B, S, T_len, H, K, dh, st,
             causal, scale, s);
}

// The same strides; dk and dv are written contiguous [B, T, K, dh].
extern "C" int flash_attention_bwd_dkv(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int T_len, int H, int K, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, int causal, float scale, int is_bf16,
    void* stream) {
  if (dh > kMaxDh || dh % 4 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 128;
  const auto run = is_bf16 ? (wide ? &launch_dkv<__nv_bfloat16, 4>
                                   : &launch_dkv<__nv_bfloat16, 2>)
                           : (wide ? &launch_dkv<float, 4>
                                   : &launch_dkv<float, 2>);
  return run(q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, K, dh, st,
             causal, scale, s);
}
