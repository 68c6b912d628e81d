// Hand-written Hopper (sm_90a) kernel: causal GQA flash-attention forward
//
//     o[b, s, h, :] = softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :]) v[b, t, h / G, :]
//     lse[b, s, h]  = log sum_t exp(scale * q . k)
//
// It replaces src/repro/kernels/attention/kernel.py::flash_attention (_kernel),
// the TPU kernel whose grid walks (b*h, q tile, kv tile) in order and keeps the
// running (m, l, acc) in VMEM scratch across the kv axis.  Here one block owns
// one (b, h, q tile) and walks the kv tiles in a loop: blocks run in parallel
// and in no order, so the kv axis cannot be a grid axis.  The mask is the
// reference's top-left causal mask, qpos >= kpos with no T - S offset
// (src/repro/kernels/attention/ref.py:19-21), and -1e30 (not -inf) marks a
// masked logit; l is clamped at 1e-30 before the final divide, as at
// kernel.py:82-85.  The scale multiplies q before the dot, as the TPU kernel
// does.  q, k, v are read in their [B, S, H, dh] / [B, T, K, dh] layout
// through the strides the wrapper passes (the TPU wrapper transposes them to
// [B*H, S, dh] first, kernel.py:105-107); KV head = h / G, G = H / K (G = 3
// at Phi-4-mini: any G works, the division is an integer one).
//
// Bound at the Phi-4-mini prefill (B = 4, S = T = 2048, H = 24, K = 8,
// dh = 128, bf16): 1.03e11 FLOP with the causal half skipped, 0.10 ms at the
// bf16 tensor-core peak; it moves ~134 MB, 0.04 ms.  This kernel does its
// arithmetic in fp32 FMA (no tensor cores), so the rate it is held to is the
// fp32 peak: ~1.5 ms.  Design against that bound: 64 x 64 tiles, 256 threads,
// each thread a 4 x 4 block of the logits and a 4 x 4 HH block of the output
// in registers (HH = 2 column groups of 64 up to dh = 128, 4 up to 256),
// operands read from shared memory as float4 (rows padded by 4 floats so 16
// rows fall on distinct banks), which keeps the FMA pipes, not shared
// memory, the limit.  K and V of a tile share one buffer (K for the logits,
// then V for P.V), so two blocks fit on an SM at dh = 128 (one at
// dh = 256: 147 KB of shared memory, 64 accumulators a thread).  Tiles
// above the diagonal are skipped whole, loads included, and the q tiles run
// heaviest first.  It is the fp32 route: bf16 with dh a multiple of 16 up
// to 192 runs attention_tc.cu on the tensor cores (ops.tensor_core_route).
//
// Takes: fp32 or bf16 (all three alike), dh a multiple of 4 and at most 256,
// the last axis contiguous; any S and T (ragged tiles are masked).  The
// Python wrapper checks all of it and enforces the reference's own shape
// contract (S and T multiples of min(128, S) and min(128, T)).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;       // query rows per block
constexpr int kBK = 64;       // key rows per tile
constexpr int kThreads = 256;
constexpr int kMaxDh = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

// rows [row0, row0 + kBQ) of one head into shared memory as fp32 (times
// ``mult``), zeros past ``n_rows``.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long row_stride, int row0,
                                          int n_rows, int dh, float mult) {
  for (int idx = threadIdx.x; idx < kBQ * dh; idx += kThreads) {
    const int r = idx / dh;
    const int d = idx - r * dh;
    const int row = row0 + r;
    dst[r * ld + d] =
        row < n_rows ? to_float(src[(long long)row * row_stride + d]) * mult
                     : 0.f;
  }
}

// HH: the output's groups of 64 columns a thread holds (dh <= 64 HH)
template <typename T, int HH>
__global__ void __launch_bounds__(kThreads, HH == 2 ? 2 : 1) flash_fwd_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    T* __restrict__ o, float* __restrict__ lse, int S, int T_len, int H,
    int K, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, int causal, float scale) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int ld = dh + 4;                // padded row of Qs / KVs
  constexpr int ldp = kBK + 4;          // padded row of Ps
  float* Qs = smem;                     // [kBQ][ld], q * scale
  float* KVs = Qs + kBQ * ld;           // [kBK][ld], K then V of a tile
  float* Ps = KVs + kBK * ld;           // [kBQ][ldp]

  const int n_q = gridDim.x;
  const int qt = n_q - 1 - blockIdx.x;  // heaviest causal tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kh = h / (H / K);
  const int q0 = qt * kBQ;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;

  const T* qb = q + b * q_sb + h * q_sh;
  const T* kb = k + b * k_sb + kh * k_sh;
  const T* vb = v + b * v_sb + kh * v_sh;
  load_tile(Qs, ld, qb + (long long)q0 * q_ss, q_ss, 0, S - q0, dh, scale);

  float m[4], l[4], acc[4][4 * HH];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * HH; ++c) acc[i][c] = 0.f;
  }

  const int last_row = min(q0 + kBQ, S) - 1;
  const int n_k = (T_len + kBK - 1) / kBK;
  const int n_run = causal ? min(n_k, last_row / kBK + 1) : n_k;

  for (int kt = 0; kt < n_run; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // previous tile's P.V is done with KVs and Ps
    load_tile(KVs, ld, kb + (long long)k0 * k_ss, k_ss, 0, T_len - k0, dh,
              1.f);
    __syncthreads();

    // logits: rows ty + 16 i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int d = 0; d < dh; d += 4) {
      float4 a[4], c[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(&Qs[(ty + 16 * i) * ld + d]);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        c[j] = *reinterpret_cast<const float4*>(&KVs[(tx + 16 * j) * ld + d]);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, c[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, c[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, c[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, c[j].w, s[i][j]);
        }
    }

    // mask, then the online softmax update; a row's 64 logits live on the
    // 16 lanes of one half-warp
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty + 16 * i;
      float mt = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        if (kpos >= T_len || (causal && qpos < kpos)) s[i][j] = kNegInf;
        mt = fmaxf(mt, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, off));
      const float m_new = fmaxf(m[i], mt);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = expf(s[i][j] - m_new);
        Ps[(ty + 16 * i) * ldp + tx + 16 * j] = p;
        rs += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rs;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * HH; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every thread is done reading K
    load_tile(KVs, ld, vb + (long long)k0 * v_ss, v_ss, 0, T_len - k0, dh,
              1.f);
    __syncthreads();

    // acc += P . V: rows ty + 16 i, columns 4 (tx + 16 hh) + e
    for (int kk = 0; kk < kBK; kk += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] =
            *reinterpret_cast<const float4*>(&Ps[(ty + 16 * i) * ldp + kk]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int hh = 0; hh < HH; ++hh) {
          const int col = 4 * (tx + 16 * hh);
          if (col < dh) {
            const float4 v4 =
                *reinterpret_cast<const float4*>(&KVs[(kk + e) * ld + col]);
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              const float pe = e == 0 ? p4[i].x
                             : e == 1 ? p4[i].y
                             : e == 2 ? p4[i].z
                                      : p4[i].w;
              acc[i][4 * hh + 0] = fmaf(pe, v4.x, acc[i][4 * hh + 0]);
              acc[i][4 * hh + 1] = fmaf(pe, v4.y, acc[i][4 * hh + 1]);
              acc[i][4 * hh + 2] = fmaf(pe, v4.z, acc[i][4 * hh + 2]);
              acc[i][4 * hh + 3] = fmaf(pe, v4.w, acc[i][4 * hh + 3]);
            }
          }
        }
      }
    }
  }

  // o = acc / l in q's dtype (o is contiguous [B, S, H, dh]); lse fp32
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= S) continue;
    const float li = fmaxf(l[i], 1e-30f);
    T* orow = o + (((long long)b * S + row) * H + h) * dh;
#pragma unroll
    for (int hh = 0; hh < HH; ++hh) {
      const int col = 4 * (tx + 16 * hh);
      if (col < dh) {
#pragma unroll
        for (int e = 0; e < 4; ++e) store(orow + col + e, acc[i][4 * hh + e] / li);
      }
    }
    if (tx == 0) lse[((long long)b * S + row) * H + h] = m[i] + logf(li);
  }
}

template <typename T, int HH>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int T_len, int H, int K, int dh, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           int causal, float scale, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)(kBQ + kBK) * (dh + 4) + kBQ * (kBK + 4));
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, HH>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((S + kBQ - 1) / kBQ, H, B);
  flash_fwd_kernel<T, HH><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      S, T_len, H, K, dh, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss,
      v_sh, causal, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int T_len, int H, int K, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    int is_bf16, void* stream) {
  if (dh > kMaxDh || dh % 4 || H % K) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool wide = dh > 128;
  const auto run = is_bf16 ? (wide ? &launch<__nv_bfloat16, 4>
                                   : &launch<__nv_bfloat16, 2>)
                           : (wide ? &launch<float, 4> : &launch<float, 2>);
  return run(q, k, v, o, lse, B, S, T_len, H, K, dh, q_sb, q_ss, q_sh, k_sb,
             k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, s);
}
