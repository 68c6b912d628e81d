// Hand-written Hopper (sm_90a) kernels: the causal GQA flash-attention
// backward in bf16 on the tensor cores (wgmma), both of its passes
//
//     P[i, j]  = exp(scale * q_i . k_j - lse_i)              (0 where masked)
//     dS[i, j] = P[i, j] * (do_i . v_j - D_i),  D_i = rowsum(do_i * o_i)
//     dq_i     = scale * sum_j dS[i, j] k_j                      (dq pass)
//     dv_j     = sum_i P[i, j] do_i,
//     dk_j     = scale * sum_i dS[i, j] q_i                      (dk/dv pass)
//
// They replace src/repro/kernels/attention/bwd.py::_dq_kernel (:47-71) and
// _dkv_kernel (:74-100), with _p_and_ds (:28-44), for bf16 inputs with dh a
// multiple of 16 up to 192; fp32 inputs and other head sizes keep the
// fp32-FMA kernels of attention_bwd.cu.  The contract is those kernels':
// dq comes back [B, S, H, dh], dk and dv per kv head, [B, T, K, dh], the
// G = H / K query heads summed inside the block; P is recomputed from the
// forward's LSE; D comes from the wrapper; the top-left causal mask
// qpos >= kpos.
//
// Bound at the Phi-4-mini training shape (B = 1, S = T = 2048, H = 24,
// K = 8, dh = 128): one causal product is 2 B H dh S (S + 1) / 2 FLOP; dq
// does three (q.k, do.v, dS.k), 0.039 ms at the bf16 tensor-core peak,
// dk/dv four (k.q, v.do, P^T do, dS^T q), 0.052 ms; ~40 MB of reads and
// writes a pass, 0.012 ms.  The operations bound both, and every product
// is a wgmma with fp32 accumulators.  The two passes mirror each other:
//
// * a dk/dv block (one warpgroup) owns one (b, kv head, 64-row kv tile)
//   and one of its two outputs, dv or dk: two blocks a tile, the heaviest
//   kv tiles first (the tile is the slowest grid axis); K (and for dk, V)
//   stay in shared memory as bf16 for the whole block; it walks the G
//   query heads and, for each, the 64-row q tiles from the diagonal down;
//   the q, do tiles (bf16, 128-byte swizzled, sm90.cuh) and their lse and
//   D slices stream through a two-stage cp.async ring;
// * a dq block (one warpgroup) owns one (b, query head, 64-row q tile),
//   the heaviest q tiles first; Q and dO stay in shared memory, the rows'
//   lse and D in registers; it walks the kv tiles of kv head h / G from 0
//   up to the diagonal, the K and V tiles streaming through a two-stage
//   cp.async ring;
// * S = Q K^T and dP = dO V^T (S^T = K Q^T and dP^T = V dO^T for dk/dv) are
//   wgmma m64n64k16 from shared memory; P = exp2(scale log2(e) S -
//   log2(e) lse), masked, and dS = P (dP - D) run on the fragments in
//   fp32 registers;
// * dq += dS K, dv += P^T dO or dk += dS^T Q is wgmma m64nDHPk16 with A
//   from registers and K, dO or Q read as the MN-major B operand of the
//   same tiles; A goes in as three bf16 terms whose sum is the fp32 dS or
//   P^T exactly (sm90.cuh split_a), since one bf16 rounding of it moves
//   the output by up to a bf16 ulp where it is largest, past the limit of
//   one bf16 rounding of its maximum that the kernels are held to;
// * each tile's share is summed by the tensor cores into a register block
//   of its own and added to the output's fp32 accumulator (round to
//   nearest): the tensor cores' fp32 sums truncate, and an accumulator fed
//   by every wgmma of up to 96 tiles drifts from the plain version's
//   rounding; the scale multiplies dq and dk once at the end;
// * splitting dv and dk over two blocks keeps one accumulator, one partial
//   and one set of A terms a thread (no spill), doubles the blocks (512 at
//   B = 1 for 132 SMs, two a SM) and costs S^T twice; dq's block holds the
//   same (768 blocks at B = 1, two a SM);
// * each output element has one owner and no atomics, so repeated runs are
//   bit-identical.
//
// Nemotron-4's dh = 192 (DHP = 192, dh 144..192) keeps the blocks and the
// tiles (shared memory: dk/dv 146 KB, dq 145 KB, one block a SM).  An
// accumulator is 96 fp32 registers a thread there, and a whole-width
// partial beside it, S, dP and A's terms would pass 255, so the output's
// product runs one 64-column block of its B operand at a time into a
// 32-register partial (sm90.cuh split_product_by_blocks), each block
// waited for and added to its columns of acc before the next: the same
// sums, in three rounds instead of one.  dk and dv stay on blocks of
// their own, as at every width, so no block holds two accumulators.
//
// Takes: bf16 q, k, v, do with the last axis contiguous and 16-byte aligned
// rows (strides multiples of 8 elements), lse and D fp32 contiguous
// [B, S, H], dh a multiple of 16 up to 192, H a multiple of K; any S and T
// (ragged tiles are masked).  The Python wrapper checks it all.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBQ = 64;                      // q rows per tile
constexpr int kBK = 64;                      // kv rows per tile
constexpr int kThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;

struct Strides {
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb,
      do_ss, do_sh;
};

template <int DHP>
constexpr int dkv_smem_bytes() {
  // K, V; two stages of (Q, dO); two of (lse, D); slack to align to 1024
  // bytes (every tile starts on a 1024-byte boundary)
  return 2 * kBK * DHP * 2 + 2 * 2 * kBQ * DHP * 2 + 2 * 2 * kBQ * 4 + 1024;
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dkv_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int T_len, int H,
    int K, int dh, Strides st, int causal, float scale, float scale_log2) {
  constexpr uint32_t kTile = 64 * DHP * 2;         // bytes of one tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sK = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sV = sK + kTile;
  const uint32_t sStages = sV + kTile;             // stage s: Q, dO
  const uint32_t sRows = sStages + 4 * kTile;      // stage s: lse, D
  const float* rows_f = reinterpret_cast<const float*>(
      smem_raw + (sRows - smem_u32(smem_raw)));

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int kh = blockIdx.x;
  const int b = blockIdx.y;
  const bool want_dk = blockIdx.z & 1;             // else dv
  const int k0 = (blockIdx.z >> 1) * kBK;          // tile 0: most q tiles
  const int G = H / K;

  load_tile<kBK, DHP>(sK, k + b * st.k_sb + kh * st.k_sh +
                              (long long)k0 * st.k_ss,
                      st.k_ss, T_len - k0, dh, tid, kThreads);
  if (want_dk)
    load_tile<kBK, DHP>(sV, v + b * st.v_sb + kh * st.v_sh +
                                (long long)k0 * st.v_ss,
                        st.v_ss, T_len - k0, dh, tid, kThreads);

  const int n_q = (S + kBQ - 1) / kBQ;
  const int qt0 = causal ? k0 / kBQ : 0;           // q tiles wholly above
  const int per_head = n_q - qt0;
  const int n_iter = G * per_head;

  // one stage: the q and do tiles of iteration ``it``, its lse and D rows
  auto load_stage = [&](int it) {
    const int h = kh * G + it / per_head;
    const int q0 = (qt0 + it % per_head) * kBQ;
    const uint32_t dst = sStages + (it & 1) * 2 * kTile;
    load_tile<kBQ, DHP>(dst, q + b * st.q_sb + h * st.q_sh +
                                 (long long)q0 * st.q_ss,
                        st.q_ss, S - q0, dh, tid, kThreads);
    load_tile<kBQ, DHP>(dst + kTile, dout + b * st.do_sb + h * st.do_sh +
                                         (long long)q0 * st.do_ss,
                        st.do_ss, S - q0, dh, tid, kThreads);
    if (tid < kBQ) {
      const int row = q0 + tid;
      const long long at = ((long long)b * S + min(row, S - 1)) * H + h;
      const int bytes = row < S ? 4 : 0;
      const uint32_t rows = sRows + (it & 1) * 2 * kBQ * 4;
      cp_async_4(rows + tid * 4, lse + at, bytes);
      cp_async_4(rows + (kBQ + tid) * 4, delta + at, bytes);
    }
  };
  if (n_iter > 0) load_stage(0);
  cp_async_commit();                  // with K (and V)

  constexpr int kPart = DHP > 128 ? 32 : DHP / 2;
  float acc[DHP / 2];                 // dk or dv, fp32
  float part[kPart];                  // one q tile's share (wide: a block's)
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  // this thread's two kv rows: row_lo and row_lo + 8; q columns 8 j + col_in
  const int row_lo = k0 + 16 * warp + (lane >> 2);
  const int col_in = 2 * (lane & 3);

  for (int it = 0; it < n_iter; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_iter) {
      load_stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t sQ = sStages + cur * 2 * kTile;
    const uint32_t sdO = sQ + kTile;
    const float* sL = rows_f + cur * 2 * kBQ;
    const float* sD = sL + kBQ;
    const int q0 = (qt0 + it % per_head) * kBQ;

    // S^T = K Q^T (and for dk, dP^T = V dO^T), fp32 in registers
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k_major(sK, kBK, 0, kk),
                      desc_k_major(sQ, kBQ, 0, kk), kk > 0);
    if (want_dk) {
#pragma unroll
      for (int kk = 0; kk < DHP / 16; ++kk)
        wgmma_ss_n64<0>(dp, desc_k_major(sV, kBK, 0, kk),
                        desc_k_major(sdO, kBQ, 0, kk), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // P^T (masked), and for dk dS^T = P^T (dP^T - D), on the fragments:
    // rows kv, columns q
    const bool masked = (causal && k0 + kBK - 1 > q0) || q0 + kBQ > S ||
                        k0 + kBK > T_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = 8 * j + col_in + (e & 1);
        const int kpos = row_lo + 8 * (e >> 1);
        const int qpos = q0 + c;
        float p = ex2(fmaf(s[4 * j + e], scale_log2, -sL[c] * kLog2e));
        if (masked &&
            (qpos >= S || kpos >= T_len || (causal && qpos < kpos)))
          p = 0.f;
        s[4 * j + e] = want_dk ? p * (dp[4 * j + e] - sD[c]) : p;
      }

    // this q tile's dv = P^T dO, or dk = dS^T Q, summed by the tensor
    // cores into ``part`` (A from registers as kTerms bf16 terms), then
    // added to acc in fp32
    uint32_t af[4][kTerms][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_a(af[kk], s, kk);
    if constexpr (DHP > 128) {
      split_product_by_blocks<DHP>(acc, part, af, want_dk ? sQ : sdO);
    } else {
      fence_regs(part);
      wgmma_fence();
      issue_split_product<DHP>(part, af, want_dk ? sQ : sdO);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(af);
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) acc[i] += part[i];
    }
    __syncthreads();  // the stage is free for iteration it + 2
  }
  cp_async_wait<0>();  // K and V's group when the block had no iteration

  // dk (times the scale) or dv in bf16, contiguous [B, T, K, dh]
  bf16* out = want_dk ? dk : dv;
  const float mult = want_dk ? scale : 1.f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= T_len) continue;
    const long long at = (((long long)b * T_len + row) * K + kh) * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + col_in;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(out + at + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * mult,
                                  acc[4 * j + 2 * r + 1] * mult);
    }
  }
}

template <int DHP>
constexpr int dq_smem_bytes() {
  // Q, dO; two stages of (K, V); slack to align to 1024 bytes
  return 2 * kBQ * DHP * 2 + 2 * 2 * kBK * DHP * 2 + 1024;
}

template <int DHP>
__global__ void __launch_bounds__(kThreads, 2) flash_bwd_dq_tc_kernel(
    const bf16* __restrict__ q, const bf16* __restrict__ k,
    const bf16* __restrict__ v, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    bf16* __restrict__ dq, int S, int T_len, int H, int K, int dh,
    Strides st, int causal, float scale, float scale_log2) {
  constexpr uint32_t kTile = 64 * DHP * 2;         // bytes of one tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sdO = sQ + kTile;
  const uint32_t sStages = sdO + kTile;            // stage s: K, V

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBQ;  // most kv tiles first
  const int kh = h / (H / K);

  load_tile<kBQ, DHP>(sQ, q + b * st.q_sb + h * st.q_sh +
                              (long long)q0 * st.q_ss,
                      st.q_ss, S - q0, dh, tid, kThreads);
  load_tile<kBQ, DHP>(sdO, dout + b * st.do_sb + h * st.do_sh +
                               (long long)q0 * st.do_ss,
                      st.do_ss, S - q0, dh, tid, kThreads);

  const int n_k = (T_len + kBK - 1) / kBK;
  const int last_row = min(q0 + kBQ, S) - 1;
  const int n_iter = causal ? min(n_k, last_row / kBK + 1) : n_k;

  // one stage: the k and v tiles of kv tile ``it``
  auto load_stage = [&](int it) {
    const int k0 = it * kBK;
    const uint32_t dst = sStages + (it & 1) * 2 * kTile;
    load_tile<kBK, DHP>(dst, k + b * st.k_sb + kh * st.k_sh +
                                 (long long)k0 * st.k_ss,
                        st.k_ss, T_len - k0, dh, tid, kThreads);
    load_tile<kBK, DHP>(dst + kTile, v + b * st.v_sb + kh * st.v_sh +
                                         (long long)k0 * st.v_ss,
                        st.v_ss, T_len - k0, dh, tid, kThreads);
  };
  if (n_iter > 0) load_stage(0);
  cp_async_commit();                  // with Q and dO

  // this thread's two q rows: row_lo and row_lo + 8; kv columns
  // 8 j + col_in; their lse (times log2(e)) and D
  const int row_lo = q0 + 16 * warp + (lane >> 2);
  const int col_in = 2 * (lane & 3);
  float lse_r[2], d_r[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at =
        ((long long)b * S + min(row_lo + 8 * r, S - 1)) * H + h;
    lse_r[r] = lse[at] * kLog2e;
    d_r[r] = delta[at];
  }
  constexpr int kPart = DHP > 128 ? 32 : DHP / 2;
  float acc[DHP / 2];                 // dq, fp32
  float part[kPart];                  // one kv tile's share (wide: a block's)
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;

  for (int it = 0; it < n_iter; ++it) {
    const int cur = it & 1;
    if (it + 1 < n_iter) {
      load_stage(it + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    fence_proxy_async();
    __syncthreads();
    const uint32_t sK = sStages + cur * 2 * kTile;
    const uint32_t sV = sK + kTile;
    const int k0 = it * kBK;

    // S = Q K^T and dP = dO V^T, fp32 in registers
    float s[32], dp[32];
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k_major(sQ, kBQ, 0, kk),
                      desc_k_major(sK, kBK, 0, kk), kk > 0);
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      wgmma_ss_n64<0>(dp, desc_k_major(sdO, kBQ, 0, kk),
                      desc_k_major(sV, kBK, 0, kk), kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);

    // dS = P (dP - D), P masked, on the fragments: rows q, columns kv
    const bool masked = (causal && k0 + kBK - 1 > q0) || q0 + kBQ > S ||
                        k0 + kBK > T_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qpos = row_lo + 8 * (e >> 1);
        const int kpos = k0 + 8 * j + col_in + (e & 1);
        float p = ex2(fmaf(s[4 * j + e], scale_log2, -lse_r[e >> 1]));
        if (masked &&
            (qpos >= S || kpos >= T_len || (causal && qpos < kpos)))
          p = 0.f;
        s[4 * j + e] = p * (dp[4 * j + e] - d_r[e >> 1]);
      }

    // this kv tile's dq = dS K, summed by the tensor cores into ``part``
    // (A from registers as kTerms bf16 terms), then added to acc in fp32
    uint32_t af[4][kTerms][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) split_a(af[kk], s, kk);
    if constexpr (DHP > 128) {
      split_product_by_blocks<DHP>(acc, part, af, sK);
    } else {
      fence_regs(part);
      wgmma_fence();
      issue_split_product<DHP>(part, af, sK);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(part);
      fence_regs(af);
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) acc[i] += part[i];
    }
    __syncthreads();  // the stage is free for iteration it + 2
  }
  cp_async_wait<0>();  // Q and dO's group when the block had no iteration

  // dq (times the scale) in bf16, contiguous [B, S, H, dh]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const long long at = (((long long)b * S + row) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + col_in;
      if (col < dh)
        *reinterpret_cast<__nv_bfloat162*>(dq + at + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] * scale,
                                  acc[4 * j + 2 * r + 1] * scale);
    }
  }
}

template <int DHP>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq, int B, int S,
              int T_len, int H, int K, int dh, Strides st, int causal,
              float scale, cudaStream_t stream) {
  constexpr int smem = dq_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dq_tc_kernel<DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (S + kBQ - 1) / kBQ);
  flash_bwd_dq_tc_kernel<DHP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), S, T_len, H, K, dh, st, causal, scale,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, const void* dout,
           const void* lse, const void* delta, void* dk, void* dv, int B,
           int S, int T_len, int H, int K, int dh, Strides st, int causal,
           float scale, cudaStream_t stream) {
  constexpr int smem = dkv_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_bwd_dkv_tc_kernel<DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(K, B, 2 * ((T_len + kBK - 1) / kBK));  // (dv, dk) per tile
  flash_bwd_dkv_tc_kernel<DHP><<<grid, kThreads, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), S, T_len, H, K, dh, st,
      causal, scale, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Strides (in elements) of q, k, v, do over (batch, row, head); dq is
// written contiguous [B, S, H, dh] in bf16.
extern "C" int flash_attention_bwd_dq_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dq, int B, int S, int T_len,
    int H, int K, int dh, long long q_sb, long long q_ss, long long q_sh,
    long long k_sb, long long k_ss, long long k_sh, long long v_sb,
    long long v_ss, long long v_sh, long long do_sb, long long do_ss,
    long long do_sh, int causal, float scale, void* stream) {
  if (dh > 192 || dh % 16 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = dh <= 64    ? &launch_dq<64>
                   : dh <= 128 ? &launch_dq<128>
                               : &launch_dq<192>;
  return run(q, k, v, dout, lse, delta, dq, B, S, T_len, H, K, dh, st,
             causal, scale, s);
}

// Strides (in elements) of q, k, v, do over (batch, row, head); dk and dv
// are written contiguous [B, T, K, dh] in bf16.
extern "C" int flash_attention_bwd_dkv_tc(
    const void* q, const void* k, const void* v, const void* dout,
    const void* lse, const void* delta, void* dk, void* dv, int B, int S,
    int T_len, int H, int K, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, long long do_sb,
    long long do_ss, long long do_sh, int causal, float scale,
    void* stream) {
  if (dh > 192 || dh % 16 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  const Strides st{q_sb, q_ss, q_sh, k_sb, k_ss, k_sh,
                   v_sb, v_ss, v_sh, do_sb, do_ss, do_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = dh <= 64    ? &launch<64>
                   : dh <= 128 ? &launch<128>
                               : &launch<192>;
  return run(q, k, v, dout, lse, delta, dk, dv, B, S, T_len, H, K, dh, st,
             causal, scale, s);
}
