// Hand-written Hopper (sm_90a) kernel: causal GQA flash-attention forward
// in bf16 on the tensor cores (wgmma)
//
//     o[b, s, h, :] = softmax_t(scale * q[b, s, h, :] . k[b, t, h / G, :]) v[b, t, h / G, :]
//     lse[b, s, h]  = log sum_t exp(scale * q . k)
//
// It replaces src/repro/kernels/attention/kernel.py::flash_attention
// (_kernel, :39-87) for bf16 inputs with dh a multiple of 16 up to 192;
// fp32 inputs and other head sizes keep the fp32-FMA kernel of
// attention.cu.  The conventions are that kernel's: the top-left causal
// mask qpos >= kpos, -1e30 for a masked logit, l clamped at 1e-30, o in
// bf16, the fp32 LSE [B, S, H] that the backward kernels consume.
//
// Bound at the Phi-4-mini prefill (B = 4, S = T = 2048, H = 24, K = 8,
// dh = 128): two causal products of 2 B H dh S (S + 1) / 2 FLOP each,
// 1.03e11 FLOP, 0.104 ms at the bf16 tensor-core peak (989 TFLOP/s); it
// moves ~134 MB, 0.040 ms at 3.35 TB/s.  So the operations bound it, and
// the design puts the products on wgmma:
//
// * a block of two consumer warpgroups owns one (b, h, q tile) of 128 rows
//   (64 a warpgroup) and walks the kv tiles of 64 rows up to the
//   diagonal, the heaviest q tiles first (the q tile is the slowest grid
//   axis, reversed); tiles above the diagonal are skipped whole, loads
//   included;
// * TMA copies Q once, and K and V tile by tile into a three-stage ring in
//   shared memory, bf16 in the 128-byte-swizzled layout wgmma reads
//   (sm90.cuh), zeros past T and past dh; one thread issues each copy and
//   an mbarrier per stage reports its bytes; the tensor maps are built
//   over the [B, T, K, dh] strides the wrapper passes, with
//   cuTensorMapEncodeTiled reached through cudaGetDriverEntryPoint (the
//   library needs no -lcuda);
// * S = Q K^T is wgmma m64n64k16 with both operands in shared memory and
//   fp32 accumulators; the scale multiplies the fp32 logits (in the
//   exponent's FMA), not q in bf16, whose rounding of q * 0.0884 would add
//   an error the reference does not have;
// * the mask and the online softmax (m, l, correction) run on the
//   accumulator fragments in registers, in base 2, row maxima by two warp
//   shuffles; l is summed per thread and reduced once at the end;
// * O += P V is wgmma m64nDHPk16 with P from registers and V read from
//   shared memory as the transposed (MN-major) B operand; O stays in fp32
//   registers.  P goes in as three bf16 terms whose sum is P exactly
//   (sm90.cuh split_a): P rounded to bf16 once moves o by up to a bf16 ulp
//   where |o| is largest, past the limit of one bf16 rounding of max |o|
//   the kernel is held to, and so do two terms (P to ~2^-17) where many
//   outputs share the top binade (no causal mask); three terms cost twice
//   the P V work of one.  Each tile's P V is summed into a register block
//   of its own and added to O in fp32 (round to nearest): the tensor
//   cores' fp32 sums truncate, and O summed in place would take that bias
//   once for every wgmma of every tile;
// * the kv loop is software-pipelined: S of tile kt and P V of tile kt - 1
//   run on the tensor cores while the warpgroup waits only for S, then
//   runs tile kt's softmax, then waits for P V and rescales O;
// * the two consumer warpgroups share each K/V tile: on the H100 that beat
//   a block of one at both Phi-4-mini shapes (PERF.md); at S <= 64 the
//   second warpgroup has no rows and writes nothing.
//
// Nemotron-4's dh = 192 (DHP = 192, dh 144..192) keeps the tiles, the ring
// and the warpgroups: Q is 48 KB, a (K, V) stage 48 KB, 193 KB in all.
// What does not fit is the registers: O (96 a thread), a whole-width P V
// partial (96), S (32) and P's terms (48) pass the 255 a thread allows.
// So that instance drops the software pipeline: each tile runs S, its
// softmax, the rescale of O, then P V one 64-column block of V at a time
// into a 32-register partial (sm90.cuh split_product_by_blocks), each
// block waited for and added to O in fp32 before the next.  Its P V is
// not overlapped with the next tile's S; that is speed left for later.
//
// Takes: bf16 q, k, v with the last axis contiguous, rows 16-byte aligned
// (strides over batch, row and head multiples of 8 elements, 16-byte
// aligned base pointers), dh a multiple of 16 up to 192, H a multiple of K;
// any S and T (ragged tiles are masked).  The Python wrapper checks it all.

#include "sm90.cuh"

namespace {

using bf16 = __nv_bfloat16;
using namespace sm90;

constexpr int kBN = 64;                      // kv rows per tile
constexpr int kStages = 3;                   // (K, V) tiles in the ring
constexpr int kWG = 2;                       // consumer warpgroups a block
constexpr int kBM = 64 * kWG;                // q rows a block
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int DHP>
constexpr int fwd_smem_bytes() {
  // Q tile, the (K, V) ring, its mbarriers (and Q's), and slack to align
  // the tiles to 1024 bytes
  return kBM * DHP * 2 + kStages * 2 * kBN * DHP * 2 + 64 + 1024;
}

// Mask one tile's logits in place (``kMasked``), update the running row
// maxima ``m`` and this thread's share of the sums ``l``, and leave
// p = 2^(scale log2(e) (s - m)) in ``s``; ``corr`` gets the factor that
// rescales what was summed before.  Rows row_lo and row_lo + 8, columns
// k0 + 8 j + col_in (+1); m is in units of the raw logits.
__device__ __forceinline__ void online_softmax(float (&s)[32], float (&m)[2],
                                               float (&l)[2],
                                               float (&corr)[2], int k0,
                                               int row_lo, int col_in,
                                               bool masked, int causal,
                                               int T_len, float scale_log2) {
  float mx[2] = {m[0], m[1]};
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      if (masked) {
        const int col = k0 + 8 * j + col_in + (e & 1);
        if (col >= T_len || (causal && col > row_lo + 8 * (e >> 1)))
          s[4 * j + e] = kMasked;
      }
      mx[e >> 1] = fmaxf(mx[e >> 1], s[4 * j + e]);
    }
  float neg[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    corr[r] = ex2((m[r] - mx[r]) * scale_log2);
    m[r] = mx[r];
    l[r] *= corr[r];
    neg[r] = -mx[r] * scale_log2;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float pe = ex2(fmaf(s[4 * j + e], scale_log2, neg[e >> 1]));
      s[4 * j + e] = pe;
      l[e >> 1] += pe;
    }
}

template <int DHP>
__global__ void __launch_bounds__(128 * kWG, 1) flash_fwd_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q,
    const __grid_constant__ CUtensorMap tm_k,
    const __grid_constant__ CUtensorMap tm_v, bf16* __restrict__ o,
    float* __restrict__ lse, int S, int T_len, int H, int K, int causal,
    float scale_log2, int dh) {
  constexpr uint32_t kTile = kBN * DHP * 2;  // bytes of one K or V tile
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sKV = sQ + kBM * DHP * 2;   // stage s: K, then V
  const uint32_t bars = sKV + kStages * 2 * kTile;  // stage s, then Q's

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int warp = (tid >> 5) & 3;
  const int lane = tid & 31;
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;  // heaviest first
  const int kh = h / (H / K);

  const int n_k = (T_len + kBN - 1) / kBN;
  const int last_row = min(q0 + kBM, S) - 1;
  const int n_run = causal ? min(n_k, last_row / kBN + 1) : n_k;

  // K and V of tile t into stage t % kStages, one box of 64 columns a
  // column block; issued by thread 0
  auto load_kv = [&](int t) {
    const uint32_t bar = bars + (t % kStages) * 8;
    const uint32_t dst = sKV + (t % kStages) * 2 * kTile;
    mbar_expect_tx(bar, 2 * kTile);
#pragma unroll
    for (int cb = 0; cb < DHP / 64; ++cb) {
      tma_load_4d(dst + cb * kBN * 128, &tm_k, bar, 64 * cb, kh, t * kBN, b);
      tma_load_4d(dst + kTile + cb * kBN * 128, &tm_v, bar, 64 * cb, kh,
                  t * kBN, b);
    }
  };
  if (tid == 0) {
    for (int i = 0; i <= kStages; ++i) mbar_init(bars + i * 8, 1);
    mbar_fence_init();
  }
  __syncthreads();
  if (tid == 0) {
    const uint32_t bar_q = bars + kStages * 8;
    mbar_expect_tx(bar_q, kBM * DHP * 2);
#pragma unroll
    for (int cb = 0; cb < DHP / 64; ++cb)
      tma_load_4d(sQ + cb * kBM * 128, &tm_q, bar_q, 64 * cb, h, q0, b);
    load_kv(0);
    if (n_run > 1) load_kv(1);
  }

  // this thread's two rows of the warpgroup's 64: row_lo and row_lo + 8
  const int wg_row0 = q0 + 64 * wg;
  const int row_lo = wg_row0 + 16 * warp + (lane >> 2);
  const int col_in = 2 * (lane & 3);
  constexpr bool kWide = DHP > 128;   // P V by column blocks, unpipelined
  constexpr int kPart = kWide ? 32 : DHP / 2;
  float acc[DHP / 2];                 // O, fp32, relative to the max m
  float part[kPart];                  // one tile's P V (wide: one block's)
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < kPart; ++i) part[i] = 0.f;
  float m[2] = {kMasked, kMasked};
  float l[2] = {0.f, 0.f};
  float corr[2];
  float s[32];
  uint32_t pf[4][kTerms][4];          // P's bf16 terms, by 16 columns
  mbar_wait(bars + kStages * 8, 0);  // Q

  // Software pipeline over the kv tiles: while the tensor cores compute
  // S of tile kt and acc += P V of tile kt - 1, the warpgroup waits only
  // for S, runs the softmax of tile kt, then waits for P V and rescales.
  // The wide instance runs each tile's steps in order (see the top).
  for (int kt = 0; kt < n_run; ++kt) {
    mbar_wait(bars + (kt % kStages) * 8, (kt / kStages) & 1);
    // every thread is past tile kt - 1's P V: tile kt - 2's stage is free
    __syncthreads();
    if (tid == 0 && kt > 0 && kt + 1 < n_run) load_kv(kt + 1);
    const uint32_t sK = sKV + (kt % kStages) * 2 * kTile;
    const uint32_t sVprev =
        sKV + ((kt + kStages - 1) % kStages) * 2 * kTile + kTile;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk)
      wgmma_ss_n64<0>(s, desc_k_major(sQ, kBM, 64 * wg, kk),
                      desc_k_major(sK, kBN, 0, kk), kk > 0);
    wgmma_commit();
    const int k0 = kt * kBN;
    const bool masked =
        (causal && k0 + kBN - 1 > wg_row0) || k0 + kBN > T_len;
    if constexpr (kWide) {
      wgmma_wait<0>();
      fence_regs(s);
      online_softmax(s, m, l, corr, k0, row_lo, col_in, masked, causal,
                     T_len, scale_log2);
#pragma unroll
      for (int i = 0; i < DHP / 2; ++i) acc[i] *= corr[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_a(pf[kk], s, kk);
      split_product_by_blocks<DHP>(acc, part, pf, sK + kTile);
    } else {
      if (kt > 0) {
        issue_split_product<DHP>(part, pf, sVprev);
        wgmma_commit();
        wgmma_wait<1>();             // S is ready; P V may still run
      } else {
        wgmma_wait<0>();
      }
      fence_regs(s);

      online_softmax(s, m, l, corr, k0, row_lo, col_in, masked, causal,
                     T_len, scale_log2);

      wgmma_wait<0>();               // P V of tile kt - 1 is summed
      fence_regs(acc);
      fence_regs(part);
      fence_regs(pf);
#pragma unroll
      for (int j = 0; j < DHP / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = 4 * j + e;
          acc[i] = (acc[i] + part[i]) * corr[e >> 1];
        }
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) split_a(pf[kk], s, kk);
    }
  }
  if constexpr (!kWide) {            // the last tile's P V
    fence_regs(acc);
    fence_regs(part);
    wgmma_fence();
    issue_split_product<DHP>(
        part, pf, sKV + ((n_run - 1) % kStages) * 2 * kTile + kTile);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(part);
#pragma unroll
    for (int i = 0; i < DHP / 2; ++i) acc[i] += part[i];
  }

  // o = acc / l in bf16 (o is contiguous [B, S, H, dh]); lse in fp32
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const int row = row_lo + 8 * r;
    if (row >= S) continue;
    const float li = fmaxf(l[r], 1e-30f);
    bf16* orow = o + (((long long)b * S + row) * H + h) * dh;
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      const int col = 8 * j + col_in;
      if (col < dh)                   // a division, one rounding
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(acc[4 * j + 2 * r] / li,
                                  acc[4 * j + 2 * r + 1] / li);
    }
    if ((lane & 3) == 0)
      lse[((long long)b * S + row) * H + h] =
          (m[r] * scale_log2 + log2f(li)) * kLn2;
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (the
// library links no -lcuda).
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &found) == cudaSuccess &&
        found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A [B, rows, heads, dh] bf16 tensor by its strides (elements) as a 4-D
// tensor map with boxes of 64 columns x 1 head x ``box_rows`` rows, 128-byte
// swizzle, zeros out of bounds.
bool make_map(CUtensorMap* map, const void* base, int B, int rows, int heads,
              int dh, long long sb, long long ss, long long sh,
              int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)dh, (cuuint64_t)heads,
                              (cuuint64_t)rows, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)ss * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)box_rows, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DHP>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int T_len, int H, int K, int dh, long long q_sb,
           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
           int causal, float scale, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, B, S, H, dh, q_sb, q_ss, q_sh, kBM) ||
      !make_map(&tm_k, k, B, T_len, K, dh, k_sb, k_ss, k_sh, kBN) ||
      !make_map(&tm_v, v, B, T_len, K, dh, v_sb, v_ss, v_sh, kBN))
    return static_cast<int>(cudaErrorInvalidValue);
  constexpr int smem = fwd_smem_bytes<DHP>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<DHP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid(H, B, (S + kBM - 1) / kBM);
  flash_fwd_tc_kernel<DHP><<<grid, 128 * kWG, smem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<bf16*>(o), static_cast<float*>(lse), S,
      T_len, H, K, causal, scale * kLog2e, dh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 q [B, S, H, dh], k and v [B, T, K, dh] by their strides (in
// elements) over (batch, row, head); o written contiguous [B, S, H, dh]
// in bf16, lse [B, S, H] in fp32.  Returns cudaErrorInvalidValue for what
// the kernel does not take, including strides a tensor map refuses.
extern "C" int flash_attention_fwd_tc(
    const void* q, const void* k, const void* v, void* o, void* lse, int B,
    int S, int T_len, int H, int K, int dh, long long q_sb, long long q_ss,
    long long q_sh, long long k_sb, long long k_ss, long long k_sh,
    long long v_sb, long long v_ss, long long v_sh, int causal, float scale,
    void* stream) {
  if (dh > 192 || dh % 16 || H % K)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto run = dh <= 64    ? &launch<64>
                   : dh <= 128 ? &launch<128>
                               : &launch<192>;
  return run(q, k, v, o, lse, B, S, T_len, H, K, dh, q_sb, q_ss, q_sh, k_sb,
             k_ss, k_sh, v_sb, v_ss, v_sh, causal, scale, s);
}
