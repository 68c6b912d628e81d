// Hand-written Hopper (sm_90a) kernels for the TensorStore's batched reads:
// the key probe and the slab row gather behind ``get_many``, and the rank
// -> slot selection behind ``sample`` (the trainer's random gather).
//
// probe_slots replaces src/repro/kernels/store/kernel.py::probe
// (_probe_kernel).  For each query key it returns the lowest live slot that
// holds the key, or ``capacity`` when no live slot does; EMPTY_KEY never
// matches.  Keys are the port's key type: int64 carrying the uint32 value.
//   Bound: it reads keys + version once (12 B a slot) and writes 4 B a query
//   -- a few hundred bytes at the serving shapes (capacity 32, 8 queries),
//   i.e. ~0.1 ns of memory time.  What bounds it is the launch itself (a few
//   microseconds).  Design: one warp per query, so a whole probe is ONE
//   launch with no atomics and no [n, capacity] match matrix; the lanes
//   stride over the capacity, each keeps the first match it sees (its lowest
//   slot), and a butterfly shuffle takes the minimum over the warp.
//
// gather_rows replaces src/repro/kernels/store/kernel.py::gather
// (_gather_kernel).  rows[r] = slab[slots[r]], any element type (the kernel
// moves bytes).
//   Bound: bytes, 2 * n * row_bytes over 3.35 TB/s (each row read once and
//   written once).  At 8 rows of 64 KB that is ~0.3 us, so at the serving
//   shapes it is launch-bound too.  Design: grid = (rows, chunks of the row);
//   16-byte vector copies when the row length and both base pointers are
//   16-byte aligned, byte copies otherwise.  A slot outside [0, capacity)
//   yields a zero row instead of a fault (callers clamp, as in the reference).
//
// sample_slots replaces src/repro/kernels/store/kernel.py::sample
// (_sample_kernel).  slots[q] is the index of the ranks[q]-th slot with
// version > 0 (0-based); a rank >= nvalid gives ``capacity`` and a rank < 0
// gives 0 -- the plain version's searchsorted(cumsum(live), r, right).  (The
// Pallas kernel gives its *padded* capacity for rank >= nvalid; the caller's
// clamp hides the difference.)
//   Bound: bytes, (C + 2n) * 4 B -- under 0.1 KB at the trainer's shapes
//   (C = 24, n = 6), so the launch itself bounds it, as for probe.  Design:
//   the TPU kernel folds sum_j [cum_j <= r] block by block, O(n * C) work.
//   Here ONE block walks the version vector in tiles of its 256 threads: a
//   warp-shuffle inclusive scan per warp, a scan of the 8 warp totals, and a
//   carried offset give every live slot its rank, and each live slot writes
//   itself into a rank -> slot map (scratch the wrapper allocates).  After a
//   __syncthreads() each query reads the map, or takes capacity or 0.  O(C + n)
//   work in one launch, no atomics, no device-wide scan.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr long long kEmptyKey = 0xFFFFFFFFLL;
constexpr int kThreads = 256;
constexpr int kUnitsPerThread = 4;
constexpr int kSampleThreads = 256;

__global__ void __launch_bounds__(kThreads) probe_kernel(
    const long long* __restrict__ keys, const int* __restrict__ version,
    const long long* __restrict__ query, int* __restrict__ out, int capacity,
    int n) {
  const int q = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (q >= n) return;  // uniform across the warp: q is the warp's index
  const long long key = query[q];
  int best = capacity;
  if (key != kEmptyKey) {
    for (int s = lane; s < capacity; s += 32) {
      if (keys[s] == key && version[s] > 0) {
        best = s;
        break;
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1)
    best = min(best, __shfl_xor_sync(0xffffffffu, best, off));
  if (lane == 0) out[q] = best;
}

template <typename T>
__global__ void __launch_bounds__(kThreads) gather_kernel(
    const T* __restrict__ slab, const int* __restrict__ slots,
    T* __restrict__ out, long long row_units, int capacity) {
  const int r = blockIdx.x;
  const int s = slots[r];
  const bool ok = s >= 0 && s < capacity;
  const T* src = slab + (size_t)(ok ? s : 0) * row_units;
  T* dst = out + (size_t)r * row_units;
  const long long base = (long long)blockIdx.y * kThreads * kUnitsPerThread;
  const T zero = T();
#pragma unroll
  for (int k = 0; k < kUnitsPerThread; ++k) {
    const long long u = base + (long long)k * kThreads + threadIdx.x;
    if (u < row_units) dst[u] = ok ? src[u] : zero;
  }
}

template <typename T>
void launch_gather(const void* slab, const void* slots, void* out,
                   long long row_units, int capacity, int n,
                   cudaStream_t stream) {
  const long long per_block = (long long)kThreads * kUnitsPerThread;
  dim3 grid(n, (unsigned)((row_units + per_block - 1) / per_block));
  gather_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(slab), static_cast<const int*>(slots),
      static_cast<T*>(out), row_units, capacity);
}

__global__ void __launch_bounds__(kSampleThreads) sample_kernel(
    const int* __restrict__ version, const int* __restrict__ ranks,
    int* __restrict__ map, int* __restrict__ out, int capacity, int n) {
  constexpr int kWarps = kSampleThreads / 32;
  __shared__ int warp_sums[32];
  __shared__ int carry;  // live slots before the current tile
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) carry = 0;
  __syncthreads();
  for (int base = 0; base < capacity; base += kSampleThreads) {
    const int s = base + threadIdx.x;
    const int live = (s < capacity && version[s] > 0) ? 1 : 0;
    int x = live;  // inclusive scan of `live` within the warp
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, x, off);
      if (lane >= off) x += y;
    }
    if (lane == 31) warp_sums[warp] = x;
    __syncthreads();
    if (warp == 0) {  // inclusive scan of the warp totals
      int w = lane < kWarps ? warp_sums[lane] : 0;
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(0xffffffffu, w, off);
        if (lane >= off) w += y;
      }
      warp_sums[lane] = w;
    }
    __syncthreads();
    const int before = carry + (warp ? warp_sums[warp - 1] : 0);
    if (live) map[before + x - 1] = s;
    __syncthreads();  // every thread has read carry and warp_sums
    if (threadIdx.x == 0) carry += warp_sums[kWarps - 1];
    __syncthreads();
  }
  const int nvalid = carry;
  for (int q = threadIdx.x; q < n; q += kSampleThreads) {
    const int r = ranks[q];
    out[q] = r < 0 ? 0 : (r >= nvalid ? capacity : map[r]);
  }
}

}  // namespace

extern "C" int probe_slots(const void* keys, const void* version,
                           const void* query, void* out, int capacity, int n,
                           void* stream) {
  const int blocks = (n * 32 + kThreads - 1) / kThreads;
  probe_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(keys), static_cast<const int*>(version),
      static_cast<const long long*>(query), static_cast<int*>(out), capacity,
      n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int gather_rows(const void* slab, const void* slots, void* out,
                           long long row_bytes, int capacity, int n,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool vec = row_bytes % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(slab) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(out) % 16 == 0;
  if (vec)
    launch_gather<uint4>(slab, slots, out, row_bytes / 16, capacity, n, s);
  else
    launch_gather<unsigned char>(slab, slots, out, row_bytes, capacity, n, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int sample_slots(const void* version, const void* ranks, void* map,
                            void* out, int capacity, int n, void* stream) {
  sample_kernel<<<1, kSampleThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(version), static_cast<const int*>(ranks),
      static_cast<int*>(map), static_cast<int*>(out), capacity, n);
  return static_cast<int>(cudaGetLastError());
}
