// One empty kernel: the device time of a launch that does no work, the
// floor that every launched kernel's device time is read against.
// Built and timed by chip_smoke.py (the [launch floor] line) with the
// port's own build (src/repro_torch/kernels/_build.py).
#include <cuda_runtime.h>

__global__ void empty_kernel() {}

extern "C" int launch_empty(void* stream) {
  empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
