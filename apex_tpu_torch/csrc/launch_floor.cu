// The launch floor: two kernels that do (almost) nothing, built and bound
// as every kernel of this directory is, so a kernel's time can be read
// against what a launch costs on its own.
//
// Replaces no TPU kernel and runs on no path of the port: chip_smoke.py
// times both under its `time_ms` (CUDA events around each launch) beside
// the kernels whose times sit near the floor (the LayerNorm forward at
// decode's rows, the cross entropy, the GEMV).
//   * empty_kernel: one block of one thread, no instructions but the exit.
//   * copy16_kernel: one block of one thread, one 16-byte load from device
//     memory and one 16-byte store: the round trip a dependent load adds.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void empty_kernel() {}

__global__ void copy16_kernel(const uint4* __restrict__ src, uint4* dst) {
  *dst = *src;
}

}  // namespace

// one launch of the empty kernel on `stream`; the CUDA error (0: launched)
extern "C" int apex_launch_floor_empty(void* stream) {
  empty_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

// one launch of the 16-byte copy (src and dst 16-byte aligned) on `stream`
extern "C" int apex_launch_floor_copy16(const void* src, void* dst,
                                        void* stream) {
  if (reinterpret_cast<uintptr_t>(src) % 16 ||
      reinterpret_cast<uintptr_t>(dst) % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  copy16_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(src), static_cast<uint4*>(dst));
  return static_cast<int>(cudaGetLastError());
}
