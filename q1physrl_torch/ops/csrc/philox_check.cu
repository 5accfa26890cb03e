// curand's Philox4x32-10 on given counters: the yardstick that chip_smoke.py
// holds the rollout kernels' Philox (philox.cuh) and its plain version
// against.  Not on any path of the port; built beside the rollout library.

#include <cstdint>
#include <cuda_runtime.h>
#include <curand_kernel.h>

namespace {

constexpr int kThreads = 256;

__global__ void curand_philox_kernel(const uint32_t* __restrict__ counters,
                                     uint32_t* __restrict__ out, int m,
                                     uint32_t key0, uint32_t key1) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= m) return;
  const uint4 r = curand_Philox4x32_10(
      make_uint4(counters[i], counters[m + i], counters[2 * m + i],
                 counters[3 * m + i]),
      make_uint2(key0, key1));
  out[i] = r.x;
  out[m + i] = r.y;
  out[2 * m + i] = r.z;
  out[3 * m + i] = r.w;
}

}  // namespace

// counters and out are (4, m) device arrays; returns the launch's
// cudaError_t.
extern "C" int q1_curand_philox(const uint32_t* counters, uint32_t* out,
                                int m, unsigned int key0, unsigned int key1,
                                void* stream) {
  if (m <= 0) return m < 0 ? (int)cudaErrorInvalidValue : 0;
  curand_philox_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0,
                         (cudaStream_t)stream>>>(counters, out, m, key0,
                                                 key1);
  return (int)cudaGetLastError();
}
