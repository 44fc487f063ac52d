// Device helpers shared by the probe kernels (probe_*.cu). newton.cu keeps
// its own copy: kernel B1 must stay bit-identical.
#pragma once

#include <cuda_runtime.h>

namespace probe {

// Sum of v over the 32 threads of a warp; every thread gets the sum.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace probe
