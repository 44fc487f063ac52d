// In-kernel control flow of the Mosaic probes: while loops whose condition
// reduces a vector carry, and a branch on a reduced scalar.
//
// Replaces (TPU kernels in tools/):
//   case 0 (row done):     probe_mosaic.py p5 (:175)
//   case 1 (fixed count):  probe_mosaic2.py e (call :26)
//   case 2 (reduce branch): probe_mosaic2.py f (call :26)
//   case 3 (element done): probe_mosaic2.py g (call :26), probe_mosaic3.py l (:149)
//
// What bounds them on an H100: launch latency (at most 8x128 float32 and
// five iterations).
//
// Design: one block holds the whole array, one thread per element (at most
// 1024). The loop `while it < 5 and not all(done)` keeps its whole-array
// condition: __syncthreads_and gives every thread all(done) at once, so the
// block leaves the loop together. Case 0's done flag is per row, set from
// the row's column 0 (xy[:, 0] > 2.4) in shared memory. Case 2 sums the
// array by warp shuffles and one shared-memory pass.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using probe::warp_sum;

enum ControlCase { kRowDone = 0, kFixed = 1, kReduce = 2, kElementDone = 3 };

constexpr int kMaxThreads = 1024;
constexpr int kIters = 5;
constexpr float kStep = 0.5f;
constexpr float kLimit = 2.4f;

__global__ void control_kernel(const float* __restrict__ x,
                               float* __restrict__ out, int R, int C, int mode) {
  __shared__ int s_row_done[kMaxThreads];
  __shared__ float s_part[kMaxThreads / 32];
  const int e = threadIdx.x;
  const int n = R * C;
  const bool live = e < n;
  const int r = e / C;
  const int c = e % C;
  float v = live ? x[e] : 0.0f;

  if (mode == kFixed) {
    for (int it = 0; it < kIters; ++it) v += kStep;
  } else if (mode == kReduce) {
    float s = warp_sum(v);
    if ((e & 31) == 0) s_part[e >> 5] = s;
    __syncthreads();
    if (e < 32) {
      s = e < (blockDim.x >> 5) ? s_part[e] : 0.0f;
      s = warp_sum(s);
      if (e == 0) s_part[0] = s;
    }
    __syncthreads();
    v = s_part[0] > 2.0f ? v * 2.0f : v;
  } else {
    if (e < R) s_row_done[e] = 0;
    __syncthreads();
    bool done = false;
    for (int it = 0; it < kIters; ++it) {
      const bool mine = mode == kRowDone ? s_row_done[r] != 0 : done;
      if (__syncthreads_and(live ? mine : true)) break;
      if (live && !mine) v += kStep;
      if (mode == kRowDone) {
        if (live && c == 0 && v > kLimit) s_row_done[r] = 1;
        __syncthreads();
      } else {
        done = done || v > kLimit;
      }
    }
  }
  if (live) out[e] = v;
}

}  // namespace

extern "C" int probe_control(const void* x, void* out, int R, int C, int mode,
                             void* stream) {
  const int n = R * C;
  if (R <= 0 || C <= 0 || n > kMaxThreads || mode < kRowDone || mode > kElementDone)
    return static_cast<int>(cudaErrorInvalidValue);
  const int threads = (n + 31) / 32 * 32;
  control_kernel<<<1, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<float*>(out), R, C, mode);
  return static_cast<int>(cudaGetLastError());
}
