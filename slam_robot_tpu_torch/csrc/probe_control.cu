// In-kernel control flow of the Mosaic probes: while loops whose condition
// reduces a vector carry, and a branch on a reduced scalar.
//
// Replaces (TPU kernels in tools/):
//   case 0 (row done):     probe_mosaic.py p5 (:175)
//   case 1 (fixed count):  probe_mosaic2.py e (call :26)
//   case 2 (reduce branch): probe_mosaic2.py f (call :26)
//   case 3 (element done): probe_mosaic2.py g (call :26), probe_mosaic3.py l (:149)
//
// What bounds them on an H100: the launch (at most 8x128 float32, five
// steps). An empty kernel of one block takes 0.00101-0.00105 ms by
// CUDA-graph replay at 32 and at 1024 threads (NVIDIA H100 80GB HBM3,
// 700.00 W; tests/torch_probe_turns.py). Above it, a case waits on its
// load, then on the instructions between load and store, issued by the
// one SM that runs the block, and on each block-wide barrier.
//
// Design: the only thing the elements share in the loops is the trip
// count. An element's own loop is v_k = v_(k-1) + 0.5 for k = 1..5; let n
// be the first k with v_k > 2.4, or 6 if there is none. v_k never falls as
// k grows (a NaN never passes), so n = 6 - #{k : v_k > 2.4}.
// `while it < 5 and not all(done)` then runs T = min(5, max n) times, and
// the element ends at v_min(n, T): the same float adds in the same order as
// the loop, so the result is the plain loop's bit for bit. Case 0's n is
// its row's, from the row's column 0, which each thread reads itself (no
// shared flag). One block, a thread an element: T is one warp max, then,
// where the block has more than one warp, one shared step and one barrier,
// and each warp reduces the warps' maxima itself. Case 2 sums the same
// way: a warp sum, one barrier, every warp sums the partials in the same
// shuffle order, so every thread holds the same total. A thread of four
// adjacent elements (16-byte loads and stores, 8x128 in 8 warps) was
// slower in the loops, where one warp's instructions are the wait: by
// graph, in turns, p5 at 8x2 0.00190 against 0.00136 ms, l at 8x128
// 0.00158 against 0.00152 (f 0.00144 against 0.00149; same card).
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using probe::warp_sum;

enum ControlCase { kRowDone = 0, kFixed = 1, kReduce = 2, kElementDone = 3 };

constexpr int kMaxThreads = 1024;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr int kIters = 5;
constexpr float kStep = 0.5f;
constexpr float kLimit = 2.4f;
constexpr unsigned kAll = 0xffffffffu;

// n: the first k in 1..kIters whose k-th step takes v past kLimit, else
// kIters + 1 (the steps that pass are the last ones)
__device__ __forceinline__ int steps_to_pass(float v) {
  int passed = 0;
#pragma unroll
  for (int k = 1; k <= kIters; ++k) {
    v += kStep;
    passed += v > kLimit;
  }
  return kIters + 1 - passed;
}

// v after its first m steps
__device__ __forceinline__ float advance(float v, int m) {
#pragma unroll
  for (int k = 1; k <= kIters; ++k)
    if (k <= m) v += kStep;
  return v;
}

template <int kCase>
__global__ void __launch_bounds__(kMaxThreads)
control_kernel(const float* __restrict__ x, float* __restrict__ out, int n, int C) {
  __shared__ float s_sum[kMaxWarps];
  __shared__ int s_trips[kMaxWarps];
  const int e = threadIdx.x;
  const int lane = e & 31, warp = e >> 5, warps = blockDim.x >> 5;
  const bool live = e < n;
  float v = live ? x[e] : 0.0f;

  if constexpr (kCase == kFixed) {
    v = advance(v, kIters);
  } else if constexpr (kCase == kReduce) {
    float s = warp_sum(v);
    if (warps > 1) {
      if (lane == 0) s_sum[warp] = s;
      __syncthreads();
      s = warp_sum(lane < warps ? s_sum[lane] : 0.0f);
    }
    v = s > 2.0f ? v * 2.0f : v;
  } else {
    // case 0: the row's column 0
    const float head = kCase == kRowDone ? (live ? x[e / C * C] : 0.0f) : v;
    const int own = live ? steps_to_pass(head) : 0;
    int trips = __reduce_max_sync(kAll, own);
    if (warps > 1) {
      if (lane == 0) s_trips[warp] = trips;
      __syncthreads();
      trips = __reduce_max_sync(kAll, lane < warps ? s_trips[lane] : 0);
    }
    v = advance(v, min(own, min(trips, kIters)));
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
  const auto* xf = static_cast<const float*>(x);
  auto* of = static_cast<float*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRowDone: control_kernel<kRowDone><<<1, threads, 0, s>>>(xf, of, n, C); break;
    case kFixed: control_kernel<kFixed><<<1, threads, 0, s>>>(xf, of, n, C); break;
    case kReduce: control_kernel<kReduce><<<1, threads, 0, s>>>(xf, of, n, C); break;
    default: control_kernel<kElementDone><<<1, threads, 0, s>>>(xf, of, n, C); break;
  }
  return static_cast<int>(cudaGetLastError());
}
