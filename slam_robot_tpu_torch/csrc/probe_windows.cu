// Per-lane window copies and scalar hand-offs: the Mosaic probes that pull
// 32x32 windows out of an image at positions read from memory.
//
// Replaces (TPU kernels in tools/):
//   probe_windows:       probe_mosaic.py p12 (:52), p2b (:87), p6 (:201);
//                        probe_mosaic2.py a, b, c (call :26);
//                        probe_mosaic3.py m (:167)
//   probe_windows_async: probe_mosaic3.py i (:53), j (:88), k (:120)
//   probe_fill:          probe_mosaic2.py d, h (call :26)
//
// What bounds them on an H100: launch latency. A case moves at most 32 KB
// (8 windows of 32x32 float32) and does no arithmetic.
//
// Design. A window start is clamped so the window fits the image, as
// lax.dynamic_slice clamps (and so a position never reads out of bounds).
// probe_windows: one block per lane, threads striding over the window.
// probe_windows_async: the counterpart of the TPU's DMA copies with
// semaphores is cp.async into shared memory, then a store. One block runs
// all lanes, as the single TPU program did: case 0 starts and waits each
// lane's copy in turn; case 1 starts every lane's copy (one commit group per
// lane) and then waits for all; case 2 first stages the positions in shared
// memory (the probe's SMEM scratch) and then copies as case 0. The copies
// are 4 bytes wide: a window row starts at any column, so 16-byte copies
// would be misaligned. probe_fill: the positions' column 0, scaled, is staged
// in shared memory and one of its entries fills the output.
#include <cuda_runtime.h>

namespace {

enum WindowCase { kInt = 0, kFloored = 1, kRows = 2, kMasked = 3, kDiagonal = 4 };
enum AsyncCase { kOneByOne = 0, kAllThenWait = 1, kStaged = 2 };

constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 * 1024;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

__global__ void windows_kernel(const float* __restrict__ img,
                               const void* __restrict__ pos,
                               const int* __restrict__ mask,
                               float* __restrict__ out, int H, int W, int ws,
                               int mode) {
  const int f = blockIdx.x;
  const int n = ws * ws;
  float* o = out + static_cast<size_t>(f) * n;
  if (mode == kMasked) {
    // out[f] = 2 * img[0:ws, 0:ws] where mask[f] > 0, else 0
    const bool keep = mask[f] > 0;
    for (int e = threadIdx.x; e < n; e += blockDim.x) {
      o[e] = keep ? img[(e / ws) * W + e % ws] * 2.0f : 0.0f;
    }
    return;
  }
  int x, y;
  if (mode == kFloored) {
    const float* p = static_cast<const float*>(pos);
    x = static_cast<int>(floorf(p[2 * f]));
    y = static_cast<int>(floorf(p[2 * f + 1]));
  } else {
    const int* p = static_cast<const int*>(pos);
    x = p[2 * f];
    y = mode == kDiagonal ? p[0] : p[2 * f + 1];
    if (mode == kRows) x = 0;
  }
  x = clampi(x, 0, W - ws);
  y = clampi(y, 0, H - ws);
  for (int e = threadIdx.x; e < n; e += blockDim.x) {
    o[e] = img[(y + e / ws) * W + x + e % ws];
  }
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__global__ void windows_async_kernel(const float* __restrict__ img,
                                     const int* __restrict__ pos,
                                     float* __restrict__ out, int H, int W,
                                     int F, int ws, int mode) {
  extern __shared__ float smem[];  // window slots, then the staged positions
  const int n = ws * ws;
  const int slots = mode == kAllThenWait ? F : 1;
  int* s_pos = reinterpret_cast<int*>(smem + slots * n);
  const int t = threadIdx.x;
  const int* p = pos;
  if (mode == kStaged) {
    for (int e = t; e < 2 * F; e += blockDim.x) s_pos[e] = pos[e];
    __syncthreads();
    p = s_pos;
  }
  auto start = [&](int f, float* dst) {
    const int x = clampi(p[2 * f], 0, W - ws);
    const int y = clampi(p[2 * f + 1], 0, H - ws);
    for (int e = t; e < n; e += blockDim.x) {
      cp_async4(dst + e, img + (y + e / ws) * W + x + e % ws);
    }
    cp_async_commit();
  };
  auto store = [&](int f, const float* src) {
    float* o = out + static_cast<size_t>(f) * n;
    for (int e = t; e < n; e += blockDim.x) o[e] = src[e];
  };
  if (mode == kAllThenWait) {
    for (int f = 0; f < F; ++f) start(f, smem + f * n);
    cp_async_wait_all();
    __syncthreads();
    for (int f = 0; f < F; ++f) store(f, smem + f * n);
  } else {
    for (int f = 0; f < F; ++f) {
      start(f, smem);
      cp_async_wait_all();
      __syncthreads();
      store(f, smem);
      __syncthreads();  // the slot is reused by the next lane's copy
    }
  }
}

__global__ void fill_kernel(const int* __restrict__ pos, float* __restrict__ out,
                            int F, int n_out, int idx, int scale) {
  extern __shared__ int s_col[];  // pos[:, 0] * scale
  for (int e = threadIdx.x; e < F; e += blockDim.x) s_col[e] = pos[2 * e] * scale;
  __syncthreads();
  const float v = static_cast<float>(s_col[idx]);
  for (int e = threadIdx.x; e < n_out; e += blockDim.x) out[e] = 0.0f + v;
}

}  // namespace

extern "C" int probe_windows(const void* img, const void* pos, const void* mask,
                             void* out, int H, int W, int F, int ws, int mode,
                             void* stream) {
  if (ws <= 0 || ws > H || ws > W || F <= 0 || mode < kInt || mode > kDiagonal)
    return static_cast<int>(cudaErrorInvalidValue);
  const int blocks = mode == kDiagonal ? 1 : F;
  windows_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), pos, static_cast<const int*>(mask),
      static_cast<float*>(out), H, W, ws, mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_windows_async(const void* img, const void* pos, void* out,
                                   int H, int W, int F, int ws, int mode,
                                   void* stream) {
  if (ws <= 0 || ws > H || ws > W || F <= 0 || mode < kOneByOne || mode > kStaged)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t slots = mode == kAllThenWait ? F : 1;
  const size_t bytes = slots * ws * ws * sizeof(float) + 2 * F * sizeof(int);
  if (bytes > kStaticSmem) return static_cast<int>(cudaErrorInvalidValue);
  windows_async_kernel<<<1, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(img), static_cast<const int*>(pos),
      static_cast<float*>(out), H, W, F, ws, mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_fill(const void* pos, void* out, int F, int n_out, int idx,
                          int scale, void* stream) {
  if (F <= 0 || idx < 0 || idx >= F || n_out <= 0 ||
      F * sizeof(int) > kStaticSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  fill_kernel<<<1, kThreads, F * sizeof(int), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(pos), static_cast<float*>(out), F, n_out, idx, scale);
  return static_cast<int>(cudaGetLastError());
}
