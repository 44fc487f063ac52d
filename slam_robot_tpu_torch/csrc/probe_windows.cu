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
// probe_windows: a time is its critical path, so at most one dependent load
// precedes the image's. A warp reads its lane's position once (two lanes,
// one request) and takes it by shuffle, with no barrier; MASKED loads its
// mask beside the image (the image's address does not depend on it) and
// selects after both arrive; ROWS reads no x. A thread holds V adjacent
// columns of a row (V = 4 where ws % 4 == 0 and the output is on 16 bytes:
// four scalar loads, since a window starts at any column, and one 16-byte
// store; else V = 1), a row's threads side by side, so each load over a
// warp reads what one contiguous row read would; a warp holds 32 / tpr
// rows, and a thread issues all its loads (kWinRows row slices) before its
// first store. The indices are set up once, with no division an element.
// At the probes' F = 8 and ws = 32 a lane spreads over 2 blocks of
// kWinWarps = 4 warps, a row a thread (16 blocks): by graph on an H100 it
// beat a block of 8 warps a lane by ~0.0001 ms, and 4 or 8 blocks of 2 or 1
// warps a lane by up to 0.00005 (PERF.md).
// probe_fill: the positions' column 0, scaled, is staged in shared memory and
// one of its entries fills the output.
//
// probe_windows_async. The TPU's DMA with semaphores is the copy engine
// (TMA) with an mbarrier here, and the TPU's serial loop over lanes was the
// one-core form, not the function: the lanes are spread over blocks, per_block = ceil(F / SMs) a
// block (one lane a block at the probes' F = 8), so their copies overlap
// across SMs. A block of kAsyncThreads threads; a lane's window lands in a
// shared slot of ws rows at a pitch of pitch(ws) floats:
// - route kBulk: the first warp issues one cp.async.bulk a window row (a row
//   a thread), of the 16-byte-aligned span of the image row around it (the
//   row pitch must be a multiple of 16 bytes and the image base on 16
//   bytes), all completing on one mbarrier whose one arrival expects their
//   bytes; the threads then store the window from the slot, shifted by its
//   column's offset in the span (16-byte stores where ws is a multiple of
//   4). (The TMA's tensor form, cp.async.bulk.tensor with a tensor map
//   from cuTensorMapEncodeTiled, raised "an illegal instruction" on an
//   H100 with driver 580.159.03 wherever the box's first column was off 16
//   bytes, as a window's may be: tests/torch_tma_repro.py.) The barrier's
//   initialization, and the threads' reads of a slot before the next
//   copies into it, are fenced against the async proxy.
// - route kCpAsync, where the bulk copies cannot go (a row pitch that is not
//   a multiple of 16 bytes, an image base off 16 bytes): 4-byte cp.async
//   copies by every thread (a window row starts at any column), a commit
//   group a lane.
// Each case keeps its discipline per block: kOneByOne starts a lane's copy
// and waits for it (and stores it) before the next; kAllThenWait starts every
// copy of the block (a slot a lane) before its first wait; kStaged first
// stages the block's positions in shared memory (the probe's SMEM scratch),
// then copies as kOneByOne. Slots are kSlotAlign-aligned. The entry point
// picks the route and the lanes a block, and refuses a block that would take
// more than kMaxSmem of shared memory.
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

enum WindowCase { kInt = 0, kFloored = 1, kRows = 2, kMasked = 3, kDiagonal = 4 };
enum AsyncCase { kOneByOne = 0, kAllThenWait = 1, kStaged = 2 };
enum AsyncRoute { kCpAsync = 0, kBulk = 1 };

constexpr int kThreads = 256;          // threads a block of probe_fill
constexpr int kWinWarps = 4;           // warps a block of probe_windows
constexpr int kWinRows = 1;            // row slices a thread of probe_windows holds
constexpr int kStaticSmem = 48 * 1024;
constexpr int kAsyncThreads = 128;     // threads a block of probe_windows_async
constexpr int kSlotAlign = 128;        // bytes; a slot's alignment
constexpr int kMaxSmem = 232448 - 64;  // dynamic shared memory a block may take

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return min(max(v, lo), hi);
}

// V adjacent floats of a window row: loaded from any column (V scalar
// loads), stored to `dst` (on 16 bytes where V == 4: one store).
template <int V>
struct Cols;

template <>
struct Cols<1> {
  float v;
  __device__ __forceinline__ void load(const float* src) { v = src[0]; }
  __device__ __forceinline__ void scale(bool keep) { v = keep ? v * 2.0f : 0.0f; }
  __device__ __forceinline__ void store(float* dst) const { dst[0] = v; }
};

template <>
struct Cols<4> {
  float4 v;
  __device__ __forceinline__ void load(const float* src) {
    v = make_float4(src[0], src[1], src[2], src[3]);
  }
  __device__ __forceinline__ void scale(bool keep) {
    v = keep ? make_float4(v.x * 2.0f, v.y * 2.0f, v.z * 2.0f, v.w * 2.0f)
             : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
  __device__ __forceinline__ void store(float* dst) const { *reinterpret_cast<float4*>(dst) = v; }
};

// A block of kWinWarps warps copies kWinRows row slices a thread of lane
// blockIdx.x's window, from row blockIdx.y * (rows a block). A row's tpr
// threads (tpr = min(32, ws / V)) hold V adjacent columns each, so a warp
// holds 32 / tpr rows. Every load of a thread is issued before its first
// store; the indices are set up once, with no per-element division.
template <int kMode, int V>
__global__ void __launch_bounds__(kWinWarps * 32)
    windows_kernel(const float* __restrict__ img, const void* __restrict__ pos,
                   const int* __restrict__ mask, float* __restrict__ out, int H, int W, int ws,
                   int tpr) {
  const int f = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int rpw = 32 / tpr;  // rows a warp
  const int sub = lane / tpr;
  const int col0 = (lane - sub * tpr) * V;
  const int row_step = kWinWarps * rpw;
  const int r0 = blockIdx.y * row_step * kWinRows + warp * rpw + sub;
  const bool active = sub < rpw;
  // MASKED: the image's address does not depend on the mask, so the mask's
  // load (one request a warp) is in flight with the image's
  bool keep = true;
  if (kMode == kMasked) keep = mask[f] > 0;
  int x = 0, y = 0;
  if (kMode != kMasked) {
    // the lane's start: lanes 0 and 1 read x and y in one request, the
    // warp takes them by shuffle (ROWS reads no x)
    int v = 0;
    if (lane < 2 && !(kMode == kRows && lane == 0)) {
      const int idx = kMode == kDiagonal ? 0 : 2 * f + lane;
      v = kMode == kFloored ? static_cast<int>(floorf(static_cast<const float*>(pos)[idx]))
                            : static_cast<const int*>(pos)[idx];
    }
    x = clampi(__shfl_sync(0xffffffffu, v, 0), 0, W - ws);
    y = clampi(__shfl_sync(0xffffffffu, v, 1), 0, H - ws);
  }
  if (!active) return;
  const float* src = img + static_cast<size_t>(y) * W + x;
  float* dst = out + static_cast<size_t>(f) * ws * ws;
  for (int c = col0; c < ws; c += tpr * V) {  // one pass where ws <= 32 V
    Cols<V> v[kWinRows];
#pragma unroll
    for (int i = 0; i < kWinRows; ++i) {
      const int r = r0 + i * row_step;
      if (r < ws) v[i].load(src + static_cast<size_t>(r) * W + c);
    }
#pragma unroll
    for (int i = 0; i < kWinRows; ++i) {
      const int r = r0 + i * row_step;
      if (r < ws) {
        if (kMode == kMasked) v[i].scale(keep);
        v[i].store(dst + static_cast<size_t>(r) * ws + c);
      }
    }
  }
}

template <int kMode>
int launch_windows(const void* img, const void* pos, const void* mask, void* out, int H, int W,
                   int F, int ws, cudaStream_t s) {
  // 16-byte stores where every output row starts on 16 bytes
  const bool vec = ws % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int V = vec ? 4 : 1;
  const int tpr = std::min(32, ws / V);
  const int rows = kWinWarps * (32 / tpr) * kWinRows;  // a block's
  const dim3 grid(kMode == kDiagonal ? 1 : F, (ws + rows - 1) / rows);
  const auto* im = static_cast<const float*>(img);
  const auto* m = static_cast<const int*>(mask);
  auto* o = static_cast<float*>(out);
  if (vec)
    windows_kernel<kMode, 4><<<grid, kWinWarps * 32, 0, s>>>(im, pos, m, o, H, W, ws, tpr);
  else
    windows_kernel<kMode, 1><<<grid, kWinWarps * 32, 0, s>>>(im, pos, m, o, H, W, ws, tpr);
  return static_cast<int>(cudaGetLastError());
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(smem)), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  // the initialization, made by this thread, visible to the async proxy
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The barrier's one arrival, expecting `bytes` more from the copies.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

// `bytes` (a multiple of 16) from global `src` to shared `dst` (both on 16
// bytes), completing on `bar`.
__device__ __forceinline__ void bulk_load(void* dst, const float* src, unsigned bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// This thread's generic accesses to shared memory (the threads' reads of a
// slot, seen through a barrier) ordered before the async proxy's next ones.
__device__ __forceinline__ void fence_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// floats between two rows of a window in its slot: room for the window's
// 16-byte-aligned span (its first column rounded down to 4, its end up)
__host__ __device__ __forceinline__ int pitch(int ws) { return (ws + 3) / 4 * 4 + 4; }

__host__ __device__ __forceinline__ int slot_bytes(int ws) {
  return (ws * pitch(ws) * 4 + kSlotAlign - 1) / kSlotAlign * kSlotAlign;
}

// Lanes [f0, f0 + nl) of this block and their positions (staged in shared
// memory after the slots for kStaged); `slots` slots of slot_bytes(ws).
struct Lanes {
  int f0, nl;
  const int* p;
};

__device__ __forceinline__ Lanes block_lanes(const int* pos, unsigned char* smem, int F,
                                             int per_block, int slots, int ws, int mode) {
  Lanes l{static_cast<int>(blockIdx.x) * per_block, 0, nullptr};
  l.nl = min(per_block, F - l.f0);
  l.p = pos + 2 * l.f0;
  if (mode == kStaged) {
    int* s_pos = reinterpret_cast<int*>(smem + slots * slot_bytes(ws));
    for (int e = threadIdx.x; e < 2 * l.nl; e += blockDim.x) s_pos[e] = l.p[e];
    __syncthreads();
    l.p = s_pos;
  }
  return l;
}

// out[f] (at `o`, on 16 bytes) from a slot whose row r holds the window's row
// at columns [shift, shift + ws), by all threads: 16-byte stores where a row
// is a whole number of them (ws a multiple of 4)
__device__ __forceinline__ void store_window(float* __restrict__ o, const float* slot, int ws,
                                             int shift) {
  const int P = pitch(ws);
  if (ws % 4 == 0) {
    for (int e = 4 * threadIdx.x; e < ws * ws; e += 4 * blockDim.x) {
      const float* q = slot + (e / ws) * (P - ws) + shift + e;
      *reinterpret_cast<float4*>(o + e) = make_float4(q[0], q[1], q[2], q[3]);
    }
    return;
  }
  for (int e = threadIdx.x; e < ws * ws; e += blockDim.x) {
    const int r = e / ws;
    o[e] = slot[r * P + shift + e - r * ws];
  }
}

__global__ void __launch_bounds__(kAsyncThreads)
windows_bulk_kernel(const float* __restrict__ img, const int* __restrict__ pos,
                    float* __restrict__ out, int H, int W, int F, int ws, int per_block,
                    int mode) {
  extern __shared__ __align__(kSlotAlign) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const int slots = mode == kAllThenWait ? per_block : 1;
  const Lanes l = block_lanes(pos, smem, F, per_block, slots, ws, mode);
  const int stride = slot_bytes(ws);
  // warp 0 issues the copies, a row a lane; its first thread the expects
  const bool issuer = threadIdx.x < 32, first = threadIdx.x == 0;
  if (first) mbar_init(&bar);
  __syncthreads();
  // lane i's window: its start, and its rows' 16-byte-aligned span [x0, x0 + len)
  struct Span {
    int x, y, x0, len;
  };
  auto span = [&](int i) {
    const int x = clampi(l.p[2 * i], 0, W - ws), y = clampi(l.p[2 * i + 1], 0, H - ws);
    return Span{x, y, x & ~3, ((x + ws + 3) & ~3) - (x & ~3)};
  };
  // warp 0 issues lane i's row copies into `slot`
  auto issue = [&](const Span& w, unsigned char* slot) {
    for (int r = threadIdx.x; r < ws; r += 32)
      bulk_load(slot + 4 * r * pitch(ws), img + static_cast<size_t>(w.y + r) * W + w.x0,
                4u * w.len, &bar);
  };
  float* o = out + static_cast<size_t>(l.f0) * ws * ws;
  if (mode == kAllThenWait) {
    if (issuer) {
      // the barrier's one arrival expects every copy of the block
      if (first) {
        unsigned bytes = 0;
        for (int i = 0; i < l.nl; ++i) bytes += 4u * span(i).len * ws;
        mbar_expect(&bar, bytes);
      }
      __syncwarp();
      for (int i = 0; i < l.nl; ++i) issue(span(i), smem + i * stride);
    }
    mbar_wait(&bar, 0);
    for (int i = 0; i < l.nl; ++i) {
      const Span w = span(i);
      store_window(o + static_cast<size_t>(i) * ws * ws,
                   reinterpret_cast<const float*>(smem + i * stride), ws, w.x - w.x0);
    }
  } else {
    for (int i = 0; i < l.nl; ++i) {
      const Span w = span(i);
      if (issuer) {
        if (first) mbar_expect(&bar, 4u * w.len * ws);
        __syncwarp();
        issue(w, smem);
      }
      mbar_wait(&bar, i & 1);
      store_window(o + static_cast<size_t>(i) * ws * ws, reinterpret_cast<const float*>(smem),
                   ws, w.x - w.x0);
      __syncthreads();  // the slot is read before the next lane's copies land there
      if (issuer) fence_async();
    }
  }
}

__global__ void __launch_bounds__(kAsyncThreads)
windows_cp_async_kernel(const float* __restrict__ img, const int* __restrict__ pos,
                        float* __restrict__ out, int H, int W, int F, int ws, int per_block,
                        int mode) {
  extern __shared__ __align__(kSlotAlign) unsigned char smem[];
  const int slots = mode == kAllThenWait ? per_block : 1;
  const Lanes l = block_lanes(pos, smem, F, per_block, slots, ws, mode);
  const int P = pitch(ws);
  const int stride = slot_bytes(ws) / 4;  // floats
  float* slot0 = reinterpret_cast<float*>(smem);
  auto start = [&](int i, float* dst) {
    const int x = clampi(l.p[2 * i], 0, W - ws);
    const int y = clampi(l.p[2 * i + 1], 0, H - ws);
    for (int e = threadIdx.x; e < ws * ws; e += blockDim.x) {
      const int r = e / ws, c = e - r * ws;
      cp_async4(dst + r * P + c, img + static_cast<size_t>(y + r) * W + x + c);
    }
    cp_async_commit();
  };
  float* o = out + static_cast<size_t>(l.f0) * ws * ws;
  if (mode == kAllThenWait) {
    for (int i = 0; i < l.nl; ++i) start(i, slot0 + i * stride);
    cp_async_wait_all();
    __syncthreads();
    for (int i = 0; i < l.nl; ++i)
      store_window(o + static_cast<size_t>(i) * ws * ws, slot0 + i * stride, ws, 0);
  } else {
    for (int i = 0; i < l.nl; ++i) {
      start(i, slot0);
      cp_async_wait_all();
      __syncthreads();
      store_window(o + static_cast<size_t>(i) * ws * ws, slot0, ws, 0);
      __syncthreads();  // the slot is reused by the next lane's copy
    }
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (above the default
// 48 KB); `done` remembers the largest size already allowed.
int allow_smem(const void* kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  if (err == 0) *done = bytes;
  return err;
}

size_t g_smem_async[2] = {0, 0};

// kBulk where every window row's 16-byte-aligned span starts on 16 bytes (a
// row pitch that is a multiple of 16 bytes, an image base on 16 bytes), else
// kCpAsync
int async_route(const void* img, int W) {
  return (4LL * W) % 16 == 0 && reinterpret_cast<uintptr_t>(img) % 16 == 0 ? kBulk : kCpAsync;
}

// The current device's SMs, read once a device.
int sm_count(int* sms) {
  constexpr int kDevices = 64;
  static int counts[kDevices] = {};
  int dev = 0;
  int err = static_cast<int>(cudaGetDevice(&dev));
  if (err) return err;
  if (dev >= kDevices)
    return static_cast<int>(cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev));
  if (counts[dev] == 0) {
    err = static_cast<int>(
        cudaDeviceGetAttribute(&counts[dev], cudaDevAttrMultiProcessorCount, dev));
    if (err) return err;
  }
  *sms = counts[dev];
  return 0;
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
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kInt:
      return launch_windows<kInt>(img, pos, mask, out, H, W, F, ws, s);
    case kFloored:
      return launch_windows<kFloored>(img, pos, mask, out, H, W, F, ws, s);
    case kRows:
      return launch_windows<kRows>(img, pos, mask, out, H, W, F, ws, s);
    case kMasked:
      return launch_windows<kMasked>(img, pos, mask, out, H, W, F, ws, s);
    default:
      return launch_windows<kDiagonal>(img, pos, mask, out, H, W, F, ws, s);
  }
}

// The route of probe_windows_async for an image `W` floats wide at `img`.
extern "C" int probe_windows_async_route(const void* img, int W) {
  return async_route(img, W);
}

// F windows at clamped int32 positions: the route by async_route, the F
// lanes over the card's SMs (ceil(F / SMs) a block); cudaErrorInvalidValue
// where a block's shared memory would pass kMaxSmem.
extern "C" int probe_windows_async(const void* img, const void* pos, void* out,
                                   int H, int W, int F, int ws, int mode, void* stream) {
  if (ws <= 0 || ws > H || ws > W || F <= 0 || mode < kOneByOne || mode > kStaged)
    return static_cast<int>(cudaErrorInvalidValue);
  int sms = 0;
  int err = sm_count(&sms);
  if (err) return err;
  const int per_block = (F + sms - 1) / sms;
  const size_t slots = mode == kAllThenWait ? per_block : 1;
  const size_t bytes = slots * slot_bytes(ws) + (mode == kStaged ? 2 * per_block * sizeof(int) : 0);
  if (bytes > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  const int route = async_route(img, W);
  const void* kernel = route == kBulk ? reinterpret_cast<const void*>(windows_bulk_kernel)
                                      : reinterpret_cast<const void*>(windows_cp_async_kernel);
  err = allow_smem(kernel, bytes, &g_smem_async[route]);
  if (err) return err;
  const int blocks = (F + per_block - 1) / per_block;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* im = static_cast<const float*>(img);
  const int* p = static_cast<const int*>(pos);
  float* o = static_cast<float*>(out);
  if (route == kBulk)
    windows_bulk_kernel<<<blocks, kAsyncThreads, bytes, s>>>(im, p, o, H, W, F, ws, per_block,
                                                             mode);
  else
    windows_cp_async_kernel<<<blocks, kAsyncThreads, bytes, s>>>(im, p, o, H, W, F, ws,
                                                                 per_block, mode);
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
