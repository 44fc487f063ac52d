// Banded bilinear sampling and its layouts: the Mosaic probes that took
// apart kernel B1's MXU formulation (slam_robot_tpu/ops/pallas/newton.py).
//
// Replaces (TPU kernels in tools/):
//   probe_bmm:            probe_mosaic.py p3 (:112), batched [F,M,K] @ [F,K,N]
//   probe_band_grad:      probe_mosaic.py p4 (:147), gradient and Hessian of
//                         s(x, y) = y * sum((R(x) W)^2) traced by autodiff
//   probe_layout:         probe_mosaic4.py g1, g2, g4, g5 (call :44)
//   probe_banded_pair:    probe_mosaic4.py g3 (_banded_pair_grouped)
//   probe_sample_grouped: probe_mosaic4.py g6 (_sample_grouped)
//
// What bounds them on an H100: launch latency. The largest cases, g2 and g3,
// write 16x104x128 float32 (852 KB); p3 is 8 x 13x32x32 multiply-adds. A launch
// takes 1-3 us on the device, so a kernel's time is its critical path: the
// loads in flight before its first store, its blocks spread over the SMs.
//
// Design. probe_bmm: one warp per output row (F*M warps, kBmmWarps rows of
// one batch entry a block, so 32 blocks at p3's shape where one block a
// batch entry made 8). Lane j owns output column j (then j+32, ...): it
// loads B's column from global memory, 32 k at a time, all loads in flight
// at once (a warp's loads of one k are one 128-byte row segment), and
// takes A's row from the lanes with __shfl_sync. Every output is fmaf over
// k in order from 0. No shared memory and no barrier.
// probe_band_grad: R(x) selects rows floor(x) and floor(x)+1 of W with
// weights (1-fx, fx), so with P = R(x) W and D = dP/dx = W[i+x0+1] - W[i+x0]
// (rows past W read 0, as the band's zeros do):
//   g = (2y sum(P D), sum(P^2)),  H = [[2y sum(D^2), 2 sum(P D)],
//                                      [2 sum(P D), 0]],
// three sums. The window does not depend on x, so a block of kBandThreads
// stages all of it in shared memory (16-byte loads where it lies on 16
// bytes, kBandStage a thread in flight) while xy is read, and the band
// waits on one load's latency and one barrier, not on xy's and then the
// window's; static shared memory up to a 64-wide window, dynamic above it,
// and the entry point refuses a window past the card's 227 KB a block.
// probe_layout: one kernel per case, with
// 32-bit index arithmetic (the entry point refuses 2^31 elements or more):
// one thread per output element of a repeat (g1), an iota-masked sum (g4)
// or a per-lane block transpose (g5); the broadcast (g2) copies 16 bytes a
// thread where W is a multiple of 4 (every aligned float4 of an output row
// is a float4 of its input row), one element a thread otherwise. On the
// card one element a thread beat four (g1, g4), g4's G loads ran faster
// issued together than each behind its lane test, and a shared-memory tile
// lost to its barrier (g5). probe_banded_pair: 32-bit indices (the entry
// point refuses 2^31 elements or more), one thread per 4 consecutive columns
// of an output row with one 16-byte store where K % 4 == 0 and the output
// starts on 16 bytes (one element a thread otherwise), the row's lane,
// fraction and start read once, every element built from the same
// where-expressions as the JAX function, so the result is exact.
// probe_sample_grouped: the grouping only fed the MXU, so this kernel samples
// directly: a block per lane (64 blocks at the probe's F: one per SM), two
// outputs a thread ((a, j) and (a, j + S) of the lane's [2S, 2S] output
// share their four taps and row pass), the taps read through the L1
// straight from the window: only the (S+1) x (S+1) pixels the taps reach,
// with no copy of the window and no barrier.
// Rows first (value or d/dy), then columns (value or d/dx), each product and
// sum rounded on its own (__fmul_rn, __fadd_rn: no contraction into FMAs),
// which is the plain version's arithmetic; the output is the lane's [[V,
// V_x], [V_y, V_xy]] blocks.
#include <algorithm>
#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using probe::warp_sum;

enum LayoutCase { kRepeat = 0, kBroadcast = 1, kMaskedSum = 2, kBlockTranspose = 3 };

constexpr int kBmmWarps = 4;         // output rows (warps) a block of probe_bmm
constexpr int kLayoutThreads = 128;  // a block of probe_layout's one-element kernels
constexpr int kCopyThreads = 256;    // a block of probe_layout's 16-byte broadcast
constexpr int kPairThreads = 256;   // a block of probe_banded_pair
constexpr int kWin = 32;            // max window edge of probe_sample_grouped
constexpr int kBandThreads = 256;   // a block of probe_band_grad
constexpr int kBandStage = 4;       // loads a thread of probe_band_grad has in flight
constexpr int kBandStatic = 64;     // window sides probe_band_grad stages in static memory
// shared memory a block may take (the H100's 227 KB), less the static sums
constexpr long long kBandMaxSmem = 232448 - 1024;

__global__ void __launch_bounds__(kBmmWarps * 32)
    bmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
               float* __restrict__ out, int M, int K, int N) {
  const int f = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kBmmWarps + (threadIdx.x >> 5);
  if (i >= M) return;
  const float* ai = a + (static_cast<size_t>(f) * M + i) * K;
  const float* bf = b + static_cast<size_t>(f) * K * N;
  float* oi = out + (static_cast<size_t>(f) * M + i) * N;
  for (int j0 = 0; j0 < N; j0 += 32) {
    const int j = j0 + lane;
    const float* col = bf + (j < N ? j : N - 1);  // lanes past N compute and drop
    float acc = 0.0f;
    int k0 = 0;
    for (; k0 + 32 <= K; k0 += 32) {
      const float av = __ldg(ai + k0 + lane);
      float bv[32];
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) bv[kk] = __ldg(col + (k0 + kk) * N);
#pragma unroll
      for (int kk = 0; kk < 32; ++kk) acc = fmaf(__shfl_sync(0xffffffffu, av, kk), bv[kk], acc);
    }
    if (k0 < K) {  // the last K % 32 terms
      const float av = k0 + lane < K ? __ldg(ai + k0 + lane) : 0.0f;
      for (int kk = 0; kk < K - k0; ++kk)
        acc = fmaf(__shfl_sync(0xffffffffu, av, kk), __ldg(col + (k0 + kk) * N), acc);
    }
    if (j < N) oi[j] = acc;
  }
}

// n elements of src to dst, kBandStage loads a thread in flight before its
// first store.
template <typename T>
__device__ __forceinline__ void stage_window(const T* __restrict__ src, T* dst, int n, int t) {
  for (int e0 = 0; e0 < n; e0 += kBandThreads * kBandStage) {
    T v[kBandStage];
#pragma unroll
    for (int k = 0; k < kBandStage; ++k) {
      const int e = e0 + k * kBandThreads + t;
      if (e < n) v[k] = src[e];
    }
#pragma unroll
    for (int k = 0; k < kBandStage; ++k) {
      const int e = e0 + k * kBandThreads + t;
      if (e < n) dst[e] = v[k];
    }
  }
}

// The window staged in shared memory (kDynamic: dynamic shared memory, for
// windows over kBandStatic on a side) while every thread reads xy (one
// request a warp, in flight beside the window's loads), one barrier, then
// the band from shared memory: a thread a column, the S rows over the
// block's warps, rows past W read as 0; the three sums by warp and one
// shared step across the warps.
template <bool kDynamic>
__global__ void __launch_bounds__(kBandThreads)
    band_grad_kernel(const float* __restrict__ win, const float* __restrict__ xy,
                     float* __restrict__ out, int WS, int S, bool vec) {
  __shared__ __align__(16) float s_static[kDynamic ? 1 : kBandStatic * kBandStatic];
  extern __shared__ __align__(16) float s_dynamic[];
  float* s_win = kDynamic ? s_dynamic : s_static;
  __shared__ float s_part[3][kBandThreads / 32];
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const float x = xy[0], y = xy[1];
  const int n = WS * WS;
  if (vec) {  // the window on 16 bytes: a float4 a load
    stage_window(reinterpret_cast<const float4*>(win), reinterpret_cast<float4*>(s_win), n / 4,
                 t);
  } else {
    stage_window(win, s_win, n, t);
  }
  const float x0f = floorf(x);
  const float fx = x - x0f;
  const int x0 = static_cast<int>(x0f);
  __syncthreads();
  float spp = 0.0f, spd = 0.0f, sdd = 0.0f;
  for (int i = warp; i < S; i += kBandThreads / 32) {
    const int k0 = i + x0, k1 = k0 + 1;
    const bool in0 = k0 >= 0 && k0 < WS, in1 = k1 >= 0 && k1 < WS;
    for (int j = lane; j < WS; j += 32) {
      const float w0 = in0 ? s_win[k0 * WS + j] : 0.0f;
      const float w1 = in1 ? s_win[k1 * WS + j] : 0.0f;
      const float p = (1.0f - fx) * w0 + fx * w1;
      const float d = w1 - w0;
      spp += p * p;
      spd += p * d;
      sdd += d * d;
    }
  }
  spp = warp_sum(spp);
  spd = warp_sum(spd);
  sdd = warp_sum(sdd);
  if (lane == 0) {
    s_part[0][warp] = spp;
    s_part[1][warp] = spd;
    s_part[2][warp] = sdd;
  }
  __syncthreads();
  if (warp == 0) {
    constexpr int kWarps = kBandThreads / 32;
    spp = lane < kWarps ? s_part[0][lane] : 0.0f;
    spd = lane < kWarps ? s_part[1][lane] : 0.0f;
    sdd = lane < kWarps ? s_part[2][lane] : 0.0f;
    spp = warp_sum(spp);
    spd = warp_sum(spd);
    sdd = warp_sum(sdd);
    if (lane == 0) {
      out[0] = 2.0f * y * spd;  // ds/dx
      out[1] = spp;             // ds/dy
      out[2] = 2.0f * y * sdd;  // d2s/dx2
      out[3] = 2.0f * spd;      // d2s/dxdy
      out[4] = 2.0f * spd;      // d2s/dydx
      out[5] = 0.0f;            // d2s/dy2
    }
  }
}

// One thread per output element of case kCase; ``total`` elements.
template <int kCase>
__global__ void layout_kernel(const float* __restrict__ in, float* __restrict__ out, int total,
                              int G, int R, int W) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total) return;
  if (kCase == kRepeat) {  // in [B, G] -> out [B, G*R], each value R times
    const int M = G * R, b = idx / M;
    out[idx] = in[b * G + (idx - b * M) / R];
  } else if (kCase == kMaskedSum) {  // the same by a G-term masked sum
    const int M = G * R, b = idx / M, lane = (idx - b * M) / R;
    const float* src = in + b * G;
    float acc = 0.0f;
#pragma unroll 4
    for (int g = 0; g < G; ++g) {
      const float v = __ldg(src + g);  // every load issued, none behind a branch
      acc = acc + (lane == g ? v : 0.0f);
    }
    out[idx] = acc;
  } else if (kCase == kBroadcast) {  // in [B*R, W] -> out [B*R, G*W]
    const int GW = G * W, row = idx / GW;
    out[idx] = in[row * W + (idx - row * GW) % W];
  } else {  // kBlockTranspose: in [B, G*R, W] -> out [B, G*W, R], block (b, g) by block
    const int WR = W * R, bg = idx / WR, e = idx - bg * WR, w = e / R, r = e - w * R;
    out[idx] = in[(bg * R + r) * W + w];
  }
}

// The broadcast (g2) as 16-byte copies: in [rows, W4] -> out [rows, G*W4]
// float4s, ``total4`` of them.
__global__ void broadcast4_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                                  int total4, int GW4, int W4) {
  const int idx = blockIdx.x * blockDim.x + threadIdx.x;
  if (idx >= total4) return;
  const int row = idx / GW4;
  out[idx] = in[row * W4 + (idx - row * GW4) % W4];
}

template <int kCase>
int launch_layout(const void* in, void* out, int total, int G, int R, int W,
                  cudaStream_t stream) {
  const int blocks = total / kLayoutThreads + (total % kLayoutThreads != 0);
  layout_kernel<kCase><<<blocks, kLayoutThreads, 0, stream>>>(
      static_cast<const float*>(in), static_cast<float*>(out), total, G, R, W);
  return static_cast<int>(cudaGetLastError());
}

// One thread per kV consecutive columns of an output row of the grouped
// band matrix [B, M, K] (M = G*2S, K = G*L): kV = 4 with one 16-byte store
// where K % 4 == 0 and the output starts on 16 bytes, else kV = 1. The row's
// lane, fraction and start are read once; every element is the JAX
// function's where-expressions, so the result is exact. 32-bit indices: the
// entry point refuses 2^31 elements or more.
template <int kV>
__global__ void __launch_bounds__(kPairThreads)
banded_pair_kernel(const float* __restrict__ frac, const int* __restrict__ start,
                   float* __restrict__ out, int n, int M, int K, int G, int S, int L) {
  const int idx = blockIdx.x * kPairThreads + threadIdx.x;
  if (idx >= n) return;
  const int quads = K / kV;  // kV divides K
  const int row = idx / quads;
  const int k0 = kV * (idx - row * quads);
  const int b = row / M, r = row - b * M;
  const int g = r / (2 * S), i2 = r - g * (2 * S);
  const bool isd = i2 >= S;
  const int i = isd ? i2 - S : i2;
  const int lane = b * G + g;
  const float fr = frac[lane];
  const int st = start[lane] + L * g;
  const float w0 = isd ? -1.0f : 1.0f - fr;
  const float w1 = isd ? 1.0f : fr;
  float v[kV];
#pragma unroll
  for (int u = 0; u < kV; ++u) {
    const int k = k0 + u;
    v[u] = (k == i + st ? w0 : 0.0f) + (k == i + st + 1 ? w1 : 0.0f);
  }
  float* dst = out + row * K + k0;
  if constexpr (kV == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    dst[0] = v[0];
  }
}

// A block per lane; thread e takes row a = e / S of the lane's [2S, 2S]
// output and column j = e % S: the outputs (a, j) and (a, j + S), which share
// the four taps and the row pass. The taps are read straight from the
// window through the L1 (the (S+1) x (S+1) region at (y0, x0); taps outside
// the window read 0), after the lane's four scalars: two dependent loads
// before the first store, no shared memory, no barrier.
__global__ void sample_kernel(const float* __restrict__ win,
                              const float* __restrict__ fxs,
                              const float* __restrict__ fys,
                              const int* __restrict__ x0s, const int* __restrict__ y0s,
                              float* __restrict__ out, int WH, int WW, int S) {
  const int f = blockIdx.x;
  const float fx = fxs[f], fy = fys[f];
  const int x0 = x0s[f], y0 = y0s[f];
  const float* wf = win + static_cast<size_t>(f) * WH * WW;
  auto tap = [&](int r, int c) {
    return (r >= 0 && r < WH && c >= 0 && c < WW) ? __ldg(wf + r * WW + c) : 0.0f;
  };
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const int S2 = 2 * S;
  float* o = out + static_cast<size_t>(f) * S2 * S2;
  for (int e = threadIdx.x; e < S2 * S; e += blockDim.x) {
    const int a = e / S, j = e - a * S;
    const int i = a < S ? a : a - S;
    const float va = tap(y0 + i, x0 + j), vb = tap(y0 + i, x0 + j + 1);
    const float vc = tap(y0 + i + 1, x0 + j), vd = tap(y0 + i + 1, x0 + j + 1);
    float t0, t1;
    if (a < S) {  // rows: value
      t0 = __fadd_rn(__fmul_rn(gy, va), __fmul_rn(fy, vc));
      t1 = __fadd_rn(__fmul_rn(gy, vb), __fmul_rn(fy, vd));
    } else {      // rows: d/dy
      t0 = __fsub_rn(vc, va);
      t1 = __fsub_rn(vd, vb);
    }
    o[a * S2 + j] = __fadd_rn(__fmul_rn(gx, t0), __fmul_rn(fx, t1));  // columns: value
    o[a * S2 + j + S] = __fsub_rn(t1, t0);                              // columns: d/dx
  }
}

}  // namespace

extern "C" int probe_bmm(const void* a, const void* b, void* out, int F, int M,
                         int K, int N, void* stream) {
  if (F <= 0 || M <= 0 || K <= 0 || N <= 0 || F > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + kBmmWarps - 1) / kBmmWarps, F);
  bmm_kernel<<<grid, kBmmWarps * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

// cudaErrorInvalidValue where the window's staging would pass what a block
// may take of shared memory (kBandMaxSmem).
extern "C" int probe_band_grad(const void* win, const void* xy, void* out, int WS,
                               int S, void* stream) {
  if (WS <= 0 || S <= 0 || 4LL * WS * WS > kBandMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const float*>(win);
  const auto* p = static_cast<const float*>(xy);
  auto* o = static_cast<float*>(out);
  const bool vec = WS * WS % 4 == 0 && (reinterpret_cast<uintptr_t>(win) & 15) == 0;
  if (WS <= kBandStatic) {
    band_grad_kernel<false><<<1, kBandThreads, 0, s>>>(w, p, o, WS, S, vec);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t bytes = 4ull * WS * WS;
  static size_t allowed = 48 * 1024;  // dynamic shared memory the kernel may take now
  if (bytes > allowed) {
    const int err = static_cast<int>(cudaFuncSetAttribute(
        band_grad_kernel<true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes)));
    if (err) return err;
    allowed = bytes;
  }
  band_grad_kernel<true><<<1, kBandThreads, bytes, s>>>(w, p, o, WS, S, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_layout(const void* in, void* out, int B, int G, int R, int W,
                            int mode, void* stream) {
  // every case writes at most B*G*R*W elements, indexed in 32 bits
  const long long total = static_cast<long long>(B) * G * R * W;
  if (B <= 0 || G <= 0 || R <= 0 || W <= 0 || total > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kRepeat:
      return launch_layout<kRepeat>(in, out, B * G * R, G, R, W, s);
    case kMaskedSum:
      return launch_layout<kMaskedSum>(in, out, B * G * R, G, R, W, s);
    case kBroadcast:
      if (W % 4 == 0 && (reinterpret_cast<uintptr_t>(in) & 15) == 0 &&
          (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
        const int total4 = static_cast<int>(total / 4);
        broadcast4_kernel<<<(total4 + kCopyThreads - 1) / kCopyThreads, kCopyThreads, 0, s>>>(
            static_cast<const float4*>(in), static_cast<float4*>(out), total4, G * W / 4,
            W / 4);
        return static_cast<int>(cudaGetLastError());
      }
      return launch_layout<kBroadcast>(in, out, static_cast<int>(total), G, R, W, s);
    case kBlockTranspose:
      return launch_layout<kBlockTranspose>(in, out, static_cast<int>(total), G, R, W, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int probe_banded_pair(const void* frac, const void* start, void* out,
                                 int B, int G, int S, int L, void* stream) {
  // B*M*K elements, indexed in 32 bits
  const long long M = 2LL * G * S, K = static_cast<long long>(G) * L;
  if (B <= 0 || G <= 0 || S <= 0 || L <= 0 || B * M * K > INT_MAX)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool vec = K % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  const int n = static_cast<int>(B * M * K / (vec ? 4 : 1));  // threads
  const int blocks = n / kPairThreads + (n % kPairThreads != 0);
  const auto* fr = static_cast<const float*>(frac);
  const auto* st = static_cast<const int*>(start);
  auto* o = static_cast<float*>(out);
  if (vec) {
    banded_pair_kernel<4><<<blocks, kPairThreads, 0, s>>>(fr, st, o, n, static_cast<int>(M),
                                                          static_cast<int>(K), G, S, L);
  } else {
    banded_pair_kernel<1><<<blocks, kPairThreads, 0, s>>>(fr, st, o, n, static_cast<int>(M),
                                                          static_cast<int>(K), G, S, L);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_sample_grouped(const void* win, const void* fx, const void* fy,
                                    const void* x0, const void* y0, void* out, int F,
                                    int WH, int WW, int S, void* stream) {
  if (F <= 0 || S <= 0 || WH <= 0 || WW <= 0 || WH > kWin || WW > kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  // 2S * S threads a lane, in whole warps, at most 1024
  const int threads = std::min(1024, (2 * S * S + 31) / 32 * 32);
  sample_kernel<<<F, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(fx),
      static_cast<const float*>(fy), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<float*>(out), WH, WW, S);
  return static_cast<int>(cudaGetLastError());
}
