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
// What bounds them on an H100: launch latency. The largest case, g3, writes
// 16x104x128 float32 (852 KB); p3 is 8 x 13x32x32 multiply-adds.
//
// Design. probe_bmm: one block per batch entry, both operands in shared
// memory, one thread per output summing over K in order (no cuBLAS).
// probe_band_grad: R(x) selects rows floor(x) and floor(x)+1 of W with
// weights (1-fx, fx), so with P = R(x) W and D = dP/dx = W[i+x0+1] - W[i+x0]
// (rows past W read 0, as the band's zeros do):
//   g = (2y sum(P D), sum(P^2)),  H = [[2y sum(D^2), 2 sum(P D)],
//                                      [2 sum(P D), 0]],
// three sums taken by one warp. probe_layout: one thread per output element
// of a repeat (g1), a broadcast (g2), an iota-masked sum (g4) or a per-lane
// block transpose (g5). probe_banded_pair: one thread per element of the
// grouped band matrix, built from the same where-expressions as the JAX
// function, so the result is exact. probe_sample_grouped: the grouping only
// fed the MXU, so this kernel samples directly: one warp per lane, the
// window in shared memory, four bilinear taps per output. Rows first (value
// or d/dy), then columns (value or d/dx), each product and sum rounded on
// its own (__fmul_rn, __fadd_rn: no contraction into FMAs), which is the
// plain version's arithmetic; the output is the lane's [[V, V_x], [V_y,
// V_xy]] blocks.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using probe::warp_sum;

enum LayoutCase { kRepeat = 0, kBroadcast = 1, kMaskedSum = 2, kBlockTranspose = 3 };

constexpr int kThreads = 256;
constexpr int kStaticSmem = 48 * 1024;
constexpr int kWin = 32;    // max window edge of probe_sample_grouped
constexpr int kLanes = 4;   // lanes (warps) per block of probe_sample_grouped

__global__ void bmm_kernel(const float* __restrict__ a, const float* __restrict__ b,
                           float* __restrict__ out, int M, int K, int N) {
  extern __shared__ float smem[];
  float* sa = smem;          // [M, K]
  float* sb = smem + M * K;  // [K, N]
  const size_t f = blockIdx.x;
  for (int e = threadIdx.x; e < M * K; e += blockDim.x) sa[e] = a[f * M * K + e];
  for (int e = threadIdx.x; e < K * N; e += blockDim.x) sb[e] = b[f * K * N + e];
  __syncthreads();
  for (int e = threadIdx.x; e < M * N; e += blockDim.x) {
    const int i = e / N, j = e % N;
    float acc = 0.0f;
    for (int k = 0; k < K; ++k) acc = fmaf(sa[i * K + k], sb[k * N + j], acc);
    out[f * M * N + e] = acc;
  }
}

__global__ void band_grad_kernel(const float* __restrict__ win,
                                 const float* __restrict__ xy,
                                 float* __restrict__ out, int WS, int S) {
  const int t = threadIdx.x;
  const float x = xy[0], y = xy[1];
  const float x0f = floorf(x);
  const float fx = x - x0f;
  const int x0 = static_cast<int>(x0f);
  float spp = 0.0f, spd = 0.0f, sdd = 0.0f;
  for (int e = t; e < S * WS; e += 32) {
    const int i = e / WS, j = e % WS;
    const int k0 = i + x0, k1 = i + x0 + 1;
    const float w0 = (k0 >= 0 && k0 < WS) ? win[k0 * WS + j] : 0.0f;
    const float w1 = (k1 >= 0 && k1 < WS) ? win[k1 * WS + j] : 0.0f;
    const float p = (1.0f - fx) * w0 + fx * w1;
    const float d = w1 - w0;
    spp += p * p;
    spd += p * d;
    sdd += d * d;
  }
  spp = warp_sum(spp);
  spd = warp_sum(spd);
  sdd = warp_sum(sdd);
  if (t == 0) {
    out[0] = 2.0f * y * spd;  // ds/dx
    out[1] = spp;             // ds/dy
    out[2] = 2.0f * y * sdd;  // d2s/dx2
    out[3] = 2.0f * spd;      // d2s/dxdy
    out[4] = 2.0f * spd;      // d2s/dydx
    out[5] = 0.0f;            // d2s/dy2
  }
}

__global__ void layout_kernel(const float* __restrict__ in, float* __restrict__ out,
                              int B, int G, int R, int W, int mode) {
  const int M = G * R;
  const size_t total = (mode == kRepeat || mode == kMaskedSum)
                           ? static_cast<size_t>(B) * M
                           : static_cast<size_t>(B) * M * W;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    if (mode == kRepeat) {  // in [B, G] -> out [B, G*R], each value R times
      const size_t b = idx / M;
      out[idx] = in[b * G + (idx % M) / R];
    } else if (mode == kMaskedSum) {  // the same by a G-term masked sum
      const size_t b = idx / M;
      const int lane = static_cast<int>(idx % M) / R;
      float acc = 0.0f;
      for (int g = 0; g < G; ++g) acc = acc + (lane == g ? in[b * G + g] : 0.0f);
      out[idx] = acc;
    } else if (mode == kBroadcast) {  // in [B, R, W] -> out [B, R, G*W]
      const int GW = G * W;
      const size_t bm = idx / GW;
      out[idx] = in[bm * W + (idx % GW) % W];
    } else {  // kBlockTranspose: in [B, G*R, W] -> out [B, G*W, R]
      const size_t b = idx / (static_cast<size_t>(M) * W);
      const int rem = static_cast<int>(idx % (static_cast<size_t>(M) * W));
      const int g = rem / (W * R);
      const int w = (rem / R) % W;
      const int r = rem % R;
      out[idx] = in[(b * M + g * R + r) * W + w];
    }
  }
}

__global__ void banded_pair_kernel(const float* __restrict__ frac,
                                   const int* __restrict__ start,
                                   float* __restrict__ out, int B, int G, int S,
                                   int L) {
  const int M = G * 2 * S;
  const int K = G * L;
  const size_t total = static_cast<size_t>(B) * M * K;
  for (size_t idx = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x;
       idx < total; idx += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t b = idx / (static_cast<size_t>(M) * K);
    const int r = static_cast<int>((idx / K) % M);
    const int k = static_cast<int>(idx % K);
    const int g = r / (2 * S);
    const int i2 = r % (2 * S);
    const bool isd = i2 >= S;
    const int i = isd ? i2 - S : i2;
    const size_t lane = b * G + g;
    const float fr = frac[lane];
    const int st = start[lane] + L * g;
    const float w0 = isd ? -1.0f : 1.0f - fr;
    const float w1 = isd ? 1.0f : fr;
    out[idx] = (k == i + st ? w0 : 0.0f) + (k == i + st + 1 ? w1 : 0.0f);
  }
}

__global__ void sample_kernel(const float* __restrict__ win,
                              const float* __restrict__ fxs,
                              const float* __restrict__ fys,
                              const int* __restrict__ x0s, const int* __restrict__ y0s,
                              float* __restrict__ out, int F, int WH, int WW, int S) {
  __shared__ float s_win[kLanes][kWin * kWin];
  const int t = threadIdx.x;
  const int wl = threadIdx.y;
  const int f = blockIdx.x * kLanes + wl;
  if (f >= F) return;  // whole warp leaves together
  const float* wf = win + static_cast<size_t>(f) * WH * WW;
  for (int e = t; e < WH * WW; e += 32) s_win[wl][(e / WW) * kWin + e % WW] = wf[e];
  __syncwarp();
  const float* sw = s_win[wl];
  auto tap = [&](int r, int c) {
    return (r >= 0 && r < WH && c >= 0 && c < WW) ? sw[r * kWin + c] : 0.0f;
  };
  const float fx = fxs[f], fy = fys[f];
  const float gx = __fsub_rn(1.0f, fx), gy = __fsub_rn(1.0f, fy);
  const int x0 = x0s[f], y0 = y0s[f];
  const int S2 = 2 * S;
  float* o = out + static_cast<size_t>(f) * S2 * S2;
  for (int e = t; e < S2 * S2; e += 32) {
    const int a = e / S2, c = e % S2;
    const int i = a % S, j = c % S;
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
    o[e] = c < S ? __fadd_rn(__fmul_rn(gx, t0), __fmul_rn(fx, t1))  // columns: value
                 : __fsub_rn(t1, t0);                                 // columns: d/dx
  }
}

int blocks_for(size_t total) {
  const size_t b = (total + kThreads - 1) / kThreads;
  return static_cast<int>(b < 4096 ? (b > 0 ? b : 1) : 4096);
}

}  // namespace

extern "C" int probe_bmm(const void* a, const void* b, void* out, int F, int M,
                         int K, int N, void* stream) {
  const size_t bytes = static_cast<size_t>(M * K + K * N) * sizeof(float);
  if (F <= 0 || M <= 0 || K <= 0 || N <= 0 || bytes > kStaticSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  bmm_kernel<<<F, kThreads, bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_band_grad(const void* win, const void* xy, void* out, int WS,
                               int S, void* stream) {
  if (WS <= 0 || S <= 0) return static_cast<int>(cudaErrorInvalidValue);
  band_grad_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(xy),
      static_cast<float*>(out), WS, S);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_layout(const void* in, void* out, int B, int G, int R, int W,
                            int mode, void* stream) {
  if (B <= 0 || G <= 0 || R <= 0 || W <= 0 || mode < kRepeat || mode > kBlockTranspose)
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = (mode == kRepeat || mode == kMaskedSum)
                           ? static_cast<size_t>(B) * G * R
                           : static_cast<size_t>(B) * G * R * W;
  layout_kernel<<<blocks_for(total), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), B, G, R, W, mode);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_banded_pair(const void* frac, const void* start, void* out,
                                 int B, int G, int S, int L, void* stream) {
  if (B <= 0 || G <= 0 || S <= 0 || L <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t total = static_cast<size_t>(B) * (G * 2 * S) * (G * L);
  banded_pair_kernel<<<blocks_for(total), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(frac), static_cast<const int*>(start),
      static_cast<float*>(out), B, G, S, L);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_sample_grouped(const void* win, const void* fx, const void* fy,
                                    const void* x0, const void* y0, void* out, int F,
                                    int WH, int WW, int S, void* stream) {
  if (F <= 0 || S <= 0 || WH <= 0 || WW <= 0 || WH > kWin || WW > kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kLanes);
  dim3 grid((F + kLanes - 1) / kLanes);
  sample_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(fx),
      static_cast<const float*>(fy), static_cast<const int*>(x0),
      static_cast<const int*>(y0), static_cast<float*>(out), F, WH, WW, S);
  return static_cast<int>(cudaGetLastError());
}
