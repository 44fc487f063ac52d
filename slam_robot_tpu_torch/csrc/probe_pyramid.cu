// The fused pyramid probes: a 2x decimation, and the first two pyramid
// levels (blur, pyrDown, blur) in one launch.
//
// Replaces (TPU kernels in tools/probe_pyramid_fused.py):
//   probe_decimate:  dec_kernel (:43), out = in[::2, ::2]
//   probe_two_level: two_level_kernel (:112):
//     l0 = sep(x, k0); d = sep(l0, kd); l1 = sep(d[::2, ::2], k1)
//   where sep is the 5-tap separable correlation with reflect-101 borders,
//   vertical pass first, taps in ascending order (acc = k0 x0; acc += k1 x1
//   ...), k0 the sigma=1.1 Gaussian, kd = [1,4,6,4,1]/16, k1 sigma=0.8.
//
// What bounds them on an H100: bytes. probe_two_level reads a 480x640
// float32 frame once and writes l0 and l1 once (2.76 MB, 0.83 us at
// 3.35 TB/s); the ~60 flops per input pixel are far below the card's
// operations-per-byte balance. Kernel B2 (blur.cu) needs three launches and
// writes and re-reads l0 and the decimated level for the same two levels.
//
// Design of probe_two_level: one 16x16-thread block per 16x16 tile of l1.
// The block works out the half-resolution rows and columns its tile reads
// (halo 2), the level-0 rows and columns those need (halo 2 around their
// even rows and columns) and the input rows and columns those need (halo
// 2), loads that input region into shared memory and recomputes l0 and d
// there: the intermediates never leave the SM. Every reflection is taken in
// global coordinates at its own stage's size (H x W for l0 and d, H/2 x W/2
// for l1), never at a tile edge; each region is the stage's needed range
// clamped to the image, which holds every reflected index because a
// reflected halo index lies within 2 of the border. d is computed only at
// the even rows and columns that l1 reads. Each block also stores its own
// 32x32 tile of l0. H and W are even (as the probe's reshape requires) and
// H/2, W/2 >= 3.
#include <cuda_runtime.h>

namespace {

constexpr int kT = 16;                          // l1 tile edge (threads per side)
constexpr int kHalf = kT + 4;                   // half-res rows feeding a tile
constexpr int kL0 = 2 * (kHalf - 1) + 1 + 4;    // level-0 rows feeding those
constexpr int kX = kL0 + 4;                     // input rows feeding those

__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

__global__ void decimate_kernel(const float* __restrict__ in, float* __restrict__ out,
                                int W, int Ho, int Wo) {
  const int total = Ho * Wo;
  for (int idx = blockIdx.x * blockDim.x + threadIdx.x; idx < total;
       idx += gridDim.x * blockDim.x) {
    const int r = idx / Wo, c = idx % Wo;
    out[idx] = in[(2 * r) * W + 2 * c];
  }
}

__global__ void two_level_kernel(const float* __restrict__ in,
                                 const float* __restrict__ taps,
                                 float* __restrict__ l0, float* __restrict__ l1,
                                 int H, int W) {
  __shared__ float s_x[kX][kX + 1];       // input region
  __shared__ float s_v[kL0][kX + 1];      // level 0, vertical pass
  __shared__ float s_l0[kL0][kL0 + 1];    // level 0
  __shared__ float s_vd[kHalf][kL0 + 1];  // d, vertical pass, even rows
  __shared__ float s_d[kHalf][kHalf + 1]; // d at even rows and columns
  __shared__ float s_vl[kT][kHalf + 1];   // level 1, vertical pass
  __shared__ float s_k[3][5];

  const int Hh = H / 2, Wh = W / 2;
  const int R0 = blockIdx.y * kT, C0 = blockIdx.x * kT;  // l1 tile origin
  // half-res region [hr0, hr1] x [hc0, hc1]
  const int hr0 = max(R0 - 2, 0), hr1 = min(R0 + kT + 1, Hh - 1);
  const int hc0 = max(C0 - 2, 0), hc1 = min(C0 + kT + 1, Wh - 1);
  // level-0 region [q0, q1] x [p0, p1]
  const int q0 = max(2 * hr0 - 2, 0), q1 = min(2 * hr1 + 2, H - 1);
  const int p0 = max(2 * hc0 - 2, 0), p1 = min(2 * hc1 + 2, W - 1);
  // input region [xr0, xr1] x [xc0, xc1]
  const int xr0 = max(q0 - 2, 0), xr1 = min(q1 + 2, H - 1);
  const int xc0 = max(p0 - 2, 0), xc1 = min(p1 + 2, W - 1);
  const int nxr = xr1 - xr0 + 1, nxc = xc1 - xc0 + 1;
  const int nq = q1 - q0 + 1, np = p1 - p0 + 1;
  const int nhr = hr1 - hr0 + 1, nhc = hc1 - hc0 + 1;

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nt = blockDim.x * blockDim.y;
  if (tid < 15) s_k[tid / 5][tid % 5] = taps[tid];
  for (int e = tid; e < nxr * nxc; e += nt) {
    const int r = e / nxc, c = e % nxc;
    s_x[r][c] = in[(xr0 + r) * W + xc0 + c];
  }
  __syncthreads();

  // level 0, vertical: rows q0..q1, input columns
  for (int e = tid; e < nq * nxc; e += nt) {
    const int qi = e / nxc, c = e % nxc;
    const int q = q0 + qi;
    float acc = s_k[0][0] * s_x[reflect101(q - 2, H) - xr0][c];
#pragma unroll
    for (int i = 1; i < 5; ++i) acc = acc + s_k[0][i] * s_x[reflect101(q - 2 + i, H) - xr0][c];
    s_v[qi][c] = acc;
  }
  __syncthreads();
  // level 0, horizontal: columns p0..p1
  for (int e = tid; e < nq * np; e += nt) {
    const int qi = e / np, pi = e % np;
    const int p = p0 + pi;
    float acc = s_k[0][0] * s_v[qi][reflect101(p - 2, W) - xc0];
#pragma unroll
    for (int j = 1; j < 5; ++j) acc = acc + s_k[0][j] * s_v[qi][reflect101(p - 2 + j, W) - xc0];
    s_l0[qi][pi] = acc;
  }
  __syncthreads();

  // store this block's 32x32 tile of l0
  for (int e = tid; e < 4 * kT * kT; e += nt) {
    const int r = 2 * R0 + e / (2 * kT), c = 2 * C0 + e % (2 * kT);
    if (r < H && c < W) l0[r * W + c] = s_l0[r - q0][c - p0];
  }
  // d, vertical, at the even rows 2*hr0 .. 2*hr1
  for (int e = tid; e < nhr * np; e += nt) {
    const int hi = e / np, pi = e % np;
    const int dr = 2 * (hr0 + hi);
    float acc = s_k[1][0] * s_l0[reflect101(dr - 2, H) - q0][pi];
#pragma unroll
    for (int i = 1; i < 5; ++i) acc = acc + s_k[1][i] * s_l0[reflect101(dr - 2 + i, H) - q0][pi];
    s_vd[hi][pi] = acc;
  }
  __syncthreads();
  // d, horizontal, at the even columns 2*hc0 .. 2*hc1: d[::2, ::2]
  for (int e = tid; e < nhr * nhc; e += nt) {
    const int hi = e / nhc, ci = e % nhc;
    const int dc = 2 * (hc0 + ci);
    float acc = s_k[1][0] * s_vd[hi][reflect101(dc - 2, W) - p0];
#pragma unroll
    for (int j = 1; j < 5; ++j) acc = acc + s_k[1][j] * s_vd[hi][reflect101(dc - 2 + j, W) - p0];
    s_d[hi][ci] = acc;
  }
  __syncthreads();
  // level 1, vertical, reflected at H/2
  for (int e = tid; e < kT * nhc; e += nt) {
    const int ri = e / nhc, ci = e % nhc;
    const int r = R0 + ri;
    if (r >= Hh) continue;
    float acc = s_k[2][0] * s_d[reflect101(r - 2, Hh) - hr0][ci];
#pragma unroll
    for (int i = 1; i < 5; ++i) acc = acc + s_k[2][i] * s_d[reflect101(r - 2 + i, Hh) - hr0][ci];
    s_vl[ri][ci] = acc;
  }
  __syncthreads();
  // level 1, horizontal, reflected at W/2, and the store
  {
    const int ri = threadIdx.y, cj = threadIdx.x;
    const int r = R0 + ri, c = C0 + cj;
    if (r < Hh && c < Wh) {
      float acc = s_k[2][0] * s_vl[ri][reflect101(c - 2, Wh) - hc0];
#pragma unroll
      for (int j = 1; j < 5; ++j) acc = acc + s_k[2][j] * s_vl[ri][reflect101(c - 2 + j, Wh) - hc0];
      l1[r * Wh + c] = acc;
    }
  }
}

}  // namespace

extern "C" int probe_decimate(const void* in, void* out, int H, int W, void* stream) {
  if (H < 2 || W < 2 || H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int total = (H / 2) * (W / 2);
  const int threads = 256;
  const int blocks = (total + threads - 1) / threads;
  decimate_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), W, H / 2, W / 2);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_two_level(const void* in, const void* taps, void* l0, void* l1,
                               int H, int W, void* stream) {
  if (H % 2 || W % 2 || H / 2 < 3 || W / 2 < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(kT, kT);
  dim3 grid((W / 2 + kT - 1) / kT, (H / 2 + kT - 1) / kT);
  two_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(taps),
      static_cast<float*>(l0), static_cast<float*>(l1), H, W);
  return static_cast<int>(cudaGetLastError());
}
