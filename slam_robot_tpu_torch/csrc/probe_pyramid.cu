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
// Design of probe_two_level (sep5's design, blur.cu, carried through both
// levels): a block of kTwoThreads = 192 threads owns a strip of kTwoRows x
// kTwoCols = 8 x 80 outputs of l1 (4 x 30 = 120 blocks at 480x640, one wave
// over 132 SMs) and the 16 x 160 tile of l0 above it, and works in virtual
// coordinates: slot s of a stage stands for the row (column) at a fixed
// offset from the strip, reflected once when the slot is read or made, never
// per tap inside a pass.
// - level 0, vertical pass in registers: thread j owns the input column
//   pa - 2 + j (pa = 2*C0 - 8, reflected once) and loads the kL0Rows + 4 input
//   rows from qa - 2 (qa = 2*R0 - 6; each row's reflected index a
//   warp-uniform scalar), all loads independent and in flight together
//   (coalesced 4-byte loads); it writes its kL0Rows vertical sums to one
//   shared row buffer. Barrier 1;
// - level 0, horizontal pass from that buffer: a thread takes 4 adjacent l0
//   columns of a row (two 16-byte shared loads, 4 outputs), writes them to a
//   second buffer and, where they lie in the block's own tile, stores them to
//   l0 as one 16-byte store (element by element where W % 4 != 0). Barrier 2;
// - d, vertical, only at the even rows that l1 reads: virtual half-row k is
//   l1's reflected row refl(R0 - 2 + k, H/2); thread j takes l0 column
//   pa + j down the kTwoRows + 4 of them, each row's five l0 rows reflected at
//   H (slots qa..). Barrier 3;
// - d, horizontal, only at the even columns, then level 1's vertical pass,
//   in registers: thread m takes virtual half-column m (l1's reflected
//   column refl(C0 - 2 + m, W/2); its five l0 columns reflected once at W),
//   makes d down its kTwoRows + 4 half-rows and l1's vertical sums from them
//   (the virtual rows are already reflected at H/2: fixed register offsets).
//   Barrier 4;
// - level 1, horizontal, as level 0's: 4 outputs a thread from two 16-byte
//   shared loads (the virtual columns are reflected at W/2), one 16-byte
//   store where W/2 % 4 == 0.
// Four barriers, no division but by constants, and each stage's reflection
// at its own size (H x W for l0 and d, H/2 x W/2 for l1), so the result is
// the plain chain's for any taps.
// Slots past the image hold clamped values that no stored output reads. H
// and W are even (as the probe's reshape requires) and H/2, W/2 >= 3.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kTwoThreads = 192;                 // a block: one input column a thread
constexpr int kTwoRows = 8;                      // l1 rows a block
constexpr int kTwoCols = 80;                     // l1 columns a block
constexpr int kL0Groups = (kTwoThreads - 4) / 4; // groups of 4 l0 columns a block makes
constexpr int kL0Cols = 4 * kL0Groups;           // l0 columns a block makes (188)
constexpr int kL0Rows = 2 * kTwoRows + 11;       // l0 rows a block makes (27)
constexpr int kInRows = kL0Rows + 4;             // input rows a thread loads (31)
constexpr int kHalfRows = kTwoRows + 4;          // d rows l1's rows read (12)
constexpr int kHalfCols = kTwoCols + 4;          // d columns l1's columns read (84)
// the l0 columns d reads, 2*C0 - 6 .. 2*C0 + 2*kTwoCols + 4, lie in the
// block's (pa + 2 .. pa + 2*kTwoCols + 12); the half-columns in the threads
static_assert(2 * kTwoCols + 12 < kL0Cols, "the l0 columns d reads must be made");
static_assert(kHalfCols <= kTwoThreads && kTwoCols % 4 == 0, "");
// the store flags of probe_two_level
constexpr int kVecL0 = 1, kVecL1 = 2;

// OpenCV BORDER_REFLECT_101 for |overhang| < n; clamped past that (slots
// that no stored output reads)
__device__ __forceinline__ int reflect101(int i, int n) {
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__device__ __forceinline__ float taps5(const float* k, const float* x) {
  float acc = k[0] * x[0];
  acc = acc + k[1] * x[1];
  acc = acc + k[2] * x[2];
  acc = acc + k[3] * x[3];
  acc = acc + k[4] * x[4];
  return acc;
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

__global__ void __launch_bounds__(kTwoThreads)
two_level_kernel(const float* __restrict__ in, const float* __restrict__ taps,
                 float* __restrict__ l0, float* __restrict__ l1, int H, int W, int vec) {
  __shared__ __align__(16) float s_a[kL0Rows][kTwoThreads];  // level 0's vertical sums, then d's
  __shared__ __align__(16) float s_b[kL0Rows][kTwoThreads];  // l0, then level 1's vertical sums

  const int Hh = H / 2, Wh = W / 2;
  const int R0 = blockIdx.y * kTwoRows, C0 = blockIdx.x * kTwoCols;  // the l1 strip
  const int qa = 2 * R0 - 6, pa = 2 * C0 - 8;  // the l0 row and column of slot 0
  const int j = threadIdx.x;
  float k0[5], kd[5], k1[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    k0[t] = taps[t];
    kd[t] = taps[5 + t];
    k1[t] = taps[10 + t];
  }

  // level 0, vertical, in registers
  {
    const float* src = in + reflect101(pa - 2 + j, W);
    float x[kInRows];
#pragma unroll
    for (int i = 0; i < kInRows; ++i)
      x[i] = src[static_cast<long long>(reflect101(qa - 2 + i, H)) * W];
#pragma unroll
    for (int r = 0; r < kL0Rows; ++r) s_a[r][j] = taps5(k0, x + r);
  }
  __syncthreads();

  // level 0, horizontal, and the block's own 16 x 160 tile of l0 (slots
  // 6.. of the rows, 8.. of the columns: groups 2..)
  for (int e = j; e < kL0Rows * kL0Groups; e += kTwoThreads) {
    const int r = e / kL0Groups, g = e - r * kL0Groups;
    const float4 a = *reinterpret_cast<const float4*>(&s_a[r][4 * g]);
    const float4 b = *reinterpret_cast<const float4*>(&s_a[r][4 * g + 4]);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = taps5(k0, v + u);
    *reinterpret_cast<float4*>(&s_b[r][4 * g]) = make_float4(o[0], o[1], o[2], o[3]);
    const int q = qa + r, p = pa + 4 * g;
    if (r < 6 || r >= 6 + 2 * kTwoRows || g < 2 || g >= 2 + kTwoCols / 2 || q >= H || p >= W)
      continue;
    float* dst = l0 + static_cast<long long>(q) * W + p;
    if (vec & kVecL0) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (p + u < W) dst[u] = o[u];
    }
  }
  __syncthreads();

  // d, vertical, at the even rows 2 * refl(R0 - 2 + k, H/2)
  if (j < kL0Cols) {
#pragma unroll
    for (int k = 0; k < kHalfRows; ++k) {
      const int dr = 2 * reflect101(R0 - 2 + k, Hh);
      float x[5];
#pragma unroll
      for (int i = 0; i < 5; ++i)
        x[i] = s_b[min(max(reflect101(dr - 2 + i, H) - qa, 0), kL0Rows - 1)][j];
      s_a[k][j] = taps5(kd, x);
    }
  }
  __syncthreads();

  // d, horizontal, at the even columns 2 * refl(C0 - 2 + m, W/2); level 1,
  // vertical, from d's column in registers
  if (j < kHalfCols) {
    const int dc = 2 * reflect101(C0 - 2 + j, Wh);
    int col[5];
#pragma unroll
    for (int t = 0; t < 5; ++t) col[t] = min(max(reflect101(dc - 2 + t, W) - pa, 0), kL0Cols - 1);
    float d[kHalfRows];
#pragma unroll
    for (int k = 0; k < kHalfRows; ++k) {
      float x[5];
#pragma unroll
      for (int t = 0; t < 5; ++t) x[t] = s_a[k][col[t]];
      d[k] = taps5(kd, x);
    }
#pragma unroll
    for (int r = 0; r < kTwoRows; ++r) s_b[r][j] = taps5(k1, d + r);
  }
  __syncthreads();

  // level 1, horizontal, and the store
  constexpr int kGroups1 = kTwoCols / 4;
  for (int e = j; e < kTwoRows * kGroups1; e += kTwoThreads) {
    const int r = e / kGroups1, g = e - r * kGroups1;
    const int y = R0 + r, x0 = C0 + 4 * g;
    if (y >= Hh || x0 >= Wh) continue;
    const float4 a = *reinterpret_cast<const float4*>(&s_b[r][4 * g]);
    const float4 b = *reinterpret_cast<const float4*>(&s_b[r][4 * g + 4]);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) o[u] = taps5(k1, v + u);
    float* dst = l1 + static_cast<long long>(y) * Wh + x0;
    if (vec & kVecL1) {
      *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (x0 + u < Wh) dst[u] = o[u];
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
  // 16-byte stores where every row of the level starts on 16 bytes
  const auto on16 = [](const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; };
  const int vec = (W % 4 == 0 && on16(l0) ? kVecL0 : 0) | ((W / 2) % 4 == 0 && on16(l1) ? kVecL1 : 0);
  const dim3 grid((W / 2 + kTwoCols - 1) / kTwoCols, (H / 2 + kTwoRows - 1) / kTwoRows);
  two_level_kernel<<<grid, kTwoThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(taps),
      static_cast<float*>(l0), static_cast<float*>(l1), H, W, vec);
  return static_cast<int>(cudaGetLastError());
}
