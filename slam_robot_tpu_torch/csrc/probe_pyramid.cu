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
// What bounds them on an H100: bytes, and below that the launch. An empty
// kernel takes 0.00101-0.00105 ms by CUDA-graph replay as one block, and
// 0.00112-0.00114 as 75 blocks of 256 threads (NVIDIA H100 80GB HBM3,
// 700.00 W; tests/torch_probe_turns.py). probe_decimate moves 0.92 MB at
// 480x640 (the even rows whole, and the output): 0.000275 ms at 3.35 TB/s.
//
// Design of probe_decimate: a 2-D grid of 16 x 4-thread blocks, no
// division; a thread takes 8 adjacent input columns of one even row as two
// 16-byte loads and stores its 4 outputs as one 16-byte store where W % 8
// == 0 and both pointers are on 16 bytes, else its 4 outputs element by
// element; every load is issued before the first store. At 480x640 that is
// 19,200 threads in 300 blocks, one wave. By graph, in turns (same card):
// 0.00147-0.00150 ms; blocks of 16 x 16 threads (75 blocks) 0.00154-0.00155,
// 16 x 8 0.00149-0.00151, 16 x 1 0.00172-0.00173.
//
// probe_two_level reads a 480x640 float32 frame once and writes l0 and l1
// once (2.76 MB, 0.83 us at 3.35 TB/s); the ~60 flops per input pixel are
// far below the card's operations-per-byte balance. Kernel B2 (blur.cu)
// needs three launches and writes and re-reads l0 and the decimated level
// for the same two levels.
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

constexpr int kDecX = 16, kDecY = 4;             // probe_decimate's block: 4 outputs a thread
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

__global__ void __launch_bounds__(kDecX * kDecY)
decimate_kernel(const float* __restrict__ in, float* __restrict__ out, int W, int Ho, int Wo,
                bool vec) {
  const int c0 = 4 * (blockIdx.x * kDecX + threadIdx.x);  // the thread's first output column
  if (c0 >= Wo) return;
  for (int r = blockIdx.y * kDecY + threadIdx.y; r < Ho; r += gridDim.y * kDecY) {
    const float* src = in + static_cast<long long>(2 * r) * W + 2 * c0;
    float* dst = out + static_cast<long long>(r) * Wo + c0;
    if (vec) {
      const float4 a = *reinterpret_cast<const float4*>(src);
      const float4 b = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<float4*>(dst) = make_float4(a.x, a.z, b.x, b.z);
    } else {
      float o[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = c0 + u < Wo ? src[2 * u] : 0.0f;
#pragma unroll
      for (int u = 0; u < 4; ++u)
        if (c0 + u < Wo) dst[u] = o[u];
    }
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

bool on16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" int probe_decimate(const void* in, void* out, int H, int W, void* stream) {
  if (H < 2 || W < 2 || H % 2 || W % 2) return static_cast<int>(cudaErrorInvalidValue);
  const int Ho = H / 2, Wo = W / 2;
  const bool vec = W % 8 == 0 && on16(in) && on16(out);
  const dim3 block(kDecX, kDecY);
  const int strips = (Ho + kDecY - 1) / kDecY;  // past the grid's 65535 rows, the kernel loops
  const dim3 grid((Wo + 4 * kDecX - 1) / (4 * kDecX), strips < 65535 ? strips : 65535);
  decimate_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), W, Ho, Wo, vec);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int probe_two_level(const void* in, const void* taps, void* l0, void* l1,
                               int H, int W, void* stream) {
  if (H % 2 || W % 2 || H / 2 < 3 || W / 2 < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  // 16-byte stores where every row of the level starts on 16 bytes
  const int vec = (W % 4 == 0 && on16(l0) ? kVecL0 : 0) | ((W / 2) % 4 == 0 && on16(l1) ? kVecL1 : 0);
  const dim3 grid((W / 2 + kTwoCols - 1) / kTwoCols, (H / 2 + kTwoRows - 1) / kTwoRows);
  two_level_kernel<<<grid, kTwoThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<const float*>(taps),
      static_cast<float*>(l0), static_cast<float*>(l1), H, W, vec);
  return static_cast<int>(cudaGetLastError());
}
