// Kernel B2 and the pyramid it builds.
//
// Replaces: slam_robot_tpu/ops/pallas/blur.py, _blur_kernel (launched via
// _call by blur() and pyr_down()), and the body of
// slam_robot_tpu/ops/pyramid.py, build_pyramid, around it.
//
// sep5_reflect101: one separable 5-tap correlation with reflect-101 borders,
// optionally decimating 2x in the store; the kernel behind the public
// blur() and pyr_down(). Taps accumulate in ascending order (acc = k0*x0;
// acc += k1*x1; ...) as in blur.py:43-52, the vertical pass first.
// What bounds it: bytes (a 480x640 blur reads and writes 1.2 MB each, 0.73
// us at 3.35 TB/s) and, at the pyramid's smaller levels, a launch's latency.
// Design:
// - the stride S is a template parameter; a block of kSepThreads = 128
//   threads takes a tile of SepTile<S>::kRows x kCols outputs (16 x 124 at
//   S = 1, 8 x 62 at S = 2), so that the tile's input span, S*(kCols-1)+5
//   columns, fits the 128 threads: 180 blocks at 480x640 either way (one
//   wave over 132 SMs), one block at 15x20;
// - vertical pass in registers: thread j owns input column S*x0 - 2 + j of
//   the span (reflected once) and loads its S*(kRows-1)+5 input rows, each
//   row's reflect-101 index a warp-uniform scalar, all loads independent and
//   in flight together (coalesced 4-byte loads, a warp reads 128 B a row);
//   it keeps the rows in registers and writes only its kRows vertical sums
//   to shared memory: one buffer of kRows x 128 floats, one barrier;
// - horizontal pass: a thread takes kVec adjacent outputs of a row (4 at S
//   = 1, 2 at S = 2), reads the 8 sums they need as two 16-byte shared loads
//   and stores them as one 16-byte (8-byte) store where the row allows (Wo a
//   multiple of kVec), else element by element.
// Rows and columns of a tile that hang past the image are loaded clamped and
// never stored.
//
// pyramid_flat: the whole flat, edge-padded pyramid of a grey image, the
// sigma0 blur at level 0 and (pyrDown + sigma_down blur) for every further
// level, each level written edge-padded by kPad into the top-left corner of
// its plane of the [L, H0+16, W0+16] tensor and the rest of the tensor
// written as zero (pyramid.py:169-172). Built with sep5_reflect101 it took
// 11 launches plus a zero fill, six pads and six slice copies a frame.
//
// What bounds it on an H100: bytes. It reads the frame once and writes the
// flat tensor once (9.0 MB at 480x640, 2.7 us at 3.35 TB/s), against ~10
// multiply-adds per output pixel. The small levels (60x80 and below) are a
// few microseconds of dependent work, not bandwidth.
//
// Design: two launches of kPyrThreads = 512 threads a block (at 480x640 on
// an H100, by graph replay: 256 threads 0.0446 ms, 512 0.0354, 1024 0.0368;
// PERF.md, B2).
// - Launch 1, one block per kPyrTile = 16 square tile of level
//   K = min(kFusedLevels, L-1), kFusedLevels = 2:
//   the block works out, from its tile down to the frame, the region each
//   stage needs (each stage's output region widened by the 2-pixel halo,
//   doubled across a pyrDown, clamped to the stage's level), loads the
//   frame region into shared memory and computes level 0, its pyrDown,
//   level 1, and so on to level K there (the halo is recomputed, as the
//   tools' two-level probe does): the intermediates never leave the SM.
//   Each stage reflects in its own level's global coordinates, never at a
//   region edge. After each level the block stores the part of the level
//   that its tile covers, edge-padded where that part meets the border. All
//   blocks then write the zero region of planes 1..L-1, one warp per row.
// - Launch 2, one block, walks levels K+1..L-1 from level K (read back from
//   the flat tensor, in L2): a level at a time, in strips of rows as large
//   as shared memory allows (one strip at 480x640, and then the level stays
//   in shared memory as the next one's input), the same two-stage chain and
//   store. These levels are 60x80 and below at 480x640, too small to fill
//   the card and each a launch's latency before.
// The host's plan (ops/cuda/blur.py, pyramid_plan) sizes the shared buffers
// from kPyrTile and kFusedLevels; the entry point checks the plan's K and
// launch 1's buffer against them.
// Reflection follows numpy's 'reflect' (jnp.pad) for levels of one and two
// pixels (period 2(n-1)), so deep pyramids of small frames match the JAX
// package. The store of every level is the kernel's own: no pad or copy.
#include <cuda_runtime.h>

namespace {

constexpr int kSepThreads = 128;  // threads a block; input columns of a tile's span

// the output tile of a block at stride S; S*(kCols-1)+5 <= kSepThreads
template <int S>
struct SepTile;
template <>
struct SepTile<1> {
  static constexpr int kRows = 16, kCols = 124, kVec = 4;
};
template <>
struct SepTile<2> {
  static constexpr int kRows = 8, kCols = 62, kVec = 2;
};

__device__ __forceinline__ int reflect101(int i, int n) {
  // OpenCV BORDER_REFLECT_101 for |overhang| < n; clamped for tiles that
  // hang past the image (their outputs are never stored).
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

template <int S>
__global__ void __launch_bounds__(kSepThreads)
sep5_reflect101_kernel(const float* __restrict__ in, float* __restrict__ out, int H, int W,
                       int Ho, int Wo, float k0, float k1, float k2, float k3, float k4) {
  using T = SepTile<S>;
  constexpr int kIn = S * (T::kRows - 1) + 5;  // input rows a tile reads
  constexpr int kGroups = T::kCols / T::kVec;  // output groups a tile row holds
  static_assert(S * (T::kCols - 1) + 5 <= kSepThreads, "the span must fit the threads");
  static_assert(4 * (kGroups - 1) + 8 <= kSepThreads, "a group's sums must lie in the row");
  __shared__ __align__(16) float vsum[T::kRows][kSepThreads];

  const int oy0 = blockIdx.y * T::kRows, ox0 = blockIdx.x * T::kCols;
  const int j = threadIdx.x;
  const float* src = in + reflect101(S * ox0 - 2 + j, W);
  float x[kIn];
#pragma unroll
  for (int i = 0; i < kIn; ++i)
    x[i] = src[static_cast<long long>(reflect101(S * oy0 - 2 + i, H)) * W];
#pragma unroll
  for (int r = 0; r < T::kRows; ++r) {
    const float* q = x + S * r;
    float acc = k0 * q[0];
    acc = acc + k1 * q[1];
    acc = acc + k2 * q[2];
    acc = acc + k3 * q[3];
    acc = acc + k4 * q[4];
    vsum[r][j] = acc;
  }
  __syncthreads();

  // group g of row r: outputs ox0 + kVec*g + u read the sums of span columns
  // 4g + S*u + 0..4 (S*kVec = 4 at either stride)
  const bool vec = Wo % T::kVec == 0;
  for (int e = j; e < T::kRows * kGroups; e += kSepThreads) {
    const int r = e / kGroups, g = e - r * kGroups;
    const int oy = oy0 + r, ox = ox0 + T::kVec * g;
    if (oy >= Ho || ox >= Wo) continue;
    const float4 a = *reinterpret_cast<const float4*>(&vsum[r][4 * g]);
    const float4 b = *reinterpret_cast<const float4*>(&vsum[r][4 * g + 4]);
    const float v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
    float o[T::kVec];
#pragma unroll
    for (int u = 0; u < T::kVec; ++u) {
      const float* q = v + S * u;
      float acc = k0 * q[0];
      acc = acc + k1 * q[1];
      acc = acc + k2 * q[2];
      acc = acc + k3 * q[3];
      acc = acc + k4 * q[4];
      o[u] = acc;
    }
    float* dst = out + static_cast<long long>(oy) * Wo + ox;
    if (vec) {
      if constexpr (T::kVec == 4) {
        *reinterpret_cast<float4*>(dst) = make_float4(o[0], o[1], o[2], o[3]);
      } else {
        *reinterpret_cast<float2*>(dst) = make_float2(o[0], o[1]);
      }
    } else {
#pragma unroll
      for (int u = 0; u < T::kVec; ++u)
        if (ox + u < Wo) dst[u] = o[u];
    }
  }
}

template <int S>
int launch_sep5(const float* in, float* out, int H, int W, int Ho, int Wo, const float* k,
                cudaStream_t s) {
  using T = SepTile<S>;
  const dim3 grid((Wo + T::kCols - 1) / T::kCols, (Ho + T::kRows - 1) / T::kRows);
  sep5_reflect101_kernel<S><<<grid, kSepThreads, 0, s>>>(in, out, H, W, Ho, Wo, k[0], k[1],
                                                         k[2], k[3], k[4]);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxLevels = 8;
constexpr int kPad = 8;            // pyramid.PAD
constexpr int kPyrTile = 16;       // launch 1: tile edge at level K (blur.TILE)
constexpr int kFusedLevels = 2;    // launch 1: levels 0..K, K <= this (blur.FUSED_LEVELS)
constexpr int kPyrThreads = 512;   // threads per block, either launch

}  // namespace

// Mirrored field for field by ops/cuda/blur.py (PyrParams, ctypes).
struct PyrParams {
  int H[kMaxLevels], W[kMaxLevels];  // level dims
  int L, K;        // depth; launch 1 computes levels 0..K
  int Hp, Wp;      // plane dims, H[0] + 2 kPad and W[0] + 2 kPad
  int buf1;        // launch 1: floats per shared buffer (two buffers)
  int strip;       // launch 2: rows of a level per pass
  int buf2;        // launch 2: floats per shared buffer (two buffers)
  float taps[15];  // level-0 blur | pyrDown | later blur, 5 each
};

namespace {

struct Region {
  int r0, r1, c0, c1;  // inclusive
};

// numpy 'reflect' (reflect-101) of index i on an axis of n; for n >= 3 the
// overhang is at most 2, for n <= 2 any i (period 2(n-1), n = 1 constant).
__device__ __forceinline__ int reflect(int i, int n) {
  if (n < 3) return n == 1 ? 0 : (i & 1);
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return i;
}

// The region of an nr x nc level that a 5-tap pass with stride s reads to
// produce `out`. Reflected halo indices lie within 2 of a border, so they
// fall inside it.
__device__ __forceinline__ Region pass_input(Region o, int s, int nr, int nc) {
  return {max(s * o.r0 - 2, 0), min(s * o.r1 + 2, nr - 1), max(s * o.c0 - 2, 0),
          min(s * o.c1 + 2, nc - 1)};
}

// Copy region x of a row-major level (row stride `stride`, element [0, 0] at
// `src`) into `a` (row stride: x's width), as asynchronous 4-byte copies
// that are all in flight at once (a region starts at any column); the
// caller synchronizes the block. Warps take rows, lanes columns.
__device__ void load_region(float* a, const float* src, int stride, Region x) {
  const int xw = x.c1 - x.c0 + 1, xh = x.r1 - x.r0 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = warp; r < xh; r += nw) {
    const float* srow = src + static_cast<long long>(x.r0 + r) * stride + x.c0;
    for (int c = lane; c < xw; c += 32) {
      const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(a + r * xw + c));
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(srow + c)
                   : "memory");
    }
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Region `out` of a separable 5-tap correlation with stride s over an nr x nc
// level whose region `in` lies in `a` (row stride: in's width): vertical
// pass into `tmp`, horizontal pass back into `a` (row stride: out's width).
// Warps take output rows and lanes columns, so a row's (vertical) or a
// column's (horizontal) five reflected tap offsets are worked out once.
__device__ void sep_pass(float* __restrict__ a, Region in, float* __restrict__ tmp, Region out,
                         int s, const float* k, int nr, int nc) {
  const int iw = in.c1 - in.c0 + 1;
  const int orows = out.r1 - out.r0 + 1, ocols = out.c1 - out.c0 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  const float k0 = k[0], k1 = k[1], k2 = k[2], k3 = k[3], k4 = k[4];
  for (int r = warp; r < orows; r += nw) {
    const int b = s * (out.r0 + r) - 2;
    const float* q0 = a + (reflect(b, nr) - in.r0) * iw;
    const float* q1 = a + (reflect(b + 1, nr) - in.r0) * iw;
    const float* q2 = a + (reflect(b + 2, nr) - in.r0) * iw;
    const float* q3 = a + (reflect(b + 3, nr) - in.r0) * iw;
    const float* q4 = a + (reflect(b + 4, nr) - in.r0) * iw;
    float* trow = tmp + r * iw;
    for (int c = lane; c < iw; c += 32) {
      float acc = k0 * q0[c];
      acc = acc + k1 * q1[c];
      acc = acc + k2 * q2[c];
      acc = acc + k3 * q3[c];
      acc = acc + k4 * q4[c];
      trow[c] = acc;
    }
  }
  __syncthreads();
  for (int c = lane; c < ocols; c += 32) {
    const int b = s * (out.c0 + c) - 2;
    const int j0 = reflect(b, nc) - in.c0, j1 = reflect(b + 1, nc) - in.c0;
    const int j2 = reflect(b + 2, nc) - in.c0, j3 = reflect(b + 3, nc) - in.c0;
    const int j4 = reflect(b + 4, nc) - in.c0;
    for (int r = warp; r < orows; r += nw) {
      const float* row = tmp + r * iw;
      float acc = k0 * row[j0];
      acc = acc + k1 * row[j1];
      acc = acc + k2 * row[j2];
      acc = acc + k3 * row[j3];
      acc = acc + k4 * row[j4];
      a[r * ocols + c] = acc;
    }
  }
  __syncthreads();
}

// Store rows [r0, r1) x cols [c0, c1) of level lv, held in `a` as region
// `o`, into its plane, with the edge padding where they meet the border.
__device__ void store_level(float* flat, const PyrParams& p, int lv, const float* a,
                            Region o, int r0, int r1, int c0, int c1) {
  const int H = p.H[lv], W = p.W[lv];
  const int pr0 = r0 == 0 ? 0 : r0 + kPad, pr1 = r1 == H ? H + 2 * kPad : r1 + kPad;
  const int pc0 = c0 == 0 ? 0 : c0 + kPad, pc1 = c1 == W ? W + 2 * kPad : c1 + kPad;
  const int ow = o.c1 - o.c0 + 1;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
  float* plane = flat + static_cast<long long>(lv) * p.Hp * p.Wp;
  for (int pr = pr0 + warp; pr < pr1; pr += nw) {
    const float* arow = a + (min(max(pr - kPad, 0), H - 1) - o.r0) * ow - o.c0;
    float* prow = plane + pr * p.Wp;
    for (int pc = pc0 + lane; pc < pc1; pc += 32) prow[pc] = arow[min(max(pc - kPad, 0), W - 1)];
  }
}

__global__ void __launch_bounds__(kPyrThreads)
pyramid_tiles_kernel(const float* __restrict__ in, float* flat,
                     const __grid_constant__ PyrParams p) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;
  float* tmp = smem + p.buf1;
  __shared__ float s_k[15];
  if (threadIdx.x < 15) s_k[threadIdx.x] = p.taps[threadIdx.x];

  const int K = p.K;
  const int R0 = blockIdx.y * kPyrTile, C0 = blockIdx.x * kPyrTile;
  Region o[kMaxLevels], d[kMaxLevels];  // each level's region, each pyrDown's
  o[K] = {R0, min(R0 + kPyrTile, p.H[K]) - 1, C0, min(C0 + kPyrTile, p.W[K]) - 1};
  for (int lv = K; lv >= 1; --lv) {
    d[lv] = pass_input(o[lv], 1, p.H[lv], p.W[lv]);
    o[lv - 1] = pass_input(d[lv], 2, p.H[lv - 1], p.W[lv - 1]);
  }
  const Region x = pass_input(o[0], 1, p.H[0], p.W[0]);
  load_region(a, in, p.W[0], x);
  __syncthreads();

  sep_pass(a, x, tmp, o[0], 1, s_k, p.H[0], p.W[0]);
  for (int lv = 0;; ++lv) {
    // the part of level lv under this block's tile
    const int sh = K - lv;
    store_level(flat, p, lv, a, o[lv], R0 << sh, min((R0 + kPyrTile) << sh, p.H[lv]),
                C0 << sh, min((C0 + kPyrTile) << sh, p.W[lv]));
    if (lv == K) break;
    sep_pass(a, o[lv], tmp, d[lv + 1], 2, s_k + 5, p.H[lv], p.W[lv]);
    sep_pass(a, d[lv + 1], tmp, o[lv + 1], 1, s_k + 10, p.H[lv + 1], p.W[lv + 1]);
  }

  // the zero region of planes 1..L-1: right of and below each padded level
  const int warps = blockDim.x / 32;
  const int lane = threadIdx.x & 31;
  const int nw = gridDim.x * gridDim.y * warps;
  const int gw = (blockIdx.y * gridDim.x + blockIdx.x) * warps + threadIdx.x / 32;
  for (int q = gw; q < (p.L - 1) * p.Hp; q += nw) {
    const int lv = 1 + q / p.Hp, r = q % p.Hp;
    const int c0 = r < p.H[lv] + 2 * kPad ? p.W[lv] + 2 * kPad : 0;
    float* row = flat + (static_cast<long long>(lv) * p.Hp + r) * p.Wp;
    for (int c = c0 + lane; c < p.Wp; c += 32) row[c] = 0.0f;
  }
}

__global__ void __launch_bounds__(kPyrThreads)
pyramid_walk_kernel(float* flat, const __grid_constant__ PyrParams p) {
  extern __shared__ __align__(16) float smem[];
  float* a = smem;
  float* tmp = smem + p.buf2;
  __shared__ float s_k[15];
  if (threadIdx.x < 15) s_k[threadIdx.x] = p.taps[threadIdx.x];
  __syncthreads();

  bool held = false;  // `a` holds the whole previous level
  for (int lv = p.K + 1; lv < p.L; ++lv) {
    const int H = p.H[lv], W = p.W[lv], Hs = p.H[lv - 1], Ws = p.W[lv - 1];
    // level lv-1's interior, written by launch 1 or the previous pass
    const float* src = flat + static_cast<long long>(lv - 1) * p.Hp * p.Wp + kPad * p.Wp + kPad;
    for (int r0 = 0; r0 < H; r0 += p.strip) {
      const Region o = {r0, min(r0 + p.strip, H) - 1, 0, W - 1};
      const Region d = pass_input(o, 1, H, W);
      const Region x = pass_input(d, 2, Hs, Ws);
      if (!(held && x.r0 == 0 && x.r1 == Hs - 1)) {
        load_region(a, src, p.Wp, x);
        __syncthreads();
      }
      sep_pass(a, x, tmp, d, 2, s_k + 5, Hs, Ws);
      sep_pass(a, d, tmp, o, 1, s_k + 10, H, W);
      store_level(flat, p, lv, a, o, o.r0, o.r1 + 1, 0, W);
      held = o.r0 == 0 && o.r1 == H - 1;  // a level in one strip stays for the next
      __syncthreads();  // the store is read by the next level; `a` is reused
    }
  }
}

// Allow `bytes` of dynamic shared memory for `kernel` (above the default
// 48 KB); `done` remembers the largest size already allowed.
int set_smem(const void* kernel, size_t bytes, size_t* done) {
  if (bytes <= 48 * 1024 || bytes <= *done) return 0;
  const int err = static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes)));
  if (err == 0) *done = bytes;
  return err;
}

size_t g_smem_tiles = 0, g_smem_walk = 0;

}  // namespace

// The output's [Ho, Wo] must be the input's at stride 1 and ((H+1)/2,
// (W+1)/2) at stride 2; H, W >= 3 (one reflection reaches every index).
extern "C" int sep5_reflect101(const void* in, void* out, int H, int W,
                               int Ho, int Wo, int stride, float k0, float k1,
                               float k2, float k3, float k4, void* stream) {
  const bool dims = stride == 1 ? Ho == H && Wo == W
                                : stride == 2 && Ho == (H + 1) / 2 && Wo == (W + 1) / 2;
  if (H < 3 || W < 3 || !dims) return static_cast<int>(cudaErrorInvalidValue);
  const float k[5] = {k0, k1, k2, k3, k4};
  const float* src = static_cast<const float*>(in);
  float* dst = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return stride == 1 ? launch_sep5<1>(src, dst, H, W, Ho, Wo, k, s)
                     : launch_sep5<2>(src, dst, H, W, Ho, Wo, k, s);
}

extern "C" int pyramid_params_size() { return static_cast<int>(sizeof(PyrParams)); }

// The flat pyramid of the [H0, W0] image `in` into `flat` [L, Hp, Wp]: launch
// 1, then launch 2 when L > K + 1. Returns the first failing cudaError_t.
extern "C" int pyramid_flat(const void* in, void* flat, const PyrParams* p, void* stream) {
  if (p->L < 1 || p->L > kMaxLevels || p->K != min(kFusedLevels, p->L - 1))
    return static_cast<int>(cudaErrorInvalidValue);
  int ext = kPyrTile;  // the frame region a tile of level K reads (pyramid_plan)
  for (int k = 0; k < p->K; ++k) ext = 2 * (ext + 3) + 5;
  ext += 4;
  if (p->buf1 < min(ext, p->H[0]) * min(ext, p->W[0]))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t smem1 = 2 * static_cast<size_t>(p->buf1) * sizeof(float);
  int err = set_smem(reinterpret_cast<const void*>(pyramid_tiles_kernel), smem1, &g_smem_tiles);
  if (err) return err;
  const dim3 grid((p->W[p->K] + kPyrTile - 1) / kPyrTile, (p->H[p->K] + kPyrTile - 1) / kPyrTile);
  pyramid_tiles_kernel<<<grid, kPyrThreads, smem1, s>>>(static_cast<const float*>(in),
                                                        static_cast<float*>(flat), *p);
  err = static_cast<int>(cudaGetLastError());
  if (err || p->K + 1 >= p->L) return err;
  const size_t smem2 = 2 * static_cast<size_t>(p->buf2) * sizeof(float);
  err = set_smem(reinterpret_cast<const void*>(pyramid_walk_kernel), smem2, &g_smem_walk);
  if (err) return err;
  pyramid_walk_kernel<<<1, kPyrThreads, smem2, s>>>(static_cast<float*>(flat), *p);
  return static_cast<int>(cudaGetLastError());
}
