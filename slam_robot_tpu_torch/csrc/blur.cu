// Separable 5-tap correlation with reflect-101 borders, optionally
// decimating 2x in the store.
//
// Replaces: slam_robot_tpu/ops/pallas/blur.py, _blur_kernel (launched via
// _call by blur() and pyr_down()). The pyramid builder runs it 11 times a
// frame at depth 6: one sigma=1.1 blur at 480x640, then five pyrDown
// ([1,4,6,4,1]/16, stride 2) + sigma=0.8 blur pairs down to 15x20.
//
// What bounds it on an H100: bytes. Each output costs 10 multiply-adds
// against one 4-byte read and one 4-byte write (the largest level moves
// 2.4 MB), far below the card's operations-per-byte balance, and the whole
// pyramid fits in the 50 MB L2. The small levels (60x80 and below) are
// bound by launch latency, not by the memory system.
//
// Design: one 32x8-thread block per 32x32 tile of OUTPUT pixels. The block
// loads its input tile plus the 2-pixel halo into shared memory once, with
// the reflect-101 index map applied at load time (so no border branches in
// the arithmetic), runs the vertical pass into a second shared buffer,
// then the horizontal pass. With stride 2 only the even input rows and
// columns are ever computed: the decimation happens in the store, and the
// TPU version's full-resolution pass + column-selection matmul are gone.
// Taps accumulate in ascending order (acc = k0*x0; acc += k1*x1; ...) as in
// blur.py:43-52.
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;                          // output tile edge
constexpr int kMaxIn = 2 * (kTile - 1) + 5;        // input tile edge at stride 2

__device__ __forceinline__ int reflect101(int i, int n) {
  // OpenCV BORDER_REFLECT_101 for |overhang| < n; clamped for tiles that
  // hang past the image (their outputs are never stored).
  if (i < 0) i = -i;
  if (i >= n) i = 2 * n - 2 - i;
  return min(max(i, 0), n - 1);
}

__global__ void sep5_reflect101_kernel(const float* __restrict__ in,
                                       float* __restrict__ out, int H, int W,
                                       int Ho, int Wo, int stride, float k0,
                                       float k1, float k2, float k3,
                                       float k4) {
  __shared__ float tile[kMaxIn][kMaxIn + 1];
  __shared__ float vert[kTile][kMaxIn + 1];

  const int oy0 = blockIdx.y * kTile;
  const int ox0 = blockIdx.x * kTile;
  const int iy0 = oy0 * stride - 2;  // input row of tile[0]
  const int ix0 = ox0 * stride - 2;
  const int in_h = stride * (kTile - 1) + 5;
  const int in_w = in_h;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int nthreads = blockDim.x * blockDim.y;
  const int tid = ty * blockDim.x + tx;

  for (int e = tid; e < in_h * in_w; e += nthreads) {
    const int r = e / in_w, c = e % in_w;
    tile[r][c] = in[reflect101(iy0 + r, H) * W + reflect101(ix0 + c, W)];
  }
  __syncthreads();

  // vertical pass: output row r reads input rows stride*r + 0..4
  for (int e = tid; e < kTile * in_w; e += nthreads) {
    const int r = e / in_w, c = e % in_w;
    const int b = stride * r;
    float acc = k0 * tile[b][c];
    acc = acc + k1 * tile[b + 1][c];
    acc = acc + k2 * tile[b + 2][c];
    acc = acc + k3 * tile[b + 3][c];
    acc = acc + k4 * tile[b + 4][c];
    vert[r][c] = acc;
  }
  __syncthreads();

  // horizontal pass + store (decimated when stride == 2)
  for (int r = ty; r < kTile; r += blockDim.y) {
    const int oy = oy0 + r;
    const int c = tx;
    const int ox = ox0 + c;
    if (oy >= Ho || ox >= Wo) continue;
    const int b = stride * c;
    float acc = k0 * vert[r][b];
    acc = acc + k1 * vert[r][b + 1];
    acc = acc + k2 * vert[r][b + 2];
    acc = acc + k3 * vert[r][b + 3];
    acc = acc + k4 * vert[r][b + 4];
    out[oy * Wo + ox] = acc;
  }
}

}  // namespace

extern "C" int sep5_reflect101(const void* in, void* out, int H, int W,
                               int Ho, int Wo, int stride, float k0, float k1,
                               float k2, float k3, float k4, void* stream) {
  dim3 block(kTile, 8);
  dim3 grid((Wo + kTile - 1) / kTile, (Ho + kTile - 1) / kTile);
  sep5_reflect101_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(in), static_cast<float*>(out), H, W, Ho, Wo,
      stride, k0, k1, k2, k3, k4);
  return static_cast<int>(cudaGetLastError());
}
