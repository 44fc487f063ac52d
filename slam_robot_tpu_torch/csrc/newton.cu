// Fused per-level Newton patch tracker: every Newton iteration of one
// pyramid level for F feature lanes in one launch.
//
// Replaces: slam_robot_tpu/ops/pallas/newton.py, _kernel (launched by
// newton_level; math in _newton_iter and newton_window_steps). The tracker
// runs it per pyramid level, per direction, per sweep (hessian.h:185-241).
//
// Per iteration and lane: margin test; bilinear resample of the 13x13 patch
// and its d/dx, d/dy, d2/dxdy from the lane's search window (support origin
// clamped to [0, W-(S+1)], validity from the raw support); gain/offset-
// normalized SSD against the reference patch with radial weights, its
// closed-form gradient and 2x2 Hessian; the 2x2 solve with the 1e-20 det
// guard and 1e20 finite guard; unit-norm cap then +-1 clip; convergence
// when both |d| < threshold. A final out-of-bounds test sets status 2.
//
// What bounds it on an H100: latency. A lane's data is ~5 KB (window <=
// 32x32 f32, reference, validity) and an iteration is ~3k flops, so the
// whole F=256 level is ~1.3 MB and ~5 MFLOP per iteration — neither the
// memory system nor the ALUs come close to their limits. The critical path
// is the chain of dependent reductions inside one lane's iteration.
//
// Design: one warp per lane, four lanes per 128-thread block. The warp
// copies its window, reference patch and validity into shared memory once;
// each thread then owns <= 6 of the 169 patch pixels and samples them with
// direct bilinear taps (the TPU kernel's banded MXU matmuls are gone). Each
// iteration makes two warp reductions by xor-shuffle — first the patch
// means and second moments, then g and H — after which every thread holds
// the same sums and computes the same 2x2 solve, so no broadcast is needed.
// A lane leaves its own loop when it is done: a done lane passes through
// _newton_iter unchanged (newton.py:156-158), so this matches the TPU
// kernel's whole-block early exit without any lane-bucket compaction.
// WH, WW (<= 32; 31x32 occurs at the coarsest level) and the per-lane level
// bounds are runtime arguments.
#include <cuda_runtime.h>

namespace {

constexpr int kS = 13;
constexpr int kHalf = (kS - 1) / 2;
constexpr int kPix = kS * kS;
constexpr int kPer = (kPix + 31) / 32;  // pixels per thread
constexpr int kWin = 32;                // max window edge (smem row stride)
constexpr int kLanes = 4;               // lanes (warps) per block
constexpr float kMargin = 0.01f;        // hessian.h:196

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__global__ void newton_level_kernel(
    const float* __restrict__ win, const float* __restrict__ pos0,
    const float* __restrict__ org, const float* __restrict__ ref,
    const float* __restrict__ ref_valid, const float* __restrict__ ref_mean,
    const float* __restrict__ ref_sumsq, const float* __restrict__ active,
    const float* __restrict__ wmask, const float* __restrict__ bounds,
    float* __restrict__ pos_out, float* __restrict__ status_out, int F, int WH,
    int WW, float threshold, int max_iters) {
  __shared__ float s_win[kLanes][kWin * kWin];
  __shared__ float s_ref[kLanes][kPix];
  __shared__ float s_w[kLanes][kPix];  // wmask * ref_valid

  const int t = threadIdx.x;
  const int wl = threadIdx.y;
  const int f = blockIdx.x * kLanes + wl;
  if (f >= F) return;  // whole warp leaves together

  const float* wf = win + static_cast<size_t>(f) * WH * WW;
  for (int e = t; e < WH * WW; e += 32) {
    s_win[wl][(e / WW) * kWin + (e % WW)] = wf[e];
  }
  for (int e = t; e < kPix; e += 32) {
    s_ref[wl][e] = ref[static_cast<size_t>(f) * kPix + e];
    s_w[wl][e] = wmask[e] * ref_valid[static_cast<size_t>(f) * kPix + e];
  }
  __syncwarp();

  const float width = bounds[2 * f];
  const float height = bounds[2 * f + 1];
  const float orgx = org[2 * f];
  const float orgy = org[2 * f + 1];
  const int iorgx = static_cast<int>(orgx);
  const int iorgy = static_cast<int>(orgy);
  const float r_mean = ref_mean[f];
  const float r_sumsq = ref_sumsq[f];
  const float act = active[f];
  const float eps = 1e-12f;
  const float inv_n = 1.0f / static_cast<float>(kPix);

  float x = pos0[2 * f];
  float y = pos0[2 * f + 1];
  float status = 0.0f;
  bool done = !((1.0f - act) < 0.5f);

  float p2[kPer], u[kPer], v[kPer], puv[kPer], w2[kPer];

  for (int it = 0; it < max_iters && !done; ++it) {
    const bool oob = (x < kMargin) || (y < kMargin) || (x + kMargin > width) ||
                     (y + kMargin > height);
    const float lx = x - orgx;
    const float ly = y - orgy;
    const float x0f = floorf(lx);
    const float y0f = floorf(ly);
    const float fx = lx - x0f;
    const float fy = ly - y0f;
    const int x0 = static_cast<int>(x0f) - kHalf;
    const int y0 = static_cast<int>(y0f) - kHalf;
    const int x0c = min(max(x0, 0), WW - (kS + 1));
    const int y0c = min(max(y0, 0), WH - (kS + 1));

    float s_m = 0.f, s_ss = 0.f, s_mx = 0.f, s_my = 0.f, s_mxy = 0.f;
    float s_px = 0.f, s_py = 0.f, s_uu = 0.f, s_vv = 0.f, s_uvp = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = t + 32 * k;
      p2[k] = u[k] = v[k] = puv[k] = w2[k] = 0.f;
      if (p < kPix) {
        const int i = p / kS, j = p % kS;
        const float* rowp = &s_win[wl][(y0c + i) * kWin + x0c + j];
        const float a = rowp[0], b = rowp[1], c = rowp[kWin], d = rowp[kWin + 1];
        // row interpolation then column interpolation (rows: value | d/dy)
        const float t0 = (1.0f - fy) * a + fy * c;
        const float t1 = (1.0f - fy) * b + fy * d;
        const float s0 = c - a;
        const float s1 = d - b;
        p2[k] = (1.0f - fx) * t0 + fx * t1;
        u[k] = t1 - t0;
        v[k] = (1.0f - fx) * s0 + fx * s1;
        puv[k] = s1 - s0;
        const int gx = x0 + iorgx + j;
        const int gy = y0 + iorgy + i;
        const bool vx = (gx >= 0) && (static_cast<float>(gx) + 1.0f <= width);
        const bool vy = (gy >= 0) && (static_cast<float>(gy) + 1.0f <= height);
        w2[k] = (vx && vy) ? s_w[wl][p] : 0.0f;
        s_m += p2[k];
        s_ss += p2[k] * p2[k];
        s_mx += u[k];
        s_my += v[k];
        s_mxy += puv[k];
        s_px += p2[k] * u[k];
        s_py += p2[k] * v[k];
        s_uu += u[k] * u[k];
        s_vv += v[k] * v[k];
        s_uvp += u[k] * v[k] + p2[k] * puv[k];
      }
    }
    // reduction phase 1: patch means and second moments
    const float m2 = warp_sum(s_m) * inv_n;
    const float ss2 = warp_sum(s_ss) * inv_n;
    const float m2x = warp_sum(s_mx) * inv_n;
    const float m2y = warp_sum(s_my) * inv_n;
    const float m2xy = warp_sum(s_mxy) * inv_n;
    const float gate = ss2 > eps ? 1.0f : 0.0f;
    const float ss2s = fmaxf(ss2, eps);
    const float ss2x = 2.0f * (warp_sum(s_px) * inv_n) * gate;
    const float ss2y = 2.0f * (warp_sum(s_py) * inv_n) * gate;
    const float ss2xx = 2.0f * (warp_sum(s_uu) * inv_n) * gate;
    const float ss2yy = 2.0f * (warp_sum(s_vv) * inv_n) * gate;
    const float ss2xy = 2.0f * (warp_sum(s_uvp) * inv_n) * gate;

    const float alpha = sqrtf(r_sumsq / ss2s);
    const float rx = ss2x / ss2s;
    const float ry = ss2y / ss2s;
    const float ax = -0.5f * alpha * rx;
    const float ay = -0.5f * alpha * ry;
    const float axx = -0.5f * (ax * rx + alpha * (ss2xx / ss2s - rx * rx));
    const float ayy = -0.5f * (ay * ry + alpha * (ss2yy / ss2s - ry * ry));
    const float axy = -0.5f * (ay * rx + alpha * (ss2xy / ss2s - rx * ry));
    const float bx = -ax * m2 - alpha * m2x;
    const float by = -ay * m2 - alpha * m2y;
    const float bxx = -axx * m2 - 2.0f * ax * m2x;
    const float byy = -ayy * m2 - 2.0f * ay * m2y;
    const float bxy = -axy * m2 - ax * m2y - ay * m2x - alpha * m2xy;
    const float beta = r_mean - alpha * m2;

    float s_gx = 0.f, s_gy = 0.f, s_hxx = 0.f, s_hyy = 0.f, s_hxy = 0.f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int p = t + 32 * k;
      if (p < kPix) {
        const float e = s_ref[wl][p] - alpha * p2[k] - beta;
        const float ex = -ax * p2[k] - alpha * u[k] - bx;
        const float ey = -ay * p2[k] - alpha * v[k] - by;
        const float exx = -axx * p2[k] - 2.0f * ax * u[k] - bxx;
        const float eyy = -ayy * p2[k] - 2.0f * ay * v[k] - byy;
        const float exy =
            -axy * p2[k] - ax * v[k] - ay * u[k] - alpha * puv[k] - bxy;
        s_gx += w2[k] * e * ex;
        s_gy += w2[k] * e * ey;
        s_hxx += w2[k] * (ex * ex + e * exx);
        s_hyy += w2[k] * (ey * ey + e * eyy);
        s_hxy += w2[k] * (ex * ey + e * exy);
      }
    }
    // reduction phase 2: gradient and Hessian of the score
    const float gx_ = 2.0f * warp_sum(s_gx);
    const float gy_ = 2.0f * warp_sum(s_gy);
    const float hxx = 2.0f * warp_sum(s_hxx);
    const float hyy = 2.0f * warp_sum(s_hyy);
    const float hxy = 2.0f * warp_sum(s_hxy);

    const float det = hxx * hyy - hxy * hxy;
    const float safe = fabsf(det) > 1e-20f ? det : (det >= 0.f ? 1e-20f : -1e-20f);
    float dx = -(hyy * gx_ - hxy * gy_) / safe;
    float dy = -(-hxy * gx_ + hxx * gy_) / safe;
    const bool finite = (fabsf(dx) < 1e20f) && (fabsf(dy) < 1e20f);
    if (!finite) {
      dx = 0.f;
      dy = 0.f;
    }
    const float n = sqrtf(dx * dx + dy * dy);
    const float scale = n > 1.0f ? 1.0f / fmaxf(n, 1e-20f) : 1.0f;
    dx *= scale;
    dy *= scale;
    const float sx = fminf(fmaxf(dx, -1.0f), 1.0f);
    const float sy = fminf(fmaxf(dy, -1.0f), 1.0f);
    const bool converged = (fabsf(dx) < threshold) && (fabsf(dy) < threshold);
    if (!oob) {
      x += sx;
      y += sy;
    } else {
      status = 2.0f;
    }
    done = oob || converged;
  }

  if (t == 0) {
    const bool final_oob = (x < kMargin) || (y < kMargin) ||
                           (x + kMargin > width) || (y + kMargin > height);
    if (final_oob && act > 0.5f) status = 2.0f;
    pos_out[2 * f] = x;
    pos_out[2 * f + 1] = y;
    status_out[f] = status;
  }
}

}  // namespace

extern "C" int newton_level(const void* win, const void* pos0, const void* org,
                            const void* ref, const void* ref_valid,
                            const void* ref_mean, const void* ref_sumsq,
                            const void* active, const void* wmask,
                            const void* bounds, void* pos_out, void* status_out,
                            int F, int WH, int WW, float threshold,
                            int max_iters, void* stream) {
  if (F <= 0) return 0;
  if (WH < kS + 1 || WW < kS + 1 || WH > kWin || WW > kWin)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kLanes);
  dim3 grid((F + kLanes - 1) / kLanes);
  newton_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(pos0),
      static_cast<const float*>(org), static_cast<const float*>(ref),
      static_cast<const float*>(ref_valid), static_cast<const float*>(ref_mean),
      static_cast<const float*>(ref_sumsq), static_cast<const float*>(active),
      static_cast<const float*>(wmask), static_cast<const float*>(bounds),
      static_cast<float*>(pos_out), static_cast<float*>(status_out), F, WH, WW,
      threshold, max_iters);
  return static_cast<int>(cudaGetLastError());
}
