// The fused Newton level in its first form, and the stages it was bisected
// into: per lane, the gain/bias-normalized SSD of a 13x13 bilinear patch cut
// from the lane's window against a reference patch, its gradient, its
// Hessian, and six steps of gradient descent or exact Newton.
//
// Replaces (TPU kernels in tools/):
//   stages 0-3 (extract, grad, jvp, fori_grad): probe_newton_bisect.py run (:93)
//   stage 4 (newton, the skeleton):              probe_newton_kernel.py run (:107)
//
// The score, per lane, at window-local position p = (x, y):
//   P = R(y) W C(x), R/C the banded bilinear matrices at floor(p) with
//   weights (1-f, f) (taps outside the window read 0), m = mean(P),
//   q = mean(P^2), alpha = sqrt(mean(ref^2) / max(q, 1e-12)),
//   beta = mean(ref) - alpha m, s = sum(wmask (ref - alpha P - beta)^2),
// means over all 169 pixels. The probes differentiate s by autodiff; here
// the gradient and Hessian are written out (as for kernel B1, newton.cu):
// only the fractional parts carry a derivative, d2P/dx2 = d2P/dy2 = 0, and
// alpha, beta carry first and second derivatives through q and m. The
// Newton step is -H^-1 g with det replaced by 1e-20 where |det| <= 1e-20,
// rescaled to norm 1 when longer, then clipped to +-1. Unlike B1 there is
// no early exit, no convergence test, no bounds and no status: every lane
// runs every iteration.
//
// What bounds it on an H100: latency, as for B1. F=256 lanes move ~1.2 MB
// and an iteration is ~15k flops per lane; the critical path is the chain
// of dependent warp reductions inside one lane's iteration.
//
// Design: B1's. One warp per lane, four lanes per 128-thread block; the
// warp copies its window, reference and weights into shared memory once;
// each thread samples <= 6 of the 169 pixels by direct taps; two
// xor-shuffle reductions per evaluation (moments, then g and H) leave every
// thread with the same sums, so each computes the same step. The code is
// separate from newton.cu, whose kernel must stay bit-identical, so
// score_terms below repeats newton.cu's alpha/beta derivative algebra:
// change the two together. Both plain versions call ops/cuda/newton.py's
// score_terms, so tests/test_torch_cuda_kernels.py's
// test_newton_kernel_matches_plain_on_card and
// test_probe_newton_kernel_on_smooth_windows pin both kernels to it.
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using probe::warp_sum;

enum Stage { kExtract = 0, kGrad = 1, kJvp = 2, kForiGrad = 3, kNewton = 4 };

constexpr int kS = 13;
constexpr int kPix = kS * kS;
constexpr int kPer = (kPix + 31) / 32;  // pixels per thread
constexpr int kWin = 32;                // max window edge (smem row stride)
constexpr int kLanes = 4;               // lanes (warps) per block
constexpr float kEps = 1e-12f;
constexpr float kRate = 0.01f;          // fori_grad's step: p - 0.01 g

struct Terms {
  float s, gx, gy, hxx, hxy, hyy;
};

// The score and its exact derivatives at (x, y), summed over the warp.
__device__ Terms score_terms(const float* sw, const float* sref, const float* swm,
                             int WH, int WW, float x, float y, float r_mean,
                             float r_sumsq) {
  const int t = threadIdx.x;
  const float inv_n = 1.0f / static_cast<float>(kPix);
  const float x0f = floorf(x);
  const float y0f = floorf(y);
  const float fx = x - x0f;
  const float fy = y - y0f;
  const int x0 = static_cast<int>(x0f);
  const int y0 = static_cast<int>(y0f);
  auto tap = [&](int r, int c) {
    return (r >= 0 && r < WH && c >= 0 && c < WW) ? sw[r * kWin + c] : 0.0f;
  };

  float p2[kPer], u[kPer], v[kPer], puv[kPer];
  float s_m = 0.f, s_ss = 0.f, s_mx = 0.f, s_my = 0.f, s_mxy = 0.f;
  float s_px = 0.f, s_py = 0.f, s_uu = 0.f, s_vv = 0.f, s_uvp = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = t + 32 * k;
    p2[k] = u[k] = v[k] = puv[k] = 0.f;
    if (p < kPix) {
      const int i = p / kS, j = p % kS;
      const float a = tap(y0 + i, x0 + j), b = tap(y0 + i, x0 + j + 1);
      const float c = tap(y0 + i + 1, x0 + j), d = tap(y0 + i + 1, x0 + j + 1);
      // rows (R @ W) then columns (@ C), as the probes' two products
      const float t0 = (1.0f - fy) * a + fy * c;
      const float t1 = (1.0f - fy) * b + fy * d;
      const float s0 = c - a;
      const float s1 = d - b;
      p2[k] = (1.0f - fx) * t0 + fx * t1;
      u[k] = t1 - t0;
      v[k] = (1.0f - fx) * s0 + fx * s1;
      puv[k] = s1 - s0;
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
  const float m2 = warp_sum(s_m) * inv_n;
  const float ss2 = warp_sum(s_ss) * inv_n;
  const float m2x = warp_sum(s_mx) * inv_n;
  const float m2y = warp_sum(s_my) * inv_n;
  const float m2xy = warp_sum(s_mxy) * inv_n;
  const float gate = ss2 > kEps ? 1.0f : 0.0f;  // d max(q, eps)/dq
  const float ss2s = fmaxf(ss2, kEps);
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

  float s_s = 0.f, s_gx = 0.f, s_gy = 0.f, s_hxx = 0.f, s_hyy = 0.f, s_hxy = 0.f;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int p = t + 32 * k;
    if (p < kPix) {
      const float w = swm[p];
      const float e = sref[p] - alpha * p2[k] - beta;
      const float ex = -ax * p2[k] - alpha * u[k] - bx;
      const float ey = -ay * p2[k] - alpha * v[k] - by;
      const float exx = -axx * p2[k] - 2.0f * ax * u[k] - bxx;
      const float eyy = -ayy * p2[k] - 2.0f * ay * v[k] - byy;
      const float exy = -axy * p2[k] - ax * v[k] - ay * u[k] - alpha * puv[k] - bxy;
      s_s += w * e * e;
      s_gx += w * e * ex;
      s_gy += w * e * ey;
      s_hxx += w * (ex * ex + e * exx);
      s_hyy += w * (ey * ey + e * eyy);
      s_hxy += w * (ex * ey + e * exy);
    }
  }
  Terms r;
  r.s = warp_sum(s_s);
  r.gx = 2.0f * warp_sum(s_gx);
  r.gy = 2.0f * warp_sum(s_gy);
  r.hxx = 2.0f * warp_sum(s_hxx);
  r.hyy = 2.0f * warp_sum(s_hyy);
  r.hxy = 2.0f * warp_sum(s_hxy);
  return r;
}

__global__ void probe_newton_kernel(const float* __restrict__ win,
                                    const float* __restrict__ pos,
                                    const float* __restrict__ ref,
                                    const float* __restrict__ wmask,
                                    float* __restrict__ out, int F, int WH, int WW,
                                    int stage, int iters) {
  __shared__ float s_win[kLanes][kWin * kWin];
  __shared__ float s_ref[kLanes][kPix];
  __shared__ float s_w[kLanes][kPix];

  const int t = threadIdx.x;
  const int wl = threadIdx.y;
  const int f = blockIdx.x * kLanes + wl;
  if (f >= F) return;  // whole warp leaves together

  const float* wf = win + static_cast<size_t>(f) * WH * WW;
  for (int e = t; e < WH * WW; e += 32) s_win[wl][(e / WW) * kWin + e % WW] = wf[e];
  float r_s = 0.f, r_ss = 0.f;
  for (int e = t; e < kPix; e += 32) {
    const float r = ref[static_cast<size_t>(f) * kPix + e];
    s_ref[wl][e] = r;
    s_w[wl][e] = wmask[e];
    r_s += r;
    r_ss += r * r;
  }
  __syncwarp();
  const float inv_n = 1.0f / static_cast<float>(kPix);
  const float r_mean = warp_sum(r_s) * inv_n;
  const float r_sumsq = warp_sum(r_ss) * inv_n;

  float x = pos[2 * f];
  float y = pos[2 * f + 1];
  float o0, o1;
  if (stage == kExtract || stage == kGrad || stage == kJvp) {
    const Terms d = score_terms(s_win[wl], s_ref[wl], s_w[wl], WH, WW, x, y, r_mean,
                                r_sumsq);
    o0 = stage == kExtract ? d.s : (stage == kGrad ? d.gx : d.hxx);
    o1 = stage == kExtract ? d.s : (stage == kGrad ? d.gy : d.hxy);
  } else {
    for (int it = 0; it < iters; ++it) {
      const Terms d = score_terms(s_win[wl], s_ref[wl], s_w[wl], WH, WW, x, y,
                                  r_mean, r_sumsq);
      if (stage == kForiGrad) {
        x = x - kRate * d.gx;
        y = y - kRate * d.gy;
        continue;
      }
      const float det = d.hxx * d.hyy - d.hxy * d.hxy;
      const float safe = fabsf(det) > 1e-20f ? det : 1e-20f;
      float dx = -(d.hyy * d.gx - d.hxy * d.gy) / safe;
      float dy = -(-d.hxy * d.gx + d.hxx * d.gy) / safe;
      const float n = sqrtf(dx * dx + dy * dy);
      if (n > 1.0f) {
        dx = dx / fmaxf(n, 1e-20f);
        dy = dy / fmaxf(n, 1e-20f);
      }
      x = x + fminf(fmaxf(dx, -1.0f), 1.0f);
      y = y + fminf(fmaxf(dy, -1.0f), 1.0f);
    }
    o0 = x;
    o1 = y;
  }
  if (t == 0) {
    out[2 * f] = o0;
    out[2 * f + 1] = o1;
  }
}

}  // namespace

extern "C" int probe_newton(const void* win, const void* pos, const void* ref,
                            const void* wmask, void* out, int F, int WH, int WW,
                            int stage, int iters, void* stream) {
  if (F <= 0) return 0;
  if (WH <= 0 || WW <= 0 || WH > kWin || WW > kWin || stage < kExtract ||
      stage > kNewton || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  dim3 block(32, kLanes);
  dim3 grid((F + kLanes - 1) / kLanes);
  probe_newton_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(win), static_cast<const float*>(pos),
      static_cast<const float*>(ref), static_cast<const float*>(wmask),
      static_cast<float*>(out), F, WH, WW, stage, iters);
  return static_cast<int>(cudaGetLastError());
}
