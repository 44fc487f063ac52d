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
// and an evaluation is ~15k flops per lane; the critical path is one lane's
// copy-in, then per evaluation two reductions of its 169 pixels and the
// scalar algebra between them.
//
// Design: B1's (newton.cu), which this kernel's first form predated (one
// warp a lane, four lanes a 128-thread block):
// - One lane per block, so F=256 puts 256 blocks on the 132 SMs (four
//   lanes a block left more than half of them idle). kWarps = 2 warps
//   share the lane's 169 pixels: on an H100 at F=256, by graph replay in
//   turns (this file built at each width), 2 warps took 0.00217 /
//   0.00245 / 0.00255 / 0.00473 / 0.00651 ms (extract / grad / jvp /
//   fori_grad / newton), 4 warps 0.00226 / 0.00254 / 0.00272 / 0.00521 /
//   0.00735 and 1 warp 0.00246 / 0.00265 / 0.00287 / 0.00542 / 0.00750,
//   against this kernel's first form's 0.00457 / 0.00475 / 0.00476 /
//   0.01069 / 0.01142 (PERF.md's kernel table, T14 and T15;
//   tests/torch_probe_newton_turns.py).
// - Every copy in flight at once: the window by cp.async, 16 bytes a copy
//   where the window's base and its row length WW allow it (the C entry
//   point picks the route), else 4 bytes, in rows of kRow floats; each
//   thread starts its copies at a row and a column it computes once, with
//   no division per element. A thread keeps the same pixels for the whole
//   call, so its reference values and weights go straight from device
//   memory to registers, loaded before the one wait on the window.
// - Reductions by a transposing butterfly (B1's): each xor step halves the
//   values a thread carries, so the 12 moments (the patch's 10 and the
//   reference's two sums, folded into the first reduction) take 16
//   shuffles and Newton's 5 score sums 9, in 5 dependent rounds. The warps'
//   partial sums meet in shared memory and every thread adds them in the
//   same order: all threads hold the same sums and take the same step, and
//   a call is bitwise repeatable.
// - The stage is a template parameter. Extract reduces 4 moments and the
//   score; grad and fori_grad 8 and the gradient; jvp 12 and the Hessian's
//   first column; only newton forms all of g and H. Extract, grad and jvp
//   make one evaluation, fori_grad and newton `iters`.
// - Taps by clamp-and-mask: the patch origin is clamped to [-kS-2, kWin]
//   (the taps of a farther origin all lie outside the window, as those of
//   the clamped one do), and a tap reads shared memory only where its row
//   and column are inside the window (two unsigned compares a pixel per
//   axis), else 0. kRow = 44 floats keeps rows 16-byte aligned and puts a
//   warp's pixels at most two to a bank (32 puts three).
// - Not TMA: a window is 4 KB at most, and the tensor form faulted at a
//   box off 16 bytes on the H100 tested (ROADMAP B, item 4).
// The code is separate from newton.cu, whose kernel must stay
// bit-identical, so the algebra below repeats newton.cu's alpha/beta
// derivative algebra: change the two together. Both plain versions call
// ops/cuda/newton.py's score_terms, so tests/test_torch_cuda_kernels.py's
// test_newton_kernel_matches_plain_on_card and the probe_newton tests
// there pin both kernels to it.
#include <cstdint>

#include <cuda_runtime.h>

namespace {

enum Stage { kExtract = 0, kGrad = 1, kJvp = 2, kForiGrad = 3, kNewton = 4 };

constexpr int kS = 13;
constexpr int kPix = kS * kS;
constexpr int kWin = 32;   // max window edge
constexpr int kRow = 44;   // shared row stride (floats)
constexpr int kWarps = 2;
constexpr int kThreads = 32 * kWarps;
constexpr int kPer = (kPix + kThreads - 1) / kThreads;  // pixels per thread
constexpr int kOff = 1 << 20;  // row of a thread's unused pixel slot: off the window
constexpr float kEps = 1e-12f;
constexpr float kRate = 0.01f;  // fori_grad's step: p - 0.01 g

// What a stage reduces: the moments (the reference's sum and sum of squares,
// the patch's m and q; with first derivatives m_x, m_y, q_x, q_y; with
// second derivatives m_xy, q_xx, q_yy, q_xy) and the score sums, each padded
// to the butterfly's power of two.
template <int St>
struct Plan {
  static constexpr bool kD1 = St != kExtract;
  static constexpr bool kD2 = St == kJvp || St == kNewton;
  static constexpr int kMoments = kD2 ? 16 : (kD1 ? 8 : 4);
  static constexpr int kSums = St == kNewton ? 8 : (St == kExtract ? 1 : 2);
  static constexpr bool kLoop = St == kForiGrad || St == kNewton;
};

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Transposing butterfly over the warp (newton.cu's): v[0..N-1] are this
// thread's partial sums; on return v[0] is the warp's total of value
// lane / (32 / N).
template <int N>
__device__ __forceinline__ void butterfly(float* v, int lane, int o = 16) {
  if constexpr (N > 1) {
    const bool upper = (lane & o) != 0;
#pragma unroll
    for (int j = 0; j < N / 2; ++j) {
      const float send = upper ? v[j] : v[j + N / 2];
      const float keep = upper ? v[j + N / 2] : v[j];
      v[j] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
    butterfly<N / 2>(v, lane, o >> 1);
  } else {
#pragma unroll
    for (; o > 0; o >>= 1) v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
  }
}

// The block's totals of v[0..N-1] (each thread's partial sums) into
// tot[0..M-1]: the butterfly in each warp, the warps' results through
// `red`, added in warp order by every thread.
template <int N, int M>
__device__ __forceinline__ void block_sum(float* v, float (*red)[N], float* tot, int lane,
                                          int warp) {
  butterfly<N>(v, lane);
  constexpr int kStep = 32 / N;
  if ((lane & (kStep - 1)) == 0) red[warp][lane / kStep] = v[0];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < M; ++j) {
    tot[j] = red[0][j];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) tot[j] += red[w][j];
  }
}

template <int St>
__global__ void __launch_bounds__(kThreads)
    probe_newton_kernel(const float* __restrict__ win, const float* __restrict__ pos,
                        const float* __restrict__ ref, const float* __restrict__ wmask,
                        float* __restrict__ out, int WH, int WW, int iters, int vec16) {
  using P = Plan<St>;
  __shared__ __align__(16) float s_win[kWin * kRow];
  __shared__ float s_mom[kWarps][P::kMoments];
  __shared__ float s_sum[kWarps][P::kSums];

  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;

  // the window: every copy issued before any wait
  {
    const float* src = win + static_cast<size_t>(f) * WH * WW;
    const int unit = vec16 ? 4 : 1;  // floats a copy
    const int per_row = WW / unit;
    const int rows = kThreads / per_row;  // rows a pass of the block
    const int r0 = t / per_row;
    const int c = (t - r0 * per_row) * unit;
    if (r0 < rows) {
      for (int r = r0; r < WH; r += rows) {
        if (vec16) {
          cp_async16(s_win + r * kRow + c, src + r * WW + c);
        } else {
          cp_async4(s_win + r * kRow + c, src + r * WW + c);
        }
      }
    }
  }
  // this thread's pixels: offsets, reference values and weights
  int pi[kPer], pj[kPer];
  float rv[kPer], wm[kPer];
  const float* rf = ref + static_cast<size_t>(f) * kPix;
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = t + kThreads * k;
    const bool on = q < kPix;
    pi[k] = on ? q / kS : kOff;
    pj[k] = on ? q % kS : 0;
    rv[k] = on ? __ldg(rf + q) : 0.0f;
    wm[k] = on ? __ldg(wmask + q) : 0.0f;
  }
  float x = pos[2 * f];
  float y = pos[2 * f + 1];
  cp_async_wait_all();
  __syncthreads();

  const float inv_n = 1.0f / static_cast<float>(kPix);
  const int evals = P::kLoop ? iters : 1;
  float o0 = 0.0f, o1 = 0.0f;
  for (int it = 0; it < evals; ++it) {
    const float x0f = floorf(x);
    const float y0f = floorf(y);
    const float fx = x - x0f;
    const float fy = y - y0f;
    const int x0 = static_cast<int>(fminf(fmaxf(x0f, -(kS + 2.0f)), float(kWin)));
    const int y0 = static_cast<int>(fminf(fmaxf(y0f, -(kS + 2.0f)), float(kWin)));

    float m[P::kMoments];
#pragma unroll
    for (int j = 0; j < P::kMoments; ++j) m[j] = 0.0f;
    float p2[kPer], u[kPer], v[kPer], puv[kPer];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int r = y0 + pi[k];
      const int c = x0 + pj[k];
      const bool r0in = static_cast<unsigned>(r) < static_cast<unsigned>(WH);
      const bool r1in = static_cast<unsigned>(r + 1) < static_cast<unsigned>(WH);
      const bool c0in = static_cast<unsigned>(c) < static_cast<unsigned>(WW);
      const bool c1in = static_cast<unsigned>(c + 1) < static_cast<unsigned>(WW);
      const float* rowp = s_win + r * kRow + c;
      const float a = (r0in && c0in) ? rowp[0] : 0.0f;
      const float b = (r0in && c1in) ? rowp[1] : 0.0f;
      const float cc = (r1in && c0in) ? rowp[kRow] : 0.0f;
      const float d = (r1in && c1in) ? rowp[kRow + 1] : 0.0f;
      // rows (R @ W) then columns (@ C), as the probes' two products
      const float t0 = (1.0f - fy) * a + fy * cc;
      const float t1 = (1.0f - fy) * b + fy * d;
      const float s0 = cc - a;
      const float s1 = d - b;
      p2[k] = (1.0f - fx) * t0 + fx * t1;
      u[k] = t1 - t0;
      v[k] = (1.0f - fx) * s0 + fx * s1;
      puv[k] = s1 - s0;
      m[0] += rv[k];
      m[1] += rv[k] * rv[k];
      m[2] += p2[k];
      m[3] += p2[k] * p2[k];
      if constexpr (P::kD1) {
        m[4] += u[k];
        m[5] += v[k];
        m[6] += p2[k] * u[k];
        m[7] += p2[k] * v[k];
      }
      if constexpr (P::kD2) {
        m[8] += puv[k];
        m[9] += u[k] * u[k];
        m[10] += v[k] * v[k];
        m[11] += u[k] * v[k] + p2[k] * puv[k];
      }
    }
    // reduction 1: the reference's means and the patch's moments
    float r1[P::kD2 ? 12 : P::kMoments];
    block_sum<P::kMoments, (P::kD2 ? 12 : P::kMoments)>(m, s_mom, r1, lane, warp);
    const float r_mean = r1[0] * inv_n;
    const float r_sumsq = r1[1] * inv_n;
    const float m2 = r1[2] * inv_n;
    const float ss2 = r1[3] * inv_n;
    const float gate = ss2 > kEps ? 1.0f : 0.0f;  // d max(q, eps)/dq
    const float ss2s = fmaxf(ss2, kEps);
    const float alpha = sqrtf(r_sumsq / ss2s);
    const float beta = r_mean - alpha * m2;

    // alpha's and beta's derivatives, as far as the stage needs them
    float m2x = 0.0f, m2y = 0.0f, rx = 0.0f, ry = 0.0f;
    float ax = 0.0f, ay = 0.0f, bx = 0.0f, by = 0.0f;
    float axx = 0.0f, axy = 0.0f, ayy = 0.0f, bxx = 0.0f, bxy = 0.0f, byy = 0.0f;
    if constexpr (P::kD1) {
      m2x = r1[4] * inv_n;
      m2y = r1[5] * inv_n;
      rx = 2.0f * (r1[6] * inv_n) * gate / ss2s;
      ry = 2.0f * (r1[7] * inv_n) * gate / ss2s;
      ax = -0.5f * alpha * rx;
      ay = -0.5f * alpha * ry;
      bx = -ax * m2 - alpha * m2x;
      by = -ay * m2 - alpha * m2y;
    }
    if constexpr (P::kD2) {
      const float m2xy = r1[8] * inv_n;
      const float ss2xx = 2.0f * (r1[9] * inv_n) * gate;
      const float ss2yy = 2.0f * (r1[10] * inv_n) * gate;
      const float ss2xy = 2.0f * (r1[11] * inv_n) * gate;
      axx = -0.5f * (ax * rx + alpha * (ss2xx / ss2s - rx * rx));
      axy = -0.5f * (ay * rx + alpha * (ss2xy / ss2s - rx * ry));
      bxx = -axx * m2 - 2.0f * ax * m2x;
      bxy = -axy * m2 - ax * m2y - ay * m2x - alpha * m2xy;
      ayy = -0.5f * (ay * ry + alpha * (ss2yy / ss2s - ry * ry));
      byy = -ayy * m2 - 2.0f * ay * m2y;
    }

    // the second pass: the score (extract), the gradient's sums (grad,
    // fori_grad, newton) and the Hessian's (jvp: xx, xy; newton: xx, yy, xy)
    constexpr int kXX = St == kNewton ? 2 : 0;
    constexpr int kXY = St == kNewton ? 4 : 1;
    float sums[P::kSums];
#pragma unroll
    for (int j = 0; j < P::kSums; ++j) sums[j] = 0.0f;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const float e = rv[k] - alpha * p2[k] - beta;
      if constexpr (!P::kD1) {
        sums[0] += wm[k] * e * e;
      } else {
        const float ex = -ax * p2[k] - alpha * u[k] - bx;
        const float ey = -ay * p2[k] - alpha * v[k] - by;
        float exx = 0.0f, eyy = 0.0f, exy = 0.0f;
        if constexpr (P::kD2) {
          exx = -axx * p2[k] - 2.0f * ax * u[k] - bxx;
          if constexpr (St == kNewton) eyy = -ayy * p2[k] - 2.0f * ay * v[k] - byy;
          exy = -axy * p2[k] - ax * v[k] - ay * u[k] - alpha * puv[k] - bxy;
        }
        if constexpr (St != kJvp) {
          sums[0] += wm[k] * e * ex;
          sums[1] += wm[k] * e * ey;
        }
        if constexpr (P::kD2) sums[kXX] += wm[k] * (ex * ex + e * exx);
        if constexpr (St == kNewton) sums[3] += wm[k] * (ey * ey + e * eyy);
        if constexpr (P::kD2) sums[kXY] += wm[k] * (ex * ey + e * exy);
      }
    }
    // reduction 2: the score, or its gradient and Hessian terms
    constexpr int kUsed = St == kNewton ? 5 : P::kSums;
    float r2[kUsed];
    block_sum<P::kSums, kUsed>(sums, s_sum, r2, lane, warp);
    if constexpr (St == kExtract) {
      o0 = o1 = r2[0];
    } else if constexpr (St == kGrad || St == kJvp) {
      o0 = 2.0f * r2[0];
      o1 = 2.0f * r2[1];
    } else if constexpr (St == kForiGrad) {
      x = x - kRate * (2.0f * r2[0]);
      y = y - kRate * (2.0f * r2[1]);
    } else {
      const float gx = 2.0f * r2[0], gy = 2.0f * r2[1];
      const float hxx = 2.0f * r2[2], hyy = 2.0f * r2[3], hxy = 2.0f * r2[4];
      const float det = hxx * hyy - hxy * hxy;
      const float safe = fabsf(det) > 1e-20f ? det : 1e-20f;
      float dx = -(hyy * gx - hxy * gy) / safe;
      float dy = -(-hxy * gx + hxx * gy) / safe;
      const float n = sqrtf(dx * dx + dy * dy);
      if (n > 1.0f) {
        dx = dx / fmaxf(n, 1e-20f);
        dy = dy / fmaxf(n, 1e-20f);
      }
      x = x + fminf(fmaxf(dx, -1.0f), 1.0f);
      y = y + fminf(fmaxf(dy, -1.0f), 1.0f);
    }
  }
  if constexpr (P::kLoop) {
    o0 = x;
    o1 = y;
  }
  if (t == 0) {
    out[2 * f] = o0;
    out[2 * f + 1] = o1;
  }
}

// 16-byte copies where every row of every lane starts on 16 bytes
bool copies_16(const void* win, int WW) {
  return reinterpret_cast<std::uintptr_t>(win) % 16 == 0 && WW % 4 == 0;
}

template <int St>
void launch(const void* win, const void* pos, const void* ref, const void* wmask, void* out,
            int F, int WH, int WW, int iters, cudaStream_t stream) {
  probe_newton_kernel<St><<<F, kThreads, 0, stream>>>(
      static_cast<const float*>(win), static_cast<const float*>(pos),
      static_cast<const float*>(ref), static_cast<const float*>(wmask),
      static_cast<float*>(out), WH, WW, iters, copies_16(win, WW) ? 1 : 0);
}

}  // namespace

extern "C" int probe_newton(const void* win, const void* pos, const void* ref,
                            const void* wmask, void* out, int F, int WH, int WW,
                            int stage, int iters, void* stream) {
  if (F <= 0) return 0;
  if (WH <= 0 || WW <= 0 || WH > kWin || WW > kWin || stage < kExtract ||
      stage > kNewton || iters < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case kExtract: launch<kExtract>(win, pos, ref, wmask, out, F, WH, WW, iters, s); break;
    case kGrad: launch<kGrad>(win, pos, ref, wmask, out, F, WH, WW, iters, s); break;
    case kJvp: launch<kJvp>(win, pos, ref, wmask, out, F, WH, WW, iters, s); break;
    case kForiGrad: launch<kForiGrad>(win, pos, ref, wmask, out, F, WH, WW, iters, s); break;
    default: launch<kNewton>(win, pos, ref, wmask, out, F, WH, WW, iters, s); break;
  }
  return static_cast<int>(cudaGetLastError());
}
