// Coarse-to-fine Newton patch tracker: every pyramid level of one tracking
// direction, for F feature lanes, in one launch.
//
// Replaces: slam_robot_tpu/ops/pallas/newton.py, _kernel (launched by
// newton_level; math in _newton_iter and newton_window_steps), together
// with the level loop around it in slam_robot_tpu/ops/tracker_fused.py,
// track_feature_batch (:198-360), and the backward reference stack that
// track_bidirectional_batch samples from the forward windows
// (_sample_from_windows, :138, :592).
//
// Per lane: pos = pts / 2^(lvls-1); for each level i from L-1 down to 0:
// lvl_on = i <= lvls-1, take = lvl_on & status == 0 & active; cut (or read)
// the level's search window; if take, run up to iters[i] Newton steps (margin
// test; bilinear resample of the 13x13 patch and its d/dx, d/dy, d2/dxdy
// from the window, support origin clamped to [0, W-(S+1)], validity from the
// raw support; gain/offset-normalized SSD against the reference with radial
// weights, its closed-form gradient and 2x2 Hessian; the 2x2 solve with the
// 1e-20 det guard and 1e20 finite guard; unit-norm cap then +-1 clip;
// convergence when both |d| < threshold; a final out-of-bounds test sets
// status 2) and take its position and status; then pos *= 2 where lvl_on
// and i > 0. ok = status == 0 & active. With a stack output, an epilogue
// samples the packed backward reference stack [F, L, 2*S*S+2] at
// pos / 2^lv from the lane's own level windows (bilinear mix, image-and-
// window validity, mean, sumsq).
//
// Window sources: (a) pyramid planes [P, Hp, Wp] with per-lane plane index
// base + level; the kernel computes the window origin as the tracker's
// _gather_windows does (nan_to_num and +-1e6 clamp, floor - 12 + PAD,
// clamped inside the level's padded extent). (b) explicit windows with
// per-level origins and strides: the matcher's window cache [F, L, 32, 32]
// and newton_level's [F, WH, WW] (one level). References are read in place
// through per-field lane and level strides: the packed [F, L, 2*S*S+2]
// stack, or newton_level's separate tensors.
//
// What bounds it on an H100: latency. A lane's data is a few KB and an
// iteration ~15 kflop, so F=256 lanes over six levels are ~2 MB and a few
// MFLOP, far from either roofline; the critical path is one lane's chain of
// dependent window copies, reductions and 2x2 solves.
//
// Design, chosen for that:
// - One lane per block, so F=256 puts 256 blocks on the 132 SMs (four
//   lanes per block left more than half of them empty). kWarps = 4 warps
//   work on the lane's 169 patch pixels: at F=256 on an H100, 4 warps took
//   0.0399 / 0.0317 ms (forward / backward, graph replay), 2 warps 0.0419 /
//   0.0311 and 1 warp 0.0621 / 0.0421 (PERF.md, B1).
// - The whole cascade and the epilogue run in one launch: the per-level
//   host work (window gathers, reference unpacking and copies, merges) is
//   gone, and the level's windows stay in shared memory for the epilogue.
// - Asynchronous copies (cp.async) into shared memory, not TMA. Windows of
//   source (a) start at any column, so they are copied 4 bytes at a time;
//   TMA would need a tensor map per pyramid and a 16-byte-multiple row
//   pitch, and a 32x32 box is too small for it to pay. References and the
//   windows of source (b) use 16-byte copies when their addresses and
//   strides allow, else 4-byte ones. In source (b) every level's origin is
//   known at entry: all windows and references are started at once, one
//   commit group per level, and level i waits only for its own group, so
//   the coarse levels compute while the fine windows arrive. In source (a)
//   a level's origin depends on the level above it, so only the references
//   are prefetched.
// - Reductions by a transposing butterfly: each xor step halves the values
//   a thread carries, so the 10 patch moments take 16 shuffles and the 5
//   gradient and Hessian sums 9 (the one-sum-per-value warp_sum took 50 and
//   25), in the same 5 dependent rounds. The warps' partial sums meet in
//   shared memory and every thread adds them in the same order, so all
//   threads hold the same sums and take the same branches.
// - The host passes the level dims, iteration counts and bounds in the
//   parameter block (TrackParams, by value): no per-call device copy.
#include <cuda_runtime.h>

namespace {

constexpr int kS = 13;
constexpr int kHalf = (kS - 1) / 2;
constexpr int kPix = kS * kS;
constexpr int kPack = 2 * kPix + 2;   // data | valid | mean | sumsq
constexpr int kWin = 32;              // max window edge (smem row stride)
constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;             // warps per lane (one lane per block)
constexpr int kThreads = 32 * kWarps;
constexpr int kMarginPx = 12;         // window margin (tracker_fused.MARGIN_PX)
constexpr int kPad = 8;               // pyramid edge padding (pyramid.PAD)
constexpr float kMargin = 0.01f;      // hessian.h:196

}  // namespace

// Mirrored field for field by ops/cuda/newton.py (TrackParams, ctypes).
struct TrackParams {
  const float* planes;       // (a) [P, Hp, Wp] or null
  const long long* plane_off;  // (a) [F] plane base per lane, or null
  const float* win;          // (b) explicit windows, or null
  const float* win_org;      // (b) window origins (x, y) per lane and level
  const float* ref[4];       // reference data, valid, mean, sumsq
  const float* pts;          // [F, 2] start at level 0 (lvls-1 scaled in)
  const int* lvls;           // [F] or null (then lvls_const)
  const void* active;        // null (all), bool [F] or float [F]
  const float* wmask;        // [S, S]
  const float* bounds;       // [F, 2] (width, height), or null: level dims
  float* pos_out;            // [F, 2]
  float* status_out;         // [F] or null
  unsigned char* ok_out;     // [F] bool or null
  float* stack_out;          // [F, L, kPack] or null: the epilogue
  float* org_out;            // [F, L, 2] or null: window origins used
  long long plane_base;
  long long win_lane, win_level, org_lane;
  long long ref_lane[4];
  int ref_level[4];
  int Hp, Wp, win_row, org_level;
  int lvls_const, active_kind, ref_vec16, win_vec16;
  int F, L;
  int h[kMaxLevels], w[kMaxLevels];    // level dims
  int wh[kMaxLevels], ww[kMaxLevels];  // window dims per level
  int iters[kMaxLevels];               // Newton budget per level
  float threshold;
};

namespace {

constexpr int kActiveAll = 0, kActiveBool = 1, kActiveFloat = 2;

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's commit groups are still in flight.
__device__ __forceinline__ void cp_async_wait(int n) {
  switch (n) {
    case 0: asm volatile("cp.async.wait_group 0;\n" ::: "memory"); break;
    case 1: asm volatile("cp.async.wait_group 1;\n" ::: "memory"); break;
    case 2: asm volatile("cp.async.wait_group 2;\n" ::: "memory"); break;
    case 3: asm volatile("cp.async.wait_group 3;\n" ::: "memory"); break;
    case 4: asm volatile("cp.async.wait_group 4;\n" ::: "memory"); break;
    case 5: asm volatile("cp.async.wait_group 5;\n" ::: "memory"); break;
    case 6: asm volatile("cp.async.wait_group 6;\n" ::: "memory"); break;
    default: asm volatile("cp.async.wait_group 7;\n" ::: "memory"); break;
  }
}

// Transposing butterfly over the warp: v[0..N-1] (N a power of two <= 32)
// are this thread's partial sums. Each xor step sends the half of the
// values that the partner keeps, so after log2(N) steps a thread carries
// one value; the remaining steps are plain xor sums. On return v[0] is the
// warp's total of value lane / (32 / N): the upper half of the values goes
// to the lanes whose bit o is set, at each step o = 16, 8, ...
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

__device__ __forceinline__ float clean(float v) {
  return isnan(v) ? 0.0f : fminf(fmaxf(v, -1e6f), 1e6f);
}

__device__ __forceinline__ bool out_of_bounds(float x, float y, float width, float height) {
  return (x < kMargin) || (y < kMargin) || (x + kMargin > width) || (y + kMargin > height);
}

// Copy n floats (16-byte copies when vec16) into shared memory.
__device__ __forceinline__ void copy_async(float* dst, const float* src, int n, bool vec16,
                                           int t, int nt) {
  if (vec16) {
    for (int e = 4 * t; e < n; e += 4 * nt) cp_async16(dst + e, src + e);
  } else {
    for (int e = t; e < n; e += nt) cp_async4(dst + e, src + e);
  }
}

__global__ void __launch_bounds__(kThreads) track_kernel(const __grid_constant__ TrackParams p) {
  constexpr int kPer = (kPix + kThreads - 1) / kThreads;  // pixels per thread
  extern __shared__ __align__(16) float smem[];
  float* s_win = smem;                              // [L][kWin * kWin]
  float* s_ref = smem + p.L * kWin * kWin;          // [L][kPack]
  __shared__ float s_org[kMaxLevels][2];
  __shared__ float s_red1[kWarps][16];
  __shared__ float s_red2[kWarps][8];

  const int f = blockIdx.x;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const int L = p.L;

  const int nlv = p.lvls ? p.lvls[f] : p.lvls_const;
  bool act = true;
  if (p.active_kind == kActiveBool) {
    act = static_cast<const unsigned char*>(p.active)[f] != 0;
  } else if (p.active_kind == kActiveFloat) {
    act = (1.0f - static_cast<const float*>(p.active)[f]) < 0.5f;
  }
  const bool keep_all = p.stack_out != nullptr || p.org_out != nullptr;

  // references of every level: one commit group
  for (int i = 0; i < L; ++i) {
    float* dst = s_ref + i * kPack;
    if (p.ref_vec16) {  // the packed stack: one contiguous row per level
      copy_async(dst, p.ref[0] + f * p.ref_lane[0] + i * p.ref_level[0], kPack, true, t,
                 kThreads);
    } else {
      copy_async(dst, p.ref[0] + f * p.ref_lane[0] + i * p.ref_level[0], kPix, false, t,
                 kThreads);
      copy_async(dst + kPix, p.ref[1] + f * p.ref_lane[1] + i * p.ref_level[1], kPix, false,
                 t, kThreads);
      if (t == 0) {
        cp_async4(dst + 2 * kPix, p.ref[2] + f * p.ref_lane[2] + i * p.ref_level[2]);
        cp_async4(dst + 2 * kPix + 1, p.ref[3] + f * p.ref_lane[3] + i * p.ref_level[3]);
      }
    }
  }
  cp_async_commit();
  // source (b): every level's window now, one group per level, coarse first
  if (p.win != nullptr) {
    for (int i = L - 1; i >= 0; --i) {
      if (keep_all || (act && i <= nlv - 1)) {
        const float* src = p.win + f * p.win_lane + i * p.win_level;
        float* dst = s_win + i * kWin * kWin;
        const int rows = p.wh[i];
        if (p.win_vec16) {
          const int vec = (p.ww[i] + 3) / 4;  // 16-byte copies per row
          for (int e = t; e < rows * vec; e += kThreads) {
            const int r = e / vec, c = 4 * (e % vec);
            cp_async16(dst + r * kWin + c, src + r * p.win_row + c);
          }
        } else {
          const int cols = p.ww[i];
          for (int e = t; e < rows * cols; e += kThreads) {
            const int r = e / cols, c = e % cols;
            cp_async4(dst + r * kWin + c, src + r * p.win_row + c);
          }
        }
      }
      cp_async_commit();
    }
  }

  // this thread's patch pixels: coordinates and radial weights
  int pi[kPer], pj[kPer];
  float wm[kPer];
#pragma unroll
  for (int k = 0; k < kPer; ++k) {
    const int q = t + kThreads * k;
    pi[k] = q < kPix ? q / kS : 0;
    pj[k] = q < kPix ? q % kS : 0;
    wm[k] = q < kPix ? p.wmask[q] : 0.0f;
  }

  const float inv0 = ldexpf(1.0f, -(nlv - 1));
  float x = p.pts[2 * f] * inv0;
  float y = p.pts[2 * f + 1] * inv0;
  float status = 0.0f;
  const float eps = 1e-12f;
  const float inv_n = 1.0f / static_cast<float>(kPix);

  for (int k = 0; k < L; ++k) {
    const int i = L - 1 - k;
    const bool lvl_on = i <= nlv - 1;
    const bool take = lvl_on && status == 0.0f && act;
    const int WH = p.wh[i], WW = p.ww[i];
    float* win = s_win + i * kWin * kWin;
    if (p.win != nullptr) {
      if (t == 0) {
        s_org[i][0] = p.win_org[f * p.org_lane + i * p.org_level];
        s_org[i][1] = p.win_org[f * p.org_lane + i * p.org_level + 1];
      }
      cp_async_wait(i);  // the groups of levels i-1 .. 0 may still fly
    } else {
      // _gather_windows: origin inside the level's padded extent
      const int hp = p.h[i] + 2 * kPad, wp = p.w[i] + 2 * kPad;
      const int ox = min(max(static_cast<int>(floorf(clean(x))) - kMarginPx + kPad, 0), wp - WW);
      const int oy = min(max(static_cast<int>(floorf(clean(y))) - kMarginPx + kPad, 0), hp - WH);
      if (t == 0) {
        s_org[i][0] = static_cast<float>(ox - kPad);
        s_org[i][1] = static_cast<float>(oy - kPad);
      }
      if (take || keep_all) {
        const long long plane = (p.plane_off ? p.plane_off[f] : p.plane_base) + i;
        const float* src = p.planes + (plane * p.Hp + oy) * p.Wp + ox;
        for (int e = t; e < WH * WW; e += kThreads) {
          const int r = e / WW, c = e % WW;
          cp_async4(win + r * kWin + c, src + r * p.Wp + c);
        }
      }
      cp_async_commit();
      cp_async_wait(0);
    }
    __syncthreads();
    const float orgx = s_org[i][0], orgy = s_org[i][1];
    if (p.org_out != nullptr && t == 0) {
      p.org_out[(f * L + i) * 2] = orgx;
      p.org_out[(f * L + i) * 2 + 1] = orgy;
    }

    if (take) {
      const float* ref = s_ref + i * kPack;
      const float width = p.bounds ? p.bounds[2 * f] : static_cast<float>(p.w[i]);
      const float height = p.bounds ? p.bounds[2 * f + 1] : static_cast<float>(p.h[i]);
      const int iorgx = static_cast<int>(orgx);
      const int iorgy = static_cast<int>(orgy);
      const float r_mean = ref[2 * kPix];
      const float r_sumsq = ref[2 * kPix + 1];
      float rv[kPer], wrv[kPer];
#pragma unroll
      for (int kk = 0; kk < kPer; ++kk) {
        const int q = t + kThreads * kk;
        rv[kk] = q < kPix ? ref[q] : 0.0f;
        wrv[kk] = q < kPix ? wm[kk] * ref[kPix + q] : 0.0f;
      }
      float p2[kPer], u[kPer], v[kPer], puv[kPer], w2[kPer];
      bool done = false;
      for (int it = 0; it < p.iters[i] && !done; ++it) {
        const bool oob = out_of_bounds(x, y, width, height);
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

        float m1[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) m1[j] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kPer; ++kk) {
          const int q = t + kThreads * kk;
          p2[kk] = u[kk] = v[kk] = puv[kk] = w2[kk] = 0.0f;
          if (q < kPix) {
            const float* rowp = win + (y0c + pi[kk]) * kWin + x0c + pj[kk];
            const float a = rowp[0], b = rowp[1], c = rowp[kWin], d = rowp[kWin + 1];
            const float t0 = (1.0f - fy) * a + fy * c;
            const float t1 = (1.0f - fy) * b + fy * d;
            const float s0 = c - a;
            const float s1 = d - b;
            p2[kk] = (1.0f - fx) * t0 + fx * t1;
            u[kk] = t1 - t0;
            v[kk] = (1.0f - fx) * s0 + fx * s1;
            puv[kk] = s1 - s0;
            const int gx = x0 + iorgx + pj[kk];
            const int gy = y0 + iorgy + pi[kk];
            const bool vx = (gx >= 0) && (static_cast<float>(gx) + 1.0f <= width);
            const bool vy = (gy >= 0) && (static_cast<float>(gy) + 1.0f <= height);
            w2[kk] = (vx && vy) ? wrv[kk] : 0.0f;
            m1[0] += p2[kk];
            m1[1] += p2[kk] * p2[kk];
            m1[2] += u[kk];
            m1[3] += v[kk];
            m1[4] += puv[kk];
            m1[5] += p2[kk] * u[kk];
            m1[6] += p2[kk] * v[kk];
            m1[7] += u[kk] * u[kk];
            m1[8] += v[kk] * v[kk];
            m1[9] += u[kk] * v[kk] + p2[kk] * puv[kk];
          }
        }
        // reduction 1: patch means and second moments
        butterfly<16>(m1, lane);
        if ((lane & 1) == 0) s_red1[warp][lane >> 1] = m1[0];
        __syncthreads();
        float r1[10];
#pragma unroll
        for (int j = 0; j < 10; ++j) {
          r1[j] = s_red1[0][j];
#pragma unroll
          for (int ww_ = 1; ww_ < kWarps; ++ww_) r1[j] += s_red1[ww_][j];
          r1[j] *= inv_n;
        }
        const float m2 = r1[0];
        const float ss2 = r1[1];
        const float m2x = r1[2];
        const float m2y = r1[3];
        const float m2xy = r1[4];
        const float gate = ss2 > eps ? 1.0f : 0.0f;
        const float ss2s = fmaxf(ss2, eps);
        const float ss2x = 2.0f * r1[5] * gate;
        const float ss2y = 2.0f * r1[6] * gate;
        const float ss2xx = 2.0f * r1[7] * gate;
        const float ss2yy = 2.0f * r1[8] * gate;
        const float ss2xy = 2.0f * r1[9] * gate;

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

        float m3[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) m3[j] = 0.0f;
#pragma unroll
        for (int kk = 0; kk < kPer; ++kk) {
          const int q = t + kThreads * kk;
          if (q < kPix) {
            const float e = rv[kk] - alpha * p2[kk] - beta;
            const float ex = -ax * p2[kk] - alpha * u[kk] - bx;
            const float ey = -ay * p2[kk] - alpha * v[kk] - by;
            const float exx = -axx * p2[kk] - 2.0f * ax * u[kk] - bxx;
            const float eyy = -ayy * p2[kk] - 2.0f * ay * v[kk] - byy;
            const float exy = -axy * p2[kk] - ax * v[kk] - ay * u[kk] - alpha * puv[kk] - bxy;
            m3[0] += w2[kk] * e * ex;
            m3[1] += w2[kk] * e * ey;
            m3[2] += w2[kk] * (ex * ex + e * exx);
            m3[3] += w2[kk] * (ey * ey + e * eyy);
            m3[4] += w2[kk] * (ex * ey + e * exy);
          }
        }
        // reduction 2: gradient and Hessian of the score
        butterfly<8>(m3, lane);
        if ((lane & 3) == 0) s_red2[warp][lane >> 2] = m3[0];
        __syncthreads();
        float r2[5];
#pragma unroll
        for (int j = 0; j < 5; ++j) {
          r2[j] = s_red2[0][j];
#pragma unroll
          for (int ww_ = 1; ww_ < kWarps; ++ww_) r2[j] += s_red2[ww_][j];
          r2[j] *= 2.0f;
        }
        const float gx_ = r2[0], gy_ = r2[1], hxx = r2[2], hyy = r2[3], hxy = r2[4];

        const float det = hxx * hyy - hxy * hxy;
        const float safe = fabsf(det) > 1e-20f ? det : (det >= 0.f ? 1e-20f : -1e-20f);
        float dx = -(hyy * gx_ - hxy * gy_) / safe;
        float dy = -(-hxy * gx_ + hxx * gy_) / safe;
        if (!((fabsf(dx) < 1e20f) && (fabsf(dy) < 1e20f))) {
          dx = 0.f;
          dy = 0.f;
        }
        const float nrm = sqrtf(dx * dx + dy * dy);
        const float scale = nrm > 1.0f ? 1.0f / fmaxf(nrm, 1e-20f) : 1.0f;
        dx *= scale;
        dy *= scale;
        const float sx = fminf(fmaxf(dx, -1.0f), 1.0f);
        const float sy = fminf(fmaxf(dy, -1.0f), 1.0f);
        const bool converged = (fabsf(dx) < p.threshold) && (fabsf(dy) < p.threshold);
        if (!oob) {
          x += sx;
          y += sy;
        } else {
          status = 2.0f;
        }
        done = oob || converged;
      }
      if (out_of_bounds(x, y, width, height)) status = 2.0f;
    }
    if (i > 0 && lvl_on) {
      x *= 2.0f;
      y *= 2.0f;
    }
  }

  if (t == 0) {
    p.pos_out[2 * f] = x;
    p.pos_out[2 * f + 1] = y;
    if (p.status_out) p.status_out[f] = status;
    if (p.ok_out) p.ok_out[f] = (status == 0.0f && act) ? 1 : 0;
  }
  if (p.stack_out == nullptr) return;

  // epilogue: the backward reference stack at pos / 2^lv from the lane's own
  // level windows (_sample_from_windows)
  __syncthreads();  // every warp has read the last iteration's s_red2
  for (int lv = 0; lv < L; ++lv) {
    const float* win = s_win + lv * kWin * kWin;
    const int WH = p.wh[lv], WW = p.ww[lv];
    const float orgx = s_org[lv][0], orgy = s_org[lv][1];
    const float s = ldexpf(1.0f, -lv);
    const float lx = clean(x * s) - orgx;
    const float ly = clean(y * s) - orgy;
    const float x0f = floorf(lx);
    const float y0f = floorf(ly);
    const float fx = lx - x0f;
    const float fy = ly - y0f;
    const int x0 = static_cast<int>(x0f) - kHalf;
    const int y0 = static_cast<int>(y0f) - kHalf;
    const int x0c = min(max(x0, 0), WW - (kS + 1));
    const int y0c = min(max(y0, 0), WH - (kS + 1));
    const int iorgx = static_cast<int>(orgx);
    const int iorgy = static_cast<int>(orgy);
    const float w_img = static_cast<float>(p.w[lv]);
    const float h_img = static_cast<float>(p.h[lv]);
    float* out = p.stack_out + (static_cast<long long>(f) * L + lv) * kPack;
    float m[2] = {0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < kPer; ++kk) {
      const int q = t + kThreads * kk;
      if (q < kPix) {
        const int ii = pi[kk], jj = pj[kk];
        const float* rowp = win + (y0c + ii) * kWin + x0c + jj;
        const float t0 = (1.0f - fy) * rowp[0] + fy * rowp[kWin];
        const float t1 = (1.0f - fy) * rowp[1] + fy * rowp[kWin + 1];
        const float d = (1.0f - fx) * t0 + fx * t1;
        const int gx = x0 + iorgx + jj, gy = y0 + iorgy + ii;
        const bool vx = (gx >= 0) && (static_cast<float>(gx) + 1.0f <= w_img) &&
                        (x0 + jj >= 0) && (x0 + jj + 1 <= WW);
        const bool vy = (gy >= 0) && (static_cast<float>(gy) + 1.0f <= h_img) &&
                        (y0 + ii >= 0) && (y0 + ii + 1 <= WH);
        out[q] = d;
        out[kPix + q] = (vx && vy) ? 1.0f : 0.0f;
        m[0] += d;
        m[1] += d * d;
      }
    }
    butterfly<2>(m, lane);
    if ((lane & 15) == 0) s_red2[warp][lane >> 4] = m[0];
    __syncthreads();
    if (t == 0) {
      float sum = s_red2[0][0], sq = s_red2[0][1];
      for (int ww_ = 1; ww_ < kWarps; ++ww_) {
        sum += s_red2[ww_][0];
        sq += s_red2[ww_][1];
      }
      out[2 * kPix] = sum / static_cast<float>(kPix);
      out[2 * kPix + 1] = sq / static_cast<float>(kPix);
    }
    __syncthreads();  // s_red2 is reused by the next level
  }
}

}  // namespace

extern "C" int newton_track_params_size() { return static_cast<int>(sizeof(TrackParams)); }

// One launch of the cascade for p->F lanes; returns the launch's cudaError_t.
extern "C" int newton_track(const TrackParams* p, void* stream) {
  if (p->F <= 0) return 0;
  if (p->L < 1 || p->L > kMaxLevels) return static_cast<int>(cudaErrorInvalidValue);
  for (int i = 0; i < p->L; ++i) {
    if (p->wh[i] < kS + 1 || p->ww[i] < kS + 1 || p->wh[i] > kWin || p->ww[i] > kWin)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem = static_cast<size_t>(p->L) * (kWin * kWin + kPack) * sizeof(float);
  track_kernel<<<p->F, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(*p);
  return static_cast<int>(cudaGetLastError());
}
