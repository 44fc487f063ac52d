"""Profile the large-map CG bundle adjustment: what bounds its GN iters/s at
10k keyframes / 500k landmarks / 1M observations.

Port of the JAX package's ``tools/profile_cg.py``. It runs ``ops/ba_cg.solve``
on ``bench_suite`` config 5's problem (``--small``: the CI shape), times one
solve after a first one, then profiles one more (``profile_trace.profile``)
and prints the GN iters/s, the total device self time, the device busy
share against the unprofiled solves on either side of the profiled one
(the timed solve and one more), device ms a GN iteration by category
(``profile_trace.CATEGORIES``) and the top kernels, then the device ms a
solve by the solver's own spans (self, inclusive, calls; stamped while the
profiler ran) and its spill counters (``ba_cg.SPILL``). The line names the
layout: in the port ``scatter`` adds with atomics, in no fixed order, and
``padded`` comes out the same every run.

    python -m slam_robot_tpu_torch.tools.profile_cg [--small] [--top 30] [--layout scatter|padded]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from slam_robot_tpu_torch.device import SPAN_MS
from slam_robot_tpu_torch.ops import ba_cg
from slam_robot_tpu_torch.tools import profile_trace, profiling
from slam_robot_tpu_torch.utils import synthetic

TRACE_DIR = profiling.scratch_path("torchtrace_cg")
KEYS = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc", "point_uncertainty",
        "obs_frame", "obs_point", "obs_px", "obs_ok", "present", "free_frame")


def problem(small: bool, dev: torch.device) -> tuple:
    """Config 5's problem tables, in ``ba_cg.solve``'s argument order."""
    nf, npts, opf = (200, 5000, 60) if small else (10000, 500000, 100)
    prob = synthetic.build_large_problem(nf, npts, obs_per_frame=opf, device=dev)
    return tuple(prob[k] for k in KEYS)


def solve_rate(args: tuple, cgc: ba_cg.CGConfig, dev: torch.device):
    """(result, s, GN iters/s) of one ``ba_cg.solve`` after a first one, and
    the first one's s."""
    t0 = time.perf_counter()
    ba_cg.solve(*args, cgc)
    profiling.sync(dev)
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    res = ba_cg.solve(*args, cgc)
    profiling.sync(dev)
    dt = time.perf_counter() - t0
    return res, dt, cgc.gn_iters / dt, first_s


def run(args: tuple, cgc: ba_cg.CGConfig, dev: torch.device, top: int = 30,
        out_dir: str | None = TRACE_DIR, emit=print) -> dict:
    """Time and profile the solve; prints the original's lines, then the
    span table (:func:`span_table`), and returns ``profile_trace.profile``'s
    figures a GN iteration with ``gn_iters_per_s``, ``solve_s``,
    ``first_s``, ``cost``, ``device_ms_by_span`` (a solve's) and
    ``spill``."""
    res, dt, rate, first_s = solve_rate(args, cgc, dev)
    emit(f"first solve: {first_s:.0f}s")
    emit(f"solve: {dt:.2f}s = {rate:.2f} GN iters/s (cost {float(res.cost):.1f}, "
         f"layout {cgc.layout})")
    profile_trace.CAPTURES.before_next(2)  # solve_rate's two solves
    SPAN_MS.reset_device()
    ba_cg.SPILL.reset()
    p = profile_trace.profile(lambda: ba_cg.solve(*args, cgc), dev, cgc.gn_iters, out_dir, top,
                              wall_before_ms=1e3 * dt)
    profile_trace.report(p, "GN iter", emit)
    spans, spill = span_table(emit)
    return dict(p, gn_iters_per_s=rate, solve_s=dt, first_s=first_s, cost=float(res.cost),
                device_ms_by_span=spans, spill=spill)


def span_table(emit=print) -> tuple:
    """Device ms a solve by span over the solves stamped since the last
    ``SPAN_MS.reset_device()`` (the profiled ones), largest self first, and
    the spill counters: ({name: {self_ms, ms, calls}}, counters)."""
    spans = SPAN_MS.read_device()
    n = spans.get("ba_cg_solve", {}).get("calls", 0)
    per = {k: {"self_ms": v["self_ms"] / n, "ms": v["ms"] / n, "calls": v["calls"] / n}
           for k, v in sorted(spans.items(), key=lambda kv: -kv[1]["self_ms"])} if n else {}
    emit(f"\n-- device ms/solve by span over {n} profiled solves (self | inclusive | "
         f"calls/solve) --")
    for k, v in per.items():
        emit(f"{k:40s} {v['self_ms']:12.3f} {v['ms']:12.3f} {v['calls']:8.1f}")
    spill = ba_cg.SPILL.read()
    emit(f"spill counters over those solves {json.dumps(spill, sort_keys=True)}")
    return per, spill


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--gn-iters", type=int, default=5)
    ap.add_argument("--cg-iters", type=int, default=20)
    ap.add_argument("--layout", default="scatter", choices=["scatter", "padded"])
    ap.add_argument("--out", default=TRACE_DIR, help="directory for trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    a = ap.parse_args(argv)
    dev = profiling.open_device(a.device, "profile_cg")
    if dev is None:
        return 1
    args = problem(a.small, dev)
    nf = args[0].shape[0]
    cgc = ba_cg.CGConfig(max_free_frames=nf, gn_iters=a.gn_iters, cg_iters=a.cg_iters,
                         precond="diag", layout=a.layout)
    print(f"device: {profiling.device_line(dev)}  problem: {nf} kf / {args[4].shape[0]} lm / "
          f"{args[6].shape[0]} obs  gn={a.gn_iters} cg={a.cg_iters} layout={a.layout}",
          flush=True)
    run(args, cgc, dev, a.top, a.out, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
