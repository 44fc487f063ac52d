"""Time the headline bench's scan under config variants, on the card.

Port of the JAX package's ``tools/profile_scan.py``. Each variant
bootstraps the bench's mid-sweep state with its own config
(``bench.bootstrap``: 96 warm frames with the polish, so the state is the
one that config would have built), then times the 64-frame continuation
(``bench.run_scan``) and reports fps beside the accuracy figures the
variant trades against: the median enabled reprojection error, the raw and
Sim(3)-aligned trajectory error, match and keyframe counts, BA iterations.
The port's scan is a loop, so the original's ``scan_compile_s`` is its
first pass; ``--reps`` passes more are timed.

Variants (the original's names and the ``SlamConfig`` change each makes):
``default``; ``backoffN`` and ``boN`` (``find_fail_backoff``); ``noslam``
(the step without BA); ``rtN`` (``roundtrip_levels``); ``ladder``
(``retry_mode``); ``sweeps2`` (``retry_sweeps``); ``fastN``
(``ba_iters_fast``); ``giveupN`` (``find_fail_give_up``); ``nowincache``
(``bwd_window_cache`` off); ``set:key=val[;key=val...]``, any field,
coerced to its type (``set:tracker_impl=lanes`` and
``set:tracker_kind=klt`` time the alternative trackers).

    python -m slam_robot_tpu_torch.tools.profile_scan [--variants default,backoff4,noslam]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no result line.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time

import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.tools import profiling
from slam_robot_tpu_torch.utils import benchscene

N_WARM, N_TIMED = 96, 64
DEFAULT = "default,backoff2,backoff4,noslam"
KEEP = ("n_matches", "is_keyframe", "fast_iters", "slow_iters")


def variant_config(name: str, base: SlamConfig) -> tuple[SlamConfig, bool]:
    """(config, run_slam) of variant ``name``, the original's branches in
    its order; raises ValueError on an unknown name."""
    rep = dataclasses.replace
    if name == "default":
        return base, True
    if name.startswith("backoff"):
        return rep(base, find_fail_backoff=int(name[len("backoff"):])), True
    if name == "noslam":
        return base, False
    if name.startswith("rt"):  # rt0 = full backward cascade, rtN = cap
        return rep(base, roundtrip_levels=int(name[2:])), True
    if name == "ladder":
        return rep(base, retry_mode="ladder"), True
    if name == "sweeps2":
        return rep(base, retry_sweeps=2), True
    if name.startswith("fast"):  # fastN = ba_iters_fast cap
        return rep(base, ba_iters_fast=int(name[4:])), True
    if name.startswith("giveup"):
        return rep(base, find_fail_give_up=int(name[6:])), True
    if name == "nowincache":
        return rep(base, bwd_window_cache=False), True
    if name.startswith("bo"):  # boN = find_fail_backoff
        return rep(base, find_fail_backoff=int(name[2:])), True
    if name.startswith("set:"):
        # set:key=val[;key=val...] with field-typed coercion, e.g.
        # set:ba_iters_slow=40;slow_every=4
        kv = {}
        for pair in name[4:].split(";"):
            k, v = pair.split("=")
            ftype = type(getattr(base, k))
            if ftype is bool:
                kv[k] = v == "True"
            elif ftype is tuple:
                kv[k] = tuple(int(t) for t in v.split("x"))  # set:solve_xslow=24x32
            else:
                kv[k] = ftype(v)
        return rep(base, **kv), True
    raise ValueError(f"unknown variant {name}")


def scan_stats(m, n_matches, is_keyframe, fast_iters, slow_iters) -> dict:
    """The original's accuracy figures of a scan's final map ``m`` and its
    per-frame metrics, rounded as the original rounds them."""
    median_err, _ = bench.err_split(m)
    ate, ate_pct, ate_al_pct = bench.trajectory_error(m)
    return {
        "median_enabled_err_px": round(median_err, 3),
        "ate_mm": round(ate, 1),
        "ate_pct_of_path": round(ate_pct, 2),
        "ate_pct_aligned": round(ate_al_pct, 2),
        "n_points": int(m.n_points),
        "mean_matches": round(float(n_matches.double().mean()), 1),
        "keyframes_in_scan": int(is_keyframe.sum()),
        "mean_fast_iters": round(float(fast_iters.double().mean()), 1),
        "mean_slow_iters": round(float(slow_iters.double().mean()), 1),
    }


def run_variant(name: str, cfg: SlamConfig, frames, n_warm: int, dev: torch.device,
                run_slam: bool = True, start=None, reps: int = 2, emit=print) -> dict:
    """Bootstrap ``n_warm`` frames with ``cfg`` (or take ``start``, a warm
    state), then the scan over ``frames[n_warm:]``: its first pass, then
    ``reps`` timed passes. Prints and returns the original's line."""
    if start is None:
        t0 = time.perf_counter()
        ps, _, _ = bench.bootstrap(cfg, frames, n_warm, dev, n_eager=0, run_slam=run_slam)
        profiling.sync(dev)
        warm_s = time.perf_counter() - t0
    else:
        ps, warm_s = start, 0.0
    imgs = torch.stack(frames[n_warm:])
    n_timed = imgs.shape[0]
    t0 = time.perf_counter()
    ps2, res = bench.run_scan(ps, imgs, cfg, run_slam, keep=KEEP)
    profiling.sync(dev)
    compile_s = time.perf_counter() - t0
    ms = compile_s / n_timed * 1000   # with no timed pass, the first's
    if reps:
        t0 = time.perf_counter()
        for _ in range(reps):
            ps2, res = bench.run_scan(ps, imgs, cfg, run_slam, keep=KEEP)
        profiling.sync(dev)
        ms = (time.perf_counter() - t0) / (reps * n_timed) * 1000
    out = {
        "variant": name,
        "scan_step_ms": round(ms, 2),
        "fps": round(1000.0 / ms, 2),
        "warm_s": round(warm_s, 1),
        "scan_compile_s": round(compile_s, 1),
        **scan_stats(ps2.map, *res[2:]),
    }
    emit(json.dumps(out))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--seed", type=int, default=0,
                    help="bench-scene world seed: same trajectory, fresh landmark texture")
    ap.add_argument("--reps", type=int, default=2,
                    help="timed scan repetitions (1 for ATE-only A/Bs)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true",
                    help="160x120, depth 4, 96 features, 24 warm and 8 timed frames")
    args = ap.parse_args(argv)
    base = profiling.SMALL if args.small else SlamConfig()
    variants = args.variants.split(",")
    try:
        configs = [variant_config(name, base) for name in variants]
    except (ValueError, AttributeError) as e:
        ap.error(str(e))
    dev = profiling.open_device(args.device, "profile_scan")
    if dev is None:
        return 1
    n_warm, n_timed = (24, 8) if args.small else (N_WARM, N_TIMED)
    frames = benchscene.make_frames(base, n_warm + n_timed, seed=args.seed, device=dev)
    print(f"device: {profiling.device_line(dev)} seed: {args.seed}", flush=True)
    for name, (cfg, run_slam) in zip(variants, configs):
        run_variant(name, cfg, frames, n_warm, dev, run_slam, reps=args.reps,
                    emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
