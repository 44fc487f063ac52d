"""Probe the live per-frame path: a robot feeds frames one at a time
(main.cpp:503-645), so what each frame costs the host is the live path's
ceiling.

Port of the JAX package's ``tools/probe_live.py``. From the bench's warm
state (``bench.bootstrap``, 96 frames) each variant runs the next
``--frames`` frames and prints the original's line (ms a frame, fps, the
first pass's seconds; the ms is the best of ``--passes`` more passes).

Variants:
  rtt         one host round trip of the card: a trivial op whose result
              is read on the host, 100 times in a chain (``chain_call_ms``);
              then 100 independent calls and one read (``parallel_call_ms``)
  eager       pipeline.step a frame, one sync at the end
  eager_sync  pipeline.step + every metric read on the host each frame
  donated     pipeline.step_donated (the port has no donation: ``step``)
  live        pipeline.step_live: 12 packed scalars on the device
  nosync      step_live, the host's issue time a frame and its first 12
              per-call ms
  live_slice  step_live on frames indexed from one stacked tensor
  live_ring   step_live_ring, the telemetry ring read on the host once
              every 8 frames (``bench.live``, ``run_replay --live``)
  bigargs     the state's tensor count and MB, and one chained trivial op
              over that many tensors (``torch._foreach_add``) a frame

The original's ``aot`` (XLA's ahead-of-time compile) and ``live_fetch``,
``live_batchfetch``, ``live_fetch1`` (the TPU relay's fetch pool,
``utils/fetchpool``) have no counterpart: each prints one line saying so.
Every variant that steps does the same work, so its final state must equal
``eager``'s bit for bit; the last line prints that check.

    python -m slam_robot_tpu_torch.tools.probe_live [--variants rtt,eager,live] [--frames 32]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no result line.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import host
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.tools import profiling
from slam_robot_tpu_torch.utils import benchscene

STEPPING = ("eager", "eager_sync", "donated", "live", "nosync", "live_slice", "live_ring")
VARIANTS = ("rtt",) + STEPPING + ("bigargs",)
NO_COUNTERPART = {
    "aot": "XLA's ahead-of-time lower and compile; the port has no jit",
    "live_fetch": "the TPU relay's fetch pool (utils/fetchpool), not ported by design",
    "live_batchfetch": "the TPU relay's batched fetch pool (utils/fetchpool), not ported by design",
    "live_fetch1": "the TPU relay's fetch pool (utils/fetchpool), not ported by design",
}
DEFAULT = "rtt,eager,eager_sync,donated,live"
RING = bench.RING


def leaves(ps) -> list:
    """Every tensor of a (nested) state NamedTuple, in field order."""
    return [x for v in ps for x in (leaves(v) if isinstance(v, tuple) else [v])]


def copy_state(ps):
    """A copy of every tensor of a (nested) state NamedTuple."""
    return type(ps)(*(copy_state(v) if isinstance(v, tuple) else v.clone() for v in ps))


def states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b), strict=True))


def rtt(dev: torch.device, n: int = 100) -> dict:
    """The card's cost of one host round trip, and of one call without it."""
    def tick(x):
        return x + 1.0

    x = tick(torch.zeros((), device=dev))
    x.item()
    t0 = time.perf_counter()
    for _ in range(n):
        x = tick(x)
        x.item()          # a round trip a call: no pipelining
    chain_ms = (time.perf_counter() - t0) / n * 1e3
    xs = [torch.full((), float(i), device=dev) for i in range(n)]
    profiling.sync(dev)
    t0 = time.perf_counter()
    ys = [tick(v) for v in xs]   # independent calls, one read
    ys[-1].item()
    par_ms = (time.perf_counter() - t0) / n * 1e3
    return {"variant": "rtt", "chain_call_ms": round(chain_ms, 3),
            "parallel_call_ms": round(par_ms, 3)}


def run(name: str, ps0, frames, cfg: SlamConfig, emit=print):
    """One pass of variant ``name`` over ``frames`` from a copy of ``ps0``.
    Returns (ms a frame, final state)."""
    dev = ps0.map.device
    ps = copy_state(ps0)
    profiling.sync(dev)
    extra = {}
    t0 = time.perf_counter()
    if name == "eager":
        for img in frames:
            ps, met = pipeline.step(ps, img, cfg)
    elif name == "eager_sync":
        for img in frames:
            ps, met = pipeline.step(ps, img, cfg)
            {k: v.tolist() for k, v in met.items()}
    elif name == "donated":
        for img in frames:
            ps, met = pipeline.step_donated(ps, img, cfg)
    elif name == "live":
        for img in frames:
            ps, met = pipeline.step_live(ps, img, cfg)
    elif name == "nosync":
        # the host's issue time: with the step's own host reads it is most
        # of the frame
        stamps = [time.perf_counter()]
        for img in frames:
            ps, met = pipeline.step_live(ps, img, cfg)
            stamps.append(time.perf_counter())
        extra["issue_ms_per_frame"] = round((time.perf_counter() - t0) / len(frames) * 1000, 2)
        extra["per_dispatch_ms"] = [round((b - a) * 1000, 2)
                                    for a, b in zip(stamps[:-1], stamps[1:])][:12]
    elif name == "live_slice":
        # bench-style frame feed: index one stacked tensor a frame
        imgs = torch.stack(list(frames))
        n = imgs.shape[0]
        t0 = time.perf_counter()
        for i in range(n):
            ps, met = pipeline.step_live(ps, imgs[i % n], cfg)
    elif name == "live_ring":
        # the shipped loop: an f32[RING, LIVE_WIDTH] ring on the device, one
        # host read a RING frames
        ring = torch.zeros((RING, pipeline.LIVE_WIDTH), dtype=torch.float32, device=dev)
        got, group = [], []
        t0 = time.perf_counter()
        for i, img in enumerate(frames):
            ps, ring = pipeline.step_live_ring(ps, ring, img, cfg)
            group.append(i)
            if len(group) == RING:
                got.extend(zip(group, host(ring)[-len(group):]))
                group = []
        if group:
            got.extend(zip(group, host(ring)[-len(group):]))
        if len(got) != len(frames):
            raise AssertionError(f"live_ring: {len(got)} of {len(frames)} frames arrived")
    elif name == "bigargs":
        # a chained trivial op over as many tensors as the state holds:
        # the cost of the argument count alone
        ts = leaves(ps)
        emit(json.dumps({"variant": "bigargs", "state_leaves": len(ts),
                         "state_mb": round(sum(x.numel() * x.element_size() for x in ts) / 1e6, 1)}))
        toy = torch._foreach_add([torch.zeros(8, device=dev) for _ in ts], 1.0)
        profiling.sync(dev)
        t0 = time.perf_counter()
        for _ in range(len(frames)):
            toy = torch._foreach_add(toy, 1.0)
    else:
        raise ValueError(f"unknown variant {name}")
    profiling.sync(dev)
    ms = (time.perf_counter() - t0) / len(frames) * 1000
    if extra:
        emit(json.dumps({"variant": name, **extra}))
    return ms, ps


def probe(ps0, frames, cfg: SlamConfig, variants, passes: int = 2, emit=print) -> dict:
    """Every variant of ``variants`` from ``ps0`` over ``frames``: its line
    (the first pass's seconds, then the best of ``passes`` more; with 0 the
    first pass's ms), and whether its final state equals ``eager``'s.
    Returns {variant: its line dict}, with ``states_equal_eager``."""
    out = {}
    finals = {}
    for name in variants:
        if name in NO_COUNTERPART:
            out[name] = {"variant": name, "no_counterpart": NO_COUNTERPART[name]}
            emit(json.dumps(out[name]))
            continue
        if name == "rtt":
            out[name] = rtt(ps0.map.device)
            emit(json.dumps(out[name]))
            continue
        t0 = time.perf_counter()
        ms, finals[name] = run(name, ps0, frames, cfg, emit)
        first_pass_s = time.perf_counter() - t0
        if passes:
            ms = min(run(name, ps0, frames, cfg, emit)[0] for _ in range(passes))
        out[name] = {"variant": name, "live_step_ms": round(ms, 2),
                     "live_fps": round(1000.0 / ms, 2), "first_pass_s": round(first_pass_s, 1)}
        emit(json.dumps(out[name]))
    if "eager" in finals:
        out["states_equal_eager"] = {k: states_equal(v, finals["eager"])
                                     for k, v in finals.items() if k in STEPPING}
        emit(json.dumps({"states_equal_eager": out["states_equal_eager"]}))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", default=DEFAULT)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--warm", type=int, default=96)
    ap.add_argument("--passes", type=int, default=2, help="timed passes after the first")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true", help="160x120, depth 4, 96 features")
    args = ap.parse_args(argv)
    variants = args.variants.split(",")
    unknown = [v for v in variants if v not in VARIANTS and v not in NO_COUNTERPART]
    if unknown:
        ap.error(f"unknown variants {unknown}")
    dev = profiling.open_device(args.device, "probe_live")
    if dev is None:
        return 1
    print(f"device: {profiling.device_line(dev)}", flush=True)
    cfg = profiling.SMALL if args.small else SlamConfig()
    frames = benchscene.make_frames(cfg, args.warm + args.frames, device=dev)
    if set(variants) & set(STEPPING + ("bigargs",)):
        t0 = time.perf_counter()
        ps0, _, _ = bench.bootstrap(cfg, frames, args.warm, dev, n_eager=0)
        profiling.sync(dev)
        print(f"warm {time.perf_counter() - t0:.0f}s", flush=True)
    else:  # rtt alone needs no warm state
        ps0 = pipeline.init(cfg, device=dev)
    probe(ps0, frames[args.warm:], cfg, variants, args.passes,
          emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
