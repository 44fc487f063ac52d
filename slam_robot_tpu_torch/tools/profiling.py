"""What the profiling tools share: the device they run on, the card's line,
and their timers.

Each tool (``profile_tpu``, ``profile_step``, ``profile_tracker``,
``profile_scan``, ``probe_live``, ``profile_trace``, ``profile_cg``,
``profile_cg_sharded``) takes ``--device`` (default ``cuda``) and opens it
with :func:`open_device`, which refuses to carry on on the CPU when the
card is meant and torch sees none. Wall times come from
``time.perf_counter()`` around loops that end in ``torch.cuda.synchronize()``
(:func:`timeit`); kernel times from CUDA events (:func:`event_ms`) and from
the replay of a CUDA graph that holds many calls (:func:`graph_ms`), which
takes the host's launch path out.
"""

from __future__ import annotations

import hashlib
import os
import sys
import tempfile
import time
from pathlib import Path

import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import default_device

# the tools' --small size: 160x120, depth 4, 96 features (the CPU tests' size)
SMALL = SlamConfig(image_width=160, image_height=120, pyramid_depth=4, levels_unsure=4,
                   max_features=96, max_corners=48, min_matches=12, max_frames=32,
                   max_points=384, max_obs=8192, max_obs_per_point=16, ba_max_iters=20)


def scratch_path(name: str) -> str:
    """``name`` in the temporary directory (``tempfile.gettempdir()``, which
    honours ``TMPDIR``), tagged with this checkout, so that two checkouts
    run side by side neither read nor overwrite each other's state caches
    and traces."""
    checkout = hashlib.sha1(str(Path(__file__).resolve().parents[2]).encode()).hexdigest()[:8]
    return os.path.join(tempfile.gettempdir(), f"{name}_{checkout}")


def open_device(name: str, tool: str) -> torch.device | None:
    """The device ``name`` (``cuda`` or ``cpu``), or None after a message on
    stderr when the card is meant and torch sees no CUDA device."""
    try:
        return default_device(name)
    except RuntimeError as e:
        print(f"{tool}: {e}", file=sys.stderr)
        return None


def device_line(dev: torch.device) -> str:
    """``<name>, <power limit>`` as nvidia-smi reports them, or ``cpu``."""
    f = bench._device_fields(dev)
    return f["device"] if dev.type != "cuda" else f"{f['device']}, {f['power_limit']}"


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timeit(fn, dev: torch.device, n: int = 10, warmup: int = 2) -> tuple[float, dict]:
    """Mean wall ms of ``fn()`` over ``n`` calls after ``warmup`` calls, each
    end synchronized, and the mean count a call of each of ``bench.counts()``
    (host syncs, hand-written kernel launches) over the timed calls."""
    for _ in range(warmup):
        fn()
    sync(dev)
    before = bench.counts()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    sync(dev)
    ms = (time.perf_counter() - t0) / n * 1e3
    return ms, {k: (v - before[k]) / n for k, v in bench.counts().items()}


def event_ms(fn, n: int = 20, warmup: int = 2) -> float:
    """Mean ms a call of ``fn()`` by CUDA events around ``n`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def graph_ms(fn, n: int = 20) -> float:
    """Mean ms a call of ``fn()`` with the host's launch path taken out:
    ``n`` calls captured in one CUDA graph (on a side stream, as
    ``ops/tracker.GraphCache`` captures), the graph replayed and timed by
    CUDA events. ``fn`` must read nothing on the host."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for _ in range(n):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(5):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (5 * n)
