"""Fused-tracker stage timing on the card: kernel, gathers, stacks.

Port of the JAX package's ``tools/profile_tracker.py``: at F =
``max_features`` lanes on two 6-level pyramids of a seeded 480x640 frame,

1. ``newton_level`` alone at [F, 32, 32] (one level of B1's kernel);
2. the window gather for one level;
3. ``get_patch_stacks``;
4. ``track_feature_batch`` at level 3: one launch of B1's ``newton_track``;
5. ``track_bidirectional_batch`` (two ``newton_track`` launches).

On the card each is timed by CUDA events around eager calls and by the
replay of a CUDA graph of the same calls (``tools/profiling.graph_ms``, the
route of ``ops/tracker.GraphCache``), which takes the host's launch path
out; the original timed jitted calls. On the CPU each is timed on the
host's clock.

    python -m slam_robot_tpu_torch.tools.profile_tracker [--device cuda|cpu] [--small]

``--small`` runs 96 lanes on a 120x160 frame, depth 4. Without a CUDA
device (and without ``--device cpu``) it exits 1 and prints no stage line.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops import pyramid as pyr
from slam_robot_tpu_torch.ops import tracker_fused
from slam_robot_tpu_torch.ops.cuda import newton
from slam_robot_tpu_torch.tools import profiling

# the original's labels; stage 4 names the port's B1 entry point
LABELS = ("newton_level kernel [F={F}]", "window gather [F={F}]", "patch stacks [F={F},L={L}]",
          "track_feature_batch (3 lvl) = newton_track", "track_bidirectional_batch")


def line(label: str, ms: float, graph: float | None = None) -> str:
    s = f"{label + ':':31s}{ms:8.3f} ms"
    return s if graph is None else f"{s}  (graph replay {graph:8.3f} ms)"


def calls(dev: torch.device, F: int, S: int, height: int, width: int, depth: int) -> list:
    """(label, call) of the five stages on seeded inputs."""
    rng = np.random.default_rng(0)
    weight = patch_ops.radial_mask(S, device=dev)

    def t(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=dev)

    img = t(rng.uniform(0, 1, size=(height, width)))
    pa = pyr.build_pyramid(img, depth=depth)
    pb = pyr.build_pyramid(img, depth=depth)
    # the plane offset as a device tensor: the calls copy no host scalar,
    # so a CUDA graph can hold them
    for p in (pa, pb):
        p.offset = torch.zeros((), dtype=torch.long, device=dev)
    pts = t(rng.uniform(50, min(400, min(height, width) - 50), size=(F, 2)))
    lvls = torch.full((F,), 3, dtype=torch.int32, device=dev)
    active = torch.ones((F,), dtype=torch.bool, device=dev)

    # 1. kernel alone at [F,32,32]
    win = t(rng.uniform(0, 1, size=(F, 32, 32)))
    ref = t(rng.uniform(0, 1, size=(F, S, S)))
    pos0 = torch.full((F, 2), 14.3, device=dev)
    org = torch.zeros((F, 2), device=dev)
    rv = torch.ones((F, S, S), device=dev)
    rm = ref.mean(dim=(1, 2))
    rs = (ref * ref).mean(dim=(1, 2))
    ones = torch.ones((F,), device=dev)
    bounds = torch.tensor([[float(width), float(height)]], device=dev).expand(F, 2).contiguous()

    def kern():
        return newton.newton_level(win, pos0, org, ref, rv, rm, rs, ones, weight, bounds,
                                   max_iters=6)

    packed = tracker_fused.pack_stacks(tracker_fused.get_patch_stacks(pa, pts, S))
    labels = [s.format(F=F, L=depth) for s in LABELS]
    return list(zip(labels, [
        kern,
        # 2. window gather for one level
        lambda: tracker_fused._gather_windows(pa, 0, pts, 32, 32),
        # 3. ref patch stacks
        lambda: tracker_fused.get_patch_stacks(pa, pts, S),
        # 4. one full track_feature_batch (the cascade from level 3)
        lambda: tracker_fused.track_feature_batch(pb, pts, lvls, weight, max_iters=6,
                                                  active=active, packed=packed),
        # 5. bidirectional
        lambda: tracker_fused.track_bidirectional_batch(pa, pb, pts, pts, lvls, weight,
                                                        max_iters=6, active=active),
    ]))


def run(dev: torch.device, F: int, S: int, height: int = 480, width: int = 640,
        depth: int = 6, n: int = 20, emit=print) -> dict:
    """Time the five stages; returns {label: {"ms", "graph_ms"}}: on the
    card ``ms`` by CUDA events and ``graph_ms`` by graph replay, on the CPU
    ``ms`` by the host clock and no ``graph_ms``."""
    out = {}
    for label, fn in calls(dev, F, S, height, width, depth):
        if dev.type == "cuda":
            ms, graph = profiling.event_ms(fn, n), profiling.graph_ms(fn, n)
        else:
            (ms, _), graph = profiling.timeit(fn, dev, n, 2), None
        out[label] = {"ms": ms, "graph_ms": graph}
        emit(line(label, ms, graph))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true", help="96 lanes, 120x160, depth 4")
    args = ap.parse_args(argv)
    dev = profiling.open_device(args.device, "profile_tracker")
    if dev is None:
        return 1
    print(f"device: {profiling.device_line(dev)}", flush=True)
    cfg = profiling.SMALL if args.small else SlamConfig()
    size = dict(height=120, width=160, depth=4) if args.small else {}
    run(dev, cfg.max_features, cfg.patch_size, **size, emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
