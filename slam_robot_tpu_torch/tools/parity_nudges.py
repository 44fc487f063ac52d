"""Is a parity drift chaos? One step of two implementations from the same
state, against each one's own spread under one-ulp nudges of the newest
frame's position.

``study`` takes the state's frame translations, the frame to step and two
step functions (each maps a translation table to the stepped newest
position and the fast BA's final cost). It steps both from the table and
from 26 nudges of it (every sign pattern in {-1, 0, +1} ulp over the
newest frame's translation), prints one line per nudge and returns a
summary: how far apart the two unnudged steps land, each side's spread
(how far a nudge moves its own step), how far the second side's unnudged
step lies from the first side's nudged ones, and each side's fast BA cost
(unnudged, and its range over the 27 steps). The BA runs to its iteration
cap and ends in one of a few basins, so the costs say whether both sides
land in the same basins. tests/torch_c1_nudges.py runs it on the JAX
package against the port on the CPU.

Run as a script, it asks the question of the port on the card against the
port on the CPU. It replays tools/parity.py's production_defaults sequence
(``--seed``, ``SlamConfig(max_frames=64)``, frames rendered on the CPU)
through the port on the CPU. Before each frame the CPU's state is carried
to the card and both devices take that frame's step. Then it studies the
frames in ``--frames`` (by default the one where the newest poses land
furthest apart) from the CPU's state. Imports no JAX.

    python -m slam_robot_tpu_torch.tools.parity_nudges [--seed 13] [--frames 21,19]
"""

from __future__ import annotations

import argparse
import itertools
import json
import sys

import numpy as np
import torch

from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.io import sources
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.tools import parity


def nudges(trans: np.ndarray, f: int):
    """(signs, copy of ``trans`` with row f - 1 moved by one ulp per
    nonzero sign) for the 26 nonzero sign patterns in {-1, 0, +1}^3."""
    for signs in itertools.product((-1, 0, 1), repeat=3):
        if any(signs):
            out = trans.copy()
            for c, sgn in enumerate(signs):
                if sgn:
                    out[f - 1, c] = np.nextafter(out[f - 1, c], np.float32(sgn * np.inf))
            yield signs, out


def study(trans: np.ndarray, f: int, steps: dict) -> dict:
    """Step frame ``f`` with both of ``steps`` ({name: fn(trans) ->
    (newest position [3], fast BA cost)}; the first is the reference side
    a, the second side b) from ``trans`` [frames, 3] float32 and from each
    of its nudges; returns the summary (distances in mm)."""
    (a, step_a), (b, step_b) = steps.items()
    base = {a: step_a(trans), b: step_b(trans)}
    moved = {a: [], b: []}
    costs = {a: [base[a][1]], b: [base[b][1]]}
    cross = []
    for signs, nudged in nudges(trans, f):
        out = {a: step_a(nudged), b: step_b(nudged)}
        for n in (a, b):
            moved[n].append(float(np.linalg.norm(out[n][0] - base[n][0])))
            costs[n].append(out[n][1])
        cross.append(float(np.linalg.norm(base[b][0] - out[a][0])))
        print(f"nudge {signs}: {a} moves {moved[a][-1]:.3f} mm (BA cost {out[a][1]:.3f}), "
              f"{b} {moved[b][-1]:.3f} mm (BA cost {out[b][1]:.3f}); {b}'s unnudged step "
              f"is {cross[-1]:.3f} mm from {a}'s", flush=True)
    apart = float(np.linalg.norm(base[b][0] - base[a][0]))
    summary = {"frame": f, "nudges": len(cross), f"{b}_vs_{a}_mm": apart}
    for n in (a, b):
        summary.update({f"{n}_spread_max_mm": max(moved[n]),
                        f"{n}_spread_median_mm": float(np.median(moved[n])),
                        f"{n}_ba_cost": base[n][1],
                        f"{n}_ba_cost_range": [min(costs[n]), max(costs[n])]})
    summary.update({f"{b}_to_{a}_nudged_min_mm": min(cross),
                    f"{b}_to_{a}_nudged_median_mm": float(np.median(cross)),
                    "inside_both": apart <= min(max(moved[a]), max(moved[b]))})
    return summary


def main(argv=None) -> list[dict]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=13)
    ap.add_argument("--frames", default="",
                    help="comma-separated frames to study (default: the furthest apart)")
    args = ap.parse_args(argv)

    spec = parity.SEQUENCES["production_defaults"]
    seq = dict(spec["seq"], seed=args.seed)
    cfg = SlamConfig(**spec["cfg"])
    src = sources.SyntheticSource(cfg, device="cpu", **seq)
    frames = [torch.as_tensor(src.get(i % 2, i)) for i in range(seq["n_frames"])]

    def step(ps, i, device):
        ps = bridge.from_numpy(bridge.to_numpy(ps), device)
        out, met = pipeline.step(ps, frames[i].to(device), cfg)
        return out, out.map.frame_trans[i].cpu().numpy(), float(met["ba_cost"])

    ps = pipeline.init(cfg, [src.k.numpy()] * 2, device="cpu")
    states, apart = [], []
    for i in range(seq["n_frames"]):
        states.append(ps)
        nxt, cpu_t, _ = step(ps, i, "cpu")
        card_t = step(ps, i, "cuda")[1]
        apart.append(float(np.linalg.norm(card_t - cpu_t)))
        ps = pipeline.maybe_polish(nxt, i, cfg)
    print(f"card vs CPU, one step from the CPU's state, newest pose mm: "
          f"{json.dumps([round(d, 4) for d in apart])}", flush=True)

    # frame 0 has no predecessor to nudge
    chosen = ([int(x) for x in args.frames.split(",")] if args.frames
              else [1 + int(np.argmax(apart[1:]))])
    out = []
    for f in chosen:
        base = states[f]

        def on(device, base=base, f=f):
            def run(trans):
                s = base._replace(map=base.map._replace(frame_trans=torch.as_tensor(trans)))
                return step(s, f, device)[1:]
            return run

        summary = {"seed": args.seed, **study(base.map.frame_trans.numpy(), f,
                                              {"cpu": on("cpu"), "card": on("cuda")})}
        print(json.dumps(summary), flush=True)
        out.append(summary)
    return out


if __name__ == "__main__":
    main(sys.argv[1:])
