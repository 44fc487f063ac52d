"""Whole large-map solves of a BAL-shaped problem, one after another.

The traffic of a ``"driver": "bal_solve"`` mix: a closed loop of one
client. Each solve runs ``slam_robot_tpu_torch.ops.ba_cg.solve`` on the
same seeded tables (the same initial state) and ends with a host read of
its ``ok`` and cost; the next is sent when that read returns. The window
runs solves back to back and ends at the first solve to finish after its
seconds.

The solver's mathematics come from the configuration (``solver``); the
traffic holds its first ``anchors`` cameras fixed (the gauge) and frees
every other one, so the frame slots are the cameras (``max_free_frames``).
The spill holds every row (``pad_spill`` = the rows), so no row is ever
lost; the pads and layout are the program's own.
"""

from __future__ import annotations

import importlib
import random
import statistics
import time

import torch

from benchmark import compare
from benchmark.reference import ba as reference
from slam_robot_tpu_torch.ops import ba_cg

ARGS = ("frame_quat", "frame_trans", "frame_cam", "cam_k", "point_loc", "point_uncertainty",
        "obs_frame", "obs_point", "obs_px", "obs_ok", "present", "free_frame")
# solves whose whole answer is kept for the comparison, drawn from the seed
SAMPLED = 2


def solver_settings(cfg: dict) -> dict:
    """The configuration's solver settings, a frame slot for every camera."""
    return dict(cfg["solver"], max_free_frames=cfg["cameras"])


def cg_config(settings: dict, rows: int, **trips) -> ba_cg.CGConfig:
    unknown = set(settings) - set(ba_cg.CGConfig._fields)
    if unknown:
        raise ValueError(f"the solver takes no {sorted(unknown)}")
    return ba_cg.CGConfig(**dict(settings, pad_spill=rows, **trips))


class Driver:
    """One cell's problem, solver and window."""

    def __init__(self, cell: dict, seed: int, device):
        cfg, traffic = cell["config"], cell["traffic"]
        gen = importlib.import_module(f"benchmark.gen.{cfg['generator']}")
        self.tables = gen.generate(cfg, traffic["anchors"], seed, device)
        self.args = tuple(self.tables[k] for k in ARGS)
        self.settings = solver_settings(cfg)
        rows = cfg["observations"]
        self.cgc = cg_config(self.settings, rows)
        self.warm_cgc = cg_config(self.settings, rows, **traffic["warm"])
        self.sizes = dict(O=rows, P=cfg["points"], W=self.settings["max_free_frames"],
                          C=cfg["cameras"], gn_iters=self.settings["gn_iters"],
                          cg_iters=self.settings["cg_iters"])
        self.sample = random.Random(seed)
        self.device = torch.device(device)

    def solve(self, cgc=None):
        """One solve and its host read: (result, ok, cost)."""
        res = ba_cg.solve(*self.args, cgc or self.cgc)
        ok, cost = torch.stack([res.ok.to(res.cost.dtype), res.cost]).tolist()
        return res, bool(ok), cost

    def warm(self) -> None:
        """Every kernel and shape of a solve, at the warm trip counts."""
        self.solve(self.warm_cgc)

    def window(self, seconds: float) -> dict:
        """Solves back to back until the first to end after ``seconds``:
        the window's seconds, the solves attempted, each solve's seconds,
        cost and ok, the sampled solves' answers by index and the window's
        peak bytes. All but ``sampled`` go into the run's record."""
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        times, costs, oks, sampled = [], [], [], {}
        start = time.perf_counter()
        end = start
        while end - start < seconds:
            t0 = time.perf_counter()
            res, ok, cost = self.solve()
            end = time.perf_counter()
            i = len(times)
            times.append(end - t0)
            costs.append(cost)
            oks.append(ok)
            # reservoir sample of SAMPLED solves
            slot = i if i < SAMPLED else self.sample.randrange(i + 1)
            if slot < SAMPLED:
                if len(sampled) == SAMPLED:
                    sampled.pop(sorted(sampled)[slot])
                sampled[i] = res
        peak = (torch.cuda.max_memory_allocated(self.device) if self.device.type == "cuda"
                else None)
        return {"window_s": end - start, "attempted": len(times), "solves": len(times),
                "solve_times": times,
                "costs": costs, "oks": oks, "sampled": sampled, "peak_window_bytes": peak}

    def check(self, window: dict, limits: dict) -> tuple[dict, int]:
        """The reference's solve of the same tables, and the window's answers
        against it (``compare.check``)."""
        ref = reference.solve(self.tables, self.settings)
        sampled = {i: r._asdict() for i, r in window["sampled"].items()}
        return compare.check(self.tables, ref, window["costs"], window["oks"], sampled, limits,
                             self.settings["cheirality_eps"])

    @staticmethod
    def summary(rec: dict) -> str:
        """The run's own figures, one line ahead of the result."""
        t = rec["solve_times"]
        q = statistics.quantiles(t, n=4) if len(t) > 1 else [t[0], t[0], t[0]]
        return (f"{rec['solves']} solves in {rec['window_s']:.6f} s; a solve's s (q1, median, "
                f"q3) {[q[0], statistics.median(t), q[2]]}, first {t[0]:.6f}, last "
                f"{t[-1]:.6f}; window peak {rec['peak_window_bytes']} B")
