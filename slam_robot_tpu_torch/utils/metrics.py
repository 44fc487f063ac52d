"""Structured per-step metrics history (SURVEY §5 observability).

Port of ``slam_robot_tpu/utils/metrics.py``: ``MetricsLog`` keeps the
scalar metrics of each ``pipeline.step`` on the host (one read per scalar)
with summary statistics and the reference-style error histogram.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from slam_robot_tpu_torch.utils.histogram import Histogram


def _dim(v) -> int:
    return v.dim() if torch.is_tensor(v) else np.ndim(v)


class MetricsLog:
    def __init__(self):
        self.rows: list[dict] = []

    def append(self, metrics: dict) -> None:
        """Keep the 0-d entries of ``metrics`` (tensors or numbers)."""
        self.rows.append({k: v.item() if torch.is_tensor(v) else np.asarray(v).item()
                          for k, v in metrics.items() if _dim(v) == 0})

    def column(self, key: str) -> np.ndarray:
        return np.array([r.get(key, np.nan) for r in self.rows])

    def summary(self) -> dict:
        if not self.rows:
            return {}
        out = {"frames": len(self.rows)}
        for key in ("n_matches", "mean_reproj_err", "fast_iters", "slow_iters"):
            col = self.column(key)
            if np.all(np.isnan(col)):
                continue
            out[key] = {
                "mean": float(np.nanmean(col)),
                "median": float(np.nanmedian(col)),
                "max": float(np.nanmax(col)),
            }
        kf = self.column("is_keyframe")
        out["keyframes"] = int(np.nansum(kf))
        return out

    def error_histogram(self, buckets: int = 10, scale: float = 1.0) -> Histogram:
        h = Histogram(buckets, scale)
        col = self.column("mean_reproj_err")
        h.add_many(col[~np.isnan(col)])
        return h

    def to_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for r in self.rows:
                f.write(json.dumps(r) + "\n")
