"""Fixed-bucket counting histogram (histogram.{h,cpp} rebuilt).

Port of ``slam_robot_tpu/utils/histogram.py`` (host numpy). Same contract:
``add`` clamps into [0, buckets); ``bucket(n)`` reads a counter; ``str()``
is the bucket dump (histogram.cpp:25-44); ``add_many`` is the vectorized
``add``.
"""

from __future__ import annotations

import numpy as np


class Histogram:
    def __init__(self, buckets: int, scale: float = 1.0):
        self.buckets = buckets
        self.scale = scale
        self.counters = np.zeros(buckets, np.int64)

    def add(self, value: float) -> None:
        b = int(value / self.scale)
        b = min(max(b, 0), self.buckets - 1)
        self.counters[b] += 1

    def add_many(self, values) -> None:
        b = (np.asarray(values) / self.scale).astype(np.int64)
        b = np.clip(b, 0, self.buckets - 1)
        np.add.at(self.counters, b, 1)

    def bucket(self, n: int) -> int:
        return int(self.counters[n])

    def str(self) -> str:
        return "".join(
            f"{i * self.scale:6g}: {self.counters[i]}\n" for i in range(self.buckets)
        )

    __str__ = str
