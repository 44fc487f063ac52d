"""Wall-clock scope timer (ScopedTimer, main.cpp:400-419).

Port of ``slam_robot_tpu/utils/timer.py``: ``block_on`` names tensors whose
device work must finish inside the timed scope, so a CUDA timing means
something (PyTorch returns before the device is done).
"""

from __future__ import annotations

import time

import torch


class ScopedTimer:
    """Prints ``TIMER: <name>: <seconds>`` on exit, like the reference."""

    def __init__(self, name: str, sink=print, block_on=None):
        self.name = name
        self.sink = sink
        self.block_on = block_on
        self.elapsed = None

    def __enter__(self):
        self.start = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self.block_on is not None:
            ts = self.block_on if isinstance(self.block_on, (list, tuple)) else [self.block_on]
            for dev in {t.device for t in ts if torch.is_tensor(t) and t.is_cuda}:
                torch.cuda.synchronize(dev)
        self.elapsed = time.perf_counter() - self.start
        self.sink(f"TIMER: {self.name}: {self.elapsed}")
        return False
