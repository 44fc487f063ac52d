"""Async frame recorder: the --save path (main.cpp:371-398).

Port of ``slam_robot_tpu/io/recorder.py``. The reference drains a
mutex-guarded frame buffer with 3 PNG-writer threads; here a
ThreadPoolExecutor does the same with backpressure. Frames are written as
%08d.png (PIL) or %08d.npy, replayable by ``FileSource``.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np


class Recorder:
    def __init__(self, directory: str, workers: int = 3, fmt: str = "png"):
        if fmt == "png":
            from slam_robot_tpu_torch.io.sources import _require

            _require("PIL", "Recorder(fmt='png')")
        os.makedirs(directory, exist_ok=True)
        self.dir = directory
        self.fmt = fmt
        self.pool = ThreadPoolExecutor(max_workers=workers)
        self.pending = []

    def save(self, frame_id: int, img) -> None:
        img = np.asarray(img)
        self.pending.append(self.pool.submit(self._write, frame_id, img))
        # bound outstanding work (the ref's fbuffer grows without bound)
        if len(self.pending) > 16:
            done = [f for f in self.pending if f.done()]
            for f in done:
                f.result()
            self.pending = [f for f in self.pending if not f.done()]

    def _write(self, frame_id: int, img: np.ndarray) -> None:
        base = os.path.join(self.dir, f"{frame_id:08d}")
        if self.fmt == "npy":
            np.save(base + ".npy", img.astype(np.float32))
        else:
            from PIL import Image

            arr = np.clip(img * 255.0, 0, 255).astype(np.uint8)
            Image.fromarray(arr).save(base + ".png")

    def close(self) -> None:
        self.pool.shutdown(wait=True)
        for f in self.pending:
            f.result()
        self.pending.clear()
