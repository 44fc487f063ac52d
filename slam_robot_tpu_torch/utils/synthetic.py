"""Synthetic camera intrinsics (port of ``slam_robot_tpu/utils/synthetic``'s
``reference_intrinsics``)."""

from __future__ import annotations

import numpy as np

from slam_robot_tpu_torch.config import SlamConfig


def reference_intrinsics(cfg: SlamConfig) -> np.ndarray:
    """Zero-distortion k with the reference's negative fy (main.cpp:474-482),
    scaled with the image width (same field of view)."""
    s = cfg.image_width / 640.0
    return np.array(
        [0, 0, 0, cfg.focal * s, -cfg.focal * s,
         cfg.image_width / 2.0, cfg.image_height / 2.0],
        np.float32,
    )
