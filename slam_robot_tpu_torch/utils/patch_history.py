"""Per-point patch-history cache: the data behind the reference's
mouse-hover inspector (matcher.cpp:68-74, 260-265, 388-393: the last 30
13x13 patches per point id, shown by main.cpp:158-267).

Port of ``slam_robot_tpu/utils/patch_history.py``. The matcher's metrics
carry per-lane match arrays (feat_point / feat_px / feat_matched); this
host-side ring cuts the matched patch from each frame and keeps the newest
``depth`` per point id. The JAX package cuts with ``cv2.getRectSubPix``;
:func:`rect_subpix` is that extraction in numpy (bilinear, replicated
border), so the port needs no cv2.
"""

from __future__ import annotations

from collections import deque

import numpy as np
import torch


def rect_subpix(img: np.ndarray, size: int, center) -> np.ndarray:
    """``cv2.getRectSubPix(img, (size, size), center)`` for a float32 [H,W]
    image: the ``size`` x ``size`` patch whose centre pixel sits at
    ``center`` (x, y), sampled bilinearly, pixels outside the image
    replicating the nearest edge. One deliberate difference: where a patch
    reaches both above the image and past its right edge, OpenCV (4.x,
    5.0) replicates column W-2 instead of W-1; here every outside pixel
    replicates its nearest edge pixel."""
    h, w = img.shape
    cx = np.float32(center[0]) - np.float32((size - 1) * 0.5)
    cy = np.float32(center[1]) - np.float32((size - 1) * 0.5)
    ix, iy = int(np.floor(cx)), int(np.floor(cy))
    a = np.float32(cx - ix)
    b = np.float32(cy - iy)
    xs = ix + np.arange(size)
    ys = iy + np.arange(size)
    x0, x1 = np.clip(xs, 0, w - 1), np.clip(xs + 1, 0, w - 1)
    y0, y1 = np.clip(ys, 0, h - 1), np.clip(ys + 1, 0, h - 1)
    one = np.float32(1.0)
    top = (one - a) * img[y0][:, x0] + a * img[y0][:, x1]
    bot = (one - a) * img[y1][:, x0] + a * img[y1][:, x1]
    return ((one - b) * top + b * bot).astype(np.float32)


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if torch.is_tensor(v) else np.asarray(v)


class PatchHistory:
    def __init__(self, size: int = 13, depth: int = 30):
        self.size = size
        self.depth = depth
        self.hist: dict[int, deque] = {}

    def update(self, img, point_ids, px, matched) -> int:
        """Record this frame's matched patches. img [H,W] f32; the arrays
        (tensors or numpy) are per feature lane. Returns the number of
        patches recorded."""
        img = np.asarray(_host(img), np.float32)
        ids = _host(point_ids)
        pxs = np.asarray(_host(px), np.float32)
        m = _host(matched)
        n = 0
        for i in np.nonzero(m & (ids >= 0))[0]:
            patch = rect_subpix(img, self.size, (pxs[i, 0], pxs[i, 1]))
            dq = self.hist.setdefault(int(ids[i]), deque(maxlen=self.depth))
            dq.appendleft(patch)  # newest first (matcher.cpp:263 push_front)
            n += 1
        return n

    def patches(self, point_id: int) -> list[np.ndarray]:
        return list(self.hist.get(int(point_id), ()))

    def strip(self, point_id: int, scale: int = 8) -> np.ndarray | None:
        """Render a point's patch history as one [S*scale, N*S*scale] image
        (the inspector row, main.cpp:199-247)."""
        ps = self.patches(point_id)
        if not ps:
            return None
        s = self.size * scale
        out = np.zeros((s, s * len(ps)), np.float32)
        for i, p in enumerate(ps):
            big = np.repeat(np.repeat(p, scale, 0), scale, 1)
            out[:, i * s:(i + 1) * s] = big
        return out

    def top_ids(self, k: int = 8) -> list[int]:
        """Point ids with the longest histories (most-tracked first)."""
        return [
            pid for pid, _ in sorted(
                self.hist.items(), key=lambda kv: -len(kv[1])
            )[:k]
        ]
