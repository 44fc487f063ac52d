"""Frame sources: the ImageSource strategy hierarchy (video.h:14-105).

Port of ``slam_robot_tpu/io/sources.py``:

- ``FileSource``        replay `%08d.npy` (or .png) directories, the
                        reference's --load path (video.h:24-38)
- ``VideoSource``       a video file through cv2.VideoCapture (video.h:41-62)
- ``DuoSource``         two sources alternated by camera index (video.h:65-86)
- ``SyntheticSource``   frames rendered from a landmark world along a
                        scripted trajectory, on a torch device
- ``V4L2Source``        live capture through the native library's V4L2
                        shim (``io/v4l2``, video.cpp:255-340)
- ``prefetch``          a double-buffering iterator that overlaps host
                        decode with device compute

All sources yield float32 [H, W] grey or [H, W, 3] numpy images via
``get(camera, frame_id)``, None at the end of the stream. PIL (``.png``)
and cv2 (``VideoSource``) are imported only when used; ``.npy`` replay
needs neither.
"""

from __future__ import annotations

import os
import queue
import threading

import numpy as np
import torch

from slam_robot_tpu_torch.device import default_device


def _require(module: str, use: str):
    """Import ``module`` for ``use``, or raise ImportError saying why."""
    try:
        return __import__(module)
    except ImportError as e:
        raise ImportError(
            f"{use} needs the '{module}' module, which is not installed: {e}. "
            "Record and replay .npy frames instead (Recorder(fmt='npy'))."
        ) from e


class FileSource:
    """Replay a directory of %08d.npy / %08d.png frames (video.h:24-38)."""

    def __init__(self, directory: str):
        self.dir = directory

    def init(self) -> bool:
        return os.path.isdir(self.dir)

    def get(self, camera: int, frame_id: int):
        base = os.path.join(self.dir, f"{frame_id:08d}")
        if os.path.exists(base + ".npy"):
            return np.load(base + ".npy")
        if os.path.exists(base + ".png"):
            _require("PIL", "reading .png frames")
            from PIL import Image

            img = np.asarray(Image.open(base + ".png"))
            if img.dtype == np.uint8:
                img = img.astype(np.float32) / 255.0
            if img.ndim == 3:
                img = img @ np.array([0.299, 0.587, 0.114], np.float32)
            return img.astype(np.float32)
        return None


class VideoSource:
    """Video-file / camera source via cv2.VideoCapture (video.h:41-62). Each
    call returns the stream's next frame; camera and frame ids are ignored,
    so two VideoSources in a DuoSource replay two files as a fake stereo
    rig, as main.cpp:456-460 does. Width 640 and 10 fps are set as the
    reference sets them (video.h:50-51); a file stream ignores both."""

    def __init__(self, path_or_cam, width: int = 640, fps: int = 10):
        self._arg = path_or_cam
        self._width = width
        self._fps = fps
        self._cap = None

    def init(self) -> bool:
        cv2 = _require("cv2", "VideoSource")
        self._cap = cv2.VideoCapture(self._arg)
        if not self._cap.isOpened():
            print(f"Failed to open video file: {self._arg}")
            return False
        self._cap.set(cv2.CAP_PROP_FRAME_WIDTH, self._width)
        self._cap.set(cv2.CAP_PROP_FPS, self._fps)
        return True

    def get(self, camera: int, frame_id: int):
        if self._cap is None and not self.init():
            return None
        ok, img = self._cap.read()
        if not ok:
            return None
        if img.ndim == 3:  # cv2 gives BGR; grey with hessian.h:100 weights
            img = img @ np.array([0.114, 0.587, 0.299], np.float32)
        return img.astype(np.float32) / 255.0


class DuoSource:
    """Alternate two sources by camera index (video.h:65-86)."""

    def __init__(self, src0, src1):
        self.srcs = (src0, src1)

    def init(self) -> bool:
        return self.srcs[0].init() and self.srcs[1].init()

    def get(self, camera: int, frame_id: int):
        return self.srcs[camera].get(camera, frame_id)


class SyntheticSource:
    """Render frames from a landmark world along a trajectory, on ``device``
    (default: the CUDA card), returned as host numpy arrays.

    Emulates the reference's rig: two cameras ``baseline_mm`` apart along
    local x, frames alternating between them (main.cpp:474-507). The world
    and the poses follow the JAX package's ``SyntheticSource`` draw for
    draw; frames agree with it to the renderer's accumulation order."""

    def __init__(self, cfg, n_frames: int = 60, seed: int = 0,
                 yaw_rate: float = 0.004, step_mm: float = 15.0,
                 n_points: int = 500, device=None):
        from slam_robot_tpu_torch.models import renderer
        from slam_robot_tpu_torch.ops import quaternion as quat
        from slam_robot_tpu_torch.utils import synthetic as syn

        dev = default_device(device)
        self.cfg = cfg
        self.n_frames = n_frames
        world, bright = renderer.make_world(n_points, seed)
        self.world = torch.as_tensor(world, device=dev)
        self.bright = torch.as_tensor(bright, device=dev)
        self.k = torch.as_tensor(syn.reference_intrinsics(cfg), device=dev)
        axis = torch.tensor([0.0, 1.0, 0.0], device=dev)
        qs, ts = [], []
        for i in range(n_frames):
            pair = i // 2
            q = quat.from_axis_angle(axis, yaw_rate * pair)
            center = torch.tensor([0.0, 0.0, step_mm * pair], device=dev)
            off = quat.rotate_inverse(
                q, torch.tensor([cfg.baseline_mm * (i % 2), 0.0, 0.0], device=dev))
            qs.append(q)
            ts.append(center + off)
        self.true_quat = torch.stack(qs) if qs else torch.zeros((0, 4), device=dev)
        self.true_trans = torch.stack(ts) if ts else torch.zeros((0, 3), device=dev)
        self._renderer = renderer

    def init(self) -> bool:
        return True

    def get(self, camera: int, frame_id: int):
        if frame_id >= self.n_frames:
            return None
        img = self._renderer.render(
            self.true_quat[frame_id], self.true_trans[frame_id], self.k,
            self.world, self.bright,
            height=self.cfg.image_height, width=self.cfg.image_width,
        )
        return img.cpu().numpy()


class V4L2Source:
    """Live V4L2 capture through the native shim (video.cpp:255-340).

    Functional only on a host with ``/dev/video*``: ``init()`` is False
    where the device node is missing or cannot be opened (on a host with no
    camera, the only answer that can be run), and ``get`` returns a grey
    f32 [h, w] frame or None. Everything else replays with ``FileSource``,
    the reference's own test strategy."""

    def __init__(self, device: str = "/dev/video0", width: int = 640, height: int = 480):
        self.device = device
        self.width = width
        self.height = height
        self._cap = None

    def init(self) -> bool:
        if not os.path.exists(self.device):
            return False
        from slam_robot_tpu_torch.io import v4l2

        cap = v4l2.Capture(self.device, self.width, self.height)
        if not cap.start():
            return False
        self._cap = cap
        return True

    def get(self, camera: int, frame_id: int):
        if self._cap is None:
            return None
        return self._cap.read()


def prefetch(source, cameras: int = 2, depth: int = 2):
    """Double-buffered frame iterator: a reader thread decodes ahead while
    the device computes (replaces the reference's fbuffer/DQBUF blocking).

    Yields (camera, frame_id, image); stops at end of stream. An exception
    raised by ``source.get`` in the reader is raised again here, so a
    failing source stops the loop instead of leaving it waiting. Closing
    the iterator early (a loop that breaks) stops the reader."""
    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()

    def reader():
        fid = 0
        cam = 0
        while not stop.is_set():
            cam ^= 1 if cameras == 2 else 0
            try:
                img = source.get(cam, fid)
            except BaseException as e:  # handed to the consumer, raised there
                q.put(e)
                return
            q.put((cam, fid, img))
            if img is None:
                return
            fid += 1

    t = threading.Thread(target=reader, daemon=True)
    t.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, BaseException):
                raise item
            cam, fid, img = item
            if img is None:
                return
            yield cam, fid, img
    finally:
        stop.set()
        while t.is_alive():  # free a reader blocked on a full queue
            try:
                q.get(timeout=0.01)
            except queue.Empty:
                pass
