"""V4L2 capture through the native library (video.cpp:255-340 rebuilt).

Port of ``slam_robot_tpu/io/v4l2.py``. Usable only on a Linux host with a
camera at ``/dev/video*``; record and replay (``sources.FileSource``) is
the hardware-free path, as it is the reference's own test strategy. On a
host with no camera (the machines this port is tested and run on) only the
no-device answer can be exercised: :meth:`Capture.start` returns False.
"""

from __future__ import annotations

import ctypes

import numpy as np

from slam_robot_tpu_torch.io import native


class Capture:
    """A V4L2 device opened at ``width`` x ``height`` YUYV, ``fps``, with
    ``num_buffers`` mmap buffers; :meth:`read` gives grey f32 frames."""

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, fps: int = 5, num_buffers: int = 4):
        self.device = device
        self.width = width
        self.height = height
        self.fps = fps
        self.num_buffers = num_buffers
        self._lib = None
        self._cap = None

    def start(self) -> bool:
        """Open and start streaming; False where the library or its V4L2
        part is absent, or the device cannot be opened."""
        lib = native.load()
        if lib is None or not hasattr(lib, "v4l2_open"):
            return False
        self._lib = lib
        self._cap = lib.v4l2_open(self.device.encode(), self.width, self.height, self.fps,
                                  self.num_buffers)
        return bool(self._cap)

    def read(self):
        """Grey f32 [h,w] frame in [0,1], or None."""
        if not self._cap:
            return None
        out = np.empty(self.height * self.width, np.float32)
        if not self._lib.v4l2_read_grey(self._cap,
                                        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float))):
            return None
        return out.reshape(self.height, self.width)

    def close(self) -> None:
        cap, self._cap = getattr(self, "_cap", None), None
        if cap:
            self._lib.v4l2_close(cap)

    def __del__(self):
        self.close()
