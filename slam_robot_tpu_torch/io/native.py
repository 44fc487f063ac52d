"""ctypes binding of the native slamio library (``native/slamio.cpp``).

Port of ``slam_robot_tpu/io/native.py``: the C implementations of the
host-side capture paths (YUYV pixel conversion, the threaded frame ring
buffer, V4L2 capture), with the JAX package's numpy route for the
conversions on a host where the library is absent.

The library is ``native/libslamio.so`` as the repository ships it. Where
that file does not load on a host (another C library, another machine
type), :func:`load` builds ``native/slamio.cpp`` with ``native/Makefile``'s
flags into ``build/native/`` and loads that; it never writes into
``native/``. :func:`available` says whether the library route runs, and
:func:`library_path` which file it loaded.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

_ROOT = Path(__file__).resolve().parents[2]
_SHIPPED = _ROOT / "native" / "libslamio.so"
_SOURCE = _ROOT / "native" / "slamio.cpp"
_BUILT = _ROOT / "build" / "native" / "libslamio.so"
# native/Makefile: CXXFLAGS ?= -O3 -fPIC -std=c++17 -Wall -Wextra,
# LDFLAGS ?= -shared -pthread
_CXXFLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra")
_LDFLAGS = ("-shared", "-pthread")

_LIB = None
_PATH: str | None = None
_TRIED = False


def _open(path) -> ctypes.CDLL | None:
    try:
        return ctypes.CDLL(str(path))
    except OSError:
        return None


def _build() -> Path | None:
    """Compile native/slamio.cpp into build/native/; None without a C++
    compiler or when the compile fails."""
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None or not _SOURCE.exists():
        return None
    _BUILT.parent.mkdir(parents=True, exist_ok=True)
    tmp = _BUILT.with_name(f"libslamio.{os.getpid()}.so")
    res = subprocess.run([cxx, *_CXXFLAGS, str(_SOURCE), "-o", str(tmp), *_LDFLAGS],
                         capture_output=True, text=True, timeout=300)
    if res.returncode != 0:
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, _BUILT)
    return _BUILT


def _declare(lib: ctypes.CDLL) -> ctypes.CDLL:
    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    lib.yuyv_to_bgr.argtypes = [u8p, ctypes.c_int, u8p]
    lib.yuyv_to_bgr.restype = None
    lib.yuyv_to_grey.argtypes = [u8p, ctypes.c_int, f32p]
    lib.yuyv_to_grey.restype = None
    lib.bgr_to_grey.argtypes = [u8p, ctypes.c_int, f32p]
    lib.bgr_to_grey.restype = None
    lib.ring_create.restype = ctypes.c_void_p
    lib.ring_create.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.ring_start.restype = None
    lib.ring_start.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ring_next.restype = ctypes.c_int
    lib.ring_next.argtypes = [ctypes.c_void_p, f32p]
    lib.ring_destroy.restype = None
    lib.ring_destroy.argtypes = [ctypes.c_void_p]
    if hasattr(lib, "v4l2_open"):
        lib.v4l2_open.restype = ctypes.c_void_p
        lib.v4l2_open.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 4
        lib.v4l2_read_grey.restype = ctypes.c_int
        lib.v4l2_read_grey.argtypes = [ctypes.c_void_p, f32p]
        lib.v4l2_close.restype = None
        lib.v4l2_close.argtypes = [ctypes.c_void_p]
    return lib


def load() -> ctypes.CDLL | None:
    """The library, loaded once: the shipped file, one built earlier into
    build/native/, or one built now; None where none loads."""
    global _LIB, _PATH, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    for path in (_SHIPPED, _BUILT):
        lib = _open(path) if path.exists() else None
        if lib is not None:
            break
    else:
        path = _build()
        lib = _open(path) if path is not None else None
    if lib is not None:
        _LIB, _PATH = _declare(lib), str(path)
    return _LIB


def available() -> bool:
    """True where the library route runs, False where the numpy route does."""
    return load() is not None


def library_path() -> str | None:
    """The file the library was loaded from, None where it is absent."""
    load()
    return _PATH


def _u8p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def _f32p(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _yuyv_bytes(yuyv, width: int, height: int) -> np.ndarray:
    yuyv = np.ascontiguousarray(yuyv, np.uint8).reshape(-1)
    if yuyv.size != 2 * width * height:
        raise ValueError(f"{yuyv.size} YUYV bytes for a {width}x{height} frame "
                         f"(want {2 * width * height})")
    return yuyv


def yuyv_to_bgr(yuyv: np.ndarray, width: int, height: int) -> np.ndarray:
    """YUYV bytes -> BGR888 [h,w,3] u8 (video.cpp:187-223 integer math)."""
    yuyv = _yuyv_bytes(yuyv, width, height)
    lib = load()
    if lib is not None:
        out = np.empty(height * width * 3, np.uint8)
        lib.yuyv_to_bgr(_u8p(yuyv), yuyv.size, _u8p(out))
        return out.reshape(height, width, 3)
    p = yuyv.reshape(-1, 4).astype(np.int32)
    y = np.stack([p[:, 0], p[:, 2]], axis=1)  # [n,2]
    cb = ((p[:, 1] - 128) * 454) >> 8
    cg = ((p[:, 1] - 128) * 88 + (p[:, 3] - 128) * 183) >> 8
    cr = ((p[:, 3] - 128) * 359) >> 8
    b = np.clip(y + cb[:, None], 0, 255)
    g = np.clip(y - cg[:, None], 0, 255)
    r = np.clip(y + cr[:, None], 0, 255)
    return np.stack([b, g, r], axis=-1).astype(np.uint8).reshape(height, width, 3)


def yuyv_to_grey(yuyv: np.ndarray, width: int, height: int) -> np.ndarray:
    """YUYV bytes -> grey f32 [h,w] in [0,1] (luma only). The library
    multiplies by float32(1/255), the numpy route divides by 255: they
    differ by one ulp on about half the byte values, as in the JAX
    package."""
    yuyv = _yuyv_bytes(yuyv, width, height)
    lib = load()
    if lib is not None:
        out = np.empty(height * width, np.float32)
        lib.yuyv_to_grey(_u8p(yuyv), yuyv.size, _f32p(out))
        return out.reshape(height, width)
    return (yuyv.reshape(-1, 2)[:, 0].astype(np.float32) / 255.0).reshape(height, width)


class FrameRing:
    """Native threaded prefetch ring over a Python frame callback.

    ``fill()`` returns the next frame (anything numpy turns into ``shape``
    f32 values) or None at the end; the library's reader thread calls it
    through a ctypes callback and keeps up to ``capacity`` frames ahead.
    :meth:`next` returns (frame, id), then (None, -1) at the end. Raises
    RuntimeError where the library is absent."""

    _FILL = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_void_p, ctypes.POINTER(ctypes.c_float))

    def __init__(self, frame_shape, capacity: int = 4, fill=None):
        self.shape = tuple(frame_shape)
        self.n = int(np.prod(self.shape))
        lib = load()
        if lib is None:
            raise RuntimeError("the native library is absent and could not be built "
                               "(make -C native)")
        self.lib = lib
        self.ring = lib.ring_create(capacity, self.n)

        def _fill(_ctx, dst):
            frame = fill()
            if frame is None:
                return 0
            np.ctypeslib.as_array(dst, shape=(self.n,))[:] = (
                np.asarray(frame, np.float32).reshape(-1))
            return 1

        self._cb = self._FILL(_fill)  # kept alive while the reader thread runs
        lib.ring_start(self.ring, ctypes.cast(self._cb, ctypes.c_void_p), None)

    def next(self):
        out = np.empty(self.n, np.float32)
        fid = self.lib.ring_next(self.ring, _f32p(out))
        if fid < 0:
            return None, -1
        return out.reshape(self.shape), fid

    def close(self) -> None:
        """Stop the reader thread (it runs the source to its end first: the
        library's reader stops only when ``fill`` returns None) and free
        the ring."""
        ring, self.ring = getattr(self, "ring", None), None
        if ring:
            self.lib.ring_destroy(ring)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        self.close()
