"""The port's host capture (``io/native``, ``io/v4l2``, ``sources.V4L2Source``)
against the JAX package's, on the CPU.

- ``yuyv_to_bgr`` and ``yuyv_to_grey`` equal the JAX package's exactly, by
  the library route and by the numpy route (the library made unavailable
  in both packages), on a seeded 64x48 YUYV frame.
- ``FrameRing`` hands the frames over unchanged, in order, with their ids,
  and ends with ``(None, -1)``.
- With no camera, ``v4l2.Capture.start`` and ``V4L2Source.init`` are False
  and read nothing, in both packages.
"""

import numpy as np
import pytest

from slam_robot_tpu.io import native as j_native
from slam_robot_tpu.io import sources as j_sources
from slam_robot_tpu.io import v4l2 as j_v4l2
from slam_robot_tpu_torch.io import native as t_native
from slam_robot_tpu_torch.io import sources as t_sources
from slam_robot_tpu_torch.io import v4l2 as t_v4l2

W, H = 64, 48


@pytest.fixture
def yuyv():
    return np.random.default_rng(7).integers(0, 256, size=2 * W * H, dtype=np.uint8)


def test_library_loads_from_the_repository_or_its_build():
    assert t_native.available()
    assert t_native.library_path() in {str(t_native._SHIPPED), str(t_native._BUILT)}


@pytest.mark.parametrize("route", ["library", "numpy"])
def test_yuyv_conversions_equal_jax(yuyv, route, monkeypatch):
    if route == "numpy":
        monkeypatch.setattr(j_native, "load", lambda: None)
        monkeypatch.setattr(t_native, "load", lambda: None)
    else:
        assert j_native.available() and t_native.available()
    bgr = t_native.yuyv_to_bgr(yuyv, W, H)
    assert bgr.shape == (H, W, 3) and bgr.dtype == np.uint8
    np.testing.assert_array_equal(bgr, j_native.yuyv_to_bgr(yuyv, W, H))
    grey = t_native.yuyv_to_grey(yuyv, W, H)
    assert grey.shape == (H, W) and grey.dtype == np.float32
    np.testing.assert_array_equal(grey, j_native.yuyv_to_grey(yuyv, W, H))
    # the routes' arithmetic: integer BGR; luma / 255 (numpy), luma * f32(1/255) (C)
    luma = yuyv.reshape(-1, 2)[:, 0].astype(np.float32)
    want = luma / np.float32(255) if route == "numpy" else luma * np.float32(1 / 255)
    np.testing.assert_array_equal(grey.reshape(-1), want)
    with pytest.raises(ValueError, match="YUYV bytes"):
        t_native.yuyv_to_grey(yuyv[:-4], W, H)


def test_frame_ring_yields_frames_and_ids_in_order():
    rng = np.random.default_rng(3)
    frames = [rng.uniform(size=(H, W)).astype(np.float32) for _ in range(7)]
    it = iter(frames)
    with t_native.FrameRing((H, W), capacity=2, fill=lambda: next(it, None)) as ring:
        got = []
        while True:
            frame, fid = ring.next()
            if frame is None:
                break
            got.append((fid, frame))
        assert ring.next() == (None, -1)
    assert [fid for fid, _ in got] == list(range(7))
    for (_, frame), want in zip(got, frames):
        np.testing.assert_array_equal(frame, want)


def test_frame_ring_refuses_without_the_library(monkeypatch):
    monkeypatch.setattr(t_native, "load", lambda: None)
    with pytest.raises(RuntimeError, match="native library"):
        t_native.FrameRing((H, W), fill=lambda: None)


def test_v4l2_without_a_camera(tmp_path):
    missing = str(tmp_path / "video9")
    for cap in (t_v4l2.Capture(missing), j_v4l2.Capture(missing)):
        assert cap.start() is False and cap.read() is None
        cap.close()
    not_a_camera = tmp_path / "video8"
    not_a_camera.write_bytes(b"")
    for src in (t_sources.V4L2Source(missing), j_sources.V4L2Source(missing),
                t_sources.V4L2Source(str(not_a_camera)),
                j_sources.V4L2Source(str(not_a_camera))):
        assert src.init() is False
        assert src.get(0, 0) is None


def test_builds_the_library_where_the_shipped_one_does_not_load(tmp_path, monkeypatch, yuyv):
    """native/slamio.cpp compiled with native/Makefile's flags into the
    build directory (here a temporary one), nothing written into native/."""
    built = tmp_path / "build" / "native" / "libslamio.so"
    monkeypatch.setattr(t_native, "_SHIPPED", tmp_path / "absent" / "libslamio.so")
    monkeypatch.setattr(t_native, "_BUILT", built)
    for name, value in (("_TRIED", False), ("_LIB", None), ("_PATH", None)):
        monkeypatch.setattr(t_native, name, value)
    assert t_native.available() and t_native.library_path() == str(built)
    assert sorted(p.name for p in built.parent.iterdir()) == ["libslamio.so"]
    np.testing.assert_array_equal(t_native.yuyv_to_bgr(yuyv, W, H),
                                  j_native.yuyv_to_bgr(yuyv, W, H))
