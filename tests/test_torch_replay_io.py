"""The replay driver's host side against the JAX package: the seeded world,
the synthetic source, the recorder and file/video sources, the prefetch
iterator, the histogram, the metrics log, the scope timer and the patch
history.

Tolerances: ``make_world``, recorded and replayed frames, video frames,
histograms and metrics logs exactly; ``SyntheticSource`` poses atol 1e-6
(float32 quaternion ops in another order) and frames atol 1e-5 (the
renderer's, tests/test_torch_scene.py); patch-history strips atol 1e-6
against ``cv2.getRectSubPix`` (bilinear taps in float32).
"""

import numpy as np
import pytest
import torch

from slam_robot_tpu.io import recorder as j_recorder
from slam_robot_tpu.io import sources as j_sources
from slam_robot_tpu.models import renderer as j_render
from slam_robot_tpu.utils import histogram as j_hist
from slam_robot_tpu.utils import metrics as j_metrics
from slam_robot_tpu.utils import patch_history as j_phist
from slam_robot_tpu.utils import timer as j_timer
from slam_robot_tpu_torch.io import recorder as t_recorder
from slam_robot_tpu_torch.io import sources as t_sources
from slam_robot_tpu_torch.models import renderer as t_render
from slam_robot_tpu_torch.utils import histogram as t_hist
from slam_robot_tpu_torch.utils import metrics as t_metrics
from slam_robot_tpu_torch.utils import patch_history as t_phist
from slam_robot_tpu_torch.utils import timer as t_timer
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)


@pytest.mark.parametrize("seed,n", [(0, 500), (3, 64)])
def test_make_world_matches(seed, n):
    tw, tb = t_render.make_world(n, seed)
    jw, jb = j_render.make_world(n, seed)
    assert tw.dtype == np.float32 and tw.shape == (n, 4)
    np.testing.assert_array_equal(tw, np.asarray(jw))
    np.testing.assert_array_equal(tb, np.asarray(jb))


def test_synthetic_source_matches():
    kw = dict(n_frames=8, n_points=400, step_mm=18.0, yaw_rate=0.06)
    t_src = t_sources.SyntheticSource(TCFG, device="cpu", **kw)
    j_src = j_sources.SyntheticSource(CFG, **kw)
    assert t_src.init() and j_src.init()
    np.testing.assert_allclose(t_src.true_quat.numpy(), np.asarray(j_src.true_quat), atol=1e-6)
    np.testing.assert_allclose(t_src.true_trans.numpy(), np.asarray(j_src.true_trans),
                               atol=1e-6, rtol=1e-6)
    for i in (0, 1, 7):
        got, want = t_src.get(i % 2, i), j_src.get(i % 2, i)
        assert isinstance(got, np.ndarray) and got.dtype == np.float32
        assert got.shape == (CFG.image_height, CFG.image_width)
        np.testing.assert_allclose(got, want, atol=1e-5)
    assert t_src.get(0, 8) is None


@pytest.mark.parametrize("fmt", ["npy", "png"])
def test_recorder_and_file_source_round_trip(tmp_path, fmt):
    """Both recorders write the same files; each package's FileSource
    reads the other's."""
    if fmt == "png":
        pytest.importorskip("PIL")
    rng = np.random.default_rng(1)
    frames = [rng.uniform(0, 1, size=(24, 32)).astype(np.float32) for _ in range(5)]
    dirs = {}
    for name, mod in (("port", t_recorder), ("jax", j_recorder)):
        rec = mod.Recorder(str(tmp_path / name), fmt=fmt)
        for i, f in enumerate(frames):
            rec.save(i, f)
        rec.close()
        dirs[name] = tmp_path / name
    for i in range(len(frames)):
        fname = f"{i:08d}.{fmt}"
        assert (dirs["port"] / fname).read_bytes() == (dirs["jax"] / fname).read_bytes()
    t_src = t_sources.FileSource(str(dirs["jax"]))
    j_src = j_sources.FileSource(str(dirs["port"]))
    assert t_src.init() and j_src.init()
    assert not t_sources.FileSource(str(tmp_path / "missing")).init()
    for i, f in enumerate(frames):
        got, want = t_src.get(i % 2, i), j_src.get(i % 2, i)
        np.testing.assert_array_equal(got, want)
        if fmt == "npy":
            np.testing.assert_array_equal(got, f)
    assert t_src.get(0, len(frames)) is None


def test_prefetch_matches_and_forwards_source_errors(tmp_path):
    rec = t_recorder.Recorder(str(tmp_path), fmt="npy")
    for i in range(5):
        rec.save(i, np.full((4, 6), i, np.float32))
    rec.close()
    got = list(t_sources.prefetch(t_sources.FileSource(str(tmp_path))))
    want = list(j_sources.prefetch(j_sources.FileSource(str(tmp_path))))
    assert [(c, f) for c, f, _ in got] == [(c, f) for c, f, _ in want] == \
        [(1, 0), (0, 1), (1, 2), (0, 3), (1, 4)]
    for (_, _, a), (_, _, b) in zip(got, want):
        np.testing.assert_array_equal(a, b)

    class Failing:
        def get(self, camera, frame_id):
            if frame_id == 2:
                raise OSError("camera unplugged")
            return np.zeros((4, 6), np.float32)

    it = t_sources.prefetch(Failing())
    assert [f for _, f, _ in [next(it), next(it)]] == [0, 1]
    with pytest.raises(OSError, match="unplugged"):
        next(it)


def test_video_source_and_duo_match(tmp_path):
    pytest.importorskip("cv2")
    from tests.test_video_source import write_videos

    paths = write_videos(tmp_path, n_pairs=2)
    t_duo = t_sources.DuoSource(t_sources.VideoSource(paths[0]),
                                t_sources.VideoSource(paths[1]))
    j_duo = j_sources.DuoSource(j_sources.VideoSource(paths[0]),
                                j_sources.VideoSource(paths[1]))
    assert t_duo.init() and j_duo.init()
    for i in range(4):
        got, want = t_duo.get(i % 2, i), j_duo.get(i % 2, i)
        assert got.shape == (120, 160) and got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert t_duo.get(0, 4) is None and t_duo.get(1, 5) is None
    assert not t_sources.VideoSource(str(tmp_path / "missing.avi")).init()


def test_histogram_matches():
    rng = np.random.default_rng(2)
    vals = rng.uniform(-3, 40, size=200)
    t, j = t_hist.Histogram(12, 2.5), j_hist.Histogram(12, 2.5)
    for v in vals[:50]:
        t.add(v)
        j.add(v)
    t.add_many(vals[50:])
    j.add_many(vals[50:])
    np.testing.assert_array_equal(t.counters, j.counters)
    assert [t.bucket(n) for n in range(12)] == [j.bucket(n) for n in range(12)]
    assert str(t) == str(j) and t.bucket(0) > 0 and t.bucket(11) > 0


def test_metrics_log_matches(tmp_path):
    rng = np.random.default_rng(3)
    t, j = t_metrics.MetricsLog(), j_metrics.MetricsLog()
    for i in range(6):
        m = {"n_matches": np.int32(rng.integers(10, 50)),
             "mean_reproj_err": np.float32(rng.uniform(0, 3)),
             "fast_iters": np.int32(i), "slow_iters": np.int32(2 * i),
             "is_keyframe": np.bool_(i % 3 == 0),
             "feat_px": rng.uniform(size=(8, 2)).astype(np.float32)}
        t.append({k: torch.as_tensor(v) for k, v in m.items()})
        j.append(m)
    assert t.rows == j.rows and "feat_px" not in t.rows[0]
    assert t.summary() == j.summary() and t.summary()["keyframes"] == 2
    assert str(t.error_histogram(6, 0.5)) == str(j.error_histogram(6, 0.5))
    t.to_jsonl(str(tmp_path / "t.jsonl"))
    j.to_jsonl(str(tmp_path / "j.jsonl"))
    assert (tmp_path / "t.jsonl").read_bytes() == (tmp_path / "j.jsonl").read_bytes()
    assert t_metrics.MetricsLog().summary() == {}


def test_scoped_timer_reports_like_jax():
    got, want = [], []
    x = torch.ones(3)
    with t_timer.ScopedTimer("step", sink=got.append, block_on=[x * 2]) as tt:
        pass
    with j_timer.ScopedTimer("step", sink=want.append) as jt:
        pass
    assert got[0].startswith("TIMER: step: ") and want[0].startswith("TIMER: step: ")
    assert float(got[0].split()[-1]) == tt.elapsed >= 0.0 and jt.elapsed >= 0.0


def test_patch_history_matches_cv2_version():
    pytest.importorskip("cv2")
    rng = np.random.default_rng(4)
    h, w = 60, 80
    ids = np.array([3, 7, -1, 9, 3, 11, 12, 13], np.int32)
    t, j = t_phist.PatchHistory(13, depth=3), j_phist.PatchHistory(13, depth=3)
    for _ in range(4):
        img = rng.uniform(0, 1, size=(h, w)).astype(np.float32)
        # interior, sub-pixel, and patches crossing the left, top, bottom
        # and right edges (one edge at a time)
        px = np.array([[40.3, 30.7], [2.2, 30.5], [50.0, 50.0], [40.0, 1.6],
                       [41.9, 57.25], [77.5, 30.1], [0.0, 59.0], [6.0, 6.0]], np.float32)
        px[:, :2] += rng.uniform(-0.4, 0.4, size=(8, 2)).astype(np.float32)
        matched = np.array([1, 1, 1, 1, 1, 1, 1, 0], bool)
        assert t.update(torch.as_tensor(img), torch.as_tensor(ids), torch.as_tensor(px),
                        torch.as_tensor(matched)) == j.update(img, ids, px, matched) == 6
    assert sorted(t.hist) == sorted(j.hist) == [3, 7, 9, 11, 12]
    assert t.top_ids(2) == j.top_ids(2) == [3, 7]
    for pid in t.hist:
        assert len(t.patches(pid)) == len(j.patches(pid)) <= 3
        np.testing.assert_allclose(t.strip(pid, scale=2), j.strip(pid, scale=2), atol=1e-6)
    assert t.strip(99) is None


def test_rect_subpix_replicates_the_nearest_edge_in_a_corner():
    """Above the image and past its right edge at once, every outside pixel
    takes its nearest edge pixel (cv2.getRectSubPix takes column W-2 there;
    the port keeps the one rule everywhere)."""
    img = np.arange(20 * 30, dtype=np.float32).reshape(20, 30)
    patch = t_phist.rect_subpix(img, 13, (29.0, 0.0))
    np.testing.assert_array_equal(patch[:7, 6:], np.full((7, 7), img[0, 29]))
    np.testing.assert_array_equal(patch[6:, :7], img[:7, 23:30])
