"""The BAL-shaped generator: exact counts, tracks of at least 2 with BAL's
mean, Ladybug's runs of consecutive cameras, every row in view at the true
values, the same seed giving the same tables, and every seed the same
graph."""

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.gen import bal
from benchmark.reference import geometry as geo
from benchmark.tests.tiny import tiny_config

CELLS = ("ladybug1723.full", "venice1778.full")
ANCHORS = 2
SEED = 2**31 + 11


def _generate(cfg, seed=SEED):
    return bal.generate(cfg, ANCHORS, seed, "cpu")


@pytest.mark.parametrize("cell", CELLS)
def test_the_configurations_state_bal_counts_and_cut_nothing(cell):
    cfg = spec.load_cell(cell)["config"]
    want = {"bal_ladybug_1723": (1723, 156502, 678718),
            "bal_venice_1778": (1778, 993923, 5001946)}[cfg["name"]]
    assert (cfg["cameras"], cfg["points"], cfg["observations"]) == want
    assert cfg["reduced"] == [] and "assumed" in cfg
    assert cfg["name"].split("_")[1] in cfg["source"].lower()


@pytest.mark.parametrize("n_points, n_obs, cap", [(156502, 678718, 64), (993923, 5001946, 256),
                                                  (2000, 9000, 16)])
def test_track_lengths_sum_exactly_with_the_mean(n_points, n_obs, cap):
    L = bal.track_lengths(n_points, n_obs, cap, 1.5)
    assert L.shape == (n_points,) and int(L.sum()) == n_obs
    assert L.min() == 2 and L.max() <= cap
    np.testing.assert_array_equal(L, bal.track_lengths(n_points, n_obs, cap, 1.5))
    assert np.mean(L > 8) > 0.01        # a tail past the point side's pad


@pytest.mark.parametrize("cell", CELLS)
def test_counts_tracks_and_view(cell):
    cfg = tiny_config(cell)
    C, P, O = cfg["cameras"], cfg["points"], cfg["observations"]
    d = _generate(cfg)
    assert d["frame_quat"].shape == (C, 4) and d["point_loc"].shape == (P, 4)
    assert d["obs_frame"].shape == (O,) and d["obs_px"].shape == (O, 2)
    assert bool(d["obs_ok"].all()) and d["free_frame"].tolist() == [False] * 2 + [True] * (C - 2)
    f, p = d["obs_frame"].long(), d["obs_point"].long()
    track = torch.bincount(p, minlength=P)
    assert int(track.min()) >= 2 and int(track.sum()) == O
    # BAL's row order: by point, cameras ascending and distinct within a point
    same = p[1:] == p[:-1]
    assert bool((p[1:] >= p[:-1]).all()) and bool((f[1:][same] > f[:-1][same]).all())
    if cfg["graph"] == "sequential":
        assert bool((f[1:][same] == f[:-1][same] + 1).all())
    # in front and inside the image by the margin, at the true values
    R = geo.rotation_matrix(d["true_quat"])
    pc = geo.to_camera(R[f], d["true_trans"][f], d["true_points"][p], geo.Precision(torch.float32))
    px = geo.pixel(pc, d["cam_k"].expand(O, 7))
    margin = cfg["assumed"]["scene"]["margin_px"]
    w, h = cfg["assumed"]["image"]
    assert float(pc[:, 2].min()) > cfg["assumed"]["scene"]["z_min_mm"]
    assert float(px[:, 0].min()) > margin and float(px[:, 0].max()) < w - margin
    assert float(px[:, 1].min()) > margin and float(px[:, 1].max()) < h - margin
    # the observed pixels carry the configuration's noise
    noise = (d["obs_px"] - px).std().item()
    assert 0.8 * cfg["assumed"]["noise"]["pixel"] < noise < 1.2 * cfg["assumed"]["noise"]["pixel"]


@pytest.mark.parametrize("cell", CELLS)
def test_a_seed_gives_the_same_tables(cell):
    cfg = tiny_config(cell)
    a, b, c = _generate(cfg), _generate(cfg), _generate(cfg, SEED + 1)
    for k in a:
        assert torch.equal(a[k], b[k]), k
    assert not torch.equal(a["point_loc"], c["point_loc"])
    assert not torch.equal(a["frame_trans"], c["frame_trans"])
    # every seed poses the same work: the configuration's graph
    assert torch.equal(a["obs_frame"], c["obs_frame"])
    assert torch.equal(a["obs_point"], c["obs_point"])


def test_ladybug_at_full_size():
    cfg = spec.load_cell("ladybug1723.full")["config"]
    d = _generate(cfg)
    O = cfg["observations"]
    assert d["obs_frame"].shape == (O,) and int(d["obs_point"].max()) == cfg["points"] - 1
    deg = torch.bincount(d["obs_frame"].long(), minlength=cfg["cameras"])
    # about two thirds of the rows lie past the frame side's 128-row pad
    assert 0.55 < float((deg - 128).clamp(min=0).sum()) / O < 0.8
