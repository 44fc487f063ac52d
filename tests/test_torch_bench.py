"""The port's headline benchmark (``slam_robot_tpu_torch/bench.py``) and the
bench workload's two diagnostics (``tools/probe_errfresh``,
``tools/probe_seed1``) against the JAX package, on the CPU, at
tests/test_pipeline.CFG (160x120, depth 4, 96 features).

- The JSON line: the port's ``detail`` keys (read from its source with
  ``ast``) are ``bench.py``'s plus ``scan_step_ms_reps`` and the device
  fields, ``err_split``'s keys are ``bench.py``'s.
- ``err_split`` and ``trajectory_error`` on a JAX state carried across by
  ``bridge`` (the JAX package's bench warm, 24 frames), against
  ``bench.py:204-253`` restated here on the JAX state's arrays with the
  JAX package's ``slam_usable`` and ``ate_aligned``: counts equal, px and
  % within 1e-6.
- ``run_scan`` over 2 frames from that state against ``jax.lax.scan`` of
  the JAX ``pipeline.step``, with tests/test_torch_pipeline.py's
  tolerances: tracking-decided fields 1e-4, poses 1 mm and 1e-4, at most
  1 % of flags apart; the per-frame reprojection errors, which BA decides
  and test_torch_pipeline.py leaves out, within 1 % (the packages leave an
  LM solve a few iterations apart: 0.27 % on frame 24).
- ``probe_errfresh.fresh_err`` against ``jax.vmap(project_point)`` on the
  bridged state: 1e-4 px, validity equal.
- ``probe_seed1``: its row keys are the original's (``ast``, on frame 0, a
  keyframe), the corner economy of the frame after the warm equals the
  JAX ``corners`` ops' on the same frame and matches, and the rotation
  fit's reflection sign is +1 or -1 where ``np.sign(det)`` gives 0.
- Without a card, ``bench.main`` and ``python -m
  slam_robot_tpu_torch.bench`` exit non-zero and print no result line.
"""

import ast
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import pipeline as j_pipe
from slam_robot_tpu.ops import corners as j_corners
from slam_robot_tpu.ops import projection as j_proj
from slam_robot_tpu.ops import pyramid as j_pyr
from slam_robot_tpu.utils import benchscene as j_scene
from slam_robot_tpu.utils.dump import ate_aligned as j_ate_aligned
from slam_robot_tpu_torch import bench, bridge
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.tools import probe_errfresh, probe_seed1
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg
from tests.test_torch_localmap import assert_state_close
from tests.test_torch_pipeline import BA_DECIDED

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TCFG = port_cfg(CFG)
N_WARM = 24


def _dict_keys(node: ast.Dict) -> set:
    return {k.value for k in node.keys if isinstance(k, ast.Constant)}


def _find_dict(tree, pred):
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict) and pred(_dict_keys(node)):
            return node
    raise AssertionError("no such dict literal")


def jax_bench_keys() -> tuple[set, set, set]:
    """(top-level keys, detail keys, err_split keys) of bench.py's line."""
    tree = ast.parse(open(os.path.join(ROOT, "bench.py")).read())
    top = _find_dict(tree, lambda k: "detail" in k and "vs_baseline" in k)
    detail = next(v for k, v in zip(top.keys, top.values) if k.value == "detail")
    split = _find_dict(tree, lambda k: "pct_disabled" in k)
    return _dict_keys(top), _dict_keys(detail), _dict_keys(split)


def test_line_keys_are_bench_py_keys():
    top, detail, split = jax_bench_keys()
    assert {"metric", "value", "unit", "vs_baseline", "detail"} == top
    assert {"scan_step_ms", "err_split", "ate_pct_aligned_median3", "n_obs"} <= detail
    tree = ast.parse(open(os.path.join(ROOT, "slam_robot_tpu_torch", "bench.py")).read())
    t_top = _find_dict(tree, lambda k: "detail" in k and "vs_baseline" in k)
    t_detail = next(v for k, v in zip(t_top.keys, t_top.values)
                    if isinstance(k, ast.Constant) and k.value == "detail")
    assert _dict_keys(t_top) == top
    # the device fields come from one ``**_device_fields(dev)`` entry
    spread = [v for k, v in zip(t_detail.keys, t_detail.values) if k is None]
    assert len(spread) == 1 and spread[0].func.id == "_device_fields"
    got = _dict_keys(t_detail)
    assert got - detail == {"scan_step_ms_reps"} and detail - got == {"device"}
    assert _dict_keys(_find_dict(tree, lambda k: "pct_disabled" in k)) == split


@pytest.fixture(scope="module")
def jax_warm():
    """The JAX package's bench warm at CFG (step + maybe_polish, 24 frames)
    and the sweep's next 2 frames."""
    frames = [np.asarray(f) for f in j_scene.make_frames(CFG, N_WARM + 2)]
    ps = j_pipe.init(CFG)
    for i in range(N_WARM):
        ps, _ = j_pipe.step(ps, jnp.asarray(frames[i]), CFG)
        ps = j_pipe.maybe_polish(ps, i, CFG)
    return frames, ps


def _jax_err_split(m):
    """bench.py:204-241 on the JAX map."""
    n = int(m.n_obs)
    errn = np.linalg.norm(np.asarray(m.obs_err[:n]), axis=1)
    dis = np.asarray(m.obs_disabled[:n])
    pu = np.asarray(j_lm.slam_usable(m.point_flags) & m.point_mask)
    usable = (~dis) & pu[np.asarray(m.obs_point[:n]).clip(0)]
    q = {p: (round(float(np.quantile(errn[~dis], p)), 3), round(float(np.quantile(errn[usable], p)), 3))
         for p in (0.5, 0.9, 0.99)}
    return float(np.median(errn[~dis])), {
        "pct_disabled": round(100.0 * float(dis.mean()), 1),
        "mean_enabled_px": round(float(errn[~dis].mean()), 3),
        "mean_disabled_px": round(float(errn[dis].mean()), 3) if dis.any() else 0.0,
        "enabled_quantiles_px": {"p50": q[0.5][0], "p90": q[0.9][0], "p99": q[0.99][0]},
        "n_enabled_usable": int(usable.sum()),
        "usable_quantiles_px": {"p50": q[0.5][1], "p90": q[0.9][1], "p99": q[0.99][1]},
    }


def _close(got, want, tol=1e-6):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            _close(got[k], want[k], tol)
    elif isinstance(want, int):
        assert got == want
    else:
        assert abs(got - want) <= tol, (got, want)


def test_err_split_and_trajectory_error_match_bench_py(jax_warm):
    _, jps = jax_warm
    m = jps.map
    tm = bridge.from_numpy(jps, "cpu").map
    med, split = bench.err_split(tm)
    want_med, want_split = _jax_err_split(m)
    assert split["n_enabled_usable"] > 100 and split["pct_disabled"] > 0
    _close(med, want_med)
    _close(split, want_split)
    # bench.py:242-253
    nf = int(m.n_frames)
    true_t = np.stack([j_scene.sweep_pose(i)[1] for i in range(nf)])
    est_t = np.asarray(m.frame_trans[:nf])
    ate = float(np.sqrt(((est_t - true_t) ** 2).sum(1)).mean())
    path = float(np.linalg.norm(true_t[-1] - true_t[0]))
    want = (ate, 100.0 * ate / path, 100.0 * j_ate_aligned(est_t, true_t) / path)
    got = bench.trajectory_error(tm)
    assert nf == N_WARM and want[0] > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_run_scan_matches_jax_lax_scan(jax_warm):
    frames, jps = jax_warm

    @jax.jit
    def j_scan(ps, imgs):
        def body(ps, img):
            ps, met = j_pipe.step(ps, img, CFG)
            return ps, (met["mean_reproj_err"], met["fast_obs_dropped"]
                        + met["slow_obs_dropped"] + met["reproject_obs_dropped"])

        return jax.lax.scan(body, ps, imgs)

    imgs = np.stack(frames[N_WARM:])
    want_ps, (want_err, want_drops) = j_scan(jps, jnp.asarray(imgs))
    got_ps, (got_err, got_drops) = bench.run_scan(bridge.from_numpy(jps, "cpu"),
                                                  torch.as_tensor(imgs), TCFG)
    assert got_err.shape == (2,) and got_drops.shape == (2,)
    assert got_drops.tolist() == np.asarray(want_drops).tolist() == [0, 0]
    np.testing.assert_allclose(got_err.numpy(), np.asarray(want_err), rtol=1e-2)
    assert_state_close(got_ps, want_ps, atol=1e-4, atol_px=1e-4, skip=BA_DECIDED)
    gm, wm = got_ps.map, want_ps.map
    np.testing.assert_allclose(gm.frame_trans.numpy(), np.asarray(wm.frame_trans), atol=1.0)
    np.testing.assert_allclose(gm.frame_quat.numpy(), np.asarray(wm.frame_quat), atol=1e-4)
    for f in ("point_flags", "obs_disabled", "ring_disabled", "obs_err_valid"):
        g, w = getattr(gm, f).numpy(), np.asarray(getattr(wm, f))
        assert (g != w).mean() <= 0.01, f


def test_fresh_err_matches_jax_projection(jax_warm):
    _, jps = jax_warm
    m = jps.map
    f = m.obs_frame.clip(0)
    p = m.obs_point.clip(0)
    px, want_valid = jax.vmap(j_proj.project_point, in_axes=(0, 0, 0, 0, None))(
        m.frame_quat[f], m.frame_trans[f], m.cam_k[m.frame_cam[f]], m.point_loc[p],
        CFG.cheirality_eps)
    want = np.asarray(jnp.linalg.norm(px - m.obs_px, axis=-1))
    got, valid = probe_errfresh.fresh_err(bridge.from_numpy(jps, "cpu").map, TCFG)
    n = int(m.n_obs)
    assert n > 300 and np.asarray(want_valid)[:n].all()
    np.testing.assert_array_equal(valid.numpy(), np.asarray(want_valid))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def _jax_row_keys() -> set:
    """Keys of tools/probe_seed1.py's per-frame row: its dict literal and
    every ``row[...] =``."""
    tree = ast.parse(open(os.path.join(ROOT, "tools", "probe_seed1.py")).read())
    keys = _dict_keys(_find_dict(tree, lambda k: "lanes_viewed" in k))
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Subscript) and getattr(t.value, "id", "") == "row":
                    keys.add(t.slice.value)
    return keys


def test_probe_seed1_rows_and_corner_economy_match(jax_warm):
    frames, jps = jax_warm
    ps, met = t_pipe.step(t_pipe.init(TCFG, device="cpu"), torch.as_tensor(frames[0]), TCFG)
    row = probe_seed1.frame_row(0, ps, met)
    assert row["kf"] and row["added"] > 5
    row.update(probe_seed1.corner_economy(torch.as_tensor(frames[0]), met, TCFG))
    assert set(row) == _jax_row_keys()
    # frame 0 has no earlier matches to suppress corners: the economy is
    # compared on the frame after the warm, with that frame's matches
    img = frames[N_WARM]
    _, met = t_pipe.step(bridge.from_numpy(jps, "cpu"), torch.as_tensor(img), TCFG)
    row = probe_seed1.corner_economy(torch.as_tensor(img), met, TCFG)
    # the JAX package's corner ops on the same frame and matches (probe_seed1.py:89-102)
    g = j_pyr.build_pyramid(jnp.asarray(img), 1, CFG.blur_sigma0).data[
        0, j_pyr.PAD:-j_pyr.PAD, j_pyr.PAD:-j_pyr.PAD]
    cpts, cval = j_corners.detect(g, CFG.max_corners, CFG.corner_quality, CFG.corner_min_dist)
    occ = j_corners.occupancy_grid(met["feat_px"].numpy(), met["feat_matched"].numpy(),
                                   CFG.image_width, CFG.image_height, CFG.suppress_grid)
    kept = j_corners.suppress_by_grid(cpts, cval, occ, CFG.image_width, CFG.image_height,
                                      CFG.suppress_grid)
    assert row["corners_detected"] == int(np.asarray(cval).sum()) > 0
    assert row["corners_after_grid"] == int(np.asarray(kept).sum())
    assert row["corners_after_grid"] < row["corners_detected"]


def test_probe_seed1_reflection_sign_is_never_zero():
    singular = np.diag([1.0, 1.0, 0.0])
    assert np.sign(np.linalg.det(singular.T @ np.eye(3))) == 0  # the original's sign
    assert probe_seed1.reflection_sign(np.eye(3), singular) == 1.0
    flip = np.diag([1.0, 1.0, -1.0])
    assert probe_seed1.reflection_sign(flip, np.eye(3)) == -1.0
    # a straight-line trajectory: a rank-one fit, still a rotation
    true_t = np.stack([[0.0, 0.0, 10.0 * i] for i in range(8)]).astype(np.float32)
    g = probe_seed1.gauge(1.1 * true_t, true_t)
    assert all(np.isfinite(v) for v in g.values())
    assert abs(g["scale_fit"] - 1 / 1.1) < 1e-4 and g["ate_mm_after_rot_scale"] < 1e-3


def test_bench_without_a_card_exits_nonzero_and_prints_no_line(capsys):
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where torch sees no CUDA device")
    assert bench.main(["--device", "cuda"]) != 0
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err
    res = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.bench"],
                         capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0 and res.stdout == ""
    assert "no CUDA device" in res.stderr
