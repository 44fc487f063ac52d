"""The port's live and checked step variants, and the replay driver's
state-reading utilities, against the JAX package on one bridged state.

The port takes four steps from ``pipeline.init`` on tests/test_pipeline.CFG
frames (CPU, one thread, so every rerun is bit-identical); the JAX package
gets those states through ``bridge.to_numpy``, rebuilt field by field.

Tolerances:
- ``step_live``'s packed row against the JAX ``step_live``'s, from the same
  state and frame, as tests/test_torch_pipeline.py holds a full step:
  what tracking decides (matches, keyframe, points added, map size,
  dropped rows) equal; what BA decides (LM iterations, the last mean
  reprojection error, the canary) is not compared, since the two packages
  leave each LM loop a few iterations apart, but the canary must stay
  below 0.1 px on both sides.
- ``step_live_ring``, ``checked_step``: against the port's own ``step``,
  exactly.
- ``dump_map`` files byte for byte; ``trajectory`` and ``ate`` exactly;
  ``draw_debug`` and ``patch_strip`` images exactly; checkpoints exactly.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from slam_robot_tpu.io import sources as j_sources
from slam_robot_tpu.models import localmap as j_lm
from slam_robot_tpu.models import matcher as j_matcher
from slam_robot_tpu.models import pipeline as j_pipe
from slam_robot_tpu.utils import checkpoint as j_ckpt
from slam_robot_tpu.utils import debug_draw as j_draw
from slam_robot_tpu.utils import dump as j_dump
from slam_robot_tpu_torch import bridge
from slam_robot_tpu_torch.models import pipeline as t_pipe
from slam_robot_tpu_torch.utils import checkpoint as t_ckpt
from slam_robot_tpu_torch.utils import debug_draw as t_draw
from slam_robot_tpu_torch.utils import dump as t_dump
from slam_robot_tpu_torch.utils import numerics
from tests.test_pipeline import CFG, scaled_intrinsics
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)
N_FRAMES = 4
TRACKING_DECIDED = ("n_matches", "is_keyframe", "slow_ok", "n_points", "n_added",
                    "fast_obs_dropped", "slow_obs_dropped", "reproject_obs_dropped")


def leaves(state) -> list[torch.Tensor]:
    out = []
    for v in state:
        out.extend(leaves(v) if isinstance(v, tuple) else [v])
    return out


def states_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(leaves(a), leaves(b)))


def to_jax(ps: t_pipe.PipelineState) -> j_pipe.PipelineState:
    """The JAX package's PipelineState holding a port state's values."""
    n = bridge.to_numpy(ps)

    def conv(kind, sub):
        return kind(**{f: jnp.asarray(v) for f, v in sub._asdict().items()})

    return j_pipe.PipelineState(
        map=conv(j_lm.MapState, n.map), matcher=conv(j_matcher.MatcherState, n.matcher),
        camera=jnp.asarray(n.camera), total_ba_iters=jnp.asarray(n.total_ba_iters),
        last_error=jnp.asarray(n.last_error))


@pytest.fixture(scope="module")
def port_run():
    """Frames, the port's states before and after each frame, its metrics."""
    src = j_sources.SyntheticSource(CFG, n_frames=N_FRAMES, n_points=400, step_mm=18.0,
                                    yaw_rate=0.06)
    frames = [torch.as_tensor(np.array(src.get(i % 2, i))) for i in range(N_FRAMES)]
    ps = t_pipe.init(TCFG, scaled_intrinsics(CFG), "cpu")
    states, mets = [ps], []
    for img in frames:
        ps, m = t_pipe.step(ps, img, TCFG)
        states.append(ps)
        mets.append(m)
    return frames, states, mets


def test_step_live_row_matches_jax(port_run):
    frames, states, mets = port_run
    i = N_FRAMES - 1
    assert t_pipe.LIVE_SCALARS == j_pipe.LIVE_SCALARS
    assert t_pipe.LIVE_IDX == j_pipe.LIVE_IDX and t_pipe.LIVE_WIDTH == j_pipe.LIVE_WIDTH == 12
    got_ps, got = t_pipe.step_live(states[i], frames[i], TCFG)
    _, want = j_pipe.step_live(to_jax(states[i]), jnp.asarray(frames[i].numpy()), CFG)
    got, want = got.numpy(), np.asarray(want)
    assert got.dtype == want.dtype == np.float32 and got.shape == want.shape == (12,)
    ix = t_pipe.LIVE_IDX
    for k in TRACKING_DECIDED:
        assert got[ix[k]] == want[ix[k]], k
    assert got[ix["n_matches"]] > 5 and got[ix["slow_ok"]] == 1.0
    assert got[ix["normalize_canary_px"]] < 0.1 and want[ix["normalize_canary_px"]] < 0.1
    # the row is the step's own metrics, packed on the device
    assert states_equal(got_ps, states[i + 1])
    np.testing.assert_array_equal(
        got, np.array([float(mets[i][k]) for k in t_pipe.LIVE_SCALARS], np.float32))


def test_step_live_ring_keeps_the_last_rows_in_order(port_run):
    frames, states, mets = port_run
    k = 3
    ring = torch.zeros((k, t_pipe.LIVE_WIDTH))
    for i in range(N_FRAMES):
        ps, ring = t_pipe.step_live_ring(states[i], ring, frames[i], TCFG)
        assert states_equal(ps, states[i + 1])
    want = [[float(mets[i][n]) for n in t_pipe.LIVE_SCALARS] for i in range(N_FRAMES - k, N_FRAMES)]
    np.testing.assert_array_equal(ring.numpy(), np.array(want, np.float32))


def test_checked_step_passes_a_clean_frame_and_flags_nan(port_run):
    frames, states, mets = port_run
    i = 2
    err, (ps, m) = t_pipe.checked_step(states[i], frames[i], TCFG)
    assert err.get() is None
    err.throw()
    assert states_equal(ps, states[i + 1])
    assert all(torch.equal(m[k], mets[i][k]) for k in mets[i])
    bad = frames[i].clone()
    bad[40:50, 60:70] = float("nan")
    err, _ = t_pipe.checked_step(states[i], bad, TCFG)
    assert "nan" in err.get()
    with pytest.raises(FloatingPointError, match="nan"):
        err.throw()


def test_guard_sees_a_nan_that_the_outputs_mask():
    """A NaN made inside (0/0) and masked away before the output is still
    flagged, as checkify's float_checks flag it; a clean function is not."""
    def masked(x):
        r = x / x
        return torch.where(torch.isnan(r), torch.zeros_like(r), r)

    x = torch.tensor([0.0, 2.0])
    guard = numerics.NanGuard()
    with guard:
        out = masked(x)
    assert torch.equal(out, torch.tensor([0.0, 1.0]))
    msg = numerics.CheckError(guard).get()
    assert msg is not None and "nan" in msg and "aten.div" in msg
    guard = numerics.NanGuard()
    with guard:
        masked(x + 1.0)
    assert numerics.CheckError(guard).get() is None and guard.n_ops > 3


def test_dump_map_trajectory_and_ate_match(port_run, tmp_path):
    _, states, _ = port_run
    m = states[-1].map
    jm = to_jax(states[-1]).map
    t_dump.dump_map(m, str(tmp_path / "port"))
    j_dump.dump_map(jm, str(tmp_path / "jax"))
    got = (tmp_path / "port").read_bytes()
    assert got == (tmp_path / "jax").read_bytes()
    # every frame, two blank lines, at least one usable point and its blank line
    assert got.count(b"\n") >= N_FRAMES + 2 + 2
    np.testing.assert_array_equal(t_dump.trajectory(m), j_dump.trajectory(jm))
    a, b = t_dump.trajectory(m), t_dump.trajectory(states[2].map)
    assert t_dump.ate(a, b) == j_dump.ate(a, b) > 0.0


def test_draw_debug_and_patch_strip_match(port_run):
    frames, states, _ = port_run
    m = states[-1].map
    img = frames[-1]
    got = t_draw.draw_debug(m, img)
    want = j_draw.draw_debug(to_jax(states[-1]).map, img.numpy())
    assert got.dtype == np.uint8 and got.shape == (CFG.image_height, CFG.image_width, 3)
    np.testing.assert_array_equal(got, want)
    assert (got != t_draw.draw_debug(m, torch.zeros_like(img))).any()  # marks drawn
    centers = [(3.0, 2.0), (80.4, 60.6), (158.0, 119.0)]
    np.testing.assert_array_equal(t_draw.patch_strip(img, centers),
                                  j_draw.patch_strip(img.numpy(), centers))


def test_checkpoint_round_trip_matches_jax(port_run, tmp_path):
    _, states, _ = port_run
    ps = states[-1]
    template = t_pipe.init(TCFG, scaled_intrinsics(CFG), "cpu")
    t_ckpt.save(ps, str(tmp_path / "port.pt"))
    got = t_ckpt.restore(template, str(tmp_path / "port.pt"), "cpu")
    assert type(got) is t_pipe.PipelineState and states_equal(got, ps)
    j_ckpt.save(to_jax(ps), str(tmp_path / "jax"))
    want = j_ckpt.restore(to_jax(template), str(tmp_path / "jax"))
    assert states_equal(got, bridge.from_numpy(want, "cpu"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='device="cpu"'):
            t_ckpt.restore(template, str(tmp_path / "port.pt"))
    small = t_pipe.init(port_cfg(CFG.__class__(max_points=64)), scaled_intrinsics(CFG), "cpu")
    with pytest.raises(ValueError, match="does not fit"):
        t_ckpt.restore(small, str(tmp_path / "port.pt"), "cpu")
