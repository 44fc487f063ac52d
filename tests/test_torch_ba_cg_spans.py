"""The device spans and spill counters inside the large-map solver
(``ops/ba_cg``), on the CPU at tests/test_torch_ba_cg.py's size (8 frames,
40 points), with pads small enough that both sides spill.

- Under a ``torch.profiler`` capture every span is recorded with the calls
  the trip counts imply: each side's segment sums ``gn_iters x (cg_iters +
  3)`` (two in assembly, one a CG product, one in the rhs or the
  back-substitution), ``ba_cg_cost`` twice, ``ba_cg_plan`` once; the
  ``scatter`` layout has the phase spans only. Each span counts the solves
  it ran under.
- Self ms never passes inclusive ms, and a span's children cover no more
  than it: inclusive less self is what they cover.
- ``ba_cg.SPILL`` equals a numpy count of the plan's segment ids made from
  the inputs alone.
- With no profiler a solve records nothing; the answer is bit for bit the
  same with the spans on; a traced solve runs exactly the untraced solve's
  aten operations (the counters' reductions run at the read).
"""

import collections

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import SPAN_MS
from slam_robot_tpu_torch.models import slam
from slam_robot_tpu_torch.ops import ba_cg
from slam_robot_tpu_torch.utils import synthetic

torch.set_num_threads(1)

SIZES = dict(max_frames=16, max_points=64, max_obs=2048, max_obs_per_point=16)
K_POINT, K_FRAME = 3, 16
PHASES = ("ba_cg_plan", "ba_cg_cost", "ba_cg_linearize", "ba_cg_pcg", "ba_cg_update")
SEGS = tuple(f"ba_cg_seg_{side}_{part}" for side in "pf" for part in ("pad", "spill"))


def _problem():
    s = synthetic.build_scene(SlamConfig(**SIZES), n_frames=8, n_points=40, point_noise=40.0,
                              pixel_noise=0.3, device="cpu").state
    free, present = slam.window_masks(s, 6, 8)
    obs_ok = slam._obs_ok(s, s.n_frames - 8)
    return (s.frame_quat, s.frame_trans, s.frame_cam, s.cam_k, s.point_loc,
            s.point_uncertainty, s.obs_frame, s.obs_point, s.obs_px, obs_ok, present, free)


ARGS = _problem()


def _cfg(layout="padded", gn_iters=2, cg_iters=3) -> ba_cg.CGConfig:
    return ba_cg.CGConfig(max_free_frames=8, gn_iters=gn_iters, cg_iters=cg_iters,
                          layout=layout, pad_obs_per_point=K_POINT,
                          pad_obs_per_frame=K_FRAME, pad_spill=ARGS[6].shape[0])


def _traced(cfg, solves=1):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        res = [ba_cg.solve(*ARGS, cfg) for _ in range(solves)]
    return res[-1]


@pytest.fixture(autouse=True)
def _fresh():
    SPAN_MS.reset_device()
    ba_cg.SPILL.reset()
    yield
    SPAN_MS.reset_device()
    ba_cg.SPILL.reset()


@pytest.mark.parametrize("layout", ["padded", "scatter"])
def test_every_span_is_recorded_with_its_trip_counts(layout):
    gn, cg = 2, 3
    assert bool(_traced(_cfg(layout, gn, cg), solves=2).ok)
    spans = SPAN_MS.read_device()
    want = {"ba_cg_solve": 1, "ba_cg_plan": 1, "ba_cg_cost": 2, "ba_cg_linearize": gn,
            "ba_cg_pcg": gn, "ba_cg_update": gn}
    if layout == "padded":
        want.update(dict.fromkeys(SEGS, gn * (cg + 3)))
    assert {k: v["calls"] for k, v in spans.items()} == {k: 2 * n for k, n in want.items()}
    assert all(v["requests"] == 2 for v in spans.values())


def test_self_within_inclusive_and_children_within_parent():
    _traced(_cfg())
    spans = SPAN_MS.read_device()
    for name, v in spans.items():
        assert 0 <= v["self_ms"] <= v["ms"], name
    for name in SEGS:
        assert spans[name]["self_ms"] == pytest.approx(spans[name]["ms"])
    solve = spans["ba_cg_solve"]
    phases = sum(spans[k]["ms"] for k in PHASES)
    assert phases <= solve["ms"]
    assert solve["ms"] - solve["self_ms"] == pytest.approx(phases)
    # the segment sums run under linearize, pcg and update alone
    covered = sum(spans[k]["ms"] - spans[k]["self_ms"]
                  for k in ("ba_cg_linearize", "ba_cg_pcg", "ba_cg_update"))
    assert covered == pytest.approx(sum(spans[k]["ms"] for k in SEGS))


def _numpy_counts(cap: int) -> dict:
    """The spill figures of both plans, counted from the inputs with numpy:
    the rows past their segment's first K, and the sequence of segment ids
    that a spill sum walks (those rows by segment, then the sentinel, cut
    to ``cap``)."""
    f, p, ok = (ARGS[i].numpy() for i in (6, 7, 9))
    f, p = np.clip(f, 0, None), np.clip(p, 0, None)
    present, free = ARGS[10].numpy(), ARGS[11].numpy()
    Fn, P, W, O = present.shape[0], ARGS[4].shape[0], 8, f.shape[0]
    has_obs = np.bincount(f[ok], minlength=Fn) > 0
    free_f = free & has_obs & (np.sum(present & has_obs) >= 2)
    slot_of = np.minimum(np.where(free_f, np.cumsum(free_f) - 1, W), W)
    slot = slot_of[f]
    out = {}
    for side, ids, n, K in (("p", np.where(ok, p, P), P, K_POINT),
                            ("f", np.where(ok & (slot < W), slot, W), W, K_FRAME)):
        counts = np.bincount(ids[ids < n], minlength=n)
        past = np.repeat(np.arange(n), np.maximum(counts - K, 0))
        walked = np.concatenate([past, np.full(O - past.size, n)])[:cap]
        runs = np.diff(np.flatnonzero(np.diff(np.concatenate([[-1], walked, [n + 1]]))))
        out.update({f"plans.{side}": 1, f"walked.{side}": walked.size,
                    f"spill_rows.{side}": past.size, f"run.{side}": int(runs.max())})
    return out


@pytest.mark.parametrize("cap", ["rows", 40])
def test_spill_counters_equal_a_numpy_count(cap):
    """``rows``: every row walked, the sentinel's run the longest; 40: the
    spill overflows on both sides and walks real runs alone."""
    cap = ARGS[6].shape[0] if cap == "rows" else cap
    _traced(_cfg()._replace(pad_spill=cap))
    want = _numpy_counts(cap)
    assert want["spill_rows.p"] > 0 and want["spill_rows.f"] > 0   # both sides spill
    assert ba_cg.SPILL.read() == want
    assert ba_cg.SPILL.read() == want      # a second read reads the same


def test_a_solve_with_no_profiler_records_nothing():
    res = ba_cg.solve(*ARGS, _cfg())
    assert bool(res.ok)
    assert SPAN_MS.read_device() == {} and ba_cg.SPILL.read() == {}


def test_the_answer_is_bit_identical_with_the_spans_on():
    off = ba_cg.solve(*ARGS, _cfg())
    on = _traced(_cfg())
    for name, a, b in zip(off._fields, off, on):
        assert torch.equal(a, b) if torch.is_tensor(a) else a == b, name


class _AtenOps(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if str(func).startswith("aten."):
            self.ops[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_a_traced_solve_runs_the_untraced_solves_ops():
    with _AtenOps() as untraced:
        ba_cg.solve(*ARGS, _cfg())
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with _AtenOps() as traced:
            ba_cg.solve(*ARGS, _cfg())
    assert sum(untraced.ops.values()) > 0 and traced.ops == untraced.ops
    assert SPAN_MS.read_device()["ba_cg_solve"]["calls"] == 1
