"""``probe_live`` on the CPU at tests/test_pipeline.CFG: from the bench's
warm state after 8 frames, every ported variant over 4 live frames.

Every variant that steps does the same work as ``eager`` and must end in
``eager``'s state bit for bit (so none skips any); ``bigargs`` runs no step
and ``rtt`` no state. Each line has the original's keys, the variants
without a counterpart print their one line, and the ring loop reads every
frame's telemetry.
"""

import json

import pytest
import torch

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.tools import probe_live
from slam_robot_tpu_torch.utils.benchscene import make_frames
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = port_cfg(CFG)
N_WARM, N_LIVE = 8, 4


@pytest.fixture(scope="module")
def probed():
    frames = make_frames(TCFG, N_WARM + N_LIVE, device="cpu")
    ps0, _, _ = bench.bootstrap(TCFG, frames, N_WARM, "cpu", n_eager=0)
    before = probe_live.copy_state(ps0)
    lines = []
    out = probe_live.probe(ps0, frames[N_WARM:], TCFG,
                           probe_live.VARIANTS + tuple(probe_live.NO_COUNTERPART), passes=0,
                           emit=lines.append)
    return out, [json.loads(x) for x in lines], ps0, before


def test_every_stepping_variant_ends_in_eagers_state_bit_for_bit(probed):
    out, _, _, _ = probed
    assert out["states_equal_eager"] == {k: True for k in probe_live.STEPPING}


def test_variants_leave_the_start_state_untouched(probed):
    _, _, ps0, before = probed
    assert probe_live.states_equal(ps0, before)


def test_lines_have_the_originals_keys(probed):
    out, lines, _, _ = probed
    assert set(out["rtt"]) == {"variant", "chain_call_ms", "parallel_call_ms"}
    for name in probe_live.STEPPING + ("bigargs",):
        assert set(out[name]) == {"variant", "live_step_ms", "live_fps", "first_pass_s"}
        assert out[name]["live_step_ms"] > 0
    by = {(x.get("variant"), frozenset(x)) for x in lines}
    assert ("bigargs", frozenset({"variant", "state_leaves", "state_mb"})) in by
    assert ("nosync", frozenset({"variant", "issue_ms_per_frame", "per_dispatch_ms"})) in by
    nosync = next(x for x in lines if "per_dispatch_ms" in x)
    assert len(nosync["per_dispatch_ms"]) == N_LIVE
    for name, why in probe_live.NO_COUNTERPART.items():
        assert {"variant": name, "no_counterpart": why} in lines


def test_bigargs_counts_the_states_tensors(probed):
    _, lines, ps0, _ = probed
    line = next(x for x in lines if "state_leaves" in x)
    assert line["state_leaves"] == len(probe_live.leaves(ps0)) > 30

