"""The port's multi-process dry run (``parallel/dryrun``), the
``torch.distributed`` counterpart of ``__graft_entry__.dryrun_multichip``:
n gloo processes on the CPU as a data x model grid, each data rank a short
SLAM run, each model group's BA sharded over its ranks through
``all_reduce``, with the original's checks and the sharded solves against
the whole table's (rtol 1e-4). Each run is joined under a 120 s timeout,
so a hung rank fails the test instead of stalling the suite."""

import pytest

from slam_robot_tpu_torch.parallel import dryrun


@pytest.mark.parametrize("n", [2, 4])
def test_dryrun_multichip(n):
    line = dryrun.dryrun_multichip(n, timeout=120.0)
    model = 2
    assert line.startswith(f"dryrun_multichip ok: {n} gloo ranks, data={n // model} x "
                           f"model={model}")


def test_check_rejects_a_sharded_cost_off_the_whole_tables():
    row = dict(rank=0, data=0, model=0, n_obs=20, n_matches=[0, 5, 5, 5], ba_cost=5.0,
               ba_cost_whole=5.0, cg_cost=11.0, cg_cost0=300.0, cg_cost_whole=11.0, cg_ok=True)
    assert dryrun.check([row]).startswith("dryrun_multichip ok: 1 gloo ranks")
    with pytest.raises(AssertionError, match="whole table"):
        dryrun.check([dict(row, cg_cost=11.1)])
    with pytest.raises(AssertionError, match="never matched"):
        dryrun.check([dict(row, n_matches=[3, 0, 0, 0])])
