"""The observation-table seam of the bundle adjusters.

The port's counterpart of the JAX package's ``psum`` over a mesh axis:
``ops/ba`` and ``ops/ba_cg`` sum every observation-derived quantity through
:class:`ObsShards`, over the shards of one process and, with a
``torch.distributed`` group, over the group's ranks. ``parallel.mesh``
re-exports it.
"""

from __future__ import annotations

import torch

# the row a padded observation table gets: no frame, no point, not used
OBS_PAD = {"obs_frame": -1, "obs_point": -1, "obs_px": 0.0, "obs_ok": False}


class ObsShards:
    """An observation table split in row blocks, and the seam through which
    every sum over its rows passes.

    ``tables[i]`` maps each column's name (``obs_frame``, ``obs_point``,
    ``obs_px``, ``obs_ok``) to shard i's rows, on that shard's device.
    :meth:`allsum` adds the shards' partial sums on ``home`` in shard order
    and then, with ``group`` (an initialized ``torch.distributed`` process
    group whose ranks each hold their own shards), all-reduces that sum over
    the group. With one shard and no group it returns the partial itself: no
    addition, so a solver that sums through the seam gives the same bits as
    one that does not."""

    def __init__(self, tables: list[dict], home, group=None):
        self.tables = tables
        self.home = torch.device(home)
        self.group = group

    @classmethod
    def whole(cls, obs_frame, obs_point, obs_px, obs_ok) -> "ObsShards":
        """The whole table as one shard on its own device."""
        return cls([dict(obs_frame=obs_frame, obs_point=obs_point, obs_px=obs_px,
                         obs_ok=obs_ok)], obs_frame.device)

    @classmethod
    def split(cls, devices, obs_frame, obs_point, obs_px, obs_ok, home=None,
              group=None) -> "ObsShards":
        """The table padded with :data:`OBS_PAD` rows to a multiple of
        ``len(devices)`` and cut into that many equal row blocks, block i on
        ``devices[i]`` (a device may repeat). ``home`` defaults to the first
        device."""
        cols = dict(obs_frame=obs_frame, obs_point=obs_point, obs_px=obs_px, obs_ok=obs_ok)
        D = len(devices)
        pad = (-obs_frame.shape[0]) % D
        if pad:
            cols = {k: torch.cat([v, torch.full((pad, *v.shape[1:]), OBS_PAD[k],
                                                dtype=v.dtype, device=v.device)])
                    for k, v in cols.items()}
        blocks = {k: v.chunk(D) for k, v in cols.items()}
        tables = [{k: blocks[k][i].to(dev) for k in cols} for i, dev in enumerate(devices)]
        return cls(tables, devices[0] if home is None else home, group)

    def allsum(self, parts: list[torch.Tensor]) -> torch.Tensor:
        """The sum of one partial per shard, on ``home``, over the group."""
        out = parts[0].to(self.home)
        for p in parts[1:]:
            out = out + p.to(self.home)
        if self.group is not None:
            torch.distributed.all_reduce(out, group=self.group)
        return out

    def sum(self, fn, shards: list | None = None):
        """``fn(shard)`` for every shard (default: every table; a solver
        passes its own per-shard records, one per table, in table order),
        summed through :meth:`allsum`; ``fn`` may return a tuple of partials,
        each summed on its own."""
        parts = [fn(s) for s in (self.tables if shards is None else shards)]
        if isinstance(parts[0], tuple):
            return tuple(self.allsum(list(col)) for col in zip(*parts))
        return self.allsum(parts)


def split_and_solve(solve_shards, devices, frame_quat, frame_trans, frame_cam, cam_k,
                    point_loc, point_uncertainty, obs_frame, obs_point, obs_px, obs_ok,
                    present, free_frame, cfg):
    """``solve_shards`` (``ops/ba``'s or ``ops/ba_cg``'s) with the
    observation table split over ``devices`` (:meth:`ObsShards.split`) and
    everything else moved to the first device, where the result lands."""
    shards = ObsShards.split(devices, obs_frame, obs_point, obs_px, obs_ok)
    home = shards.home
    return solve_shards(*(t.to(home) for t in (frame_quat, frame_trans, frame_cam, cam_k,
                                               point_loc, point_uncertainty)),
                        shards, present.to(home), free_frame.to(home), cfg)
