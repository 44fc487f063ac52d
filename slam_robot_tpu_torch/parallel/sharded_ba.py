"""Sharded bundle adjustment: the observation table split across devices.

Port of ``slam_robot_tpu/parallel/sharded_ba.py``. The heavy part of every
BA iteration is per-observation work (residuals, Jacobians and the block
sums into the landmark systems and the reduced camera system), and that
axis splits cleanly:

    mesh axis 'model'  <- observation rows
    replicated         <- frame and point parameters (small)
    the ObsShards seam <- the block sums, added over the shards

Where the JAX package lets XLA's partitioner insert the all-reduces, the
port's ``ops/ba.solve_shards`` sums each observation-derived block through
``ops/obs_shards.ObsShards``: over the shards of one process, and with a
``torch.distributed`` group over its ranks.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops import ba
from slam_robot_tpu_torch.ops.obs_shards import ObsShards, split_and_solve
from slam_robot_tpu_torch.parallel.mesh import Mesh


def solve_sharded(mesh: Mesh, frame_quat, frame_trans, frame_cam, cam_k, point_loc,
                  point_uncertainty, obs_frame, obs_point, obs_px, obs_ok, present,
                  free_frame, cfg: ba.BAConfig = ba.BAConfig(),
                  obs_axis: str = "model") -> ba.BAResult:
    """ba.solve with the observation table split over ``obs_axis``: padded
    with ``obs_ok=False`` rows to a multiple of the axis size, one row block
    per device of the axis. Everything else is replicated on the mesh's
    first device, where the result lands."""
    return split_and_solve(ba.solve_shards, mesh.axis_devices(obs_axis), frame_quat,
                           frame_trans, frame_cam, cam_k, point_loc, point_uncertainty,
                           obs_frame, obs_point, obs_px, obs_ok, present, free_frame, cfg)


def assemble_partials(mesh: Mesh, obs_r, obs_w, obs_jf, obs_jp, obs_point, obs_slot,
                      n_points: int, n_slots: int, obs_axis: str = "model"):
    """The same reduction spelled out: each shard assembles blocks from its
    observation rows, then the seam sums them.

    Inputs are per-observation residuals [O,2], weights [O], frame/point
    Jacobians [O,2,6]/[O,2,4], point indices and frame slots (indices out
    of range are dropped, negative ones wrap once, as the JAX package's
    scatters do). Returns (Hff [W,6,6], bf [W,6],
    C [P,4,4], bp [P,4]) on the mesh's first device."""
    devices = mesh.axis_devices(obs_axis)
    D = len(devices)
    O = obs_r.shape[0]
    if O % D:
        raise ValueError(f"{O} observation rows do not split over the {D} devices of "
                         f"mesh axis {obs_axis!r}")
    cols = (obs_r, obs_w, obs_jf, obs_jp, obs_point, obs_slot)
    shards = ObsShards([dict(zip(("r", "w", "jf", "jp", "pidx", "slot"),
                                 (c.to(dev) for c in block)))
                        for dev, *block in zip(devices, *(c.chunk(D) for c in cols))],
                       devices[0])

    def add_into(n, idx, vals):  # out-of-range rows land in scratch row n
        idx = idx.long()
        idx = torch.where(idx < 0, idx + n, idx)
        idx = torch.where((idx >= 0) & (idx < n), idx, n)
        return vals.new_zeros((n + 1, *vals.shape[1:])).index_add_(0, idx, vals)[:n]

    def local(s):
        r, w, jf, jp = s["r"], s["w"], s["jf"], s["jp"]
        return (add_into(n_slots, s["slot"], torch.einsum("oia,oib,o->oab", jf, jf, w)),
                add_into(n_slots, s["slot"], -torch.einsum("oia,oi->oa", jf, w[:, None] * r)),
                add_into(n_points, s["pidx"], torch.einsum("oia,oib,o->oab", jp, jp, w)),
                add_into(n_points, s["pidx"], -torch.einsum("oia,oi->oa", jp, w[:, None] * r)))

    return shards.sum(local)
