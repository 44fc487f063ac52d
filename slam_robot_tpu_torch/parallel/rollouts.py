"""Rollout fleets: data-parallel closed-loop simulations.

Port of ``slam_robot_tpu/parallel/rollouts.py``. BASELINE config 4: 64
parallel rollouts. ``fleet`` splits the goal batch over the mesh's 'data'
axis; each device integrates its own chunk as one batch through
``sim.rollout``, and the results are gathered to the first device. No other
cross-device traffic.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.models import sim
from slam_robot_tpu_torch.parallel.mesh import Mesh


def fleet(mesh: Mesh, goals, n_steps: int = 200, data_axis: str = "data"):
    """goals [B,3] -> (trajectories [B,n_steps,2], final distances [B]) on
    the first device of the 'data' axis. B must be divisible by the
    data-axis size."""
    devices = mesh.axis_devices(data_axis)
    goals = torch.as_tensor(goals, dtype=torch.float32)
    if goals.shape[0] % len(devices):
        raise ValueError(f"{goals.shape[0]} goals do not split over the {len(devices)} "
                         f"devices of mesh axis {data_axis!r}")
    # launch every chunk before gathering any: each device's queue fills
    # while the next is fed
    runs = [sim.rollout(chunk.to(dev), n_steps=n_steps)
            for chunk, dev in zip(goals.chunk(len(devices)), devices)]
    first = devices[0]
    return (torch.cat([traj.to(first) for traj, _ in runs]),
            torch.cat([dist.to(first) for _, dist in runs]))
