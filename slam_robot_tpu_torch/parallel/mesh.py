"""Mesh helpers: a named grid of devices.

Port of ``slam_robot_tpu/parallel/mesh.py``'s ``make_mesh``. A ``Mesh`` is a
numpy grid of ``torch.device``s with axis names; it starts no process group
(the ``torch.distributed`` form belongs with the sharded BA and multi-robot
paths).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_robot_tpu_torch.device import default_device


class Mesh(NamedTuple):
    devices: np.ndarray          # object array of torch.device, one axis per name
    axis_names: tuple[str, ...]

    @property
    def shape(self) -> dict[str, int]:
        return dict(zip(self.axis_names, self.devices.shape))

    def axis_devices(self, name: str) -> list[torch.device]:
        """The devices along axis ``name``, at index 0 of every other axis."""
        grid = np.moveaxis(self.devices, self.axis_names.index(name), 0)
        return list(grid.reshape(grid.shape[0], -1)[:, 0])


def make_mesh(axes: dict[str, int] | None = None, devices=None) -> Mesh:
    """Build a mesh. Default: every visible CUDA card on one 'data' axis
    (raises where torch sees none, as ``device.default_device``).

    make_mesh({'data': 4, 'model': 2}) lays 8 devices on a 4x2 grid:
    'data' shards rollouts/robots, 'model' shards BA observation work.
    """
    if devices is None:
        default_device("cuda")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if axes is None:
        axes = {"data": len(devices)}
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    if int(np.prod(shape)) != len(devices):
        raise ValueError(f"mesh {axes} needs {np.prod(shape)} devices, have {len(devices)}")
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), names)
