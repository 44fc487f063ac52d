"""Carry SLAM state between the JAX package and this port.

The JAX package's ``PipelineState`` / ``MapState`` / ``MatcherState`` and
this port's share field names, shapes and dtypes. :func:`from_numpy` takes
any object with those fields whose leaves convert with ``np.asarray``
(a JAX state does) and builds the port's state on ``device``;
:func:`to_numpy` turns a port state back into the same NamedTuple shape
with numpy leaves, from which a caller rebuilds the JAX type field by
field. This module imports no JAX.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from slam_robot_tpu_torch.models import localmap as lm
from slam_robot_tpu_torch.models import matcher as matcher_mod
from slam_robot_tpu_torch.models import pipeline

_TYPES = {
    "PipelineState": pipeline.PipelineState,
    "MapState": lm.MapState,
    "MatcherState": matcher_mod.MatcherState,
}

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _leaf_to_torch(x, device) -> torch.Tensor:
    a = np.asarray(x)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unexpected dtype {a.dtype} in a SLAM state")
    return torch.as_tensor(np.array(a, copy=True), dtype=_DTYPES[a.dtype], device=device)


def from_numpy(state, device=None, kind: type | None = None):
    """Port state (``kind``: one of PipelineState, MapState, MatcherState;
    default from the source's type name) from a JAX-package state."""
    kind = kind or _TYPES[type(state).__name__]
    out = {}
    for field in kind._fields:
        val = getattr(state, field)
        sub = _TYPES.get(type(val).__name__)
        out[field] = from_numpy(val, device, sub) if sub else _leaf_to_torch(val, device)
    return kind(**out)


def to_numpy(state: NamedTuple):
    """The same NamedTuple with every tensor leaf as a numpy array."""
    out = {}
    for field in state._fields:
        val = getattr(state, field)
        out[field] = to_numpy(val) if isinstance(val, tuple) else val.detach().cpu().numpy()
    return type(state)(**out)
