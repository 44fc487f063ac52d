"""Pipeline/map state checkpointing (SURVEY §5: the reference has none,
only input record/replay).

Counterpart of ``slam_robot_tpu/utils/checkpoint.py``: ``save`` writes a
state NamedTuple (``PipelineState``, ``MapState``, ``MatcherState``) with
``torch.save`` as nested dicts of tensors; ``restore`` reads it back into
the structure of a template state, onto a given device. Loading uses
``weights_only=True``, so a file can hold nothing but tensors and dicts.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.device import default_device


def _to_dict(state) -> dict:
    return {f: _to_dict(v) if isinstance(v, tuple) else v.detach().cpu()
            for f, v in zip(state._fields, state)}


def _from_dict(template, data: dict, device):
    out = {}
    for f, v in zip(template._fields, template):
        if isinstance(v, tuple):
            out[f] = _from_dict(v, data[f], device)
        else:
            t = data[f]
            if t.dtype != v.dtype or t.shape != v.shape:
                raise ValueError(f"checkpoint field {f}: {t.dtype}{tuple(t.shape)} does not "
                                 f"fit the template's {v.dtype}{tuple(v.shape)}")
            out[f] = t.to(device)
    return type(template)(**out)


def save(state, path: str) -> None:
    """Save a state NamedTuple to ``path``."""
    torch.save(_to_dict(state), path)


def restore(template, path: str, device=None):
    """Restore into the structure of ``template`` on ``device`` (default:
    the CUDA card)."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    return _from_dict(template, data, default_device(device))
