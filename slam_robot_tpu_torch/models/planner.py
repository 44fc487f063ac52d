"""Dubins-style path planner (planner.cpp rebuilt), batched over leading
dimensions.

Port of ``slam_robot_tpu/models/planner.py``. The reference generates 18
candidate paths, 6 primitives {LSL, LSR, LRL} x {+1,-1} parity, each in
{forward, time-reversed, direction-flipped} variants (planner.cpp:218-264),
and takes the arg-min by path length (planner.cpp:266-282). ``all_paths``
evaluates the three primitives once over a [..., 3 variants, 2 parities]
grid and lays the 18 candidates out as one [..., 18, 3] tensor in the JAX
package's type order (``mtype = 6 * variant + sub``), where the JAX package
picks one with ``lax.switch`` on a traced index.

A path is (dist[..., 3], kind[..., 3], valid[...]) with kind -1 left, 0
straight, +1 right, as float32 (the reference's Segment,
planner.cpp:32-38). ``interpolate_path`` walks the segments with a fixed
per-segment sample capacity and a validity mask (in place of the dynamic
std::vector of planner.cpp:284-340).

The entry points run on their first argument's device when it is a tensor,
else on the CUDA card (``device.default_device``).

``mod2pi`` and ``modpi`` are floor modulo (``torch.remainder``, as
``jnp.mod``), not ``torch.fmod``: the two differ on every negative angle.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import torch

from slam_robot_tpu_torch.device import default_device

TURNING_RADIUS = 2.0  # planner.cpp:24
N_TYPES = 18
PI = math.pi

# sub-types 0-5: {LSL+, LSR+, LSL-, LSR-, LRL+, LRL-} (planner.cpp:218-236),
# as (primitive, parity index): parity index 0 is +1, 1 is -1
_SUBTYPES = ((0, 0), (1, 0), (0, 1), (1, 1), (2, 0), (2, 1))


class Path(NamedTuple):
    dist: torch.Tensor   # [..., 3]
    kind: torch.Tensor   # [..., 3] -1 left, 0 straight, 1 right (float32)
    valid: torch.Tensor  # [...] bool


def mod2pi(a):
    return torch.remainder(a, 2.0 * PI)


def modpi(a):
    return torch.remainder(a + PI, 2.0 * PI) - PI


def _rot(angle):
    """R(angle) @ [1, 0]: [..., 2]."""
    return torch.stack([torch.cos(angle), torch.sin(angle)], dim=-1)


def norm(v):
    """The Euclidean norm over the last axis as ``jnp.linalg.norm`` takes it:
    the square root of the sum of squares."""
    return torch.sqrt(torch.sum(v * v, dim=-1))


def _lsl(cpos, cdir, gpos, gdir, parity, r):
    """planner.cpp:53-85."""
    ca = cpos + r * _rot(cdir + parity * PI / 2)
    cb = gpos + r * _rot(gdir + parity * PI / 2)
    heading = cb - ca
    dist = norm(heading)
    valid = dist > 0
    angle = torch.atan2(heading[..., 1], heading[..., 0])
    a1 = angle - cdir
    a2 = gdir - angle
    return Path(
        dist=torch.stack([mod2pi(parity * a1), dist, mod2pi(parity * a2)], dim=-1),
        kind=torch.stack([-parity, torch.zeros_like(parity), -parity], dim=-1),
        valid=valid,
    )


def _lsr(cpos, cdir, gpos, gdir, parity, r):
    """planner.cpp:88-137: clamped before arcsin and sqrt, on ``sdist``, so
    that an invalid type stays finite."""
    ca = cpos + r * _rot(cdir + parity * PI / 2)
    cb = gpos + r * _rot(gdir - parity * PI / 2)
    heading = cb - ca
    dist = norm(heading)
    valid = dist >= r * 2
    sdist = torch.clamp(dist, min=r * 2 + 1e-9)
    angle = torch.atan2(heading[..., 1], heading[..., 0])
    theta = torch.arcsin(torch.clamp(r / (sdist / 2), -1.0, 1.0))
    tdist = torch.sqrt(torch.clamp(sdist * sdist - 4 * r * r, min=0.0))
    angle1 = angle + parity * theta
    a1 = angle1 - cdir
    a2 = angle1 - gdir
    return Path(
        dist=torch.stack([mod2pi(a1 * parity), tdist, mod2pi(a2 * parity)], dim=-1),
        kind=torch.stack([-parity, torch.zeros_like(parity), parity], dim=-1),
        valid=valid,
    )


def _lrl(cpos, cdir, gpos, gdir, parity, r):
    """planner.cpp:142-190: clamped before arccos, on ``sdist``."""
    ca = cpos + r * _rot(cdir + parity * PI / 2)
    cb = gpos + r * _rot(gdir + parity * PI / 2)
    heading = cb - ca
    dist = norm(heading)
    valid = dist <= r * 4
    sdist = torch.clamp(dist, max=r * 4)
    angle = torch.atan2(heading[..., 1], heading[..., 0])
    theta = -torch.arccos(torch.clamp((sdist / 2) / (r * 2), -1.0, 1.0))
    t1 = cdir - angle - PI / 2
    t2 = gdir - angle - PI / 2
    a1 = torch.where(parity < 0, t1 - (PI - theta), theta - t1)
    a2 = PI + 2 * theta
    a3 = torch.where(parity < 0, theta - t2, parity * (t2 - (PI - theta)))
    return Path(
        dist=torch.stack([mod2pi(a1), mod2pi(a2), mod2pi(a3)], dim=-1),
        kind=torch.stack([-parity, parity, -parity], dim=-1),
        valid=valid,
    )


def reverse_path(p: Path) -> Path:
    """planner.cpp:193-205: reversed order, negated distances."""
    return Path(dist=-p.dist.flip(-1), kind=p.kind.flip(-1), valid=p.valid)


def path_length(p: Path, r=TURNING_RADIUS):
    """planner.cpp:207-216."""
    seg = torch.where(p.kind == 0, torch.abs(p.dist), torch.abs(modpi(p.dist)) * r)
    return seg[..., 0] + seg[..., 1] + seg[..., 2]


@functools.lru_cache(maxsize=None)
def _parity(device: torch.device) -> torch.Tensor:
    """[+1, -1], made once per device (no copy to the device per call)."""
    return torch.tensor([1.0, -1.0], dtype=torch.float32, device=device)


def _as_f32(x, like):
    return torch.as_tensor(x, dtype=torch.float32, device=like.device)


def _lead(x):
    """The first argument as float32: a tensor keeps its device, anything
    else goes to the CUDA card (``default_device``), as the JAX package's
    arrays go to its default device."""
    dev = x.device if isinstance(x, torch.Tensor) else default_device(None)
    return torch.as_tensor(x, dtype=torch.float32, device=dev)


def all_paths(cpos, cdir, gpos, gdir, r=TURNING_RADIUS):
    """Every one of the 18 types at once (planner.cpp:238-264): (Path with
    dist and kind [..., 18, 3] and valid [..., 18], lengths [..., 18], inf
    where the type is invalid). Type ``6 * major + sub``: major 0 forward,
    1 time-reversed (goal to start, then ``reverse_path``), 2 flipped
    (headings turned by pi, segments negated, arcs taken mod 2pi)."""
    cpos = _lead(cpos)
    gpos = _as_f32(gpos, cpos)
    cdir = _as_f32(cdir, cpos)
    gdir = _as_f32(gdir, cpos)
    # the three variants' (start, goal) on a new axis -2 ...
    sp = torch.stack([cpos, gpos, cpos], dim=-2)                     # [..., 3, 2]
    gp = torch.stack([gpos, cpos, gpos], dim=-2)
    sd = torch.stack([cdir, gdir, mod2pi(cdir + PI)], dim=-1)        # [..., 3]
    gd = torch.stack([gdir, cdir, mod2pi(gdir + PI)], dim=-1)
    # ... and the two parities on axis -1 of the headings
    parity = _parity(cpos.device)
    sp, gp = sp[..., None, :], gp[..., None, :]                      # [..., 3, 1, 2]
    sd, gd = sd[..., None], gd[..., None]                            # [..., 3, 1]
    prims = [f(sp, sd, gp, gd, parity, r) for f in (_lsl, _lsr, _lrl)]  # [..., 3, 2, ...]
    dist = torch.stack([prims[k].dist[..., j, :] for k, j in _SUBTYPES], dim=-2)   # [...,3,6,3]
    kind = torch.stack([prims[k].kind.expand_as(prims[k].dist)[..., j, :]
                        for k, j in _SUBTYPES], dim=-2)
    valid = torch.stack([prims[k].valid[..., j] for k, j in _SUBTYPES], dim=-1)    # [...,3,6]
    (d_fwd, d_rev, d_flip), (k_fwd, k_rev, k_flip) = dist.unbind(-3), kind.unbind(-3)
    # time-reversed: reversed order, negated distances
    rev = reverse_path(Path(d_rev, k_rev, None))
    # flipped: negated, arcs taken mod 2pi
    k_flip = -k_flip
    d_flip = -d_flip
    d_flip = torch.where(k_flip != 0, mod2pi(d_flip), d_flip)
    dist = torch.stack([d_fwd, rev.dist, d_flip], dim=-3)
    kind = torch.stack([k_fwd, rev.kind, k_flip], dim=-3)
    batch = dist.shape[:-3]
    p = Path(dist=dist.reshape(*batch, N_TYPES, 3), kind=kind.reshape(*batch, N_TYPES, 3),
             valid=valid.reshape(*batch, N_TYPES))
    lengths = torch.where(p.valid, path_length(p, r), torch.full_like(p.dist[..., 0], math.inf))
    return p, lengths


def shortest_path(cpos, cdir, gpos, gdir, r=TURNING_RADIUS):
    """Arg-min over all 18 types at once (planner.cpp:266-282); ties go to
    the first type. Returns (Path, length, type_index)."""
    paths, lengths = all_paths(cpos, cdir, gpos, gdir, r)
    best = torch.argmin(lengths, dim=-1)
    pick = Path(
        dist=torch.gather(paths.dist, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :],
        kind=torch.gather(paths.kind, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :],
        valid=torch.gather(paths.valid, -1, best[..., None])[..., 0],
    )
    return pick, torch.gather(lengths, -1, best[..., None])[..., 0], best


def _segment_ends(pos, direction, d, kind, r):
    """One segment's straight and curve (end, heading), and its circle's
    centre and start angle."""
    heading = _rot(direction)
    sheading = torch.where((d < 0)[..., None], -heading, heading)
    s_end = pos + torch.abs(d)[..., None] * sheading
    center = pos + r * _rot(direction - kind * PI / 2)
    t1 = direction - kind * PI / 2 + PI
    c_end = center + r * _rot(t1 - d * kind)
    return sheading, s_end, center, t1, c_end, direction - kind * d


def interpolate_path(cpos, cdir, p: Path, step: float = 0.1,
                     samples_per_seg: int = 256, r=TURNING_RADIUS):
    """Polyline samples along a path (planner.cpp:284-340).

    Returns (points[..., 3*N+1, 2], valid mask [..., 3*N+1]). Each segment
    contributes its start (always valid) plus up to N-1 interior samples at
    arc-length ``step``; the final endpoint is appended last."""
    pos = _lead(cpos)
    direction = _as_f32(cdir, pos)
    ts = torch.arange(samples_per_seg, dtype=torch.float32, device=pos.device) * step
    all_pts, all_valid = [], []
    for s in range(3):
        d, kind = p.dist[..., s], p.kind[..., s].to(torch.float32)
        sheading, s_end, center, t1, c_end, c_dir = _segment_ends(pos, direction, d, kind, r)
        # straight (planner.cpp:293-308)
        spts = pos[..., None, :] + ts[:, None] * sheading[..., None, :]
        svalid = ts < torch.clamp(torch.abs(d), min=1e-9)[..., None]
        # curve (planner.cpp:309-335)
        cdist = modpi(d)
        order = torch.where(cdist < 0, -kind, kind)
        angles = t1[..., None] - ts * order[..., None]
        cpts = center[..., None, :] + r * torch.stack([torch.cos(angles), torch.sin(angles)],
                                                      dim=-1)
        cvalid = ts < torch.clamp(torch.abs(cdist), min=1e-9)[..., None]
        is_straight = kind == 0
        all_pts.append(torch.where(is_straight[..., None, None], spts, cpts))
        # the segment start is always emitted (ts=0 row), matching the
        # reference's push_back(c.pos_) per segment
        valid = torch.where(is_straight[..., None], svalid, cvalid)
        valid[..., 0] = True
        all_valid.append(valid)
        pos = torch.where(is_straight[..., None], s_end, c_end)
        direction = torch.where(is_straight, direction, c_dir)
    pts = torch.cat(all_pts + [pos[..., None, :]], dim=-2)
    valid = torch.cat([torch.cat(all_valid, dim=-1) & p.valid[..., None], p.valid[..., None]],
                      dim=-1)
    return pts, valid


def path_endpoint(cpos, cdir, p: Path, r=TURNING_RADIUS):
    """Final (pos, dir) after following the path (for reachability checks)."""
    pos = _lead(cpos)
    direction = _as_f32(cdir, pos)
    for s in range(3):
        d, kind = p.dist[..., s], p.kind[..., s].to(torch.float32)
        _, s_end, _, _, c_end, c_dir = _segment_ends(pos, direction, d, kind, r)
        is_straight = kind == 0
        pos = torch.where(is_straight[..., None], s_end, c_end)
        direction = torch.where(is_straight, direction, c_dir)
    return pos, direction
