"""Batched coarse-to-fine Newton patch tracker (hessian.h:147-264), the
autodiff "lanes" tracker.

Port of ``slam_robot_tpu/ops/tracker.py``. The photometric score is a
closed differentiable function of the sub-pixel position (bilinear
sampling is piecewise polynomial), so the Newton step takes its gradient
(``torch.func.grad``) and its forward-over-reverse Hessian
(``torch.func.jacfwd`` of the gradient) instead of the reference's six
finite-difference scores (BruteHessian, hessian.h:147-172). The fused
tracker (``ops/tracker_fused``, kernel B1) derives the same two by hand;
this module is its autodiff counterpart (``tracker_impl="lanes"``).

The JAX package vmaps single-feature functions over lanes; here every
function is batched over lanes, shape [K, ...]. Each lane's Newton loop,
a ``lax.while_loop`` under vmap there, is a Python loop of ``max_iters``
trips with a per-lane ``done`` mask: a lane that is done stays frozen, so
every lane ends where the while loop leaves it, with no host read inside a
level. The level cascade (``lax.fori_loop`` there) is a Python loop over
the pyramid's levels; levels coarser than a lane's ``lvls - 1`` are masked.

Semantics of Track/TrackFeature (hessian.h:185-264): step d = -H^-1 g,
clamped to unit norm and then per component to [-1, 1]; stop when both
|dx|, |dy| < threshold; the out-of-bounds margin test at every iteration
and after the loop fails the track; coarse-to-fine from level lvls-1 with
pt / 2^(lvls-1), x2 between levels. The forward/backward round trip
(matcher.cpp:173-206) is :func:`track_bidirectional`.
"""

from __future__ import annotations

import torch
from torch.func import grad, jacfwd, vmap

from slam_robot_tpu_torch.ops import patch as patch_ops
from slam_robot_tpu_torch.ops.patch import Patch
from slam_robot_tpu_torch.ops.pyramid import FlatPyramid, level_dims, PAD

OK = 0
SMALL_DET = 1       # kept for API parity (hessian.h:48-52); never raised
OUT_OF_BOUNDS = 2

_MARGIN = 0.01  # hessian.h:196


def pyramid_dims(pyr: FlatPyramid):
    h, w = pyr.data.shape[-2] - 2 * PAD, pyr.data.shape[-1] - 2 * PAD
    return level_dims(h, w, pyr.depth)


def lane_offsets(pyr: FlatPyramid, K: int, device) -> torch.Tensor:
    """Each lane's base plane in ``pyr.data`` (``pyr.offset``: an int, a 0-d
    or a [K] tensor) as a [K] long tensor."""
    if isinstance(pyr.offset, int):  # a fill, not a copy from the host
        return torch.full((K,), pyr.offset, dtype=torch.long, device=device)
    return pyr.offset.to(torch.long).expand(K)


def active_mask(active, K: int, device) -> torch.Tensor:
    """``active`` (None: every lane; a bool or a [K] mask) as a [K] bool
    tensor."""
    if active is None:
        return torch.ones((K,), dtype=torch.bool, device=device)
    return torch.as_tensor(active, dtype=torch.bool, device=device).expand(K)


def get_patch_stack(pyr: FlatPyramid, pts: torch.Tensor, size: int = 13) -> Patch:
    """GetPatches (hessian.h:175-183): patches at pts / 2^i for every level
    i, as a Patch with axes [K, L, ...]. ``pyr.offset`` selects each lane's
    pyramid in a stack."""
    dims = pyramid_dims(pyr)
    offs = lane_offsets(pyr, pts.shape[0], pts.device)
    out = []
    for i in range(pyr.depth):
        h, w = dims[i]
        out.append(patch_ops.extract(pyr.data, offs + i, w, h, pts / (2.0 ** i), size))
    return Patch(*(torch.stack([getattr(p, f) for p in out], 1) for f in Patch._fields))


def level_patch(stack: Patch, i: int) -> Patch:
    """Level ``i`` of a [K, L, ...] patch stack."""
    return Patch(*(f[:, i] for f in stack))


def _lane_score(xy, base, a, b, c, d, ref_centered, weight_ok, ref_sumsq):
    """One lane's ``patch.score`` of its reference against the patch at
    sub-pixel ``xy``, with fewer operations for the derivatives to carry:
    the bilinear patch as a + fx b + fy (c + fx d) from the four corner
    planes of its support at ``base`` = floor(xy) (``patch.support``; the
    score depends on the support only through its integer start, so autodiff
    in ``xy`` sees the bilinear mix as autodiff of ``patch.extract`` does),
    and the gain/bias-compensated residual r - alpha p - beta as
    (r - mean r) - alpha (p - mean p)."""
    size = ref_centered.shape[-1]
    n = size * size
    f = xy - base
    p = a + f[0] * b + f[1] * (c + f[0] * d)
    alpha = torch.sqrt(ref_sumsq / torch.clamp(torch.sum(p * p) / n, min=1e-12))
    diff = ref_centered - alpha * (p - torch.sum(p) / n)
    return torch.sum(diff * diff * weight_ok)


def _grad_twice(*args):
    g = grad(_lane_score)(*args)
    return g, g


# (H [K,2,2], g [K,2]) per lane: jacfwd of the gradient, which it also returns
_derivatives = vmap(jacfwd(_grad_twice, has_aux=True))


def out_of_bounds(xy, width: float, height: float):
    """[K] True where a position is within the margin of a level's edge
    (hessian.h:196)."""
    return ((xy[:, 0] < _MARGIN) | (xy[:, 1] < _MARGIN)
            | (xy[:, 0] + _MARGIN > width) | (xy[:, 1] + _MARGIN > height))


def track_level(stack, index, width: int, height: int, ref_patch: Patch, pts, weight,
                threshold: float = 0.001, max_iters: int = 10, size: int = 13,
                active=None):
    """Newton iterations of every lane against one pyramid level
    (hessian.h:185-241): plane ``index`` (int or [K]) of ``stack``, true
    size ``width`` x ``height``. ``ref_patch`` [K, S, S], ``pts`` [K, 2].
    Returns (new_pts [K, 2], status [K] int32).

    Lanes with ``active`` False start done and come back unchanged, OK."""
    K = pts.shape[0]
    dev = pts.device
    active = active_mask(active, K, dev)
    xy = pts.to(torch.float32)
    status = torch.full((K,), OK, dtype=torch.int32, device=dev)
    done = ~active
    wf, hf = float(width), float(height)
    ref_centered = ref_patch.data - ref_patch.mean[:, None, None]
    for _ in range(max_iters):
        oob = out_of_bounds(xy, wf, hf)
        sup, x0, y0 = patch_ops.support(stack, index, width, height, xy, size)
        base = torch.stack([x0, y0], -1).to(torch.float32)
        ok = ref_patch.valid & patch_ops.support_valid(x0, y0, width, height, size)
        a = sup[:, :size, :size]
        b = sup[:, :size, 1:] - a
        c = sup[:, 1:, :size] - a
        h, g = _derivatives(xy, base, a, b, c, sup[:, 1:, 1:] - sup[:, 1:, :size] - b,
                            ref_centered, torch.where(ok, weight, 0.0), ref_patch.sumsq)
        det = h[:, 0, 0] * h[:, 1, 1] - h[:, 0, 1] * h[:, 1, 0]
        tiny = torch.where(det >= 0, 1e-20, -1e-20)
        safe_det = torch.where(torch.abs(det) > 1e-20, det, tiny)
        d = -torch.stack([h[:, 1, 1] * g[:, 0] - h[:, 0, 1] * g[:, 1],
                          -h[:, 1, 0] * g[:, 0] + h[:, 0, 0] * g[:, 1]], -1) / safe_det[:, None]
        d = torch.where(torch.isfinite(d), d, torch.zeros_like(d))
        n = torch.linalg.norm(d, dim=-1, keepdim=True)
        d = torch.where(n > 1.0, d / torch.clamp(n, min=1e-20), d)
        step = torch.clamp(d, -1.0, 1.0)
        new_xy = torch.where(oob[:, None], xy, xy + step)
        converged = (torch.abs(d[:, 0]) < threshold) & (torch.abs(d[:, 1]) < threshold)
        xy = torch.where(done[:, None], xy, new_xy)
        status = torch.where(done | ~oob, status, torch.full_like(status, OUT_OF_BOUNDS))
        done = done | oob | converged
    status = torch.where(out_of_bounds(xy, wf, hf) & active,
                         torch.full_like(status, OUT_OF_BOUNDS), status)
    return xy, status


def cascade(pyr: FlatPyramid, pts, lvls, active, level_fn):
    """The coarse-to-fine loop shared by the trackers: p = pts / 2^(lvls-1),
    then from the coarsest level down, ``level_fn(level, p, take)`` ->
    (new_p, ok) for the lanes still tracking at that level, x2 between
    levels. Returns (p, ok) with ok False for inactive lanes."""
    K = pts.shape[0]
    dev = pts.device
    lvls = torch.as_tensor(lvls, dtype=torch.int32, device=dev).expand(K)
    active = active_mask(active, K, dev)
    p = pts.to(torch.float32) / (2.0 ** (lvls - 1)).to(torch.float32)[:, None]
    ok = torch.ones((K,), dtype=torch.bool, device=dev)
    for i in range(pyr.depth - 1, -1, -1):
        lvl_on = i <= lvls - 1
        take = lvl_on & ok & active
        new_p, st = level_fn(i, p, take)
        p = torch.where(take[:, None], new_p, p)
        ok = torch.where(take, st, ok)
        if i > 0:
            p = torch.where(lvl_on[:, None], p * 2.0, p)
    return p, ok & active


def track_feature(pyr: FlatPyramid, patches: Patch, pts, lvls, weight,
                  threshold: float = 0.001, max_iters: int = 10, active=None):
    """Coarse-to-fine TrackFeature (hessian.h:243-264) with a per-lane level
    count ``lvls`` (int or [K]; the matcher uses 3 or 6 by point
    uncertainty, matcher.cpp:227-229). ``patches`` [K, L, ...] are the
    reference stacks (:func:`get_patch_stack`). Returns (pts [K,2], ok [K])."""
    dims = pyramid_dims(pyr)
    offs = lane_offsets(pyr, pts.shape[0], pts.device)
    S = int(weight.shape[0])

    def level(i, p, take):
        h, w = dims[i]
        new_p, st = track_level(pyr.data, offs + i, w, h, level_patch(patches, i), p, weight,
                                threshold, max_iters, S, active=take)
        return new_p, st == OK

    return cascade(pyr, pts, lvls, active, level)


def _bidirectional(pyr_from: FlatPyramid, pyr_to: FlatPyramid, from_pt, init_to_pt, lvls,
                   weight, threshold, max_iters, roundtrip_px, min_variance, active, fn):
    S = int(weight.shape[0])
    p1 = get_patch_stack(pyr_from, from_pt, S)
    to_pt, ok1 = fn(pyr_to, p1, init_to_pt, lvls, weight, threshold, max_iters, active=active)
    p2 = get_patch_stack(pyr_to, to_pt, S)
    back_pt, ok2 = fn(pyr_from, p2, from_pt, lvls, weight, threshold, max_iters, active=ok1)
    textured = (p1.sumsq[:, 0] - p1.mean[:, 0] ** 2) >= min_variance
    dist = torch.linalg.norm(from_pt - back_pt, dim=-1)
    return to_pt, ok1 & ok2 & textured & (dist <= roundtrip_px)


def _bidirectional_flat(from_data, from_offs, to_data, to_offs, from_pt, init_to_pt, lvls,
                        active, weight, *, depth_from, depth_to, threshold, max_iters,
                        roundtrip_px, min_variance, fn):
    """:func:`_bidirectional` on tensors only (what a CUDA graph captures)."""
    return _bidirectional(FlatPyramid(from_data, None, None, depth_from, from_offs),
                          FlatPyramid(to_data, None, None, depth_to, to_offs), from_pt,
                          init_to_pt, lvls, weight, threshold, max_iters, roundtrip_px,
                          min_variance, active, fn)


class GraphCache:
    """CUDA graphs of ``fn``, one per call signature (every tensor
    argument's shape and dtype and the keyword arguments). The first call
    with a signature runs ``fn`` once on a side stream and captures it into
    a graph over copies of its inputs; every call copies its inputs into
    those and replays the graph, which launches the same kernels on the same
    values as calling ``fn``. Returns copies of the outputs. ``captures`` and
    ``replays`` count what it did."""

    def __init__(self, fn):
        self.fn = fn
        self.graphs = {}
        self.captures = 0
        self.replays = 0

    def __call__(self, *tensors, **kwargs):
        key = (tuple((t.shape, t.dtype, t.device) for t in tensors),
               tuple(sorted(kwargs.items())))
        entry = self.graphs.get(key)
        if entry is None:
            inputs = [t.clone() for t in tensors]
            side = torch.cuda.Stream()
            side.wait_stream(torch.cuda.current_stream())
            with torch.cuda.stream(side):
                self.fn(*inputs, **kwargs)
            torch.cuda.current_stream().wait_stream(side)
            graph = torch.cuda.CUDAGraph()
            # other threads (a frame source rendering or copying on the
            # card) go on while this one captures
            with torch.cuda.graph(graph, capture_error_mode="thread_local"):
                outputs = self.fn(*inputs, **kwargs)
            entry = self.graphs[key] = (graph, inputs, outputs)
            self.captures += 1
        graph, inputs, outputs = entry
        for dst, src in zip(inputs, tensors):
            dst.copy_(src)
        graph.replay()
        self.replays += 1
        return tuple(o.clone() for o in outputs)


# the alternative trackers' passes on a card: ~500 operations a Newton
# iteration whatever the lane count, so an eager pass is host-bound
BIDIRECTIONAL_GRAPHS = GraphCache(_bidirectional_flat)


def track_bidirectional(pyr_from: FlatPyramid, pyr_to: FlatPyramid, from_pt, init_to_pt,
                        lvls, weight, threshold: float = 0.001, max_iters: int = 10,
                        roundtrip_px: float = 0.3, min_variance: float = 1e-5,
                        active=None, track_fn=None):
    """Forward/backward consistency tracking (matcher.cpp:173-206).

    Forward: patches at ``from_pt`` in ``pyr_from``, tracked in ``pyr_to``
    from ``init_to_pt``. Backward: patches at the forward result in
    ``pyr_to``, tracked in ``pyr_from`` from ``from_pt``, for the lanes
    whose forward track succeeded. A lane is accepted when both succeed, its
    finest-level reference patch has variance >= ``min_variance`` (a flat
    patch's degenerate Hessian would pass the round trip trivially) and the
    round trip lands within ``roundtrip_px`` of ``from_pt``. ``track_fn``
    swaps in another tracker with :func:`track_feature`'s contract
    (``ops/klt.track_feature``). Returns (to_pt [K,2], ok [K]).

    On a card the pass is replayed from a CUDA graph
    (:data:`BIDIRECTIONAL_GRAPHS`), the same kernels on the same values."""
    fn = track_fn or track_feature
    K = from_pt.shape[0]
    dev = from_pt.device
    lvls = torch.as_tensor(lvls, dtype=torch.int32, device=dev).expand(K)
    active = active_mask(active, K, dev)
    if not from_pt.is_cuda:
        return _bidirectional(pyr_from, pyr_to, from_pt, init_to_pt, lvls, weight, threshold,
                              max_iters, roundtrip_px, min_variance, active, fn)
    return BIDIRECTIONAL_GRAPHS(
        pyr_from.data, lane_offsets(pyr_from, K, dev), pyr_to.data, lane_offsets(pyr_to, K, dev),
        from_pt, init_to_pt, lvls, active, weight, depth_from=pyr_from.depth,
        depth_to=pyr_to.depth, threshold=float(threshold), max_iters=int(max_iters),
        roundtrip_px=float(roundtrip_px), min_variance=float(min_variance), fn=fn)
