"""The traced run's capture and its reduction to device figures.

The arithmetic is a copy of the port's ``tools/profile_trace`` (markers
launched around the traced work, the run's bounds on the device's own clock,
the audit of launches against kernels, the categories of device work), kept
here so that the yardstick does not move with the program. One capture
(:func:`capture`) holds the measured window: ``LEAD_MARKS`` markers, the
window's work, one tail marker. Its reduction (:func:`reduce_window`) gives
the window's length and busy time on the device's clock, its kernels, the
device time by category and the audit. A second, short capture with the
host's operators beside the device's (:func:`idle_gaps`) names what the host
was doing while the device was idle.
"""

from __future__ import annotations

import bisect
import re
import time

import torch
from torch.profiler import ProfilerActivity

MARK_KERNEL = "spin_kernel"      # torch.cuda._sleep's kernel: the marker
LEAD_MARKS = 3
LEAD_S, TAIL_S = 0.5, 0.25
CAPTURE_TRIES = 3

# device work by kernel or operator name, tried in order (the port's
# profile_cg categories; hand-written kernels fall to "other")
CATEGORIES = (
    ("memcpy and memset", r"^Memcpy|^Memset|direct_copy_kernel|FillFunctor"),
    ("scatter and index_put_", r"index_put|scatter|index_add|indexing_backward|put_"),
    ("gather and index", r"index|gather|take|masked_select|embedding"),
    ("gemm/gemv and bmm", r"gemm|gemv|bmm|cublas|cutlass|xmma|dot_kernel"),
    ("sort and scan", r"sort|Sort|scan|Scan|radix|Radix"),
    ("reductions", r"reduce_kernel|Reduce"),
    ("elementwise", r"elementwise|vectorized|unrolled"),
)


def category(name: str) -> str:
    for cat, pattern in CATEGORIES:
        if re.search(pattern, name):
            return cat
    return "other"


def mark() -> None:
    torch.cuda._sleep(1)


def _is_device(e) -> bool:
    return e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()


def _is_mark(e) -> bool:
    return _is_device(e) and MARK_KERNEL in e.name()


def _is_kernel(e) -> bool:
    return _is_device(e) and not e.name().startswith(("Memcpy", "Memset"))


def capture(run):
    """``run()`` traced: (its return value, the capture's events). The
    profiler warms on a discarded step; the run sits ``LEAD_S`` after the
    trace's start and ``TAIL_S`` before its end."""
    warm = torch.zeros(8, device="cuda")
    with torch.profiler.profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                 repeat=1)) as prof:
        for _ in range(4):
            warm.add_(1.0)
        torch.cuda.synchronize()
        prof.step()
        time.sleep(LEAD_S)
        for _ in range(LEAD_MARKS):
            mark()
        out = run()
        mark()
        torch.cuda.synchronize()
        time.sleep(TAIL_S)
        prof.step()
    return out, prof.profiler.kineto_results.events()


def audit(events) -> dict:
    """Launches whose kernel the capture lost, against launches and kernels
    (the port's ``profile_trace.audit``)."""
    launches, kernels = set(), set()
    for e in events:
        if _is_device(e):
            if not e.name().startswith(("Memcpy", "Memset")):
                kernels.add(e.correlation_id())
        elif "LaunchKernel" in e.name():
            launches.add(e.correlation_id())
    lost = sorted(launches - kernels)
    return {"kernel_launches": len(launches), "kernels": len(kernels), "lost_launches": len(lost)}


def bounds(events) -> tuple | None:
    """(end of the last lead marker the capture kept, start of the tail
    marker) on the device's clock, and the correlation ids between which the
    run's launches lie; None where the capture kept no lead marker or the
    tail marker is not its last launch."""
    marks = sorted((e for e in events if _is_mark(e)), key=lambda e: e.correlation_id())
    if len(marks) < 2:
        return None
    last_launch = max((e.correlation_id() for e in events
                       if not _is_device(e) and "LaunchKernel" in e.name()), default=None)
    lead, tail = marks[-2], marks[-1]
    if tail.correlation_id() != last_launch:
        return None
    return (lead.start_ns() + lead.duration_ns(), tail.start_ns(),
            lead.correlation_id(), tail.correlation_id())


def _union_ns(intervals) -> int:
    busy, end = 0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy


def reduce_window(events) -> dict | None:
    """The window's figures from a :func:`capture`: ``window_ns`` between the
    markers, ``busy_ns`` (the union of the device operations in it),
    ``kernels``, ``by_category_ns``, ``idle_gaps`` (:func:`idle_gaps`) and the
    capture's ``audit``; None where the markers do not bound the run (a
    capture that lost them)."""
    b = bounds(events)
    if b is None:
        return None
    w0, w1, c0, c1 = b
    ops = [e for e in events if _is_device(e) and c0 < e.correlation_id() < c1]
    inside = [e for e in events if c0 < e.correlation_id() < c1]
    intervals = [(max(e.start_ns(), w0), min(e.start_ns() + e.duration_ns(), w1)) for e in ops]
    cats: dict = {}
    for e in ops:
        cats[category(e.name())] = cats.get(category(e.name()), 0) + e.duration_ns()
    return {"window_ns": w1 - w0, "busy_ns": _union_ns(i for i in intervals if i[1] > i[0]),
            "kernels": sum(1 for e in ops if _is_kernel(e)), "by_category_ns": cats,
            "idle_gaps": idle_gaps(events, ops, (w0, w1)), "audit": audit(inside)}


def captured_window(run) -> tuple:
    """:func:`capture` of ``run`` taken again while its audit finds a lost
    kernel or lost markers, ``CAPTURE_TRIES`` times at most: (run's value,
    :func:`reduce_window`'s figures or None, retakes)."""
    for tries in range(CAPTURE_TRIES):
        out, events = capture(run)
        fig = reduce_window(events)
        if fig is not None and fig["audit"]["lost_launches"] == 0:
            break
    return out, fig, tries


def idle_gaps(events, ops, window: tuple, top: int = 10) -> list:
    """The device's idle time in ``window`` (device ns), by the host operator
    that launched the work which ended each gap (the outermost ``aten::``
    operator around the launch), summed over gaps and largest first:
    [[name, seconds], ...] of the ``top`` largest."""
    w0, w1 = window
    ops = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.correlation_id())
                 for e in ops)
    # the runtime calls that launched device work (kernels, copies, sets)
    launch_at = {e.correlation_id(): e.start_ns() for e in events
                 if e.device_type() == torch.autograd.DeviceType.CPU
                 and e.name().startswith(("cuda", "cu")) and e.correlation_id()}
    host_ops = sorted(((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()) for e in events
                       if e.device_type() == torch.autograd.DeviceType.CPU
                       and e.name().startswith("aten::")), key=lambda o: (o[0], -o[1]))
    outer, reach = [], -1     # outermost operators, in time order
    for s, e, name in host_ops:
        if s >= reach:
            outer.append((s, e, name))
            reach = e
    starts = [s for s, _, _ in outer]

    def host_at(t):
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and outer[i][0] <= t <= outer[i][1]:
            return outer[i][2]
        return "host between operators"

    gaps: dict = {}
    end = w0
    for s, e, corr in ops:
        if s > end:
            name = host_at(launch_at[corr]) if corr in launch_at else "launch not captured"
            gaps[name] = gaps.get(name, 0.0) + (s - end) / 1e9
        end = max(end, e)
    if w1 > end:
        gaps["after the last kernel"] = gaps.get("after the last kernel", 0.0) + (w1 - end) / 1e9
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:top]
