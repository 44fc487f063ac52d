"""A device trace of the headline bench's scan, with device time by
category and by kernel, and host time by the step's spans.

Port of the JAX package's ``tools/profile_trace.py``. It builds the
bench's mid-sweep state (``bench.bootstrap``: 96 warm frames, cached with
``utils/checkpoint`` in the temporary directory, one file a checkout, so
that a second run skips the warm), traces one pass of the scan's 64
frames with ``torch.profiler``, times one more unprofiled, and prints:

- the total device self time, a frame;
- the device busy share: that time over the unprofiled pass's wall time
  (the profiler slows the host, so its own wall time would overstate it);
- device ms a frame by category (:data:`CATEGORIES`, the counterparts of
  the original's ``hlo_stats`` categories);
- the top kernels (us total, us a frame, name);
- host ms a frame by the step's spans (``device.span``), read on the host's
  clock during the unprofiled pass (:class:`SpanTimer`): the control time
  that the original's one-program scan hid in its ``while`` overhead;
- the profiled launches of the hand-written kernels beside the port's own
  launch counters over the same pass.

On the card the profiled pass traces device activity only (CUPTI): with
the host's op events a pass of ~1.5M launches takes many minutes to read
back. The trace that ``trace_detail`` re-reads (Chrome JSON in ``--out``,
default ``torchtrace_<checkout>/trace.json`` in the temporary directory)
is one more pass over the first :data:`DETAIL_FRAMES` frames with the
host's operators, launches and spans as well, so that each kernel can be
put in the span that launched it. On
the CPU (``--device cpu``, for the tests) the "device" rows are the CPU's
operator events, and the profiled pass is the one exported.

A process that has run for minutes loses kernels from its traces (ROADMAP
C6), so a long-running caller hands its profiled passes to a fresh process
as a job: :func:`write_job` writes the state, the frames and what to run
into a directory, and :func:`run_job` runs its parts (``--job DIR --part
P``), each in a fresh process of its own, one after the other.

    python -m slam_robot_tpu_torch.tools.profile_trace [--refresh-state] [--top 40] [--frames 64]
    python -m slam_robot_tpu_torch.tools.profile_trace --job DIR [--part trace|cg] [--device cuda]

Without a CUDA device (and without ``--device cpu``) it exits 1 and prints
no result line.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import dataclasses
import functools
import json
import os
import re
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch
from torch.profiler import ProfilerActivity

from slam_robot_tpu_torch import bench
from slam_robot_tpu_torch.config import SlamConfig
from slam_robot_tpu_torch.device import SPAN_MS
from slam_robot_tpu_torch.models import pipeline
from slam_robot_tpu_torch.tools import profiling
from slam_robot_tpu_torch.utils import benchscene, checkpoint

TRACE_DIR = profiling.scratch_path("torchtrace")
N_WARM, N_TIMED = 96, 64
# frames of the exported trace on the card, which also holds the host's
# operators, launches and spans (~10^5 events a frame)
DETAIL_FRAMES = 2
# beside the trace: the port's launch counters over the exported pass
LAUNCHES_FILE = "launches.json"

CATEGORIES = ("newton_track", "pyramid_flat", "other hand-written kernels", "gather and index",
              "gemm/gemv and bmm", "elementwise", "reductions", "scatter and index_put_",
              "memcpy and memset", "other")

# the __global__ functions behind the main path's two hand-written entry
# points (slam_robot_tpu_torch/csrc): B1's newton_track, B2's pyramid_flat
B1_KERNELS = ("track_kernel",)
B2_KERNELS = ("pyramid_tiles_kernel", "pyramid_walk_kernel")

_CSRC = Path(__file__).resolve().parents[1] / "csrc"

# PyTorch's own operators and kernels by name (the CPU's aten:: operator
# names and the card's kernel names), tried in this order
_RULES = (
    ("memcpy and memset", r"^Memcpy|^Memset|^aten::(copy_|fill_|zero_|zeros_like|clone|"
                          r"_to_copy|contiguous)$|direct_copy_kernel|FillFunctor"),
    ("scatter and index_put_", r"index_put|scatter|index_add|indexing_backward|put_"),
    ("gather and index", r"index|gather|take|masked_select|embedding"),
    ("gemm/gemv and bmm", r"gemm|gemv|bmm|cublas|cutlass|xmma|dot_kernel|^aten::(mm|addmm|"
                          r"mv|dot|matmul|baddbmm|addmv)$"),
    ("reductions", r"reduce_kernel|scan|^aten::(sum|mean|max|min|amax|amin|argmax|argmin|"
                   r"any|all|prod|norm|linalg_vector_norm|cumsum|std|var)$"),
    ("elementwise", r"elementwise|^aten::(add|sub|mul|div|neg|abs|sqrt|rsqrt|exp|log|pow|"
                    r"where|clamp|clamp_min|clamp_max|maximum|minimum|eq|ne|lt|le|gt|ge|"
                    r"logical_and|logical_or|logical_not|logical_xor|bitwise_and|bitwise_or|"
                    r"bitwise_not|bitwise_xor|floor|ceil|round|trunc|sin|cos|atan2|sign|"
                    r"remainder|fmod|reciprocal|sigmoid|tanh|square|lerp|addcmul|addcdiv|"
                    r"masked_fill|rsub|floor_divide|hypot|copysign|isnan|isfinite|"
                    r"nan_to_num)_?$"),
)


@functools.cache
def hand_written_kernels() -> frozenset:
    """Every ``__global__`` function in the port's CUDA sources."""
    names = set()
    for src in sorted(_CSRC.glob("*.cu")):
        text = src.read_text()
        names.update(re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)",
                                text))
    return frozenset(names)


def category(name: str) -> str:
    """The category of a device row (a kernel, copy or operator name)."""
    mangled = re.match(r"_Z(\d+)", name)   # CUPTI may give a kernel's mangled name
    if mangled:
        base = name[mangled.end():mangled.end() + int(mangled.group(1))]
    else:
        # the port's kernels sit in an anonymous namespace of their source
        base = re.sub(r"^(void\s+)?(\(anonymous namespace\)::)?", "", name)
        base = base.split("(")[0].split("<")[0].strip()
    if base in B1_KERNELS:
        return "newton_track"
    if base in B2_KERNELS:
        return "pyramid_flat"
    if base in hand_written_kernels():
        return "other hand-written kernels"
    for cat, pattern in _RULES:
        if re.search(pattern, name):
            return cat
    return "other"


def _self_us(e, dev: torch.device) -> float:
    if dev.type != "cuda":
        return e.self_cpu_time_total
    return getattr(e, "self_device_time_total", 0) or getattr(e, "self_cuda_time_total", 0)


def device_rows(averages, dev: torch.device) -> list:
    """(name, count, self us) of the trace's device work from its
    ``key_averages()``: on the card its kernels, copies and sets; on the CPU
    its operators. Spans (``record_function`` ranges, which cover the same
    work) are left out."""
    want = torch.autograd.DeviceType.CUDA if dev.type == "cuda" else torch.autograd.DeviceType.CPU
    return [(e.key, e.count, _self_us(e, dev)) for e in averages
            if e.device_type == want and not getattr(e, "is_user_annotation", False)]


def split(rows) -> tuple[float, dict]:
    """(total self us, {category: self us}) of ``device_rows``."""
    cats = dict.fromkeys(CATEGORIES, 0.0)
    for name, _, us in rows:
        cats[category(name)] += us
    return sum(us for _, _, us in rows), cats


class SpanTimer:
    """Host wall ms by span while it is entered: turns ``device.SPAN_MS`` on
    (every ``device.span`` adds its host time, nested spans in each
    enclosing one) and leaves ``ms`` and ``calls`` by span name. No profiler
    runs, so it costs about a microsecond a span."""

    def __enter__(self):
        SPAN_MS.reset()
        SPAN_MS.on = True
        return self

    def __exit__(self, *exc):
        SPAN_MS.on = False
        self.ms, self.calls = SPAN_MS.read(), dict(SPAN_MS.calls)
        return False


# idle seconds before and after a traced run inside the trace's window: the
# tracer keeps only device activity whose time stamps fall inside it, and a
# card's stamps may run early against the host's (a kernel 2-8 ms before its
# launch, in fresh processes). Late in a long process a host+device pass
# still lost its first ~77 kernels with a 1 s lead, while every kernel it
# kept started after its launch: that loss is not the window's, and
# trace_detail reports it
LEAD_S, TAIL_S = 1.0, 0.25


# a marker launched into a capture, which its events can be split by: on
# the card a kernel (torch.cuda._sleep's), on the CPU a span. The host's calls
# are numbered in order (their correlation ids), so the calls made after a
# marker have larger ids than its own, whatever the device's time stamps say
MARK = "capture_mark"
# markers launched back to back before a traced run; the run starts after
# the last one the capture kept. A capture's first kernel was seen lost on
# the card (profile_cg's padded solve lost its one start marker in three
# takes running), and a lost marker before a kept one costs nothing. One
# more marker, the capture's last launch, closes the run: the two bound the
# run on the device's own clock
LEAD_MARKS = 3


class CaptureLog:
    """Every capture this process made, in order (ROADMAP C6: what precedes
    a capture that loses kernels): per profiler session, its tool, its index
    among the process's sessions, the process's seconds and the kernel
    launches it had made before it, whether trace_detail's reader was still
    running, and the capture's launches and audit ``lost_at`` once audited
    (None until then). The launches are those the captures counted: each
    traced run's, and each unprofiled run of the same work (:meth:`ran`),
    which makes as many; the small launches of setting up a tool are not
    counted."""

    def __init__(self):
        self.t0 = time.perf_counter()
        self.records, self.launched, self.unseen_runs = [], 0, 0
        self.tool, self.reader = None, None

    def open(self) -> None:
        """The record of a session that starts now."""
        rec = {"tool": self.tool, "session": len(self.records),
               "s": round(time.perf_counter() - self.t0, 3), "launches_before": self.launched,
               "reader_running": self.reader is not None and self.reader.poll() is None,
               "launches": None, "lost_at": None}
        self.records.append(rec)

    def close(self, a: dict) -> None:
        """The last session's capture audited (``a``, :func:`audit`): its
        launches counted, and the runs of the same work made unprofiled just
        before it (:meth:`before_next`) counted before it. Nothing when no
        session is open."""
        if not self.records or self.records[-1]["launches"] is not None:
            return
        rec = self.records[-1]
        rec["launches"], rec["lost_at"] = a["kernel_launches"], a["lost_at"]
        if a.get("lost_markers"):
            rec["lost_markers"] = a["lost_markers"]
        earlier = self.unseen_runs * a["kernel_launches"]
        rec["launches_before"] += earlier
        self.launched += earlier + a["kernel_launches"]
        self.unseen_runs = 0

    def before_next(self, runs: int) -> None:
        """``runs`` unprofiled runs of the next capture's work were just made."""
        self.unseen_runs += runs

    def ran(self, launches: int) -> None:
        """An unprofiled run of ``launches`` kernel launches was just made."""
        self.launched += launches


CAPTURES = CaptureLog()


def mark(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda._sleep(1)
    else:
        with torch.profiler.record_function(MARK):
            pass


def _is_mark(e, dev: torch.device) -> bool:
    return "spin_kernel" in e.name() if dev.type == "cuda" else e.name() == MARK


def marks(events, dev: torch.device) -> list:
    """The correlation ids of the capture's markers, in order."""
    return sorted(e.correlation_id() for e in events if _is_mark(e, dev))


def run_bounds(events, dev: torch.device) -> tuple | None:
    """The marker events around :func:`traced`'s run: the last of its lead
    markers that the capture kept and its tail marker; None where the
    capture kept no lead marker or lost the tail one (on the card the
    capture's last kernel launch)."""
    found = marks(events, dev)
    if len(found) < 2:
        return None
    if dev.type == "cuda":
        last = max((e.correlation_id() for e in events if "LaunchKernel" in e.name()),
                   default=None)
        if found[-1] != last:
            return None
    by_corr = {e.correlation_id(): e for e in events if _is_mark(e, dev)}
    return by_corr[found[-2]], by_corr[found[-1]]


def traced(run, dev: torch.device, activities):
    """The profiler after one traced ``run()``. The profiler warms up on a
    first, discarded step (a few small launches), and the run sits
    :data:`LEAD_S` after the traced window's start and :data:`TAIL_S`
    before its end, :data:`LEAD_MARKS` markers (:func:`mark`) launched just
    before it and one just after it: the window may hold the host's record
    of a warm-up launch whose kernel ran before it, or lose its first
    kernel, and :func:`run_events` leaves out what precedes the last lead
    marker kept. The profiler's ``run_ns`` is the run's wall on the host's
    clock, from after the lead markers' launches to the device's end of the
    run and its tail marker."""
    CAPTURES.open()
    warm = torch.zeros(8, device=dev)
    with torch.profiler.profile(activities=activities,
                                schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                 repeat=1)) as prof:
        for _ in range(4):
            warm.add_(1.0)
        profiling.sync(dev)
        prof.step()
        time.sleep(LEAD_S)
        for _ in range(LEAD_MARKS):
            mark(dev)
        t0 = time.perf_counter_ns()
        run()
        mark(dev)
        profiling.sync(dev)
        prof.run_ns = time.perf_counter_ns() - t0
        time.sleep(TAIL_S)
        prof.step()
    return prof


def run_events(prof, dev: torch.device) -> list | None:
    """The events of :func:`traced`'s run: those between the last of its
    lead markers that the capture kept (a later one that it lost is a lost
    launch of the run) and its tail marker (:func:`run_bounds`); None when
    the capture kept no lead marker or lost the tail one."""
    events = capture_events(prof)
    bounds = run_bounds(events, dev)
    if bounds is None:
        return None
    lead, tail = (b.correlation_id() for b in bounds)
    return [e for e in events if lead < e.correlation_id() < tail]


def run_audit(prof, dev: torch.device) -> dict:
    """The :func:`audit` of :func:`traced`'s run (:func:`run_events`). A
    capture that lost every lead marker's kernel, or the tail marker's, has
    lost kernels too: its audit is the whole capture's, with
    ``lost_markers``."""
    events = run_events(prof, dev)
    if events is None:
        a = dict(audit(capture_events(prof)), lost_markers=LEAD_MARKS)
    else:
        a = audit(events)
    CAPTURES.close(a)
    return a


def capture_events(prof) -> list:
    """The events of the capture that ``prof`` (a ``torch.profiler.profile``
    after its active step) holds, as Kineto gives them: without building
    the operator events that ``key_averages()`` builds (minutes for a
    capture of 10^5 launches)."""
    return prof.profiler.kineto_results.events()


def _is_device(e) -> bool:
    """A capture event that is the device's work (a kernel, copy or set;
    not the device-side copy of a ``record_function`` span)."""
    return e.device_type() == torch.autograd.DeviceType.CUDA and not e.is_user_annotation()


def device_time(ops, window: tuple | None, run_ns: int) -> dict:
    """How the device's time in ``ops`` (capture events: ``start_ns()``,
    ``duration_ns()`` and the stream, ``device_resource_id()``) lies against
    itself and against the run that made it, on the clock of the capture's
    own time stamps: per stream its operations, their summed time
    (``busy_ns``) and its span from the first one's start to the last one's
    end (``span_ns``); across streams the first start and the last end
    (``first_ns``, ``last_ns``, ``span_ns``), beside the run's ``window``
    (start, end) between :func:`traced`'s markers (:func:`run_bounds`: the
    last lead marker's end, the tail marker's start; None where unknown) and
    the run's host wall ``run_ns``. On the card a stream runs one operation
    at a time, so a stream's summed time over its span counts something
    twice, and an operation outside the window is not the run's
    (``chip_smoke._gate_profile`` fails both). On the CPU the operations are
    operators, nested ones within each enclosing one: figures for the tests.
    Times in ns, spans also in ms."""
    streams, first, last = {}, None, None
    for e in ops:
        start = e.start_ns()
        end = start + e.duration_ns()
        s = streams.setdefault(str(e.device_resource_id()),
                               {"ops": 0, "busy_ns": 0, "first_ns": start, "last_ns": end})
        s["ops"] += 1
        s["busy_ns"] += e.duration_ns()
        s["first_ns"], s["last_ns"] = min(s["first_ns"], start), max(s["last_ns"], end)
        first = start if first is None else min(first, start)
        last = end if last is None else max(last, end)
    out = {}
    for k, s in sorted(streams.items()):
        span = s["last_ns"] - s["first_ns"]
        out[k] = {"ops": s["ops"], "busy_ns": s["busy_ns"], "span_ns": span,
                  "busy_ms": s["busy_ns"] / 1e6, "span_ms": span / 1e6}
    span = 0 if first is None else last - first
    window_ns = None if window is None else window[1] - window[0]
    return {"streams": out, "first_ns": first, "last_ns": last, "span_ns": span,
            "window": None if window is None else list(window), "window_ns": window_ns,
            "run_ns": run_ns, "span_ms": span / 1e6,
            "window_ms": None if window is None else window_ns / 1e6, "run_ms": run_ns / 1e6}


def audit(events) -> dict:
    """``trace_detail.read``'s audit of a capture read back in process
    (ROADMAP C6): the host's kernel launches (``cudaLaunchKernel``,
    ``cuLaunchKernel`` and the like) that have no kernel with their correlation id
    (``lost_launches``; ``lost_at``, the first five's places in launch
    order), against the launches and kernels the capture holds. A kernel
    that a CUDA graph launched has no such launch (``unlaunched_kernels``),
    and is not lost."""
    launches, kernels = set(), set()
    for e in events:
        if _is_device(e):
            if not e.name().startswith(("Memcpy", "Memset")):
                kernels.add(e.correlation_id())
        elif "LaunchKernel" in e.name():
            launches.add(e.correlation_id())
    order = sorted(launches)
    lost = [i for i, corr in enumerate(order) if corr not in kernels]
    return {"kernel_launches": len(launches), "kernels": len(kernels),
            "lost_launches": len(lost), "unlaunched_kernels": len(kernels - launches),
            "lost_at": lost[:5]}


def audit_fault(a: dict) -> str | None:
    """What is wrong with a capture by its :func:`audit`, or None: a launch
    whose kernel the capture lost, a capture whose markers (:func:`mark`)
    no longer tell its run apart (``lost_markers``: kernels lost), or
    kernels and no launch to hold them against (an audit that cannot see
    the launches proves nothing)."""
    if a.get("lost_markers"):
        return (f"{a['lost_markers']} kernels lost where the markers must tell the run apart, "
                f"so its bounds are unknown")
    if a["lost_launches"]:
        return f"{a['lost_launches']} of {a['kernel_launches']} kernel launches lost their kernel"
    if a["kernels"] and not a["kernel_launches"]:
        return f"{a['kernels']} kernels and no launch in the capture"
    return None


# a capture that lost a kernel (ROADMAP C6) is taken again, CAPTURE_TRIES
# times in all at most; a caller's gate fails on a loss the last one still has
CAPTURE_TRIES = 3


def retaken(take, fault) -> tuple:
    """``take()``, taken again while ``fault(result)`` names a fault, at most
    CAPTURE_TRIES times in all: (the last result, the retakes made)."""
    for retakes in range(CAPTURE_TRIES):
        got = take()
        if fault(got) is None:
            break
    return got, retakes


def busy_share_session(works: dict, dev: torch.device) -> dict:
    """The busy share of each of ``works`` ({name: run}) from one traced
    session (:func:`traced`; on the card device activity only) that runs
    them in turn, a marker (:func:`mark`) before each and after the last, then
    each once on the host's clock. A work's events are those whose
    correlation id (the order of the host's calls) falls between its two
    markers. By name: device busy ms (kernels, copies and sets; spans left
    out), device operations, the busy share of its unprofiled wall time,
    kernel launches and its events' :func:`audit`. The traced pass comes
    first, as in :func:`profile`, so that a fresh process pays its first
    launches there. On the CPU the "device" work is the operators', nested
    ones counted in each enclosing one: a figure for the tests, not a busy
    share. A line whose capture lost a kernel is taken again in a session of
    its own (:func:`retaken`; ``retakes``)."""
    out = _busy_session(works, dev)
    for name, run in works.items():
        if audit_fault(out[name]["audit"]) is not None:
            out[name], retakes = retaken(lambda: _busy_session({name: run}, dev)[name],
                                         lambda f: audit_fault(f["audit"]))
            out[name]["retakes"] = retakes + 1
    return out


def _busy_session(works: dict, dev: torch.device) -> dict:
    """:func:`busy_share_session`'s figures from one traced session."""
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]

    def all_works():  # the last of traced's lead markers opens the first work
        for i, run in enumerate(works.values()):
            if i:
                mark(dev)
            run()

    events = capture_events(traced(all_works, dev, acts))
    found = marks(events, dev)
    n = len(works)
    # the last n markers close the works (traced's tail marker the last)
    # and the one before them opens the first. A lost marker after that
    # start would shift the split and is a lost launch there: then, as when
    # too few markers are left, no work's bounds are known, and every work's
    # capture is faulty (audit_fault)
    lost_markers = max(0, n + 1 - len(found))
    bounds = found[-n - 1:]
    whole = audit(events if lost_markers else
                  [e for e in events if e.correlation_id() > bounds[0]])
    if not lost_markers:
        lost_markers = whole["lost_launches"]
    CAPTURES.close(dict(whole, lost_markers=lost_markers))
    parts = [[] for _ in works]
    for e in events if not lost_markers else ():
        k = bisect.bisect_left(bounds, e.correlation_id()) - 1
        if 0 <= k < len(works) and e.correlation_id() != bounds[k + 1]:
            parts[k].append(e)
    out = {}
    for name, run, evs in zip(works, works.values(), parts):
        if dev.type == "cuda":
            work = [e for e in evs if _is_device(e)]
        else:
            work = [e for e in evs if not e.is_user_annotation()]
        busy_ms = sum(e.duration_ns() for e in work) / 1e6
        profiling.sync(dev)
        t0 = time.perf_counter()
        run()
        profiling.sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
        a = audit(evs)
        CAPTURES.ran(a["kernel_launches"])
        if lost_markers:
            a["lost_markers"] = lost_markers
        out[name] = {"wall_ms": wall_ms, "device_busy_ms": busy_ms, "device_ops": len(work),
                     "busy_share": busy_ms / wall_ms, "kernel_launches": a["kernel_launches"],
                     "audit": a, "retakes": 0}
    return out


def profile(run, dev: torch.device, n_units: int, out_dir: str | None = None,
            top: int = 40, detail=None, detail_units: int | None = None,
            wall_before_ms: float | None = None) -> dict:
    """``run()`` once under ``torch.profiler``, then once on the host's clock
    (with :class:`SpanTimer`). Returns the figures per unit (``n_units``
    frames or iterations in one ``run``): wall ms, device ms, busy share,
    device ms by category, the ``top`` device rows, host ms by span, the
    launches of B1 and B2 in the trace and by the port's counters, the
    profiled run's wall ms (:func:`traced`'s ``run_ns``), every device
    row's count (``counts``), the capture's :func:`audit` and its
    ``retakes`` (:func:`retaken`: a capture that lost a kernel is taken
    again), and the profiled run's :func:`device_time` (the whole run's,
    not a unit's).

    The traced pass comes first: in a fresh process it pays for the first
    launches (each kernel loads on its first one), which would slow an
    unprofiled pass several times and leave the device's time as it is.
    ``wall_before_ms`` is the wall of an unprofiled ``run()`` the caller
    made just before (``profile_cg``'s timed solve): the wall is then the
    mean of the two unprofiled passes on either side of the traced one (a
    saturated card's wall moves by ~1 % from one pass to the next).

    With ``out_dir``, writes the operator table there as
    ``profile_device.txt`` and a Chrome trace as ``trace.json`` for
    ``trace_detail``: on the CPU the profiled pass's; on the card one more
    pass, of ``detail()`` (``detail_units`` units; default ``run``), traced
    with the host's operators, launches and spans beside the device's work,
    and exported after its :func:`audit` (``trace_units``, ``trace_retakes``,
    and the port's counters over that pass as ``trace_counted_launches``)."""
    acts = [ProfilerActivity.CUDA] if dev.type == "cuda" else [ProfilerActivity.CPU]

    def take():
        before = bench.counts()
        prof = traced(run, dev, acts)
        counters = {k: v - before[k] for k, v in bench.counts().items()}
        return prof, counters, run_audit(prof, dev)

    (prof, counters, captured), retakes = retaken(take, lambda got: audit_fault(got[2]))
    bounds = run_bounds(capture_events(prof), dev)
    window = None if bounds is None else (bounds[0].start_ns() + bounds[0].duration_ns(),
                                          bounds[1].start_ns())
    ops = [e for e in run_events(prof, dev) or ()
           if (_is_device(e) if dev.type == "cuda" else not e.is_user_annotation())]
    timing = device_time(ops, window, prof.run_ns)
    with SpanTimer() as spans:
        t0 = time.perf_counter()
        run()
        profiling.sync(dev)
        wall_ms = 1e3 * (time.perf_counter() - t0)
    CAPTURES.ran(captured["kernel_launches"])
    if wall_before_ms is not None:
        wall_ms = (wall_ms + wall_before_ms) / 2
    averages = prof.key_averages()
    rows = device_rows(averages, dev)
    total_us, cats = split(rows)
    in_trace = collections.Counter()
    for name, count, _ in rows:
        in_trace[category(name)] += count
    rows.sort(key=lambda r: -r[2])
    out = {
        "units": n_units, "wall_ms": wall_ms / n_units,
        "profiled_wall_ms": timing["run_ms"] / n_units, "device_time": timing,
        "device_ms": total_us / 1e3 / n_units, "busy_share": total_us / 1e3 / wall_ms,
        "by_category_ms": {k: v / 1e3 / n_units for k, v in cats.items()},
        "top": [{"us_total": us, "us_per_unit": us / n_units, "count": n, "name": name,
                 "category": category(name)} for name, n, us in rows[:top]],
        "counts": {name: n for name, n, _ in rows},
        "device_ops": sum(n for _, n, _ in rows),
        "kernel_launches": sum(n for name, n, _ in rows
                               if not name.startswith(("Memcpy", "Memset"))),
        "host_ms_by_span": {k: v / n_units for k, v in sorted(spans.ms.items())},
        "span_calls": dict(spans.calls),
        "traced_launches": {k: in_trace[k] for k in ("newton_track", "pyramid_flat")},
        "counted_launches": {k: counters[k] for k in ("newton_track", "pyramid_flat")},
        "syncs": counters["syncs"] / n_units,
        "audit": captured, "retakes": retakes,
    }
    if out_dir is not None:
        os.makedirs(out_dir, exist_ok=True)
        out["trace"] = os.path.join(out_dir, "trace.json")
        sort = "self_device_time_total" if dev.type == "cuda" else "self_cpu_time_total"
        with open(os.path.join(out_dir, "profile_device.txt"), "w") as f:
            f.write(averages.table(sort_by=sort, row_limit=60))
        if dev.type == "cuda":
            def take_detail():
                before = bench.counts()
                prof = traced(detail or run, dev, [ProfilerActivity.CPU, ProfilerActivity.CUDA])
                counted = {k: v - before[k] for k, v in bench.counts().items()}
                return prof, counted, run_audit(prof, dev)

            (prof, counted, _), out["trace_retakes"] = retaken(
                take_detail, lambda got: audit_fault(got[2]))
            out["trace_units"] = detail_units or n_units
        else:
            counted, out["trace_units"] = counters, n_units
        out["trace_counted_launches"] = {k: counted[k] for k in ("newton_track", "pyramid_flat")}
        prof.export_chrome_trace(out["trace"])
        with open(os.path.join(out_dir, LAUNCHES_FILE), "w") as f:
            json.dump({"units": out["trace_units"],
                       "counted_launches": out["trace_counted_launches"]}, f)
    return out


def report(p: dict, unit: str, emit=print) -> None:
    """The original's printout of :func:`profile`'s figures: ``unit`` is
    ``frame`` or ``GN iter``."""
    n = p["units"]
    emit(f"\ntotal device self time: {p['device_ms'] * n:.1f} ms "
         f"({p['device_ms']:.3f} ms/{unit})")
    emit(f"device busy share: {100 * p['busy_share']:.2f} % of the unprofiled "
         f"{p['wall_ms']:.2f} ms/{unit} (profiled pass {p['profiled_wall_ms']:.2f} ms/{unit}); "
         f"{p['device_ops'] / n:.1f} device ops/{unit}")
    t = p["device_time"]
    streams = {k: [s["ops"], round(s["busy_ms"], 3), round(s["span_ms"], 3)]
               for k, s in t["streams"].items()}
    window = "unknown" if t["window"] is None else f"{t['window_ms']:.3f} ms"
    emit(f"profiled run: device span {t['span_ms']:.3f} ms, its markers {window} apart on the "
         f"device, the run's host wall {t['run_ms']:.3f} ms; by stream [ops, busy ms, span ms] "
         f"{json.dumps(streams)}")
    emit(f"\n-- by category (ms/{unit}) --")
    for k, v in sorted(p["by_category_ms"].items(), key=lambda kv: -kv[1]):
        emit(f"{k:40s} {v:8.3f}")
    emit(f"\n-- top {len(p['top'])} ops (us total | us/{unit} | name) --")
    for r in p["top"]:
        emit(f"{r['us_total']:10.0f} {r['us_per_unit']:8.1f}  [{r['category'][:18]:18s}] "
             f"{r['name'][:110]}")
    emit(f"\n-- host ms/{unit} by span (unprofiled pass; nested spans count in each) --")
    for k, v in sorted(p["host_ms_by_span"].items(), key=lambda kv: -kv[1]):
        emit(f"{k:40s} {v:8.3f}")
    emit(f"launches in the trace {json.dumps(p['traced_launches'])}, by the port's counters "
         f"{json.dumps(p['counted_launches'])}; {p['syncs']:.2f} host syncs/{unit}")


def state_cache(cfg: SlamConfig, n_warm: int) -> str:
    return profiling.scratch_path(f"bench_state_torch_{cfg.image_width}x{cfg.image_height}"
                                  f"_{cfg.max_features}_w{n_warm}") + ".pt"


def get_state(cfg: SlamConfig, frames, n_warm: int, dev: torch.device, refresh: bool = False,
              cache: str | None = None, emit=print):
    """The bench's mid-sweep state after ``n_warm`` warm frames, read from
    ``cache`` (a ``utils/checkpoint`` file) when it is there and fits, else
    bootstrapped and saved there."""
    cache = cache or state_cache(cfg, n_warm)
    template = pipeline.init(cfg, device=dev)
    if not refresh and os.path.exists(cache):
        try:
            ps = checkpoint.restore(template, cache, dev)
        except (ValueError, KeyError) as e:
            emit(f"state: cache {cache} does not fit ({e}); bootstrapping")
        else:
            emit(f"state: loaded cache {cache}")
            return ps
    t0 = time.perf_counter()
    ps, _, _ = bench.bootstrap(cfg, frames, n_warm, dev, n_eager=0)
    profiling.sync(dev)
    emit(f"state: bootstrapped in {time.perf_counter() - t0:.0f}s")
    checkpoint.save(ps, cache)
    return ps


def trace_scan(ps, imgs: torch.Tensor, cfg: SlamConfig, dev: torch.device,
               out_dir: str | None = TRACE_DIR, top: int = 40, first_pass: bool = True,
               emit=print) -> dict:
    """The scan's first pass over ``imgs`` from ``ps`` (left out without
    ``first_pass``: when the caller has just run these frames from ``ps``,
    or in a fresh process, where :func:`profile`'s traced pass comes first),
    then :func:`profile` of one more; prints and returns its figures."""
    if first_pass:
        t0 = time.perf_counter()
        bench.run_scan(ps, imgs, cfg)
        profiling.sync(dev)
        emit(f"first pass: {time.perf_counter() - t0:.0f}s")
    k = min(DETAIL_FRAMES, imgs.shape[0])
    p = profile(lambda: bench.run_scan(ps, imgs, cfg), dev, imgs.shape[0], out_dir, top,
                detail=lambda: bench.run_scan(ps, imgs[:k], cfg), detail_units=k)
    emit(f"scan: {p['wall_ms']:.2f} ms/frame")
    report(p, "frame", emit)
    if out_dir is not None:
        emit(f"trace: {p['trace']} ({p['trace_units']} frames)")
    return p


# ROADMAP C6: in a process that has profiled and launched for a few minutes,
# CUPTI's kernel time stamps run early against the host's clock (Kineto's
# warning "GPU op timestamp < runtime timestamp", by up to ~0.24 s), and
# Kineto drops the kernels that then start before its window (its
# "Out-of-range" count rises by as many), from a device-only trace as from
# an exported one; a fresh process lost none. A job holds what a
# long-running caller profiles, for fresh processes to run in turn (PARTS):
# "trace", the scan's trace (trace_scan, no first pass), then trace_detail's
# reading of the export, in a process of its own beside the busy shares of
# ``busy`` (bench_suite.busy_works); then "cg", the config-5 tools of ``cg``
# (profile_cg in each layout, then profile_cg_sharded) in a second fresh
# process, whose first capture is config 5's: late in one process the
# config-5 captures were seen to lose their first kernels in every take
JOB_FILE, RESULT_FILE, STATE_FILE, FRAMES_FILE = "job.json", "result.json", "state.pt", "frames.pt"
DETAIL_FILE = "detail.json"
PARTS = ("trace", "cg")
# seconds the job waits for trace_detail after its last solve
DETAIL_TIMEOUT_S = 300
_ROOT = Path(__file__).resolve().parents[2]

def write_job(job_dir: str, ps, imgs: torch.Tensor, cfg: SlamConfig, top: int,
              cg: dict | None = None, busy: dict | None = None) -> None:
    """The job of :func:`run_job` in ``job_dir``: the state ``ps`` (a
    ``utils/checkpoint`` file), the frames ``imgs``, the config and the
    options, ``cg`` those of the config-5 tools ({"layouts", "gn_iters",
    "cg_iters", "top", "small"} of ``profile_cg``, and "shards" of
    ``profile_cg_sharded``, none when empty; None: no solve), ``busy`` those
    of the busy shares ({"small", "steps", "fleet_goals"} of
    ``bench_suite.busy_works``; None: none; they need ``cg`` with the padded
    layout, whose solve is config 5's line)."""
    os.makedirs(job_dir, exist_ok=True)
    checkpoint.save(ps, os.path.join(job_dir, STATE_FILE))
    torch.save(imgs.cpu(), os.path.join(job_dir, FRAMES_FILE))
    job = {"cfg": dataclasses.asdict(cfg), "top": top, "cg": cg}
    if busy is not None:
        job["busy"] = busy
    with open(os.path.join(job_dir, JOB_FILE), "w") as f:
        json.dump(job, f)


def read_job(job_dir: str, dev: torch.device) -> tuple:
    """(state, frames, config, options) of :func:`write_job`'s job, on ``dev``."""
    with open(os.path.join(job_dir, JOB_FILE)) as f:
        job = json.load(f)
    cfg = SlamConfig(**{k: tuple(v) if isinstance(v, list) else v
                        for k, v in job.pop("cfg").items()})
    ps = checkpoint.restore(pipeline.init(cfg, device=dev), os.path.join(job_dir, STATE_FILE),
                            dev)
    imgs = torch.load(os.path.join(job_dir, FRAMES_FILE), weights_only=True).to(dev)
    return ps, imgs, cfg, job


def cg_busy(figures: dict) -> dict:
    """Config 5's busy line from ``profile_cg``'s figures (a solve's)."""
    n = figures["units"]
    return {"wall_ms": figures["wall_ms"] * n, "device_busy_ms": figures["device_ms"] * n,
            "device_ops": figures["device_ops"], "busy_share": figures["busy_share"],
            "kernel_launches": figures["audit"]["kernel_launches"], "audit": figures["audit"],
            "retakes": figures["retakes"], "from": "profile_cg padded"}


def part_file(part: str) -> str:
    return f"result_{part}.json"


def do_job(job_dir: str, dev: torch.device, part: str) -> dict:
    """Part ``part`` (:data:`PARTS`) of the job in ``job_dir`` in this
    process; writes and returns its result: each tool's figures, printed
    lines and seconds, the port's counters over the part (``launches``),
    every capture's record (``captures``, :class:`CaptureLog`) and the
    part's seconds; for "trace" also trace_detail's JSON and the busy shares
    (``busy``, by line, but config 5's)."""
    from slam_robot_tpu_torch.ops import ba_cg
    from slam_robot_tpu_torch.tools import bench_suite, profile_cg

    t_part = time.perf_counter()
    if part == "trace":
        ps, imgs, cfg, job = read_job(job_dir, dev)
    else:  # the config-5 tools take no state
        with open(os.path.join(job_dir, JOB_FILE)) as f:
            job = json.load(f)
    before = bench.counts()
    tools, result = {}, {}
    busy_opts, cg = job.get("busy"), job["cg"]

    def tool(name, fn):
        lines, t0 = [], time.perf_counter()
        CAPTURES.tool = name
        figures = fn(lines.append)
        tools[name] = {"figures": figures, "lines": lines, "s": time.perf_counter() - t0}

    if part == "trace":
        tool("profile_trace", lambda emit: trace_scan(ps, imgs, cfg, dev, job_dir, job["top"],
                                                      first_pass=False, emit=emit))
        trace = tools["profile_trace"]["figures"]["trace"]
        with open(os.path.join(job_dir, DETAIL_FILE), "w") as f:
            reader = subprocess.Popen([sys.executable, "-m",
                                       "slam_robot_tpu_torch.tools.trace_detail",
                                       "--trace", trace, "--json"], stdout=f, cwd=_ROOT)
        CAPTURES.reader = reader
        try:  # the busy shares in one session while trace_detail reads
            if busy_opts is not None:
                t0 = time.perf_counter()
                big = profile_cg.problem(cg["small"], dev)
                CAPTURES.tool = "busy shares"
                result["busy"] = busy_share_session(bench_suite.busy_works(
                    dev, busy_opts["small"], busy_opts["steps"], busy_opts["fleet_goals"], big),
                    dev)
                result["busy_s"] = time.perf_counter() - t0
            rc = reader.wait(timeout=DETAIL_TIMEOUT_S)
        finally:
            if reader.poll() is None:
                reader.kill()
                reader.wait()
        if rc != 0:
            raise RuntimeError(f"trace_detail exited {rc} on {trace}")
        with open(os.path.join(job_dir, DETAIL_FILE)) as f:
            result["detail"] = json.load(f)
    elif part == "cg":
        big = profile_cg.problem(cg["small"], dev)
        for layout in cg["layouts"]:
            cgc = ba_cg.CGConfig(max_free_frames=big[0].shape[0], gn_iters=cg["gn_iters"],
                                 cg_iters=cg["cg_iters"], precond="diag", layout=layout)
            tool(f"profile_cg {layout}", lambda emit: profile_cg.run(
                big, cgc, dev, cg["top"], out_dir=None, emit=emit))
        if cg["shards"]:
            tool("profile_cg_sharded", lambda emit: _sharded(
                dev, cg, big, tools.get("profile_cg padded"), emit))
    else:
        raise ValueError(f"no part {part!r}: one of {PARTS}")
    after = bench.counts()
    result.update(tools=tools, launches={k: v - before[k] for k, v in after.items()},
                  captures=CAPTURES.records, s=time.perf_counter() - t_part)
    with open(os.path.join(job_dir, part_file(part)), "w") as f:
        json.dump(result, f)
    return result


def _sharded(dev: torch.device, cg: dict, big: tuple, padded: dict | None, emit) -> dict:
    """``profile_cg_sharded.run`` over ``cg["shards"]`` on the job's config
    5 problem ``big``, its projection from the padded solve's rate where the
    job measured one; emits each validation row, then the projection."""
    from slam_robot_tpu_torch.tools import profile_cg_sharded

    measured = padded["figures"]["gn_iters_per_s"] if padded is not None else None
    out = profile_cg_sharded.run(dev, tuple(cg["shards"]), small=cg["small"], measured=measured,
                                 big=big, emit=lambda s: None)
    for r in out["validation"]:
        emit(json.dumps(r))
    emit(json.dumps({k: out[k] for k in ("projection_basis", "projection")}))
    return out


def run_job(job_dir: str, dev: torch.device, timeout: float) -> dict:
    """Run :func:`write_job`'s job in fresh processes, one a part
    (``python -m slam_robot_tpu_torch.tools.profile_trace --job DIR --part
    P``; the "cg" part only where the job has ``cg``), each started when the
    one before it has ended, and wait for them at most ``timeout`` s in all.
    Returns the parts' results as one, written to ``RESULT_FILE``: the tools
    of both, the trace's detail and busy shares (config 5's, "5", from the
    padded solve of the second process), the counters summed, every
    capture's record with its process (1 or 2) and each process's seconds
    (``processes``). Raises when a process exits other than 0 or runs out of
    time (it and what it started are then killed)."""
    with open(os.path.join(job_dir, JOB_FILE)) as f:
        job = json.load(f)
    parts = PARTS if job["cg"] is not None else PARTS[:1]
    for name in (RESULT_FILE, *map(part_file, PARTS)):
        if os.path.exists(os.path.join(job_dir, name)):
            os.remove(os.path.join(job_dir, name))
    deadline = time.perf_counter() + timeout
    results = {}
    for part in parts:
        cmd = [sys.executable, "-m", "slam_robot_tpu_torch.tools.profile_trace",
               "--job", os.path.abspath(job_dir), "--part", part, "--device", dev.type]
        proc = subprocess.Popen(cmd, cwd=_ROOT, start_new_session=True)
        try:
            rc = proc.wait(timeout=max(0.0, deadline - time.perf_counter()))
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
            raise RuntimeError(f"the profiling job in {job_dir} ran past {timeout} s") from None
        if rc != 0:
            raise RuntimeError(f"the profiling job in {job_dir} exited {rc} in its {part} part")
        with open(os.path.join(job_dir, part_file(part))) as f:
            results[part] = json.load(f)
    first = results["trace"]
    result = {"tools": dict(first["tools"]), "detail": first["detail"],
              "launches": dict(first["launches"]), "captures": [], "processes": {}}
    for n, (part, r) in enumerate(results.items(), 1):
        if n > 1:
            result["tools"].update(r["tools"])
            for k, v in r["launches"].items():
                result["launches"][k] += v
        result["captures"] += [dict(c, process=n) for c in r["captures"]]
        result["processes"][part] = r["s"]
    if "busy" in first:
        result["busy"] = dict(first["busy"], **{"5": cg_busy(
            result["tools"]["profile_cg padded"]["figures"])})
        result["busy_s"] = first["busy_s"]
    with open(os.path.join(job_dir, RESULT_FILE), "w") as f:
        json.dump(result, f)
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--refresh-state", action="store_true")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--frames", type=int, default=N_TIMED, help="frames a pass")
    ap.add_argument("--out", default=TRACE_DIR, help="directory for trace.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda; cpu for a CPU run)")
    ap.add_argument("--small", action="store_true",
                    help="160x120, depth 4, 96 features, 24 warm frames")
    ap.add_argument("--job", metavar="DIR", help="run a part of the job that write_job left "
                                                  "in DIR")
    ap.add_argument("--part", choices=PARTS, default=PARTS[0], help="the job's part to run")
    args = ap.parse_args(argv)
    dev = profiling.open_device(args.device, "profile_trace")
    if dev is None:
        return 1
    if args.job:
        do_job(args.job, dev, args.part)
        return 0
    cfg = profiling.SMALL if args.small else SlamConfig()
    n_warm = 24 if args.small else N_WARM
    frames = benchscene.make_frames(cfg, n_warm + args.frames, device=dev)
    print(f"device: {profiling.device_line(dev)}", flush=True)
    ps = get_state(cfg, frames, n_warm, dev, refresh=args.refresh_state,
                   emit=lambda s: print(s, flush=True))
    trace_scan(ps, torch.stack(frames[n_warm:]), cfg, dev, args.out, args.top,
               emit=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    # run as the package's module, so that the tools it calls (profile_cg)
    # log their captures in the same CAPTURES
    from slam_robot_tpu_torch.tools import profile_trace

    sys.exit(profile_trace.main())
