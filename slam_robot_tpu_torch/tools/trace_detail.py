"""Re-read a trace that ``profile_trace`` exported and print its device
rows in detail, without the card.

Port of the JAX package's ``tools/trace_detail.py``, which re-read an XLA
trace's ``hlo_stats``. Here the trace is ``torch.profiler``'s Chrome JSON
(``profile_trace``'s export, on the card its first frames with the host's
side too): one row per kernel (on the CPU, per operator) name, with its
occurrences, total and a-frame us, category, and the spans it ran in,
which stand in for the xplane's source info: for each occurrence the
innermost ``record_function`` range (``device.span``) around its launch.
Before the rows it prints B1's and B2's rows against the port's launch
counters over the traced pass (``launches.json`` beside the trace), with
"SHORT" where the trace lost some, and the launches that have no kernel in
the trace.

    python -m slam_robot_tpu_torch.tools.trace_detail [--match track_kernel] [--top 30] [--frames 2] [--json]
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys

from slam_robot_tpu_torch.tools.profile_trace import (DETAIL_FRAMES, LAUNCHES_FILE, TRACE_DIR,
                                                      category)

# Chrome-trace categories: device work (on the card's timeline, or the
# CPU's operators), spans (host ranges and their device-side copies), and
# the host's launch calls, which a kernel names by its correlation id
DEVICE_WORK = {"kernel", "gpu_memcpy", "gpu_memset"}
WORK = DEVICE_WORK | {"cpu_op"}
SPANS = {"gpu_user_annotation", "user_annotation"}
LAUNCHES = {"cuda_runtime", "cuda_driver"}


def _track(e: dict):
    """The timeline an event lies on: the device (its spans lie on the
    device's own row, not the kernels' stream) or the host thread."""
    if e["cat"] in DEVICE_WORK or e["cat"] == "gpu_user_annotation":
        return e.get("pid")
    return e.get("pid"), e.get("tid")


def _fold_repeats(ops: list) -> list:
    """The operator events ``key_averages`` counts: as ``torch.profiler``
    does (``EventList._remove_dup_nodes``), an operator that is the only
    child of an operator of the same name on its thread is folded into it
    (``aten::add(Tensor, Scalar)`` calling ``aten::add(Tensor, Tensor)`` is
    one call). ``ops`` are one thread's events sorted by start."""
    parent, children = {}, collections.defaultdict(list)
    stack = []
    for i, e in enumerate(ops):
        end = e["ts"] + e.get("dur", 0)
        while stack and ops[stack[-1]]["ts"] + ops[stack[-1]].get("dur", 0) + 0.01 < end:
            stack.pop()
        if stack:
            parent[i] = stack[-1]
            children[stack[-1]].append(i)
        stack.append(i)
    gone = set()
    for i, e in enumerate(ops):  # parents before children
        p = parent.get(i)
        if p is not None and ops[p]["name"] == e["name"] and len(children[p]) == 1:
            gone.add(i)
            children[p] = children[i]
            for c in children[i]:
                parent[c] = p
    return [e for i, e in enumerate(ops) if i not in gone]


def read(path: str) -> tuple[list, dict]:
    """(rows, audit) of the trace at ``path``.

    ``rows``: one dict per work name (the device's kernels, copies and
    sets; in a CPU trace its operators): ``name``, ``cat``
    (``profile_trace.category``), ``occ``, ``us`` (total duration) and
    ``spans`` (a Counter over its occurrences of the innermost enclosing
    span's name, "-" where none encloses it), largest ``us`` first. A
    kernel's span is the one that enclosed its launch on the host (the
    launch call with the kernel's correlation id), else the device-side
    span that encloses it on the card's timeline.

    ``audit``: the host's kernel launches that have no kernel in the trace
    (``lost_launches``, with the spans they were made in; launches before
    the last of ``profile_trace.traced``'s lead markers that the trace
    kept, where it has one, are the warm-up step's or a marker's and left
    out), kernels with no
    launch (``unlaunched_kernels``), and the least time from a launch to the
    start of its kernel (``min_launch_to_kernel_us``; a kernel cannot start
    before its launch, so a negative value means the device's time stamps
    run early against the host's)."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    events = [e for e in events
              if e.get("ph") == "X" and e.get("cat") in WORK | SPANS | LAUNCHES]
    # a card's trace also holds the host's operators: its rows are the
    # device's work (and its operators are left out); a CPU trace's rows
    # are its operators
    if any(e["cat"] in DEVICE_WORK for e in events):
        work = DEVICE_WORK
        events = [e for e in events if e["cat"] != "cpu_op"]
    else:
        work = {"cpu_op"}
    # spans first at equal start, longer (enclosing) ones first
    events.sort(key=lambda e: (e["ts"], e["cat"] not in SPANS, -e.get("dur", 0)))
    threads = collections.defaultdict(list)
    for e in events:
        if e["cat"] == "cpu_op":
            threads[_track(e)].append(e)
    kept = {id(e) for ops in threads.values() for e in _fold_repeats(ops)}
    open_spans = collections.defaultdict(list)
    launched_in = {}
    kernel_launches = {}
    kernel_corrs = set()
    by_name = {}
    done = []
    min_gap = None
    for e in events:
        end = e["ts"] + e.get("dur", 0)
        stack = open_spans[_track(e)]
        # a span still open encloses this event unless it ends first (0.01
        # us of slack for the trace's rounding)
        while stack and stack[-1][1] + 0.01 < end:
            stack.pop()
        inner = stack[-1][0] if stack else "-"
        if e["cat"] in SPANS:
            stack.append((e["name"], end))
            continue
        corr = e.get("args", {}).get("correlation")
        if e["cat"] in LAUNCHES:
            launched_in[corr] = inner
            if "LaunchKernel" in e["name"]:
                kernel_launches[corr] = (inner, e["ts"])
            continue
        if e["cat"] in work and (e["cat"] != "cpu_op" or id(e) in kept):
            done.append((e, corr, inner))
    # a kernel may sort before its launch (the device's time stamps running
    # early), so kernels meet their launches once every launch is read
    for e, corr, inner in done:
        if e["cat"] == "kernel":
            kernel_corrs.add(corr)
            if corr in kernel_launches:
                gap = e["ts"] - kernel_launches[corr][1]
                min_gap = gap if min_gap is None else min(min_gap, gap)
        if e["cat"] in DEVICE_WORK and launched_in.get(corr, "-") != "-":
            inner = launched_in[corr]
        r = by_name.setdefault(e["name"], {"name": e["name"], "cat": category(e["name"]),
                                           "occ": 0, "us": 0.0,
                                           "spans": collections.Counter()})
        r["occ"] += 1
        r["us"] += e.get("dur", 0)
        r["spans"][inner] += 1
    # the run starts after the last of profile_trace.traced's lead marker
    # kernels that the trace kept (its tail marker, the trace's last launch,
    # follows the run); a launch before it is the warm-up step's (whose
    # kernel ran before the window) or a lead marker's
    tail = max(kernel_launches, default=None)
    start = max((corr for e, corr, _ in done if "spin_kernel" in e["name"] and corr != tail),
                default=None)
    lost = collections.Counter(span for corr, (span, _) in kernel_launches.items()
                               if corr not in kernel_corrs and (start is None or corr > start))
    audit = {"kernel_launches": len(kernel_launches), "lost_launches": sum(lost.values()),
             "lost_launch_spans": dict(lost),
             "unlaunched_kernels": len(kernel_corrs - set(kernel_launches)),
             "min_launch_to_kernel_us": min_gap}
    return sorted(by_name.values(), key=lambda r: -r["us"]), audit


def rows(path: str) -> list:
    """The rows of :func:`read`."""
    return read(path)[0]


def shortfall(path: str, rows: list) -> dict | None:
    """B1's and B2's rows in the trace at ``path`` against the port's launch
    counters over the traced pass (``profile_trace`` writes them beside the
    trace as ``launches.json``): {kernel: [rows, counted]}, or None without
    that file."""
    side = os.path.join(os.path.dirname(path), LAUNCHES_FILE)
    if not os.path.exists(side):
        return None
    with open(side) as f:
        counted = json.load(f)["counted_launches"]
    occ = collections.Counter()
    for r in rows:
        occ[r["cat"]] += r["occ"]
    return {k: [occ[k], n] for k, n in counted.items()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--match", default="")
    ap.add_argument("--top", type=int, default=30)
    ap.add_argument("--frames", type=int, default=DETAIL_FRAMES,
                    help="frames the trace holds (profile_trace's detail pass)")
    ap.add_argument("--trace", default=os.path.join(TRACE_DIR, "trace.json"))
    ap.add_argument("--json", action="store_true",
                    help="print one JSON object: every row, the shortfall and the audit")
    args = ap.parse_args(argv)
    if not os.path.exists(args.trace):
        print(f"trace_detail: no trace at {args.trace}", file=sys.stderr)
        return 1
    found, audit = read(args.trace)
    short = shortfall(args.trace, found)
    if args.json:
        print(json.dumps({"rows": [dict(r, spans=dict(r["spans"])) for r in found],
                          "shortfall": short, "audit": audit}))
        return 0
    if short is not None:
        # a trace may lack kernels that ran (the profiler keeps only device
        # activity inside its window): say so before any row
        missing = {k: n - got for k, (got, n) in short.items() if got < n}
        print(f"B1/B2 rows against the port's counters over the traced pass: "
              f"{json.dumps(short)}; "
              + (f"SHORT by {json.dumps(missing)}: the rows are incomplete" if missing
                 else "complete"))
    print(f"launches: {json.dumps(audit)}")
    n = 0
    for r in found:
        if args.match and args.match not in r["name"]:
            continue
        n += 1
        if n > args.top:
            break
        spans = ", ".join(f"{k} x{v}" for k, v in r["spans"].most_common(4))
        print(f"== {r['name'][:160]}")
        print(f"    [{r['cat']}]  {r['us'] / args.frames:.1f} us/frame  occ={r['occ']}  "
              f"total={r['us']:.0f} us")
        print(f"    span: {spans}")
        print()
    return 0


if __name__ == "__main__":
    sys.exit(main())
