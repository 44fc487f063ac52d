"""Device, precision pins and the host-sync counter.

The port's entry points run on the CUDA card unless the caller names
another device: :func:`default_device` resolves ``device=None`` to
``cuda`` and raises where torch sees no CUDA device, rather than carrying
on on the CPU.

The JAX package pins ``Precision.HIGHEST`` wherever a matmul touches pixel
coordinates or geometry: reduced-precision matmul inputs quantize a pixel
coordinate near x=640 by ~2 px (``tracker_fused.py:346-348``). The port's
counterpart is to keep every float32 matmul and convolution in full float32:
TF32 off for cuBLAS and for cuDNN (cuDNN defaults to TF32).
"""

from __future__ import annotations

import itertools
import threading
import time

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def default_device(device=None) -> torch.device:
    """``device`` as a ``torch.device``; ``None`` means the CUDA card.

    Raises ``RuntimeError`` when the CUDA card is meant (no device given, or
    a ``cuda`` one) and torch sees no CUDA device: a CPU run asks for it
    with ``device="cpu"``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: torch.cuda.is_available() is False. Pass "
            "device=\"cpu\" (or --device cpu) to run on the CPU.")
    return dev


class Counter:
    """A plain event count, ``n``, that a run reads and resets."""

    def __init__(self):
        self.n = 0


class SyncCounter(Counter):
    """Counts device-to-host reads made for control flow.

    Each read stalls the host until the device has finished the queued work,
    so the per-frame count is the first number a latency study looks at.
    """

    def read(self, t: torch.Tensor):
        """``t.tolist()``, counted as one host sync."""
        self.n += 1
        return t.tolist()


SYNCS = SyncCounter()


class Tally:
    """Named counts, each a host int or a device tensor that grows without a
    host read; :meth:`read` reads them all at once.

    :meth:`keep` and :meth:`peak` hold each value as it comes (a host int, a
    device tensor, or a function that gives one when called) and :meth:`read`
    sums them or takes the largest: no device work a call, and a function's
    work runs at the read, not where the value was made."""

    def __init__(self):
        self.counts = {}
        self.kept = {}
        self.peaks = {}

    def add(self, name: str, n) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def keep(self, name: str, n) -> None:
        self.kept.setdefault(name, []).append(n)

    def peak(self, name: str, n) -> None:
        self.peaks.setdefault(name, []).append(n)

    def read(self) -> dict:
        out = {k: int(v) for k, v in self.counts.items()}
        for held, total in ((self.kept, sum), (self.peaks, max)):
            for k, vs in held.items():
                vs[:] = [int(v() if callable(v) else v) for v in vs]  # release what was held
                out[k] = total(vs)
        return out

    def reset(self) -> None:
        self.counts, self.kept, self.peaks = {}, {}, {}


# what the step's off-by-default knobs did: lanes and sweeps they ran,
# frames they moved or dropped (models/pipeline, models/matcher)
KNOBS = Tally()


def host(t: torch.Tensor):
    """Read a (small) tensor on the host, counting the sync."""
    return SYNCS.read(t)


def tracing() -> bool:
    """Whether a ``torch.profiler`` capture runs in this thread: the spans then
    stamp the device, and the counters fed only while they do are fed."""
    return torch._C._autograd._profiler_enabled()


def _stamp(like=None):
    """Now on the clock of the device the work is queued on: a timing CUDA
    event recorded on the current stream once CUDA is initialized (outside
    a graph capture), else the host's ns (a CPU run, where the device is the
    host). ``like``, a stamp already taken, picks its kind."""
    cuda = (isinstance(like, torch.cuda.Event) if like is not None else
            torch.cuda.is_initialized() and not torch.cuda.is_current_stream_capturing())
    if cuda:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev
    return time.perf_counter_ns()


class _Stamped:
    """One device-stamped span: its name, parent span, request (the ordinal of
    the outermost span it ran under), stamps, and its children's ms."""

    __slots__ = ("name", "parent", "request", "start", "end", "child_ms")

    def __init__(self, name, parent, request):
        self.name, self.parent, self.request = name, parent, request
        self.start, self.end, self.child_ms = _stamp(), None, 0.0

    def ms(self) -> float:
        if isinstance(self.start, torch.cuda.Event):
            return self.start.elapsed_time(self.end)
        return (self.end - self.start) / 1e6


class SpanClock(Tally):
    """Host wall ms by span name, added while ``on`` (off by default): each
    :func:`span` adds the time from entering it to leaving it; nested spans
    count in each enclosing one. ``calls`` counts the spans left.

    Device ms by span name, while a ``torch.profiler`` capture runs
    (:func:`tracing`): each span stamps the device on entry and exit
    (:func:`_stamp`) and is kept in memory with its parent span and its
    request, the ordinal of the outermost span it ran under (one
    ``ba_cg_solve`` where the caller runs the solver alone).
    :meth:`read_device` resolves them; :meth:`reset` leaves them."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.calls = {}
        self._starts = threading.local()
        self._open = threading.local()
        self._requests = itertools.count(1)
        self._left = []      # stamped spans left, each before its parent
        self.device = {}     # resolved: name -> calls, ms, self_ms, request ordinals

    def read(self) -> dict:
        return dict(self.counts)

    def reset(self) -> None:
        super().reset()
        self.calls = {}

    def enter(self) -> None:
        self._starts.__dict__.setdefault("stack", []).append(time.perf_counter())

    def leave(self, name: str) -> None:
        self.add(name, 1e3 * (time.perf_counter() - self._starts.stack.pop()))
        self.calls[name] = self.calls.get(name, 0) + 1

    def stamp_enter(self, name: str) -> _Stamped:
        stack = self._open.__dict__.setdefault("stack", [])
        parent = stack[-1] if stack else None
        request = next(self._requests) if parent is None else parent.request
        s = _Stamped(name, parent, request)
        stack.append(s)
        return s

    def stamp_leave(self, s: _Stamped) -> None:
        s.end = _stamp(like=s.start)
        self._open.stack.pop()
        self._left.append(s)

    def read_device(self) -> dict:
        """Device ms by span name over every stamped span left since
        :meth:`reset_device`: ``calls``, ``ms`` (inclusive), ``self_ms``
        (``ms`` less what its child spans cover) and ``requests`` (the
        outermost spans it ran under). The spans left since the last read
        are resolved after one synchronize, and their events released."""
        left, self._left = self._left, []
        if any(isinstance(s.start, torch.cuda.Event) for s in left):
            torch.cuda.synchronize()
        for s in left:
            ms = s.ms()
            if s.parent is not None:
                s.parent.child_ms += ms
            t = self.device.setdefault(s.name, {"calls": 0, "ms": 0.0, "self_ms": 0.0,
                                                "requests": set()})
            t["calls"] += 1
            t["ms"] += ms
            t["self_ms"] += ms - s.child_ms
            t["requests"].add(s.request)
        return {k: dict(v, requests=len(v["requests"])) for k, v in self.device.items()}

    def reset_device(self) -> None:
        self._left, self.device = [], {}


# host ms by span (tools/profile_trace turns it on for an unprofiled pass);
# device ms by span while a torch.profiler capture runs
SPAN_MS = SpanClock()


class _Span(torch.profiler.record_function):
    """``record_function`` that also feeds :data:`SPAN_MS`: host ms while it
    is on, device stamps while a profiler capture runs."""

    def __enter__(self):
        self._timed = SPAN_MS.on
        if self._timed:
            SPAN_MS.enter()
        self._stamped = SPAN_MS.stamp_enter(self.name) if tracing() else None
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._stamped is not None:
                SPAN_MS.stamp_leave(self._stamped)
            if self._timed:
                SPAN_MS.leave(self.name)


def span(name: str):
    """A named range for ``torch.profiler`` traces and :data:`SPAN_MS` (a
    context manager or a function decorator); costs ~10 us a call when no
    profiler runs."""
    return _Span(name)
