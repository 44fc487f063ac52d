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
    host read; :meth:`read` reads them all at once."""

    def __init__(self):
        self.counts = {}

    def add(self, name: str, n) -> None:
        self.counts[name] = self.counts.get(name, 0) + n

    def read(self) -> dict:
        return {k: int(v) for k, v in self.counts.items()}

    def reset(self) -> None:
        self.counts = {}


# what the step's off-by-default knobs did: lanes and sweeps they ran,
# frames they moved or dropped (models/pipeline, models/matcher)
KNOBS = Tally()


def host(t: torch.Tensor):
    """Read a (small) tensor on the host, counting the sync."""
    return SYNCS.read(t)


class SpanClock(Tally):
    """Host wall ms by span name, added while ``on`` (off by default): each
    :func:`span` adds the time from entering it to leaving it; nested spans
    count in each enclosing one. ``calls`` counts the spans left."""

    def __init__(self):
        super().__init__()
        self.on = False
        self.calls = {}
        self._starts = threading.local()

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


# host ms by span (tools/profile_trace turns it on for an unprofiled pass)
SPAN_MS = SpanClock()


class _Span(torch.profiler.record_function):
    """``record_function`` that also feeds :data:`SPAN_MS` while it is on."""

    def __enter__(self):
        self._timed = SPAN_MS.on
        if self._timed:
            SPAN_MS.enter()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._timed:
                SPAN_MS.leave(self.name)


def span(name: str):
    """A named range for ``torch.profiler`` traces and :data:`SPAN_MS` (a
    function decorator); costs ~10 us a call when no profiler runs."""
    return _Span(name)
