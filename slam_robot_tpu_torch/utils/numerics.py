"""Float guards over every operation of a step: the counterpart of JAX's
``checkify.float_checks`` for ``pipeline.checked_step``.

:class:`NanGuard` is a ``TorchDispatchMode``: while it is active, every aten
operation that runs (inside the port's code, inside ``torch.func``
transforms, on any device) passes through it. For each operation it tests
the floating outputs for NaN and, for an integer division, the divisor for
zero. The test result stays on the device: one 0-d bool per checked
operation, read on the host once, by :meth:`CheckError.get`. The guard
only observes: it changes no value, so a guarded step computes exactly what
an unguarded one does. The hand-written CUDA kernels launch outside the
dispatcher: a NaN one of them writes shows at the first operation that
reads it.

Skipped: the allocating operations (``empty`` and friends), whose output is
uninitialised memory until a kernel or a copy fills it (the operation that
fills it is checked); views, which make no values (the operation that wrote
the viewed tensor is checked, and a NaN in an input of the step shows at
the first operation that computes with it); and forward-mode AD's symbolic
zero tangents (``_efficientzerotensor``) and shape-only tensors on the
``meta`` device, which hold no values to read.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode

_UNINITIALISED = {"empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided", "resize_", "set_"}
_INT_DIVISION = {"div", "div_", "floor_divide", "floor_divide_", "remainder",
                 "remainder_", "fmod", "fmod_"}


def _is_int(x) -> bool:
    if isinstance(x, torch.Tensor):
        return not (x.is_floating_point() or x.is_complex())
    return isinstance(x, int)


class NanGuard(TorchDispatchMode):
    """Record, per operation, whether it produced a NaN or divided an
    integer by zero. Use as a context manager around the guarded code."""

    def __init__(self):
        super().__init__()
        self.n_ops = 0
        # per check: (operation index, op name, failure kind)
        self._checks: list[tuple[int, str, str]] = []
        self._flags: dict[torch.device, tuple[list, list]] = {}
        self._host_fail: int | None = None

    def _record(self, flag: torch.Tensor, name: str, kind: str) -> None:
        idx, flags = self._flags.setdefault(flag.device, ([], []))
        idx.append(len(self._checks))
        flags.append(flag)
        self._checks.append((self.n_ops, name, kind))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        self.n_ops += 1
        op = func.overloadpacket.__name__
        if op in _UNINITIALISED or func.is_view:
            return out
        name = str(func)
        # integer division: a true division of integers gives floats
        int_div = op in _INT_DIVISION and not (
            op.startswith("div") and kwargs.get("rounding_mode") is None)
        if int_div and len(args) >= 2 and _is_int(args[0]) and _is_int(args[1]):
            divisor = args[1]
            if isinstance(divisor, torch.Tensor):
                if divisor.device.type != "meta":
                    self._record(torch.any(divisor == 0), name, "division by zero")
            elif divisor == 0 and self._host_fail is None:
                self._host_fail = len(self._checks)
                self._checks.append((self.n_ops, name, "division by zero"))
        outs = out if isinstance(out, (tuple, list)) else (out,)
        for t in outs:
            if (isinstance(t, torch.Tensor) and t.is_floating_point() and t.numel()
                    and t.device.type != "meta" and not t._is_zerotensor()):
                self._record(torch.any(torch.isnan(t)), name, "nan generated")
        return out

    def first_failure(self) -> tuple[int, str, str] | None:
        """(operation index, op name, failure kind) of the first failing
        operation, or None. One host read per device used."""
        first = self._host_fail
        for idx, flags in self._flags.values():
            bad = torch.stack(flags)
            hit, at = torch.stack([bad.any().long(), bad.long().argmax()]).tolist()
            if hit:
                first = idx[at] if first is None else min(first, idx[at])
        return None if first is None else self._checks[first]


class CheckError:
    """The error value of ``checked_step``, shaped like checkify's:
    :meth:`get` gives None or a message, :meth:`throw` raises it."""

    def __init__(self, guard: NanGuard):
        self._guard = guard
        self._msg: str | None = None
        self._read = False

    def get(self) -> str | None:
        if not self._read:
            fail = self._guard.first_failure()
            self._read = True
            if fail is not None:
                i, name, kind = fail
                self._msg = (f"{kind} by {name} (operation {i} of the step's "
                             f"{self._guard.n_ops})")
        return self._msg

    def throw(self) -> None:
        msg = self.get()
        if msg is not None:
            raise FloatingPointError(msg)
