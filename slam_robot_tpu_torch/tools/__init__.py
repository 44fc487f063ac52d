"""The port's tools: ``parity`` (the parity replay of the JAX package's
``tools/parity.py``), ``parity_nudges`` (is a drift on the card chaos?),
and the Mosaic probes of the JAX package's ``tools/`` on the port's
hand-written CUDA kernels, documented below.

One module per probe script, with the script's name: ``probe_mosaic``,
``probe_mosaic2``, ``probe_mosaic3``, ``probe_mosaic4``,
``probe_newton_kernel``, ``probe_newton_bisect``, ``probe_pyramid_fused``.
Each holds its script's cases under the script's case names and runs them:

    python -m slam_robot_tpu_torch.tools.probe_newton_kernel [--device cuda|cpu]

printing one ``PASS <case>`` or ``FAIL <case>: ...`` line per case and
exiting 1 if any case failed. The device defaults to the CUDA card. On the
card a case passes when its kernel meets both the original's expected
values and its plain PyTorch version within the case's tolerance; on the
CPU the wrapper runs the plain version, which must meet the expected
values. The kernels live in ``ops/cuda/probe_*.py``.

Where an original's inputs are constant (all-ones arrays), a wrong index
or a shared flag would still give the expected values; such a module also
has ``SEEDED``: the same kernels on seeded non-uniform inputs, held against
a reference that does not assume constant inputs. ``main`` runs only the
originals' cases; ``chip_smoke.py`` and the tests run both.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
from typing import Callable

import numpy as np
import torch

from slam_robot_tpu_torch.device import default_device
from slam_robot_tpu_torch.ops.cuda import build

PROBES = ("probe_mosaic", "probe_mosaic2", "probe_mosaic3", "probe_mosaic4",
          "probe_newton_kernel", "probe_newton_bisect", "probe_pyramid_fused")


@dataclasses.dataclass(frozen=True)
class Case:
    """One probe case: its inputs, the wrapper that runs it, the plain
    version, the original's expected values and the tolerance."""

    name: str                     # the original's case name
    kernel: build.Kernel          # the entry point the wrapper launches once
    replaces: str                 # file:line of the TPU kernel
    inputs: Callable[[torch.device], tuple]
    run: Callable                 # the wrapper: kernel on the card, plain on the CPU
    plain: Callable               # the plain PyTorch version
    want: Callable                # the original's expected values
    atol: float = 0.0
    rtol: float = 0.0
    atol_card: float | None = None  # the kernel's tolerance, where it differs
    # one PyTorch call computing the same function, for timing only:
    # library(*inputs) returns the zero-argument call
    library: Callable | None = None
    flops: Callable | None = None   # float32 operations the function needs
    n_bytes: Callable | None = None  # bytes it must move, where not all of
    # every input and output (the default)


def seeded(case: Case, inputs: Callable, want: Callable | None = None,
           tag: str = "seeded") -> Case:
    """``case`` on other inputs, named ``<case> (<tag>)`` (``want`` replaces
    the expected values where the original's hold only for its inputs)."""
    return dataclasses.replace(case, name=f"{case.name} ({tag})", inputs=inputs,
                               want=want or case.want)


def uniform(device, seed: int, shape, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """float32 uniform in [lo, hi) from numpy's default_rng(seed)."""
    a = np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)
    return torch.as_tensor(a, device=device)


def all_cases(kind: str = "CASES") -> list[Case]:
    """Every probe module's ``CASES`` (or ``SEEDED``), in ``PROBES`` order."""
    mods = [importlib.import_module(f"{__name__}.{name}") for name in PROBES]
    return [c for m in mods for c in getattr(m, kind, [])]


def tap_bytes(shape, y0s, x0s, rows: int, cols: int) -> int:
    """Bytes a sampler must read: the distinct float32 pixels of windows
    ``shape`` [F, H, W] that a rows x cols block of taps at lane f's
    (y0s[k][f], x0s[k][f]) reaches, over every k, clipped to the window."""
    f, h, w = shape
    dev = y0s[0].device
    ys = torch.arange(h, device=dev)[None]
    xs = torch.arange(w, device=dev)[None]
    hit = torch.zeros((f, h, w), dtype=torch.bool, device=dev)
    for y0, x0 in zip(y0s, x0s):
        y0, x0 = y0.long()[:, None], x0.long()[:, None]
        in_y = (ys >= y0) & (ys < y0 + rows)
        in_x = (xs >= x0) & (xs < x0 + cols)
        hit |= in_y[:, :, None] & in_x[:, None, :]
    return 4 * int(hit.sum())


def flat_tensors(x) -> list[torch.Tensor]:
    """The tensors of a tensor or a (nested) tuple of them, in order."""
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in flat_tensors(v)]
    return [x] if isinstance(x, torch.Tensor) else []


def _arrays(x) -> list[np.ndarray]:
    if isinstance(x, (tuple, list)):
        return [a for v in x for a in _arrays(v)]
    if isinstance(x, torch.Tensor):
        return [x.detach().cpu().numpy().astype(np.float64)]
    return [np.asarray(x, dtype=np.float64)]


def max_abs_err(got, want) -> float:
    """Largest |got - want| over all outputs; inf when the shapes differ."""
    g, w = _arrays(got), _arrays(want)
    if len(g) != len(w) or any(a.shape != b.shape for a, b in zip(g, w)):
        return float("inf")
    return max((float(np.max(np.abs(a - b))) if a.size else 0.0) for a, b in zip(g, w))


def _close(got, want, atol: float, rtol: float) -> tuple[bool, float]:
    g, w = _arrays(got), _arrays(want)
    err = max_abs_err(got, want)
    ok = err != float("inf") and all(
        bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b))) for a, b in zip(g, w))
    return ok, err


def check(case: Case, device: torch.device) -> tuple[bool, str]:
    """Run ``case`` on ``device``; (passed, what was compared)."""
    args = case.inputs(device)
    got = case.run(*args)
    if device.type == "cuda":
        torch.cuda.synchronize()
    atol = case.atol if device.type != "cuda" or case.atol_card is None else case.atol_card
    tol = f"atol {atol:g}" + (f" rtol {case.rtol:g}" if case.rtol else "")
    ok, err = _close(got, case.want(*args), atol, case.rtol)
    notes = [f"expected values: max_abs_err {err:.3g}"]
    if device.type == "cuda":
        ok_p, err_p = _close(got, case.plain(*args), atol, case.rtol)
        ok = ok and ok_p
        notes.append(f"plain version: max_abs_err {err_p:.3g}")
    return ok, f"{', '.join(notes)} ({tol})"


def main_for(doc: str, cases: list[Case], argv=None) -> int:
    """A probe module's ``main``: run every case, print PASS/FAIL lines."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cuda: the kernels against their plain versions; cpu: the plain versions")
    args = ap.parse_args(argv)
    device = default_device(args.device)
    failed = 0
    for case in cases:
        try:
            ok, detail = check(case, device)
        except Exception as e:  # noqa: BLE001 - a probe reports each case and goes on
            ok, detail = False, f"{type(e).__name__}: {str(e).splitlines()[0][:300]}"
        print(f"{'PASS' if ok else 'FAIL'} {case.name}: {detail}", flush=True)
        failed += not ok
    return 1 if failed else 0
