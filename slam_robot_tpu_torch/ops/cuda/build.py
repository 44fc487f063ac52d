"""Build and load the port's CUDA kernels (``slam_robot_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` file to an object, all sources at
once in parallel processes, and links the objects into one shared library
with a plain C interface, written to ``build/kernels/`` at the repository
root and named by a hash of the sources, so an edited source rebuilds and an
unchanged one loads at once. The library loads with ``ctypes``; every
entry point takes device pointers and the CUDA stream as ``c_void_p``,
integers as ``c_int``, floats as ``c_float`` and a parameter block (a C
struct, :class:`Params`) as packed bytes, and returns the ``cudaError_t``
of its launch.

Nothing here runs at import: the first kernel call builds the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C entry points and their argument types
SIGNATURES = {
    # in, out, H, W, Ho, Wo, stride, k0..k4, stream
    "sep5_reflect101": [_P, _P, _I, _I, _I, _I, _I, _F, _F, _F, _F, _F, _P],
    # in, flat, PyrParams (Params.block), stream
    "pyramid_flat": [_P, _P, _P, _P],
    "pyramid_params_size": [],
    # TrackParams (Params.block), stream
    "newton_track": [_P, _P],
    "newton_track_params_size": [],
    # the tools' probes (ops/cuda/probe_*.py)
    # img, pos, mask, out, H, W, F, WS, case, stream
    "probe_windows": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # img, pos, out, H, W, F, WS, case, stream
    "probe_windows_async": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # img, W
    "probe_windows_async_route": [_P, _I],
    # pos, out, F, n_out, idx, scale, stream
    "probe_fill": [_P, _P, _I, _I, _I, _I, _P],
    # x, out, R, C, case, stream
    "probe_control": [_P, _P, _I, _I, _I, _P],
    # a, b, out, F, M, K, N, stream
    "probe_bmm": [_P, _P, _P, _I, _I, _I, _I, _P],
    # win, xy, out, WS, S, stream
    "probe_band_grad": [_P, _P, _P, _I, _I, _P],
    # in, out, B, G, R, W, case, stream
    "probe_layout": [_P, _P, _I, _I, _I, _I, _I, _P],
    # frac, start, out, B, G, S, L, stream
    "probe_banded_pair": [_P, _P, _P, _I, _I, _I, _I, _P],
    # win, fx, fy, x0, y0, out, F, WH, WW, S, stream
    "probe_sample_grouped": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # win, pos, ref, wmask, out, F, WH, WW, stage, iters, stream
    "probe_newton": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # in, out, H, W, stream
    "probe_decimate": [_P, _P, _I, _I, _P],
    # in, taps, l0, l1, H, W, stream
    "probe_two_level": [_P, _P, _P, _P, _I, _I, _P],
}


class Kernel:
    """A launch counter for one hand-written kernel.

    The wrapper that launches the kernel adds one for each launch and
    nowhere else, so a run can show that its main path went through it.
    """

    def __init__(self, name: str, source: str):
        self.name = name
        self.source = source
        self.launches = 0
        self._fn = None  # the C function, kept from the first launch on

    def fn(self):
        if self._fn is None:
            self._fn = load_library()[self.name]
        return self._fn

    def launch(self, *args, kernels: int = 1) -> None:
        """Call the C entry point, raise if the launch failed, and count the
        ``kernels`` launches that it made."""
        check_launch(self.name, self.fn()(*args))
        self.launches += kernels


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def library_path() -> Path:
    h = hashlib.sha1()
    for src in _sources() + sorted(CSRC.glob("*.cuh")):  # headers rebuild too
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:12]}.so"


def _run(cmds: list[list[str]], verbose: bool) -> None:
    """Run the commands side by side; raise with the output of any that fails."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for c in cmds]
    outs = [p.communicate()[0] for p in procs]
    for cmd, p, text in zip(cmds, procs, outs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed ({p.returncode}):\n{' '.join(cmd)}\n{text}")
        if verbose and text:
            print(text)


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{out.stem}.{os.getpid()}"
    nvcc = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]
    if verbose:
        nvcc.append("-Xptxas=-v")
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    try:
        _run([[*nvcc, "-c", "-o", str(o), str(src)] for o, src in zip(objs, _sources())],
             verbose)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        _run([[_nvcc(), *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)]], verbose)
    finally:
        for o in objs:
            o.unlink(missing_ok=True)
    os.replace(tmp, out)
    return out


@functools.cache
def load_library() -> dict:
    """Build if needed, load with ctypes, and return {name: C function}."""
    lib = ctypes.CDLL(str(build()))
    fns = {}
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


class Params:
    """A C parameter block, a struct passed to an entry point by pointer,
    mirrored field for field: ``layout`` is ((name, struct code, count),
    ...) in the C struct's order (codes P, q, i, f with native alignment).
    ``block`` makes the bytes the entry point reads; the first block checks
    that their size equals the C struct's (the entry point ``size_fn``)."""

    def __init__(self, layout, size_fn: str):
        self.layout = tuple(layout)
        self.size_fn = size_fn
        # the trailing zero-count item pads to the struct's alignment
        align = "q" if any(code in "Pq" for _, code, _ in self.layout) else "i"
        self.fmt = "@" + "".join(f"{n}{code}" for _, code, n in self.layout) + f"0{align}"
        self.checked = False

    def pack(self, **values) -> bytes:
        """The bytes of ``values`` by field name; fields not given are 0,
        array fields are zero-padded."""
        flat = []
        for name, _, n in self.layout:
            v = values.get(name)
            if n == 1:
                flat.append(v or 0)
            else:
                v = list(v or ())
                flat.extend(v + [0] * (n - len(v)))
        return struct.pack(self.fmt, *flat)

    def block(self, **values) -> bytes:
        """``pack`` for an entry point of the library, after checking once
        that the layout has the C struct's size."""
        if not self.checked:
            want = load_library()[self.size_fn]()
            if struct.calcsize(self.fmt) != want:
                raise RuntimeError(f"{self.size_fn}: the C struct is {want} bytes, its Python "
                                   f"mirror {struct.calcsize(self.fmt)}")
            self.checked = True
        return self.pack(**values)


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device | int) -> int:
    """The raw handle of the current CUDA stream on ``device`` (a device or
    its index): ``torch.cuda.current_stream(device).cuda_stream`` without
    building a ``Stream`` object. Read on every launch, never kept: under
    CUDA-graph capture the current stream is the capture's."""
    index = device if isinstance(device, int) else device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def check_cuda(t: torch.Tensor, name: str, shape: tuple | None = None,
               dtype: torch.dtype = torch.float32) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` and ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
