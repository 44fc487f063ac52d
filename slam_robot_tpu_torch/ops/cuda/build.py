"""Build and load the port's CUDA kernels (``slam_robot_tpu_torch/csrc``).

``nvcc`` compiles every ``csrc/*.cu`` file into one shared library with a
plain C interface, written to ``build/kernels/`` at the repository root and
named by a hash of the sources, so an edited source rebuilds and an
unchanged one loads at once. The library loads with ``ctypes``; every
entry point takes device pointers and the CUDA stream as ``c_void_p``,
integers as ``c_int`` and floats as ``c_float``, and returns the
``cudaError_t`` of its launch.

Nothing here runs at import: the first kernel call builds the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
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
    # win, pos0, org, ref, ref_valid, ref_mean, ref_sumsq, active, wmask,
    # bounds, pos_out, status_out, F, WH, WW, threshold, max_iters, stream
    "newton_level": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                     _I, _I, _I, _F, _I, _P],
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

    def fn(self):
        return load_library()[self.name]


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
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS).encode())
    return BUILD_DIR / f"libslam_kernels_{h.hexdigest()[:12]}.so"


def build(verbose: bool = False) -> Path:
    """Compile ``csrc/*.cu`` unless the hashed library already exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [_nvcc(), *ARCH_FLAGS, "-std=c++17", "-O3", "-shared",
           "-Xcompiler", "-fPIC", "-lineinfo", "-o", str(tmp),
           *[str(s) for s in _sources()]]
    if verbose:
        cmd.insert(1, "-Xptxas=-v")
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({res.returncode}):\n{' '.join(cmd)}\n{res.stdout}\n{res.stderr}"
        )
    if verbose and (res.stdout or res.stderr):
        print(res.stdout + res.stderr)
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


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: cudaError {err}")


def stream_handle(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(t: torch.Tensor, name: str, shape: tuple | None = None) -> None:
    """Raise unless ``t`` is a contiguous float32 CUDA tensor of ``shape``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
