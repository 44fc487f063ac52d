"""Per-lane window copies and scalar hand-offs: the CUDA kernels
``csrc/probe_windows.cu`` and their plain PyTorch versions.

Counterparts of the Mosaic probes ``tools/probe_mosaic.py`` (p12, p2b, p6),
``tools/probe_mosaic2.py`` (a-d, h) and ``tools/probe_mosaic3.py`` (i-k, m).
A window's start is clamped so the window fits the image, as
``lax.dynamic_slice`` clamps. A CUDA tensor always goes to the kernel; a CPU
tensor always goes to the plain version. There is no fallback.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops.cuda import build

SOURCE = "slam_robot_tpu_torch/csrc/probe_windows.cu"
WINDOWS = build.Kernel("probe_windows", SOURCE)
WINDOWS_ASYNC = build.Kernel("probe_windows_async", SOURCE)
FILL = build.Kernel("probe_fill", SOURCE)

# cases of probe_windows
INT, FLOORED, ROWS, MASKED, DIAGONAL = range(5)
# cases of probe_windows_async
ONE_BY_ONE, ALL_THEN_WAIT, STAGED = range(3)
# its routes (csrc/probe_windows.cu AsyncRoute): the copy engine's bulk
# copies (the TMA's non-tensor form), or 4-byte cp.async for the images they
# cannot take
CP_ASYNC, BULK = range(2)
ROUTE_NAMES = {CP_ASYNC: "cp.async", BULK: "tma-bulk"}


def windows_plain(img, pos, size: int, case: int = INT, mask=None):
    """Plain version, one lane at a time as the probes' loops: out[f] =
    img[y:y+size, x:x+size] at lane f's (x, y) (int32 positions; FLOORED:
    float32, floored; ROWS: x = 0; DIAGONAL: x = y = pos[0, 0], one window
    [size, size]); MASKED: 2 * img[:size, :size] where mask[f] > 0, else 0."""
    h, w = img.shape
    if case == MASKED:
        win = img[:size, :size] * 2.0
        return torch.stack([win if m > 0 else torch.zeros_like(win) for m in mask.tolist()])
    starts = (torch.floor(pos) if case == FLOORED else pos).tolist()
    if case == DIAGONAL:
        starts = [[starts[0][0], starts[0][0]]]
    out = []
    for px, py in starts:
        x = 0 if case == ROWS else min(max(int(px), 0), w - size)
        y = min(max(int(py), 0), h - size)
        out.append(img[y:y + size, x:x + size])
    out = torch.stack(out)
    return out[0] if case == DIAGONAL else out


def _check_windows(img, pos, size: int, pos_dtype):
    if img.dim() != 2 or not 0 < size <= min(img.shape):
        raise ValueError(f"need a [H, W] image with H, W >= {size}, got {tuple(img.shape)}")
    build.check_cuda(img, "img")
    if pos is not None:
        if pos.dim() != 2 or pos.shape[1] != 2:
            raise ValueError(f"pos: expected [F, 2], got {tuple(pos.shape)}")
        build.check_cuda(pos, "pos", dtype=pos_dtype)


def windows(img, pos, size: int, case: int = INT, mask=None):
    """Windows of ``img`` [H, W] float32 at ``pos`` [F, 2] (x, y): [F, size,
    size] ([size, size] for DIAGONAL). MASKED takes ``mask`` [F] int32 and no
    positions. See :func:`windows_plain`."""
    if case not in (INT, FLOORED, ROWS, MASKED, DIAGONAL):
        raise ValueError(f"unknown case {case}")
    if not img.is_cuda:
        return windows_plain(img, pos, size, case, mask)
    masked = case == MASKED
    _check_windows(img, None if masked else pos, size,
                   torch.float32 if case == FLOORED else torch.int32)
    f = mask.shape[0] if masked else pos.shape[0]
    if masked:
        build.check_cuda(mask, "mask", (f,), torch.int32)
    h, w = img.shape
    shape = (size, size) if case == DIAGONAL else (f, size, size)
    out = torch.empty(shape, dtype=torch.float32, device=img.device)
    WINDOWS.launch(img.data_ptr(), None if masked else pos.data_ptr(),
                   mask.data_ptr() if masked else None, out.data_ptr(), h, w, f, size, case,
                   build.stream_handle(img.device))
    return out


def async_route(img) -> int:
    """The route that :func:`windows_async` takes for ``img`` [H, W] float32
    on the card (the entry point's own choice): BULK where every window
    row's 16-byte-aligned span starts on 16 bytes (a row pitch that is a
    multiple of 16 bytes, an image base on 16 bytes), else CP_ASYNC."""
    return build.load_library()["probe_windows_async_route"](img.data_ptr(), img.shape[1])


def windows_async(img, pos, size: int, case: int = ONE_BY_ONE):
    """The windows of :func:`windows` (int32 positions) copied
    asynchronously through shared memory, the lanes spread over the card's
    SMs, by the copy engine's bulk copies or by cp.async
    (:func:`async_route`): ONE_BY_ONE starts and waits each lane's copy in
    turn, ALL_THEN_WAIT starts all of a block's copies then waits, STAGED
    first stages the positions in shared memory. The entry point refuses a
    block whose shared memory would pass what the card allows (a launch
    error here). The plain version is ``windows_plain``."""
    if case not in (ONE_BY_ONE, ALL_THEN_WAIT, STAGED):
        raise ValueError(f"unknown case {case}")
    if not img.is_cuda:
        return windows_plain(img, pos, size, INT)
    _check_windows(img, pos, size, torch.int32)
    f = pos.shape[0]
    if f == 0:
        raise ValueError("pos: no lanes")
    h, w = img.shape
    out = torch.empty((f, size, size), dtype=torch.float32, device=img.device)
    WINDOWS_ASYNC.launch(img.data_ptr(), pos.data_ptr(), out.data_ptr(), h, w, f, size, case,
                         build.stream_handle(img.device))
    return out


def fill_plain(pos, shape, idx: int, scale: int):
    """Plain version: ``shape`` filled with float(pos[idx, 0] * scale)."""
    v = pos[idx, 0] * scale
    return torch.zeros(shape, dtype=torch.float32, device=pos.device) + v.to(torch.float32)


def fill(pos, shape, idx: int, scale: int = 1):
    """``shape`` filled with pos[idx, 0] * scale (pos [F, 2] int32), the
    column staged through shared memory as the probes stage it in SMEM."""
    f = pos.shape[0]
    if pos.dim() != 2 or pos.shape[1] != 2 or not 0 <= idx < f:
        raise ValueError(f"need pos [F, 2] and 0 <= idx < F, got {tuple(pos.shape)}, {idx}")
    if not pos.is_cuda:
        return fill_plain(pos, shape, idx, scale)
    build.check_cuda(pos, "pos", dtype=torch.int32)
    out = torch.empty(shape, dtype=torch.float32, device=pos.device)
    FILL.launch(pos.data_ptr(), out.data_ptr(), f, out.numel(), idx, scale,
                build.stream_handle(pos.device))
    return out
