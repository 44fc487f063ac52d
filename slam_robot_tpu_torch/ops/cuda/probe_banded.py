"""Banded bilinear sampling and its layouts: the CUDA kernels
``csrc/probe_banded.cu`` and their plain PyTorch versions.

Counterparts of ``tools/probe_mosaic.py`` p3 and p4 and
``tools/probe_mosaic4.py`` g1-g6, the probes that took apart kernel B1's
MXU formulation (``slam_robot_tpu/ops/pallas/newton.py``: ``_banded_pair``,
``_banded_pair_grouped``, ``_expand_rows``, ``_sample_grouped``). A CUDA
tensor always goes to the kernel; a CPU tensor always goes to the plain
version. There is no fallback.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_robot_tpu_torch.ops.cuda import build, newton

SOURCE = "slam_robot_tpu_torch/csrc/probe_banded.cu"
BMM = build.Kernel("probe_bmm", SOURCE)
BAND_GRAD = build.Kernel("probe_band_grad", SOURCE)
LAYOUT = build.Kernel("probe_layout", SOURCE)
BANDED_PAIR = build.Kernel("probe_banded_pair", SOURCE)
SAMPLE_GROUPED = build.Kernel("probe_sample_grouped", SOURCE)

# cases of probe_layout: g1, g2, g4, g5
REPEAT, BROADCAST, MASKED_SUM, BLOCK_TRANSPOSE = range(4)

_MAX_GRID_Y = 65535  # probe_bmm's batch entries: its grid's y extent
_MAX_ELEMENTS = 2**31 - 1  # probe_layout and probe_banded_pair index in 32 bits
_MAX_WINDOW = 32


def bmm_plain(a, b):
    """Plain version: out[f] = a[f] @ b[f] as a broadcast product and sum."""
    return (a[:, :, :, None] * b[:, None, :, :]).sum(2)


def bmm(a, b):
    """Batched product [F, M, K] @ [F, K, N] -> [F, M, N], float32."""
    if a.dim() != 3 or b.dim() != 3 or a.shape[0] != b.shape[0] or a.shape[2] != b.shape[1]:
        raise ValueError(f"need [F, M, K] @ [F, K, N], got {tuple(a.shape)} @ {tuple(b.shape)}")
    if not a.is_cuda:
        return bmm_plain(a, b)
    f, m, k = a.shape
    n = b.shape[2]
    if f > _MAX_GRID_Y:
        raise ValueError(f"{f} batch entries: at most {_MAX_GRID_Y}")
    build.check_cuda(a, "a")
    build.check_cuda(b, "b")
    out = a.new_empty((f, m, n))
    BMM.launch(a.data_ptr(), b.data_ptr(), out.data_ptr(), f, m, k, n,
               build.stream_handle(a.device))
    return out


def band_grad_plain(win, xy, size: int):
    """Plain version of :func:`band_grad`: the hand-derived sums over the
    banded product P = R(x) W and its x-derivative D."""
    ws = win.shape[0]
    x, y = xy[0], xy[1]
    x0f = torch.floor(x)
    fx = x - x0f
    pad = size + 1  # rows past W read 0, as the band's zeros
    wp = F.pad(win, (0, 0, pad, pad))
    x0 = int(x0f) + pad
    rows0 = wp[x0:x0 + size]
    rows1 = wp[x0 + 1:x0 + 1 + size]
    p = (1.0 - fx) * rows0 + fx * rows1
    d = rows1 - rows0
    spp, spd, sdd = (p * p).sum(), (p * d).sum(), (d * d).sum()
    zero = torch.zeros_like(spp)
    return torch.stack([torch.stack([2.0 * y * spd, spp]),
                        torch.stack([2.0 * y * sdd, 2.0 * spd]),
                        torch.stack([2.0 * spd, zero])])


def band_grad(win, xy, size: int):
    """Gradient and Hessian of s(x, y) = y * sum((R(x) W)^2) at ``xy`` [2]:
    [3, 2] = (g, H[0], H[1]). R(x) [size, WS] is the bilinear band at
    floor(x) with weights (1 - fx, fx); W = ``win`` [WS, WS] float32. The
    kernel stages the whole window in one block's shared memory: its entry
    point refuses a window past what a block may take (241 wide and more on
    an H100), a launch error here."""
    if win.dim() != 2 or win.shape[0] != win.shape[1] or tuple(xy.shape) != (2,):
        raise ValueError(f"need win [WS, WS] and xy [2], got {tuple(win.shape)}, {tuple(xy.shape)}")
    if not win.is_cuda:
        return band_grad_plain(win, xy, size)
    build.check_cuda(win, "win")
    build.check_cuda(xy, "xy", (2,))
    out = torch.empty((3, 2), dtype=torch.float32, device=win.device)
    BAND_GRAD.launch(win.data_ptr(), xy.data_ptr(), out.data_ptr(), win.shape[0], size,
                     build.stream_handle(win.device))
    return out


def layout_plain(t, case: int, groups: int, rows: int):
    """Plain version of :func:`layout`."""
    if case == REPEAT:
        return t[:, torch.arange(groups * rows, device=t.device) // rows]
    if case == MASKED_SUM:
        lane = torch.arange(groups * rows, device=t.device)[None] // rows
        out = torch.zeros((t.shape[0], groups * rows), dtype=t.dtype, device=t.device)
        for g in range(groups):
            out = out + torch.where(lane == g, t[:, g:g + 1], torch.zeros((), dtype=t.dtype,
                                                                          device=t.device))
        return out
    if case == BROADCAST:
        return torch.cat([t] * groups, dim=2)
    return torch.cat([t[:, g * rows:(g + 1) * rows].transpose(1, 2) for g in range(groups)],
                     dim=1)


def layout(t, case: int, groups: int, rows: int):
    """The grouped layouts of ``_sample_grouped``'s probes (float32):

    - REPEAT (g1) and MASKED_SUM (g4): t [B, G] -> [B, G*rows], each lane's
      value repeated over its ``rows`` rows (``jnp.repeat``, and the same by
      a G-term iota-masked sum, ``_expand_rows``);
    - BROADCAST (g2): t [B, M, W] -> [B, M, G*W], G copies side by side
      (``rows`` is not used);
    - BLOCK_TRANSPOSE (g5): t [B, G*rows, W] -> [B, G*W, rows], each lane's
      [rows, W] block transposed.

    On either device it refuses more than 2^31 - 1 elements of B x G x
    rows x W (W = 1 for REPEAT and MASKED_SUM): the kernel indexes in 32
    bits.
    """
    if case not in (REPEAT, BROADCAST, MASKED_SUM, BLOCK_TRANSPOSE):
        raise ValueError(f"unknown case {case}")
    if case in (REPEAT, MASKED_SUM):
        if t.dim() != 2 or t.shape[1] != groups:
            raise ValueError(f"need t [B, {groups}], got {tuple(t.shape)}")
        b, w = t.shape[0], 1
        shape = (b, groups * rows)
    else:
        if t.dim() != 3 or (case == BLOCK_TRANSPOSE and t.shape[1] != groups * rows):
            raise ValueError(f"need t [B, {groups * rows}, W], got {tuple(t.shape)}")
        b, w = t.shape[0], t.shape[2]
        if case == BROADCAST:  # the kernel's R is then t's row count
            rows = t.shape[1]
            shape = (b, rows, groups * w)
        else:
            shape = (b, groups * w, rows)
    if b * groups * rows * w > _MAX_ELEMENTS:
        raise ValueError(f"{b} x {groups} x {rows} x {w} elements: the kernel indexes in 32 "
                         f"bits, at most {_MAX_ELEMENTS}")
    if not t.is_cuda:
        return layout_plain(t, case, groups, rows)
    build.check_cuda(t, "t")
    out = t.new_empty(shape)
    LAYOUT.launch(t.data_ptr(), out.data_ptr(), b, groups, rows, w, case,
                  build.stream_handle(t.device))
    return out


def banded_pair_grouped_plain(frac, start, length: int, size: int, groups: int):
    """Plain version: ``_banded_pair_grouped``'s where-expressions."""
    f = frac.shape[0]
    b, m, k = f // groups, groups * 2 * size, groups * length
    dev = frac.device
    r = torch.arange(m, device=dev)
    g = r // (2 * size)
    i2 = r % (2 * size)
    isd = (i2 >= size)[None, :, None]
    i = torch.where(i2 >= size, i2 - size, i2)[None, :, None]
    lane = torch.arange(b, device=dev)[:, None] * groups + g[None, :]     # [B, M]
    fr = frac[lane][:, :, None]
    st = (start[lane] + length * g[None, :])[:, :, None]
    kk = torch.arange(k, device=dev)[None, None, :]
    one = torch.ones((), dtype=frac.dtype, device=dev)
    w0 = torch.where(isd, -one, 1.0 - fr)
    w1 = torch.where(isd, one, fr)
    zero = torch.zeros((), dtype=frac.dtype, device=dev)
    return torch.where(kk == i + st, w0, zero) + torch.where(kk == i + st + 1, w1, zero)


def banded_pair_grouped(frac, start, length: int, size: int, groups: int):
    """Grouped banded selection matrix [F/G, G*2*size, G*length] of lanes'
    ``frac`` [F] float32 and ``start`` [F] int32: each lane's 2*size rows
    hold its bilinear band (1 - frac, frac) and its derivative (-1, +1) at
    columns start+i, start+i+1 of its own block of ``length`` columns.
    On either device it refuses 2^31 elements or more: the kernel indexes
    in 32 bits."""
    f = frac.shape[0]
    if frac.dim() != 1 or tuple(start.shape) != (f,) or groups < 1 or f % groups:
        raise ValueError(f"need frac, start [F] with F % {groups} == 0, got "
                         f"{tuple(frac.shape)}, {tuple(start.shape)}")
    b = f // groups
    if b * (groups * 2 * size) * (groups * length) > _MAX_ELEMENTS:
        raise ValueError(f"[{b}, {groups * 2 * size}, {groups * length}] elements: the kernel "
                         f"indexes in 32 bits, at most {_MAX_ELEMENTS}")
    if not frac.is_cuda:
        return banded_pair_grouped_plain(frac, start, length, size, groups)
    build.check_cuda(frac, "frac")
    build.check_cuda(start, "start", dtype=torch.int32)
    out = torch.empty((b, groups * 2 * size, groups * length), dtype=torch.float32,
                      device=frac.device)
    BANDED_PAIR.launch(frac.data_ptr(), start.data_ptr(), out.data_ptr(), b, groups, size,
                       length, build.stream_handle(frac.device))
    return out


def bilinear_taps(win, x0, y0, size: int):
    """The four taps win[f, y0+i (+1), x0+j (+1)] of every lane's size x
    size patch, each [F, size, size]. Taps outside the window read 0, as the
    band matrices' zeros do."""
    f, wh, ww = win.shape
    pad = size + 2
    wp = F.pad(win, (pad, pad, pad, pad))
    ar = torch.arange(size, device=win.device)
    # a clamped index lands in the zero border, as the unclamped one would
    rows = (y0.long()[:, None] + pad + ar).clamp(0, wh + 2 * pad - 2)[:, :, None]
    cols = (x0.long()[:, None] + pad + ar).clamp(0, ww + 2 * pad - 2)[:, None, :]
    lane = torch.arange(f, device=win.device)[:, None, None]
    return (wp[lane, rows, cols], wp[lane, rows, cols + 1],
            wp[lane, rows + 1, cols], wp[lane, rows + 1, cols + 1])


def sample_grouped_plain(win, fx, fy, x0, y0, size: int):
    """Plain version: four gathered taps per output, rows first (value or
    d/dy), then columns (value or d/dx): kernel B1's ``newton.bilinear``."""
    v, vx, vy, vxy = newton.bilinear(*bilinear_taps(win, x0, y0, size),
                                     fx[:, None, None], fy[:, None, None])
    return torch.cat([torch.cat([v, vx], 2), torch.cat([vy, vxy], 2)], 1)


def sample_grouped(win, fx, fy, x0, y0, size: int, groups: int):
    """``_sample_grouped``: per lane of ``win`` [F, WH, WW] the [2S, 2S]
    blocks [[V, V_x], [V_y, V_xy]] of the size x size bilinear patch at
    (x0 + fx, y0 + fy) (x0, y0 int32 [F]; fx, fy float32 [F]). ``groups``
    G only fed the TPU's MXU: the result does not depend on it, and G must
    divide F as there."""
    f = win.shape[0]
    if win.dim() != 3 or groups < 1 or f % groups:
        raise ValueError(f"need win [F, WH, WW] with F % {groups} == 0, got {tuple(win.shape)}")
    if not win.is_cuda:
        return sample_grouped_plain(win, fx, fy, x0, y0, size)
    _, wh, ww = win.shape
    if wh > _MAX_WINDOW or ww > _MAX_WINDOW:
        raise ValueError(f"window {wh}x{ww} larger than {_MAX_WINDOW}x{_MAX_WINDOW}")
    build.check_cuda(win, "win")
    for name, t, dtype in (("fx", fx, torch.float32), ("fy", fy, torch.float32),
                           ("x0", x0, torch.int32), ("y0", y0, torch.int32)):
        build.check_cuda(t, name, (f,), dtype)
    out = torch.empty((f, 2 * size, 2 * size), dtype=torch.float32, device=win.device)
    SAMPLE_GROUPED.launch(win.data_ptr(), fx.data_ptr(), fy.data_ptr(), x0.data_ptr(),
                          y0.data_ptr(), out.data_ptr(), f, wh, ww, size,
                          build.stream_handle(win.device))
    return out
