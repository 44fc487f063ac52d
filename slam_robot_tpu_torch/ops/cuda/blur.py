"""Separable 5-tap blur, pyrDown and the flat pyramid: the CUDA kernels of
``csrc/blur.cu`` and their plain PyTorch versions.

Counterpart of ``slam_robot_tpu/ops/pallas/blur.py`` (``_blur_kernel``) and
of the body of ``slam_robot_tpu/ops/pyramid.py``'s ``build_pyramid``.
``sep5`` (entry point ``sep5_reflect101``) is the kernel behind the public
``blur``/``pyr_down``; ``pyramid_flat`` builds the whole flat, edge-padded
pyramid in at most two launches. A CUDA tensor always goes to a kernel; a
CPU tensor always goes to the plain version. There is no fallback.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from slam_robot_tpu_torch.ops.cuda import build

SOURCE = "slam_robot_tpu_torch/csrc/blur.cu"
KERNEL = build.Kernel("sep5_reflect101", SOURCE)
PYRAMID = build.Kernel("pyramid_flat", SOURCE)

PYRDOWN_WEIGHTS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)
PAD = 8            # edge padding of every pyramid level
MAX_LEVELS = 8     # csrc/blur.cu kMaxLevels
TILE = 16          # csrc/blur.cu kPyrTile: launch 1's tile edge at its last level
FUSED_LEVELS = 2   # csrc/blur.cu kFusedLevels: launch 1 computes levels 0..min(2, L-1)
WALK_SMEM = 200 * 1024  # launch 2: shared-memory budget, bytes


@functools.cache
def gaussian_weights(sigma: float, size: int = 5) -> tuple[float, ...]:
    """OpenCV getGaussianKernel, computed in float32 like the reference."""
    i = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-(i * i) / (2.0 * sigma * sigma))
    return tuple((k / torch.sum(k)).tolist())


def _reflect_index(n: int, device) -> torch.Tensor:
    """Rows of an n-long axis padded by 2 on each side with numpy's
    'reflect' (reflect-101; period 2(n-1), constant for n = 1)."""
    i = torch.arange(-2, n + 2, device=device)
    if n == 1:
        return torch.zeros_like(i)
    p = 2 * (n - 1)
    i = torch.remainder(i, p)
    return torch.where(i < n, i, p - i)


def sep5_plain(img: torch.Tensor, weights, stride: int = 1) -> torch.Tensor:
    """Plain version: reflect-101 pad, five shifted adds down the rows, five
    across the columns (ascending taps, blur.py:43-52), then keep every
    ``stride``-th row and column (output size ((h+1)//2, (w+1)//2) at 2).
    Any size: levels of one or two pixels reflect as numpy does."""
    h, w = img.shape
    x = img[_reflect_index(h, img.device)][:, _reflect_index(w, img.device)]
    k = [float(v) for v in weights]
    acc = k[0] * x[0:h, :]
    for i in range(1, 5):
        acc = acc + k[i] * x[i:i + h, :]
    out = k[0] * acc[:, 0:w]
    for j in range(1, 5):
        out = out + k[j] * acc[:, j:j + w]
    if stride == 2:
        out = out[::2, ::2]
    return out.contiguous()


def sep5(img: torch.Tensor, weights, stride: int = 1) -> torch.Tensor:
    """Separable 5-tap reflect-101 correlation of a [H, W] float32 image,
    decimated by ``stride`` (1 or 2). Needs H, W >= 3."""
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    if img.dim() != 2 or min(img.shape) < 3:
        raise ValueError(f"need a [H, W] image with H, W >= 3, got {tuple(img.shape)}")
    if not img.is_cuda:
        return sep5_plain(img, weights, stride)
    build.check_cuda(img, "img")
    h, w = img.shape
    ho, wo = (h + 1) // 2 if stride == 2 else h, (w + 1) // 2 if stride == 2 else w
    out = torch.empty((ho, wo), dtype=torch.float32, device=img.device)
    k = [float(v) for v in weights]
    KERNEL.launch(img.data_ptr(), out.data_ptr(), h, w, ho, wo, stride, *k,
                  build.stream_handle(img.device))
    return out


def blur(img: torch.Tensor, sigma: float = 1.1) -> torch.Tensor:
    """Gaussian 5x5 blur with reflect-101 border (hessian.h:102,113)."""
    return sep5(img, gaussian_weights(sigma), 1)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV pyrDown: binomial 5x5 + 2x decimation to ((h+1)//2, (w+1)//2)."""
    return sep5(img, PYRDOWN_WEIGHTS, 2)


def level_dims(height: int, width: int, depth: int) -> tuple[tuple[int, int], ...]:
    dims = [(height, width)]
    for _ in range(1, depth):
        h, w = dims[-1]
        dims.append(((h + 1) // 2, (w + 1) // 2))
    return tuple(dims)


def pyramid_flat_plain(grey: torch.Tensor, depth: int, sigma0: float = 1.1,
                       sigma_down: float = 0.8, sep=sep5_plain) -> torch.Tensor:
    """The flat pyramid [depth, H+2*PAD, W+2*PAD] of a [H, W] grey image by
    separate passes ``sep(img, weights, stride)``: level 0 blurred with
    ``sigma0``, each further level pyrDown then blurred with ``sigma_down``;
    level l edge-padded by PAD in the top-left corner of plane l, zeros
    elsewhere. With ``sep5_plain`` it is the plain version of
    :func:`pyramid_flat`; with ``sep5`` the 11-launch route it replaced."""
    g = sep(grey, gaussian_weights(float(sigma0)), 1)
    levels = [g]
    for _ in range(1, depth):
        g = sep(sep(g, PYRDOWN_WEIGHTS, 2), gaussian_weights(float(sigma_down)), 1)
        levels.append(g)
    h0, w0 = grey.shape
    flat = torch.zeros((depth, h0 + 2 * PAD, w0 + 2 * PAD), dtype=torch.float32,
                       device=grey.device)
    for lvl, img_l in enumerate(levels):
        hl, wl = img_l.shape
        flat[lvl, : hl + 2 * PAD, : wl + 2 * PAD] = F.pad(
            img_l[None, None], (PAD, PAD, PAD, PAD), mode="replicate")[0, 0]
    return flat


# csrc/blur.cu's PyrParams, field for field
PYR_PARAMS = build.Params(
    (("H", "i", MAX_LEVELS), ("W", "i", MAX_LEVELS), ("L", "i", 1), ("K", "i", 1),
     ("Hp", "i", 1), ("Wp", "i", 1), ("buf1", "i", 1), ("strip", "i", 1), ("buf2", "i", 1),
     ("taps", "f", 15)),
    "pyramid_params_size")


def pyramid_plan(height: int, width: int, depth: int) -> dict:
    """The launch plan of :func:`pyramid_flat` for a ``height`` x ``width``
    frame: the levels launch 1 computes (0..K), its buffer (floats: the
    frame region a TILE x TILE tile of level K needs), and launch 2's strip
    of rows and buffer (level K+1's strip and the level-K rows it reads,
    all columns). Raises where launch 2's buffers exceed its budget."""
    dims = level_dims(height, width, depth)
    k = min(FUSED_LEVELS, depth - 1)
    ext = TILE
    for _ in range(k):
        ext = 2 * (ext + 4 - 1) + 5  # a blur's halo, then the pyrDown it reads
    ext += 4                         # level 0's blur
    buf1 = min(ext, height) * min(ext, width)

    def walk_buf(strip: int) -> int:
        need = 0
        for lv in range(k + 1, depth):
            (h, _), (hs, ws) = dims[lv], dims[lv - 1]
            rows = min(2 * (min(strip, h) + 4 - 1) + 5, hs)
            need = max(need, rows * ws)
        return need

    strip = dims[k + 1][0] if k + 1 < depth else 1
    while strip > 1 and 2 * 4 * walk_buf(strip) > WALK_SMEM:
        strip = (strip + 1) // 2
    buf2 = walk_buf(strip)
    if 2 * 4 * buf2 > WALK_SMEM:
        raise ValueError(f"a {height}x{width} frame is too wide for pyramid_flat's "
                         f"second launch ({2 * 4 * buf2} B of shared memory)")
    return dict(dims=dims, K=k, buf1=buf1, strip=strip, buf2=buf2,
                launches=1 + (k + 1 < depth))


@functools.cache
def _params(height: int, width: int, depth: int, sigma0: float, sigma_down: float):
    """(the packed PyrParams, kernel launches) for one frame size and pair of
    sigmas."""
    plan = pyramid_plan(height, width, depth)
    block = PYR_PARAMS.block(
        H=[h for h, _ in plan["dims"]], W=[w for _, w in plan["dims"]], L=depth, K=plan["K"],
        Hp=height + 2 * PAD, Wp=width + 2 * PAD, buf1=plan["buf1"], strip=plan["strip"],
        buf2=plan["buf2"],
        taps=gaussian_weights(sigma0) + PYRDOWN_WEIGHTS + gaussian_weights(sigma_down))
    return block, plan["launches"]


def pyramid_flat(grey: torch.Tensor, depth: int = 6, sigma0: float = 1.1,
                 sigma_down: float = 0.8) -> torch.Tensor:
    """The flat, edge-padded pyramid [depth, H+2*PAD, W+2*PAD] of a [H, W]
    float32 grey image, as :func:`pyramid_flat_plain` computes it, in one
    launch (depth <= 3) or two."""
    if grey.dim() != 2 or min(grey.shape) < 1:
        raise ValueError(f"need a [H, W] image, got {tuple(grey.shape)}")
    if not 1 <= depth <= MAX_LEVELS:
        raise ValueError(f"depth must be in [1, {MAX_LEVELS}], got {depth}")
    if not grey.is_cuda:
        return pyramid_flat_plain(grey, depth, sigma0, sigma_down)
    build.check_cuda(grey, "grey")
    h, w = grey.shape
    params, launches = _params(h, w, depth, float(sigma0), float(sigma_down))
    flat = torch.empty((depth, h + 2 * PAD, w + 2 * PAD), dtype=torch.float32,
                       device=grey.device)
    PYRAMID.launch(grey.data_ptr(), flat.data_ptr(), params,
                   build.stream_handle(grey.device), kernels=launches)
    return flat
