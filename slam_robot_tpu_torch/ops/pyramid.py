"""Gaussian image pyramids (hessian.h:95-126), flat edge-padded layout.

Port of ``slam_robot_tpu/ops/pyramid.py``. Per MakePyramid: grey f32/255,
GaussianBlur 5x5 sigma=1.1 at level 0; each further level is pyrDown
followed by GaussianBlur 5x5 sigma=0.8. Both passes run through
``ops/cuda/blur`` (the hand-written kernel on a CUDA tensor, its plain
version on a CPU one).

The pyramid is stored FLAT, as in the JAX package: one
[L, H0+2*PAD, W0+2*PAD] tensor with level l's edge-padded image in the
top-left corner and its true size in ``heights/widths``. Edge padding by
``PAD`` gives getRectSubPix's replicate-border semantics to a plain slice
in the patch extractor.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from slam_robot_tpu_torch.device import span
from slam_robot_tpu_torch.ops.cuda import blur as blur_kernel

PAD = 8


class FlatPyramid:
    """Edge-padded pyramid stack.

    ``data`` [L(*V), H0+2*PAD, W0+2*PAD]; per-entry true sizes in
    ``heights``/``widths`` (int32 tensors). ``offset`` is a base index into
    the leading axis — an int or a per-lane int tensor — so several pyramids
    can live stacked in one tensor (the matcher's view ring).
    """

    def __init__(self, data, heights, widths, depth_: int = 0, offset=0):
        self.data = data
        self.heights = heights
        self.widths = widths
        self.depth_ = int(depth_)
        self.offset = offset

    @property
    def depth(self) -> int:
        return self.depth_ or self.data.shape[0]


def level_dims(height: int, width: int, depth: int) -> tuple[tuple[int, int], ...]:
    dims = [(height, width)]
    for _ in range(1, depth):
        h, w = dims[-1]
        dims.append(((h + 1) // 2, (w + 1) // 2))
    return tuple(dims)


def to_grey(img: torch.Tensor) -> torch.Tensor:
    """RGB (or already-grey) uint8/f32 -> grey f32 in [0,1] with the
    CV_RGB2GRAY weights (0.299, 0.587, 0.114) (hessian.h:100)."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) / 255.0
    img = img.to(torch.float32)
    if img.dim() == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
        img = img @ w
    return img


@functools.cache
def gaussian_kernel(sigma: float, size: int = 5) -> tuple[float, ...]:
    """OpenCV getGaussianKernel: exp(-(i-c)^2 / (2 sigma^2)), normalized."""
    return blur_kernel.gaussian_weights(sigma, size)


def blur(img: torch.Tensor, sigma: float, size: int = 5) -> torch.Tensor:
    if size != 5:
        raise ValueError("only the 5-tap blur is ported")
    return blur_kernel.sep5(img, gaussian_kernel(float(sigma)), 1)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV pyrDown: binomial 5x5 + 2x decimation to size (n+1)//2."""
    return blur_kernel.pyr_down(img)


def _edge_pad(img: torch.Tensor, pad: int = PAD) -> torch.Tensor:
    return F.pad(img[None, None], (pad, pad, pad, pad), mode="replicate")[0, 0]


@span("pyramid")
def build_pyramid(img: torch.Tensor, depth: int = 6, sigma0: float = 1.1,
                  sigma_down: float = 0.8) -> FlatPyramid:
    """Full MakePyramid as a FlatPyramid: 2*depth - 1 blur-kernel launches."""
    g = to_grey(img).contiguous()
    g = blur(g, sigma0)
    levels = [g]
    for _ in range(1, depth):
        g = blur(pyr_down(g), sigma_down)
        levels.append(g)

    h0, w0 = levels[0].shape
    dims = level_dims(h0, w0, depth)
    flat = torch.zeros((depth, h0 + 2 * PAD, w0 + 2 * PAD), dtype=torch.float32,
                       device=g.device)
    for lvl, img_l in enumerate(levels):
        hl, wl = dims[lvl]
        flat[lvl, : hl + 2 * PAD, : wl + 2 * PAD] = _edge_pad(img_l)
    dev = g.device
    return FlatPyramid(
        data=flat,
        heights=torch.tensor([d[0] for d in dims], dtype=torch.int32, device=dev),
        widths=torch.tensor([d[1] for d in dims], dtype=torch.int32, device=dev),
        depth_=depth,
    )
