"""Gaussian image pyramids (hessian.h:95-126), flat edge-padded layout.

Port of ``slam_robot_tpu/ops/pyramid.py``. Per MakePyramid: grey f32/255,
GaussianBlur 5x5 sigma=1.1 at level 0; each further level is pyrDown
followed by GaussianBlur 5x5 sigma=0.8. ``build_pyramid`` runs the whole
flat pyramid through ``ops/cuda/blur.pyramid_flat`` (two launches of the
hand-written kernel on a CUDA tensor, its plain version on a CPU one);
``blur`` and ``pyr_down`` run one pass through ``ops/cuda/blur.sep5``.

The pyramid is stored FLAT, as in the JAX package: one
[L, H0+2*PAD, W0+2*PAD] tensor with level l's edge-padded image in the
top-left corner and its true size in ``heights/widths``. Edge padding by
``PAD`` gives getRectSubPix's replicate-border semantics to a plain slice
in the patch extractor.
"""

from __future__ import annotations

import functools

import torch

from slam_robot_tpu_torch.device import span
from slam_robot_tpu_torch.ops.cuda import blur as blur_kernel

PAD = blur_kernel.PAD
level_dims = blur_kernel.level_dims


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


def to_grey(img: torch.Tensor) -> torch.Tensor:
    """RGB (or already-grey) uint8/f32 -> grey f32 in [0,1] with the
    CV_RGB2GRAY weights (0.299, 0.587, 0.114) (hessian.h:100)."""
    if img.dtype == torch.uint8:
        img = img.to(torch.float32) / 255.0
    img = img.to(torch.float32)
    if img.dim() == 3:
        img = img @ _grey_weights(img.device)
    return img


@functools.cache
def _grey_weights(device: torch.device) -> torch.Tensor:
    return torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32, device=device)


@functools.cache
def level_sizes(height: int, width: int, depth: int, device: torch.device):
    """(heights, widths) int32 tensors of a pyramid, made once per size and
    device (a tensor made from host data is a synchronizing copy on a card)."""
    dims = level_dims(height, width, depth)
    return (torch.tensor([d[0] for d in dims], dtype=torch.int32, device=device),
            torch.tensor([d[1] for d in dims], dtype=torch.int32, device=device))


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


@span("pyramid")
def build_pyramid(img: torch.Tensor, depth: int = 6, sigma0: float = 1.1,
                  sigma_down: float = 0.8) -> FlatPyramid:
    """Full MakePyramid as a FlatPyramid: ``blur.pyramid_flat`` on the grey
    image (at most two kernel launches on the card)."""
    g = to_grey(img).contiguous()
    h0, w0 = g.shape
    heights, widths = level_sizes(h0, w0, depth, g.device)
    return FlatPyramid(data=blur_kernel.pyramid_flat(g, depth, sigma0, sigma_down),
                       heights=heights, widths=widths, depth_=depth)
