"""The fused pyramid probes: the CUDA kernels ``csrc/probe_pyramid.cu`` and
their plain PyTorch versions.

Counterparts of ``tools/probe_pyramid_fused.py`` ``dec_kernel`` (a 2x
decimation) and ``two_level_kernel`` (the first two pyramid levels, blur ->
pyrDown -> blur, in one launch). A CUDA tensor always goes to the kernel; a
CPU tensor always goes to the plain version. There is no fallback.
"""

from __future__ import annotations

import torch

from slam_robot_tpu_torch.ops.cuda import blur, build

SOURCE = "slam_robot_tpu_torch/csrc/probe_pyramid.cu"
DECIMATE = build.Kernel("probe_decimate", SOURCE)
TWO_LEVEL = build.Kernel("probe_two_level", SOURCE)

SIGMA0 = 1.1       # level 0's blur
SIGMA_DOWN = 0.8   # the blur after each pyrDown


def _check_even(img):
    if img.dim() != 2 or img.shape[0] % 2 or img.shape[1] % 2 or min(img.shape) < 6:
        raise ValueError(f"need a [H, W] image with H, W even and >= 6, got {tuple(img.shape)}")


def decimate_plain(img):
    """Plain version, the probe's reshapes: even rows, then even columns."""
    h, w = img.shape
    return img.reshape(h // 2, 2, w)[:, 0, :].reshape(h // 2, w // 2, 2)[:, :, 0]


def decimate(img):
    """img[::2, ::2] of a [H, W] float32 image with H, W even."""
    _check_even(img)
    if not img.is_cuda:
        return decimate_plain(img)
    build.check_cuda(img, "img")
    h, w = img.shape
    out = torch.empty((h // 2, w // 2), dtype=torch.float32, device=img.device)
    DECIMATE.launch(img.data_ptr(), out.data_ptr(), h, w, build.stream_handle(img.device))
    return out


def taps(sigma0: float = SIGMA0, sigma1: float = SIGMA_DOWN):
    """[3, 5] float32: the level-0 blur, pyrDown's binomial, the level-1 blur."""
    return torch.tensor([blur.gaussian_weights(sigma0), blur.PYRDOWN_WEIGHTS,
                         blur.gaussian_weights(sigma1)], dtype=torch.float32)


def two_level_plain(img, k):
    """Plain version, the probe's chain: l0 = sep(x, k0), d = sep(l0, kd) at
    full size, l1 = sep(d[::2, ::2], k1), with kernel B2's plain version."""
    k0, kd, k1 = k.tolist()
    l0 = blur.sep5_plain(img, k0)
    d = blur.sep5_plain(l0, kd)
    return l0, blur.sep5_plain(decimate_plain(d), k1)


def two_level(img, k):
    """The first two pyramid levels of a [H, W] float32 image (H, W even) in
    one launch: (l0 [H, W], l1 [H/2, W/2]). ``k`` [3, 5] the taps of
    :func:`taps`, on the image's device."""
    _check_even(img)
    if tuple(k.shape) != (3, 5):
        raise ValueError(f"taps: expected [3, 5], got {tuple(k.shape)}")
    if not img.is_cuda:
        return two_level_plain(img, k)
    build.check_cuda(img, "img")
    build.check_cuda(k, "taps", (3, 5))
    h, w = img.shape
    l0 = torch.empty((h, w), dtype=torch.float32, device=img.device)
    l1 = torch.empty((h // 2, w // 2), dtype=torch.float32, device=img.device)
    TWO_LEVEL.launch(img.data_ptr(), k.data_ptr(), l0.data_ptr(), l1.data_ptr(), h, w,
                     build.stream_handle(img.device))
    return l0, l1
