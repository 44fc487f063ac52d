"""Separable 5-tap blur and pyrDown: the CUDA kernel ``csrc/blur.cu`` and
its plain PyTorch version.

Counterpart of ``slam_robot_tpu/ops/pallas/blur.py`` (``_blur_kernel``).
A CUDA tensor always goes to the kernel; a CPU tensor always goes to the
plain version. There is no fallback between the two.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from slam_robot_tpu_torch.ops.cuda import build

KERNEL = build.Kernel("sep5_reflect101", "slam_robot_tpu_torch/csrc/blur.cu")

PYRDOWN_WEIGHTS = (1.0 / 16, 4.0 / 16, 6.0 / 16, 4.0 / 16, 1.0 / 16)


def gaussian_weights(sigma: float, size: int = 5) -> tuple[float, ...]:
    """OpenCV getGaussianKernel, computed in float32 like the reference."""
    i = torch.arange(size, dtype=torch.float32) - (size - 1) / 2.0
    k = torch.exp(-(i * i) / (2.0 * sigma * sigma))
    return tuple((k / torch.sum(k)).tolist())


def sep5_plain(img: torch.Tensor, weights, stride: int = 1) -> torch.Tensor:
    """Plain version: reflect-101 pad, five shifted adds down the rows, five
    across the columns (ascending taps, blur.py:43-52), then keep every
    ``stride``-th row and column (output size ((h+1)//2, (w+1)//2) at 2)."""
    h, w = img.shape
    x = F.pad(img[None, None], (2, 2, 2, 2), mode="reflect")[0, 0]
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
    err = KERNEL.fn()(img.data_ptr(), out.data_ptr(), h, w, ho, wo, stride,
                      *k, build.stream_handle(img.device))
    build.check_launch(KERNEL.name, err)
    KERNEL.launches += 1
    return out


def blur(img: torch.Tensor, sigma: float = 1.1) -> torch.Tensor:
    """Gaussian 5x5 blur with reflect-101 border (hessian.h:102,113)."""
    return sep5(img, gaussian_weights(sigma), 1)


def pyr_down(img: torch.Tensor) -> torch.Tensor:
    """OpenCV pyrDown: binomial 5x5 + 2x decimation to ((h+1)//2, (w+1)//2)."""
    return sep5(img, PYRDOWN_WEIGHTS, 2)

