"""The port's two hand-written CUDA kernels against their plain PyTorch
versions on the card.

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips: a CUDA kernel has no CPU or
interpret mode. ``make_newton_case`` also feeds the CPU tests of the
Newton kernel's plain version (tests/test_torch_newton.py).

Tolerances: blur atol 1e-5 (five-tap float32 sums in another order);
Newton pos atol 2e-3 px (convergence threshold 1e-3 px: a lane whose last
step lands near it may take one more or one fewer step when the 169-pixel
sums are taken in another order), status equal.
"""

import numpy as np
import pytest
import torch

from slam_robot_tpu_torch.ops import patch as t_patch
from slam_robot_tpu_torch.ops.cuda import blur as t_blur
from slam_robot_tpu_torch.ops.cuda import newton as t_newton

F = 37

ORDER = ("win", "pos0", "org", "ref", "ref_valid", "ref_mean", "ref_sumsq",
         "active", "wmask", "bounds")

BLUR_SHAPES = [(48, 64), (47, 63), (15, 20), (3, 5), (480, 640)]


def make_newton_case(seed: int, wh: int, ww: int):
    """F lanes of smooth random windows with a reference patch cut from a
    shifted copy, so Newton has a real basin to converge into; some lanes
    inactive, three started inside the level's 0.01 px margin."""
    rng = np.random.default_rng(seed)
    base = rng.uniform(0.1, 0.9, size=(F, wh + 8, ww + 8)).astype(np.float32)
    k = np.array([1, 4, 6, 4, 1], np.float32) / 16
    for ax in (1, 2):
        base = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, base)
    win = np.ascontiguousarray(base[:, 4:4 + wh, 4:4 + ww]).astype(np.float32)
    org = rng.integers(-8, 40, size=(F, 2)).astype(np.float32)
    c = np.array([ww / 2.0, wh / 2.0], np.float32)
    pos0 = (org + c + rng.uniform(-2.0, 2.0, size=(F, 2))).astype(np.float32)
    ref = np.stack([base[f, 4 + int(c[1]) - 6 + 1:4 + int(c[1]) + 7 + 1,
                         4 + int(c[0]) - 6:4 + int(c[0]) + 7] for f in range(F)])
    ref = ref.astype(np.float32)
    ref_valid = (rng.uniform(size=(F, 13, 13)) > 0.05).astype(np.float32)
    active = (rng.uniform(size=F) > 0.2).astype(np.float32)
    bounds = np.tile(np.array([[60.0, 50.0]], np.float32), (F, 1))
    pos0[0, 1] = 0.005
    pos0[1, 0] = 0.005
    pos0[2, 0] = 59.999
    active[:3] = 1.0
    return dict(
        win=win, pos0=pos0, org=org, ref=ref, ref_valid=ref_valid,
        ref_mean=ref.mean(axis=(1, 2)), ref_sumsq=(ref * ref).mean(axis=(1, 2)),
        active=active, wmask=t_patch.radial_mask(13).numpy(), bounds=bounds,
    )


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU or interpret mode")
    return torch.device("cuda")


@pytest.mark.cuda
def test_blur_kernel_matches_plain_on_card(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    before = t_blur.KERNEL.launches
    for shape in BLUR_SHAPES:
        x = torch.rand(shape, generator=gen, device=cuda_device)
        for stride in (1, 2):
            got = t_blur.sep5(x, t_blur.gaussian_weights(0.8), stride)
            want = t_blur.sep5_plain(x, t_blur.gaussian_weights(0.8), stride)
            assert got.shape == want.shape
            assert float((got - want).abs().max()) <= 1e-5
    assert t_blur.KERNEL.launches == before + 2 * len(BLUR_SHAPES)


@pytest.mark.cuda
@pytest.mark.parametrize("wh,ww", [(32, 32), (31, 32), (26, 31)])
def test_newton_kernel_matches_plain_on_card(cuda_device, wh, ww):
    case = make_newton_case(wh * 100 + ww, wh, ww)
    args = [torch.as_tensor(case[k], device=cuda_device) for k in ORDER]
    before = t_newton.KERNEL.launches
    got_pos, got_st = t_newton.newton_level(*args, threshold=1e-3, max_iters=6)
    want_pos, want_st = t_newton.newton_window_steps(*args, 1e-3, 6)
    assert t_newton.KERNEL.launches == before + 1
    assert torch.equal(got_st, want_st)
    assert float((got_pos - want_pos).abs().max()) <= 2e-3


@pytest.mark.cuda
def test_kernel_wrappers_reject_bad_inputs(cuda_device):
    """Wrong dtype, shape or device raises instead of launching."""
    x = torch.zeros((16, 16), device=cuda_device, dtype=torch.float64)
    with pytest.raises(ValueError):
        t_blur.sep5(x, t_blur.PYRDOWN_WEIGHTS, 1)
    case = make_newton_case(0, 32, 32)
    args = [torch.as_tensor(case[k], device=cuda_device) for k in ORDER]
    args[3] = args[3][:, :12]  # ref [F,12,13]
    with pytest.raises(ValueError):
        t_newton.newton_level(*args)
