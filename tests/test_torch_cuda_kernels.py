"""The port's hand-written CUDA kernels against their plain PyTorch
versions on the card: B1 (``newton_track``, and ``newton_level`` as its
one-level call), B2 (``pyramid_flat`` and ``sep5``) and the tools' probe
kernels, with the launches each makes per pyramid and per sweep; the
alternative trackers' CUDA-graph replay against their eager pass; and the
closed loop on the card (the fleet without a host read, the SLAM loop's
launch gates at run_sim's 120x160 shapes).

This file imports no JAX, so it also runs where only the port is installed:

    python -m pytest --noconftest -o addopts="" tests/test_torch_cuda_kernels.py

Without a CUDA device every test here skips: a CUDA kernel has no CPU or
interpret mode. ``make_newton_case`` also feeds the CPU tests of the
Newton kernel's plain version (tests/test_torch_newton.py).

Tolerances: blur and the flat pyramid atol 1e-5 (five-tap float32 sums in
another order); Newton pos atol 2e-3 px (convergence threshold 1e-3 px: a
lane whose last step lands near it may take one more or one fewer step
when the 169-pixel sums are taken in another order), status and ok equal
but for lanes ending within 2e-3 px of the level's 0.01 px margin; the
backward stack atol 1e-5 against its plain version on the kernel's own
positions and windows (bilinear mixes and means of the same pixels).
Probes: copies, layouts
and loops exact; the batched product rtol 1e-5; the grouped sampling exact
(both sides round each product and sum alone); the two-level pyramid atol
1e-5; the Newton stages atol 1e-3 (6 steps: 2e-3 px).
"""

import importlib
import math


import numpy as np
import pytest
import torch

from slam_robot_tpu_torch import tools
from slam_robot_tpu_torch.ops import patch as t_patch
from slam_robot_tpu_torch.ops import pyramid as t_pyr
from slam_robot_tpu_torch.ops import tracker_fused as t_tf
from slam_robot_tpu_torch.ops.cuda import blur as t_blur
from slam_robot_tpu_torch.ops.cuda import build
from slam_robot_tpu_torch.ops.cuda import newton as t_newton
from slam_robot_tpu_torch.ops.cuda import probe_banded as pb
from slam_robot_tpu_torch.ops.cuda import probe_control as pc
from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
from slam_robot_tpu_torch.ops.cuda import probe_pyramid as pp
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from slam_robot_tpu_torch.tools import probe_mosaic2 as t_m2
from slam_robot_tpu_torch.tools import probe_newton_kernel as t_nk

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
@pytest.mark.parametrize("group", [2, 4])
def test_newton_group_is_group_one_on_card(cuda_device, group):
    """group G runs the same kernel as G = 1: bit-identical results."""
    case = make_newton_case(3, 32, 32)
    args = [torch.as_tensor(case[k][:36] if k != "wmask" else case[k], device=cuda_device)
            for k in ORDER]
    one_pos, one_st = t_newton.newton_level(*args, threshold=1e-3, max_iters=6)
    g_pos, g_st = t_newton.newton_level(*args, threshold=1e-3, max_iters=6, group=group)
    assert torch.equal(g_pos, one_pos) and torch.equal(g_st, one_st)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (47, 63), (6, 8), (120, 158), (720, 1280)])
def test_pyramid_flat_matches_plain_on_card(cuda_device, shape):
    """Every element, the edge padding and the zero region included; 158
    wide is a padded row of 696 B, not a multiple of 16; at 720x1280 the
    second launch takes level 3 in strips."""
    gen = torch.Generator(device=cuda_device).manual_seed(4)
    grey = torch.rand(shape, generator=gen, device=cuda_device)
    before = t_blur.PYRAMID.launches
    got = t_blur.pyramid_flat(grey, 6)
    want = t_blur.pyramid_flat_plain(grey, 6)
    assert t_blur.PYRAMID.launches == before + t_blur.pyramid_plan(*shape, 6)["launches"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[want == 0], want[want == 0])


@pytest.mark.cuda
def test_build_pyramid_launches_pyramid_flat_only(cuda_device):
    img = torch.randint(0, 255, (120, 160, 3), dtype=torch.uint8, device=cuda_device)
    sep_before, pyr_before = t_blur.KERNEL.launches, t_blur.PYRAMID.launches
    p = t_pyr.build_pyramid(img, 6)
    assert t_blur.PYRAMID.launches == pyr_before + 2
    assert t_blur.KERNEL.launches == sep_before
    assert p.heights.device.type == "cuda" and p.heights.tolist() == [120, 60, 30, 15, 8, 4]


def _texture(rng, h, w):
    """A smooth seeded texture in [0, 1] (box-blurred noise)."""
    img = rng.uniform(size=(h + 8, w + 8)).astype(np.float32)
    k = np.ones(5, np.float32) / 5
    for ax in (0, 1):
        img = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), ax, img)
    img = img[4:4 + h, 4:4 + w]
    return (img - img.min()) / (img.max() - img.min())


def _track_case(dev, F=37, h=120, w=160, depth=4, budgets=(2, 3, None)):
    """Two edge-padded pyramids of a texture and its shifted copy, the packed
    references at the first's points, perturbed starts, mixed level counts
    drawn from ``budgets`` (None: ``depth``), some lanes inactive and some
    started by the border."""
    rng = np.random.default_rng(8)
    img = _texture(rng, h, w + 4)
    pa = t_pyr.build_pyramid(torch.as_tensor(img[:, :w], device=dev), depth)
    pb = t_pyr.build_pyramid(torch.as_tensor(img[:, 3:w + 3], device=dev), depth)
    pts = np.stack([rng.uniform(2, w - 2, F), rng.uniform(2, h - 2, F)], -1).astype(np.float32)
    pts = torch.as_tensor(pts, device=dev)
    packed = t_tf.pack_stacks(t_tf.get_patch_stacks(pa, pts))
    start = pts + torch.as_tensor(rng.uniform(-4, 1, (F, 2)).astype(np.float32), device=dev)
    budgets = [depth if b is None else b for b in budgets]
    lvls = torch.as_tensor(rng.choice(budgets, F).astype(np.int32), device=dev)
    active = torch.as_tensor(rng.uniform(size=F) > 0.15, device=dev)
    wmask = t_patch.radial_mask(13, device=dev)
    return pa, pb, pts, start, lvls, active, packed, wmask


def _near_margin(pos, w, h):
    x, y = pos[:, 0], pos[:, 1]
    return torch.minimum(torch.minimum(x - 0.01, y - 0.01),
                         torch.minimum(w - 0.01 - x, h - 0.01 - y)).abs() < 2e-3


def _assert_track_close(got, want, w, h):
    (gp, gok), (wp, wok) = got, want
    assert float((gp - wp).abs().max()) <= 2e-3
    assert not bool(((gok != wok) & ~_near_margin(wp, w, h)).any())


def _level_starts(solver, starts: list):
    """``solver`` recording the positions each level starts from (called
    coarsest level first)."""

    def run(*args, **kw):
        starts.insert(0, args[1])
        return solver(*args, **kw)

    return run


@pytest.mark.cuda
@pytest.mark.parametrize("F", [37, 96, 260])
def test_newton_track_matches_plain_on_card(cuda_device, F):
    """Forward on the planes with the backward stack, then backward on the
    window cache, each one launch, against the plain level loop; F=96 is
    the SLAM loop's (run_sim --slam: 120x160, 4 levels), F=260 lanes put
    more blocks than SMs on an H100. The forward pass cuts every level's
    window where the plain loop does."""
    _check_newton_track(cuda_device, F)


@pytest.mark.cuda
def test_newton_track_one_level_lanes_match_plain_on_card(cuda_device):
    """Lanes at a budget of one level both ways (adaptive_fwd_px's first
    attempt) mixed with budgets 3 and 4 in one launch."""
    _check_newton_track(cuda_device, 96, budgets=(1, 3, None))


def _check_newton_track(cuda_device, F, budgets=(2, 3, None)):
    pa, pb, pts, start, lvls, active, packed, wmask = _track_case(cuda_device, F=F,
                                                                  budgets=budgets)
    dims = t_tf._static_dims(pb)
    before = t_newton.KERNEL.launches
    pos, ok, stack, orgs = t_newton.newton_track(
        start, lvls, active, packed, wmask, dims, planes=pb.data, stack=True, origins=True)
    assert t_newton.KERNEL.launches == before + 1
    starts = []
    ppos, pok, pwin = t_newton.track_levels(
        _level_starts(t_newton.newton_window_steps, starts), start, lvls, active, packed,
        wmask, dims, planes=pb.data, return_windows=True)
    _assert_track_close((pos, ok), (ppos, pok), 160, 120)
    assert bool(ok.any())
    plain_orgs = torch.stack([o for _, o in pwin], 1)
    assert t_newton.origin_mismatches(pb.data, dims, orgs, plain_orgs, starts) == 0
    # the epilogue against its plain version on the kernel's own state
    plain_stack = t_newton.stack_at_origins(pb.data, 0, dims, pos, orgs)
    assert float((stack - plain_stack).abs().max()) <= 1e-5

    wins, worgs = t_tf.get_window_stacks(pa, pts)
    bpos, bok = t_newton.newton_track(pts, lvls, ok, stack, wmask, dims,
                                      win_cache=(wins, worgs))
    assert t_newton.KERNEL.launches == before + 2
    want_b = t_newton.newton_track_plain(pts, lvls, ok, stack, wmask, dims,
                                         win_cache=(wins, worgs))
    _assert_track_close((bpos, bok), want_b, 160, 120)


@pytest.mark.cuda
def test_newton_track_view_ring_offsets_on_card(cuda_device):
    """Per-lane plane bases (the matcher's view ring) and the ref_pyr route."""
    pa, pb, pts, start, lvls, active, packed, wmask = _track_case(cuda_device, F=20)
    ring = t_pyr.FlatPyramid(torch.cat([pb.data, pa.data]), None, None, depth_=4,
                             offset=torch.tensor([4, 0] * 10, device=cuda_device))
    dims = t_tf._static_dims(pb)
    got = t_newton.newton_track(pts, lvls, active, packed, wmask, dims, planes=ring.data,
                                offset=ring.offset)
    want = t_newton.newton_track_plain(pts, lvls, active, packed, wmask, dims,
                                       planes=ring.data, offset=ring.offset)
    _assert_track_close(got, want, 160, 120)
    got = t_tf.track_feature_batch(pb, start, lvls, wmask, max_iters=6, active=active,
                                   ref_pyr=pa, ref_pts=pts)
    want = t_newton.newton_track_plain(start, lvls, active, t_tf._extract_packed(pa, pts, 13),
                                       wmask, dims, planes=pb.data)
    _assert_track_close(got, want, 160, 120)


@pytest.mark.cuda
def test_newton_track_reference_exact_mode_at_the_parity_shape_on_card(cuda_device):
    """tools/parity's sequences (240x320, depth 5, F=192, reference-exact):
    the forward pass with no backward stack, then the backward pass on a
    four-view ring through per-lane plane offsets with references extracted
    at the forward positions and no window cache; budgets 1, 3 and 5."""
    F, depth = 192, 5
    pa, pb, pts, start, lvls, active, packed, wmask = _track_case(
        cuda_device, F=F, h=240, w=320, depth=depth, budgets=(1, 3, None))
    dims = t_tf._static_dims(pb)
    got = t_newton.newton_track(start, lvls, active, packed, wmask, dims, planes=pb.data)
    want = t_newton.newton_track_plain(start, lvls, active, packed, wmask, dims,
                                       planes=pb.data)
    _assert_track_close(got, want, 320, 240)
    pos, ok = got
    assert bool(ok.any())
    ring = torch.cat([pa.data, pb.data, pa.data.flip(-1), pb.data.flip(-2)])
    off = torch.as_tensor(np.random.default_rng(3).integers(0, 4, F) * depth,
                          device=cuda_device)
    bwd = (pts, lvls, ok, t_tf._extract_packed(pb, pos, 13), wmask, dims)
    got_b = t_newton.newton_track(*bwd, planes=ring, offset=off)
    want_b = t_newton.newton_track_plain(*bwd, planes=ring, offset=off)
    _assert_track_close(got_b, want_b, 320, 240)
    assert bool(got_b[1].any())


@pytest.mark.cuda
def test_bidirectional_sweep_is_two_launches_on_card(cuda_device):
    pa, pb, pts, start, lvls, active, packed, wmask = _track_case(cuda_device)
    wins = t_tf.get_window_stacks(pa, pts)
    launches, sweeps = t_newton.KERNEL.launches, t_tf.SWEEPS.n
    got = t_tf.track_bidirectional_batch(pa, pb, pts, start, lvls, wmask, max_iters=6,
                                         active=active, p1_packed=packed,
                                         bwd_ref_from_window=True, bwd_win_cache=wins)
    assert t_newton.KERNEL.launches == launches + 2 and t_tf.SWEEPS.n == sweeps + 1
    assert bool(got[1].any())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lanes", "klt"])
def test_alternative_tracker_graph_replays_the_eager_pass_on_card(cuda_device, kind):
    """tracker.track_bidirectional replays a CUDA graph on the card: the
    same values as the eager pass, bit for bit, and the same on a second
    call with other inputs (the graph's inputs are copied in)."""
    from slam_robot_tpu_torch.ops import klt, tracker

    fn = klt.track_feature if kind == "klt" else tracker.track_feature
    rng = np.random.default_rng(3)
    img = rng.uniform(size=(120, 160)).astype(np.float32)
    wmask = t_patch.radial_mask(13, device=cuda_device)
    graphs = tracker.BIDIRECTIONAL_GRAPHS
    for shift in (1, 2):
        pa, pb = (t_pyr.build_pyramid(torch.as_tensor(np.roll(img, s, 1), device=cuda_device),
                                      depth=4) for s in (0, shift))
        pts = torch.as_tensor(rng.uniform(20, 100, size=(32, 2)), dtype=torch.float32,
                              device=cuda_device)
        lvls = torch.full((32,), 4, dtype=torch.int32, device=cuda_device)
        active = torch.arange(32, device=cuda_device) % 5 != 0
        replays = graphs.replays
        got = tracker.track_bidirectional(pa, pb, pts, pts, lvls, wmask, max_iters=6,
                                          active=active, track_fn=fn)
        offs = torch.zeros(32, dtype=torch.long, device=cuda_device)
        want = graphs.fn(pa.data, offs, pb.data, offs, pts, pts, lvls, active, wmask,
                         depth_from=4, depth_to=4, threshold=0.001, max_iters=6,
                         roundtrip_px=0.3, min_variance=1e-5, fn=fn)
        assert graphs.replays == replays + 1
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
        assert bool(got[1].any())


@pytest.mark.cuda
def test_pipeline_init_defaults_to_the_card(cuda_device):
    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import pipeline

    cfg = SlamConfig(image_width=160, image_height=120, pyramid_depth=4,
                     max_features=64, max_points=128, max_obs=1024)
    ps = pipeline.init(cfg)
    for t in list(ps.map) + list(ps.matcher):
        assert t.device.type == "cuda"


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
    with pytest.raises(ValueError):
        t_blur.pyramid_flat(x, 6)
    pa, pb, pts, start, lvls, active, packed, wmask = _track_case(cuda_device, F=8)
    with pytest.raises(ValueError):
        t_newton.newton_track(start, lvls, active, packed[:, :3], wmask,
                              t_tf._static_dims(pb), planes=pb.data)


@pytest.mark.cuda
@pytest.mark.parametrize("name", tools.PROBES)
def test_probe_main_passes_on_card(cuda_device, name, capsys):
    mod = importlib.import_module(f"slam_robot_tpu_torch.tools.{name}")
    assert mod.main(["--device", "cuda"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == len(mod.CASES) and all(ln.startswith("PASS ") for ln in lines), lines


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c.name for c in tools.all_cases("SEEDED")])
def test_probe_seeded_case_on_card(cuda_device, name):
    """The kernels whose original inputs are constant, on seeded ones."""
    case = {c.name: c for c in tools.all_cases("SEEDED")}[name]
    ok, detail = tools.check(case, cuda_device)
    assert ok, detail


@pytest.mark.cuda
def test_probe_windows_clamp_and_control_on_random_inputs(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(1)
    img = torch.rand((40, 70), generator=gen, device=cuda_device)
    pos = torch.tensor([[-5, 3], [60, 30], [10, 9], [0, 0]], dtype=torch.int32,
                       device=cuda_device)
    for case in (pw.INT, pw.ROWS, pw.DIAGONAL):
        assert torch.equal(pw.windows(img, pos, 16, case), pw.windows_plain(img, pos, 16, case))
    fpos = pos.to(torch.float32) + 0.7
    assert torch.equal(pw.windows(img, fpos, 16, pw.FLOORED),
                       pw.windows_plain(img, fpos, 16, pw.FLOORED))
    for case in (pw.ONE_BY_ONE, pw.ALL_THEN_WAIT, pw.STAGED):
        assert torch.equal(pw.windows_async(img, pos, 16, case),
                           pw.windows_plain(img, pos, 16, pw.INT))
    x = (3.0 * torch.rand((24, 40), generator=gen, device=cuda_device)).contiguous()
    for case in (pc.ROW_DONE, pc.FIXED, pc.REDUCE, pc.ELEMENT_DONE):
        assert torch.equal(pc.control(x, case), pc.control_plain(x, case))


CONTROL_CASES = {"row_done": pc.ROW_DONE, "fixed": pc.FIXED, "reduce": pc.REDUCE,
                 "element_done": pc.ELEMENT_DONE}


def _bits(t):
    return t.contiguous().view(torch.int32)


def _control_inputs(dev, case: int, shape) -> list:
    """F's three sums (far above 2, far below, exactly 2.0); for the loops,
    the edge values each alone at (1, 1), else three seeded edge inputs."""
    if case == pc.REDUCE:
        return [t_m2.sum_edges(dev, 1, shape, kind) for kind in t_m2.SUM_KINDS]
    if shape == (1, 1):
        return [torch.tensor([[v]], dtype=torch.float32, device=dev) for v in t_m2.LOOP_EDGES]
    return [t_m2.loop_edges(dev, seed, shape) for seed in range(3)]


def _off16(dev, *shapes):
    """Tensors of ``shapes`` that start 4 bytes past 16, in one buffer."""
    sizes = [math.prod(s) for s in shapes]
    buf = torch.zeros(sum(sizes) + 4 * len(shapes), device=dev)
    out, at = [], 1
    for shape, n in zip(shapes, sizes):
        out.append(buf[at:at + n].view(shape))
        at = (at + n + 2) // 4 * 4 + 1  # the next float 4 bytes past 16
    assert all(t.data_ptr() % 16 == 4 for t in out)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 1), (8, 2), (8, 128), (24, 40), (1, 1024), (1023, 1),
                                   (3, 5)])
@pytest.mark.parametrize("case", list(CONTROL_CASES))
def test_probe_control_bit_for_bit_eager_and_replayed_on_card(cuda_device, case, shape):
    """T5, T7 e-g and T11's kernel at shapes from one element to the 1024
    it takes, one row and one column, partial warps, on values that pass
    2.4 after each of 1..5 steps or never, start past it, NaN, +-inf and
    -0.0 (F: sums far on each side of 2 and exactly 2.0): bit for bit the
    plain version, twice the same, a replayed CUDA graph the eager call;
    where n % 4 == 0, x and out 4 bytes off 16, and x alone, give the same
    bits."""
    mode = CONTROL_CASES[case]
    r, c = shape
    for x in _control_inputs(cuda_device, mode, shape):
        before = pc.KERNEL.launches
        eager, replayed = _eager_and_replayed(lambda: pc.control(x, mode))
        again = pc.control(x, mode)
        assert pc.KERNEL.launches == before + 3
        want = _bits(pc.control_plain(x, mode))
        assert torch.equal(_bits(eager), want), x
        assert torch.equal(_bits(again), want) and torch.equal(_bits(replayed), want)
        if x.numel() % 4 == 0:
            xo, out = _off16(cuda_device, shape, shape)
            xo.copy_(x)
            assert torch.equal(_bits(pc.control(xo, mode)), want)
            pc.KERNEL.launch(xo.data_ptr(), out.data_ptr(), r, c, mode,
                             build.stream_handle(cuda_device))
            assert torch.equal(_bits(out), want)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (6, 8), (102, 150), (6, 10), (34, 646)])
def test_probe_decimate_bit_for_bit_eager_and_replayed_on_card(cuda_device, shape):
    """T16's kernel at the probe's 480x640, at the least size, at W % 8 != 0
    (6x10, 102x150, 34x646: element by element) and on inputs and outputs
    4 bytes off 16 (each alone and both): img[::2, ::2] bit for bit, twice
    the same, a replayed CUDA graph the eager call."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] * shape[1])
    img = torch.rand(shape, generator=gen, device=cuda_device)
    h, w = shape
    want = img[::2, ::2]
    before = pp.DECIMATE.launches
    eager, replayed = _eager_and_replayed(lambda: pp.decimate(img))
    again = pp.decimate(img)
    assert pp.DECIMATE.launches == before + 3
    assert torch.equal(eager, want) and torch.equal(again, want) and torch.equal(replayed, want)
    src, out = _off16(cuda_device, shape, (h // 2, w // 2))
    src.copy_(img)
    assert torch.equal(pp.decimate(src), want)
    stream = build.stream_handle(cuda_device)
    for a in (img, src):
        out.zero_()
        pp.DECIMATE.launch(a.data_ptr(), out.data_ptr(), h, w, stream)
        assert torch.equal(out, want)


@pytest.mark.cuda
def test_probe_banded_kernels_on_random_inputs(cuda_device):
    gen = torch.Generator(device=cuda_device).manual_seed(2)
    a = torch.rand((5, 13, 32), generator=gen, device=cuda_device)
    b = torch.rand((5, 32, 24), generator=gen, device=cuda_device)
    torch.testing.assert_close(pb.bmm(a, b), pb.bmm_plain(a, b), rtol=1e-5, atol=0)
    f = 12
    win = torch.rand((f, 30, 31), generator=gen, device=cuda_device)
    fx = torch.rand((f,), generator=gen, device=cuda_device)
    fy = torch.rand((f,), generator=gen, device=cuda_device)
    x0 = torch.randint(-3, 20, (f,), generator=gen, device=cuda_device).to(torch.int32)
    y0 = torch.randint(-3, 20, (f,), generator=gen, device=cuda_device).to(torch.int32)
    assert torch.equal(pb.sample_grouped(win, fx, fy, x0, y0, 13, 4),
                       pb.sample_grouped_plain(win, fx, fy, x0, y0, 13))
    st = torch.randint(0, 19, (f,), generator=gen, device=cuda_device).to(torch.int32)
    assert torch.equal(pb.banded_pair_grouped(fx, st, 32, 13, 3),
                       pb.banded_pair_grouped_plain(fx, st, 32, 13, 3))
    xy = torch.tensor([7.6, -0.4], device=cuda_device)
    torch.testing.assert_close(pb.band_grad(win[0, :30, :30].contiguous(), xy, 13),
                               pb.band_grad_plain(win[0, :30, :30], xy, 13), rtol=1e-5, atol=0)


def _eager_and_replayed(fn):
    """``fn()`` once eagerly and once captured in a CUDA graph and replayed."""
    eager = fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = fn()
    graph.replay()
    torch.cuda.synchronize()
    return eager, captured


@pytest.mark.cuda
@pytest.mark.parametrize("m,n,k", [(13, 32, 32), (7, 20, 5), (13, 20, 32), (7, 32, 5),
                                   (13, 40, 37)])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_bmm_at_tail_shapes_eager_and_replayed_on_card(cuda_device, m, n, k, aligned):
    """T3's kernel at shapes that are not multiples of 4 or 32 (a column
    tail, a K tail) and on operands off 16-byte alignment, against its plain
    version, and a replayed CUDA graph equal to the eager call."""
    gen = torch.Generator(device=cuda_device).manual_seed(100 * m + n + k)
    f = 6
    a = torch.rand((f, m, k), generator=gen, device=cuda_device)
    buf = torch.rand((f * k * n + 1,), generator=gen, device=cuda_device)
    b = (buf[:-1] if aligned else buf[1:]).view(f, k, n)
    eager, replayed = _eager_and_replayed(lambda: pb.bmm(a, b))
    torch.testing.assert_close(eager, pb.bmm_plain(a, b), rtol=1e-5, atol=0)
    assert torch.equal(eager, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("case", [pb.REPEAT, pb.BROADCAST, pb.MASKED_SUM, pb.BLOCK_TRANSPOSE])
@pytest.mark.parametrize("groups,rows,w", [(4, 26, 30), (3, 26, 32), (4, 27, 5), (2, 40, 70)])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_layout_at_other_shapes_eager_and_replayed_on_card(cuda_device, case, groups,
                                                                 rows, w, aligned):
    """T13's four layouts at W not a multiple of 4 (the broadcast's
    one-element body), W = 32 off 16-byte alignment (the same) and on it
    (its 16-byte copies), and R other than 26, exact against the plain
    version, and a replayed CUDA graph equal to the eager call."""
    gen = torch.Generator(device=cuda_device).manual_seed(groups * rows + w)
    shape = (16, groups) if case in (pb.REPEAT, pb.MASKED_SUM) else (16, groups * rows, w)
    n = math.prod(shape)
    buf = torch.randn((n + 1,), generator=gen, device=cuda_device)
    t = (buf[:-1] if aligned else buf[1:]).view(shape)
    eager, replayed = _eager_and_replayed(lambda: pb.layout(t, case, groups, rows))
    assert torch.equal(eager, pb.layout_plain(t, case, groups, rows))
    assert torch.equal(eager, replayed)


# every level of a 480x640 pyramid, an odd shape, and the least sides sep5
# takes (3: one reflection reaches every index)
SEP5_SHAPES = [(480, 640), (240, 320), (120, 160), (60, 80), (30, 40), (15, 20), (47, 63),
               (3, 3), (3, 17), (17, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", SEP5_SHAPES)
@pytest.mark.parametrize("stride", [1, 2])
def test_blur_sep5_at_the_pyramid_shapes_eager_and_replayed_on_card(cuda_device, shape, stride):
    """B2's sep5 (blur at stride 1 with build_pyramid's sigmas, pyrDown's
    taps at stride 2) against its plain version, atol 1e-5, and a replayed
    CUDA graph equal to the eager call."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] * 1000 + shape[1])
    x = torch.rand(shape, generator=gen, device=cuda_device)
    weights = ([t_blur.gaussian_weights(1.1), t_blur.gaussian_weights(0.8)] if stride == 1
               else [t_blur.PYRDOWN_WEIGHTS])
    for w in weights:
        eager, replayed = _eager_and_replayed(lambda: t_blur.sep5(x, w, stride))
        want = t_blur.sep5_plain(x, w, stride)
        assert eager.shape == want.shape
        assert float((eager - want).abs().max()) <= 1e-5
        assert torch.equal(eager, replayed)


def _edge_positions(h: int, w: int, size: int, f: int, seed: int) -> torch.Tensor:
    """f int32 (x, y) positions: past every edge and corner, on the last
    start that fits, and random ones around the image."""
    edges = [[-5, -7], [w + 9, -3], [-9, h + 2], [w + 40, h + 40], [0, 0],
             [w - size, h - size], [-1, (h - size) // 2], [(w - size) // 2, h - size + 1]]
    rng = np.random.default_rng(seed)
    rand = rng.integers(-size, max(h, w) + size, (max(f - len(edges), 0), 2)).tolist()
    return torch.tensor((edges + rand)[:f], dtype=torch.int32)


WINDOW_CASES = [pw.INT, pw.FLOORED, pw.ROWS, pw.MASKED, pw.DIAGONAL]


def _window_inputs(dev, case: int, h: int, w: int, size: int, f: int):
    """(img, pos, mask) for ``pw.windows``: positions past every edge
    (``_edge_positions``); FLOORED's with fractions from -0.9 to 0.9, so
    that negative fractional starts floor below 0; MASKED's mask of -1..2."""
    gen = torch.Generator(device=dev).manual_seed(h * w + size * f + case)
    img = torch.rand((h, w), generator=gen, device=dev)
    pos = _edge_positions(h, w, size, f, seed=f + size).to(dev)
    mask = None
    if case == pw.FLOORED:
        frac = torch.linspace(-0.9, 0.9, 2 * f, device=dev).view(f, 2)
        pos = pos.to(torch.float32) + frac
    elif case == pw.MASKED:
        mask = torch.randint(-1, 3, (f,), generator=gen, device=dev).to(torch.int32)
        pos = None
    return img, pos, mask


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES)
@pytest.mark.parametrize("h,w,size,f", [(128, 256, 32, 8), (40, 70, 16, 12), (64, 96, 30, 9),
                                        (33, 50, 7, 5), (100, 120, 48, 6), (70, 90, 36, 4),
                                        (210, 260, 200, 3)])
@pytest.mark.parametrize("aligned", [True, False])
def test_windows_every_case_at_the_edges_eager_and_replayed_on_card(cuda_device, case, h, w,
                                                                    size, f, aligned):
    """T1, T2, T6, T7 a-c and T12's window copy bit for bit equal to the
    plain windows in every case: positions past every edge and corner,
    windows 32 wide (16-byte stores), 30 and 7 (not a multiple of 4), 36, 48
    and 200 (over 32), into an output on 16 bytes and one 4 bytes off them
    (4-byte stores), eager and replayed from a CUDA graph."""
    img, pos, mask = _window_inputs(cuda_device, case, h, w, size, f)
    want = pw.windows_plain(img, pos, size, case, mask)
    if aligned:
        before = pw.WINDOWS.launches
        eager, replayed = _eager_and_replayed(lambda: pw.windows(img, pos, size, case, mask))
        assert pw.WINDOWS.launches == before + 2
    else:
        buf = torch.full((2, want.numel() + 1), float("nan"), device=cuda_device)
        outs = buf[:, 1:].view(2, *want.shape)
        assert outs[0].data_ptr() % 16 == 4

        def launch(i):
            pw.WINDOWS.launch(img.data_ptr(), None if pos is None else pos.data_ptr(),
                              None if mask is None else mask.data_ptr(), outs[i].data_ptr(),
                              h, w, f, size, case, build.stream_handle(cuda_device))
            return outs[i]

        launch(0)
        _eager_and_replayed(lambda: launch(1))
        eager, replayed = outs[0], outs[1]
    assert torch.equal(eager, want), (case, size, aligned)
    assert torch.equal(replayed, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", [c.name for c in tools.all_cases()
                                  if c.kernel is pw.WINDOWS])
def test_windows_at_the_probes_inputs_eager_and_replayed_on_card(cuda_device, name):
    """Each probe case of the window copy bit for bit equal to its plain
    version on the probe's own inputs, eager and replayed."""
    case = {c.name: c for c in tools.all_cases()}[name]
    args = case.inputs(cuda_device)
    eager, replayed = _eager_and_replayed(lambda: case.run(*args))
    want = case.plain(*args)
    assert torch.equal(eager, want) and torch.equal(replayed, want)


@pytest.mark.cuda
@pytest.mark.parametrize("ws", [16, 30, 32, 48, 100, 200])
@pytest.mark.parametrize("edge,dx", [("left", -3.4), ("left", -0.6), ("left", 0.0),
                                     ("left", 2.5), ("right", -12.5), ("right", -2.1),
                                     ("right", 0.5)])
@pytest.mark.parametrize("aligned", [True, False])
def test_band_grad_at_other_windows_and_points_eager_and_replayed_on_card(cuda_device, ws, edge,
                                                                          dx, aligned):
    """T4's gradient and Hessian within rtol 1e-5 of the plain version at
    windows staged in static (up to 64 wide) and dynamic shared memory,
    from 16-byte loads and (a window 4 bytes off 16) 4-byte ones, with x0
    negative, inside, past WS - S and at WS (the band's rows past W read
    0): x at ``dx`` from the window's left or right edge."""
    x = dx if edge == "left" else ws + dx
    gen = torch.Generator(device=cuda_device).manual_seed(ws * 100 + int(10 * x) + aligned)
    buf = torch.rand((ws * ws + 1,), generator=gen, device=cuda_device)
    win = (buf[:-1] if aligned else buf[1:]).view(ws, ws)
    assert (win.data_ptr() % 16 == 0) == aligned
    xy = torch.tensor([x, 0.7], device=cuda_device)
    eager, replayed = _eager_and_replayed(lambda: pb.band_grad(win, xy, 13))
    torch.testing.assert_close(eager, pb.band_grad_plain(win, xy, 13), rtol=1e-5, atol=0)
    assert torch.equal(eager, replayed)


@pytest.mark.cuda
def test_band_grad_refuses_a_window_past_the_cards_shared_memory(cuda_device):
    """The entry point stages the whole window in one block's shared memory:
    240 x 240 floats (230,400 B) fit the H100's 227 KB, 241 x 241 do not, and
    the wrapper raises the refusal (no plain fallback)."""
    xy = torch.tensor([3.3, 1.7], device=cuda_device)
    win = torch.rand((240, 240), device=cuda_device)
    torch.testing.assert_close(pb.band_grad(win, xy, 13), pb.band_grad_plain(win, xy, 13),
                               rtol=1e-5, atol=0)
    before = pb.BAND_GRAD.launches
    with pytest.raises(RuntimeError, match="cudaError 1$"):
        pb.band_grad(torch.rand((241, 241), device=cuda_device), xy, 13)
    assert pb.BAND_GRAD.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize("case", [pw.ONE_BY_ONE, pw.ALL_THEN_WAIT, pw.STAGED])
def test_windows_async_routes_eager_and_replayed_on_card(cuda_device, case):
    """T8-T10's async window copy exactly equal to the plain windows: at the
    probes' shape (the copy engine's bulk copies), with positions clamped at
    every edge, and at windows 16 and 30 wide (odd spans); at an image 70
    wide (a row pitch off 16 bytes) and at one 4 bytes off 16-byte
    alignment (cp.async); at the most lanes that ALL_THEN_WAIT's shared
    memory allows (50 slots of 32 rows at a pitch of 36 floats, 4608 B, a
    block; 51 pass the card's 227 KB); each eager and replayed from a CUDA
    graph."""
    gen = torch.Generator(device=cuda_device).manual_seed(7 + case)
    probe = torch.rand((128, 256), generator=gen, device=cuda_device)
    buf = torch.rand((128 * 256 + 1,), generator=gen, device=cuda_device)
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    most = 50 * sms
    runs = [(probe, 32, 8, pw.BULK), (probe, 16, 40, pw.BULK), (probe, 30, 24, pw.BULK),
            (torch.rand((64, 70), generator=gen, device=cuda_device), 16, 12, pw.CP_ASYNC),
            (buf[1:].view(128, 256), 32, 8, pw.CP_ASYNC),
            (probe, 32, most, pw.BULK)]
    for img, size, f, route in runs:
        assert pw.async_route(img) == route
        pos = _edge_positions(*img.shape, size, f, seed=f).to(cuda_device)
        before = pw.WINDOWS_ASYNC.launches
        eager, replayed = _eager_and_replayed(lambda: pw.windows_async(img, pos, size, case))
        assert pw.WINDOWS_ASYNC.launches == before + 2
        want = pw.windows_plain(img, pos, size, pw.INT)
        assert torch.equal(eager, want), (tuple(img.shape), size, f, route)
        assert torch.equal(replayed, want)
    too_many = torch.zeros((most + 1, 2), dtype=torch.int32, device=cuda_device)
    before = pw.WINDOWS_ASYNC.launches
    if case == pw.ALL_THEN_WAIT:  # 51 slots a block
        with pytest.raises(RuntimeError, match="cudaError 1$"):
            pw.windows_async(probe, too_many, 32, case)
        assert pw.WINDOWS_ASYNC.launches == before
    else:  # one slot a block
        assert torch.equal(pw.windows_async(probe, too_many, 32, case),
                           pw.windows_plain(probe, too_many, 32, pw.INT))


@pytest.mark.cuda
@pytest.mark.parametrize("stage", list(pn.STAGES))
def test_probe_newton_kernel_on_smooth_windows(cuda_device, stage):
    case = make_newton_case(5, 32, 32)
    win = torch.as_tensor(case["win"], device=cuda_device)
    ref = torch.as_tensor(case["ref"], device=cuda_device)
    wmask = torch.as_tensor(case["wmask"], device=cuda_device)
    pos = torch.full((F, 2), 15.4, device=cuda_device)
    got = pn.probe_newton(win, pos, ref, wmask, pn.STAGES[stage])
    want = pn.probe_newton_plain(win, pos, ref, wmask, pn.STAGES[stage])
    atol = 2e-3 if stage == "newton" else 1e-3
    assert float((got - want).abs().max()) <= atol


@pytest.mark.cuda
@pytest.mark.parametrize("f", [1, 5, 257])
@pytest.mark.parametrize("wh,ww", [(32, 32), (17, 23)])
@pytest.mark.parametrize("stage", list(pn.STAGES))
def test_probe_newton_at_the_window_edges_on_card(cuda_device, f, wh, ww, stage):
    """T14/T15 against the plain version with lanes past the window's edges
    (``edge_inputs``: their taps outside the window read 0) and radial
    weights, on partial and odd grids, at a 32x32 window (rows on 16 bytes:
    16-byte copies) and at 17x23 (rows off 16 bytes: 4-byte copies), the
    loops at 0, 1 and 6 iterations; one launch a call, two calls on the same
    inputs bitwise equal, and a window whose base is 4 bytes off 16 (4-byte
    copies) giving the same bits as the one on a fresh allocation."""
    win, pos, ref, wmask = t_nk.edge_inputs(cuda_device, f + wh, f, wh, ww)
    buf = torch.empty(win.numel() + 1, device=cuda_device)
    off = buf[1:].view(win.shape)
    off.copy_(win)
    assert win.data_ptr() % 16 == 0 and off.data_ptr() % 16 == 4
    st = pn.STAGES[stage]
    atol = 2e-3 if st == pn.NEWTON else 1e-3
    for iters in ((0, 1, 6) if st in (pn.FORI_GRAD, pn.NEWTON) else (6,)):
        before = pn.KERNEL.launches
        got = pn.probe_newton(win, pos, ref, wmask, st, iters)
        again = pn.probe_newton(win, pos, ref, wmask, st, iters)
        moved = pn.probe_newton(off, pos, ref, wmask, st, iters)
        assert pn.KERNEL.launches == before + 3
        want = pn.probe_newton_plain(win, pos, ref, wmask, st, iters)
        assert torch.equal(got, again) and torch.equal(got, moved), iters
        assert float((got - want).abs().max()) <= atol, iters
        if iters == 0:
            assert torch.equal(got, pos)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (102, 150), (6, 8)])
def test_probe_pyramid_kernels_on_partial_tiles(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(3)
    img = torch.rand(shape, generator=gen, device=cuda_device)
    assert torch.equal(pp.decimate(img), img[::2, ::2])
    k = pp.taps().to(cuda_device)
    for got, want in zip(pp.two_level(img, k), pp.two_level_plain(img, k)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(480, 640), (6, 6), (50, 70), (34, 646), (102, 150),
                                   (488, 648)])
def test_probe_two_level_eager_and_replayed_on_card(cuda_device, shape):
    """T17 at the probe's 480x640, at the least size it takes (6x6: one
    block, every tap reflected) and at shapes whose strips are partial in
    both directions (l1 rows not a multiple of a strip's 8, columns not of
    its 80), with W and W/2 off a multiple of 4 (element stores) and on it
    (16-byte stores), against its plain version (atol 1e-5), one launch a
    call, and a replayed CUDA graph equal to the eager call."""
    gen = torch.Generator(device=cuda_device).manual_seed(shape[0] * shape[1])
    img = torch.rand(shape, generator=gen, device=cuda_device)
    k = pp.taps().to(cuda_device)
    before = pp.TWO_LEVEL.launches
    eager, replayed = _eager_and_replayed(lambda: pp.two_level(img, k))
    assert pp.TWO_LEVEL.launches == before + 2
    for got, again, want in zip(eager, replayed, pp.two_level_plain(img, k)):
        assert got.shape == want.shape
        assert float((got - want).abs().max()) <= 1e-5
        assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("f,wh,ww", [(37, 32, 32), (5, 17, 23), (130, 14, 14), (1, 9, 31)])
def test_probe_sample_grouped_at_small_windows_past_every_edge_on_card(cuda_device, f, wh, ww):
    """g6 at windows under 32x32, lanes whose taps reach past every edge of
    the window (they read 0), F not a multiple of the old kernel's four
    lanes a block, exactly its plain version (both round each product and
    sum alone), eager and replayed."""
    gen = torch.Generator(device=cuda_device).manual_seed(f + wh * ww)
    win = 255.0 * torch.rand((f, wh, ww), generator=gen, device=cuda_device)
    fx = torch.rand((f,), generator=gen, device=cuda_device)
    fy = torch.rand((f,), generator=gen, device=cuda_device)
    lane = torch.arange(f, device=cuda_device)
    x0 = (lane * 5 % (ww + 6) - 9).to(torch.int32)  # -9 .. ww - 4: taps past both edges
    y0 = (lane * 7 % (wh + 6) - 9).to(torch.int32)
    eager, replayed = _eager_and_replayed(lambda: pb.sample_grouped(win, fx, fy, x0, y0, 13, 1))
    assert torch.equal(eager, pb.sample_grouped_plain(win, fx, fy, x0, y0, 13))
    assert torch.equal(eager, replayed)


@pytest.mark.cuda
@pytest.mark.parametrize("f,groups,length,size", [(64, 4, 32, 13), (64, 4, 30, 13),
                                                  (9, 1, 33, 5), (12, 3, 7, 4)])
@pytest.mark.parametrize("aligned", [True, False])
def test_probe_banded_pair_at_other_widths_and_offsets_on_card(cuda_device, f, groups, length,
                                                               size, aligned):
    """g3 at K = G*L a multiple of 4 (16-byte stores) and not (one element
    a thread), and into an output 4 bytes off 16 (one element a thread),
    exactly its plain version, eager and replayed."""
    gen = torch.Generator(device=cuda_device).manual_seed(f * length + size)
    frac = torch.rand((f,), generator=gen, device=cuda_device)
    start = torch.randint(-2, length, (f,), generator=gen, device=cuda_device).to(torch.int32)
    b, m, k = f // groups, groups * 2 * size, groups * length
    want = pb.banded_pair_grouped_plain(frac, start, length, size, groups)
    if aligned:
        eager, replayed = _eager_and_replayed(
            lambda: pb.banded_pair_grouped(frac, start, length, size, groups))
    else:
        buf = torch.full((2, b * m * k + 1), float("nan"), device=cuda_device)
        outs = buf[:, 1:].view(2, b, m, k)
        assert outs[0].data_ptr() % 16 == 4

        def launch(i):
            pb.BANDED_PAIR.launch(frac.data_ptr(), start.data_ptr(), outs[i].data_ptr(), b,
                                  groups, size, length, build.stream_handle(cuda_device))
            return outs[i]

        launch(0)
        _eager_and_replayed(lambda: launch(1))
        eager, replayed = outs[0], outs[1]
    assert torch.equal(eager, want)
    assert torch.equal(eager, replayed)


def _loop_frame(dev):
    """A frame of the SLAM loop's world at its shape (120x160), the camera
    turned to the landmarks."""
    import math

    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import renderer, sim, vehicle
    from slam_robot_tpu_torch.run_sim import SLAM_LOOP
    from slam_robot_tpu_torch.utils import synthetic

    cfg = SlamConfig(**SLAM_LOOP)
    world = sim.make_world(400, seed=0, device=dev)
    q, t = sim.camera_pose(vehicle.init_state(heading=math.pi / 2, device=dev))
    k = torch.as_tensor(synthetic.reference_intrinsics(cfg), device=dev)
    return renderer.render(q, t, k, world.points, world.brightness, 120, 160)


@pytest.mark.cuda
def test_pyramid_flat_at_the_slam_loop_shape_on_card(cuda_device):
    """run_sim --slam's pyramid: 120x160 at depth 4, launch 1 for levels
    0-2 and launch 2 for the 15x20 level."""
    grey = _loop_frame(cuda_device)
    before = t_blur.PYRAMID.launches
    got = t_blur.pyramid_flat(grey, 4)
    want = t_blur.pyramid_flat_plain(grey, 4)
    assert t_blur.PYRAMID.launches == before + 2
    assert got.shape == want.shape == (4, 136, 176)
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[want == 0], want[want == 0])


@pytest.mark.cuda
def test_pyramid_flat_at_the_parity_shape_on_card(cuda_device):
    """tools/parity's pyramid: 240x320 at depth 5, every element."""
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    grey = torch.rand((240, 320), generator=gen, device=cuda_device)
    before = t_blur.PYRAMID.launches
    got = t_blur.pyramid_flat(grey, 5)
    want = t_blur.pyramid_flat_plain(grey, 5)
    assert t_blur.PYRAMID.launches == before + t_blur.pyramid_plan(240, 320, 5)["launches"]
    assert got.shape == want.shape
    assert float((got - want).abs().max()) <= 1e-5
    assert torch.equal(got[want == 0], want[want == 0])


@pytest.mark.cuda
def test_fleet_on_card_matches_cpu_without_a_host_read(cuda_device):
    """sim.rollout's loop reads nothing back (a sync raises in this mode);
    the card's fleet summary within the CPU's: reached count within 1 goal,
    median final distance within 0.01 m."""
    from slam_robot_tpu_torch.models import sim
    from slam_robot_tpu_torch.run_sim import goal_batch

    goals = torch.as_tensor(goal_batch(16))
    on_card = goals.to(cuda_device)
    sim.rollout(on_card, n_steps=1)  # makes the planner's per-device constant
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        traj, dist = sim.rollout(on_card, n_steps=300)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = sim.rollout(goals, n_steps=300)[1].numpy()
    got = dist.cpu().numpy()
    assert traj.shape == (16, 300, 2) and np.isfinite(got).all()
    assert abs(int((got < 0.5).sum()) - int((want < 0.5).sum())) <= 1
    assert abs(float(np.median(got)) - float(np.median(want))) <= 0.01


@pytest.mark.cuda
def test_slam_loop_launch_gates_on_card(cuda_device):
    """Three steps of rollout_slam at run_sim's config: two pyramid_flat
    launches a frame, two newton_track launches a sweep, no sep5."""
    from slam_robot_tpu_torch import SlamConfig
    from slam_robot_tpu_torch.models import sim
    from slam_robot_tpu_torch.run_sim import SLAM_LOOP
    from slam_robot_tpu_torch.utils import synthetic

    cfg = SlamConfig(**SLAM_LOOP)
    k = synthetic.reference_intrinsics(cfg)
    world = sim.make_world(400, seed=0, device=cuda_device)
    pyr, sep, track, sweeps = (t_blur.PYRAMID.launches, t_blur.KERNEL.launches,
                               t_newton.KERNEL.launches, t_tf.SWEEPS.n)
    traj, est, dist = sim.rollout_slam([3.0, 2.0, 0.0], world, cfg, [k, k], n_steps=3)
    assert t_blur.PYRAMID.launches - pyr == 6 and t_blur.KERNEL.launches == sep
    assert t_tf.SWEEPS.n > sweeps
    assert t_newton.KERNEL.launches - track == 2 * (t_tf.SWEEPS.n - sweeps)
    assert bool(torch.isfinite(traj).all() and torch.isfinite(est).all())
    assert traj.device.type == "cuda" and np.isfinite(float(dist))


@pytest.mark.cuda
def test_bench_warm_goes_on_from_a_stepped_state_bit_for_bit_on_card(cuda_device):
    """The bench's warm at SlamConfig() from frame 0, and from the state
    after frames 0-63 stepped as chip_smoke.py's phase 4 steps them (step +
    maybe_polish): the same state, bit for bit, after frame 95."""
    from slam_robot_tpu_torch import SlamConfig, bench
    from slam_robot_tpu_torch.models import pipeline
    from slam_robot_tpu_torch.utils.benchscene import make_frames

    cfg = SlamConfig()
    frames = make_frames(cfg, 96, device=cuda_device)
    want, _, _ = bench.bootstrap(cfg, frames, 96, cuda_device)
    ps = pipeline.init(cfg, device=cuda_device)
    for i in range(64):
        ps, _ = pipeline.step(ps, frames[i], cfg)
        ps = pipeline.maybe_polish(ps, i, cfg)
    got, _, _ = bench.bootstrap(cfg, frames, 96, cuda_device, start=(ps, 64))

    def leaves(s):
        return [x for v in s for x in (leaves(v) if isinstance(v, tuple) else [v])]

    for g, w in zip(leaves(got), leaves(want), strict=True):
        assert torch.equal(g, w)
