"""The host-side argument preparation of the one-launch kernels, on the CPU:
what ``newton_track`` and ``pyramid_flat`` read besides their tensors.

``newton.level_table`` (per-level dims, window sizes and Newton budgets) is
the table the plain level loop runs and the kernel's parameter block
carries; ``newton.track_params`` fills that block (plane indices, strides
of the packed references and of the window cache, the 16-byte-copy
flags), which ``build.Params`` packs as the C struct lays it out;
``blur.pyramid_plan`` sizes the pyramid's two launches.
"""

import struct

import pytest
import torch

from slam_robot_tpu_torch.ops.cuda import blur, newton
from slam_robot_tpu_torch.ops.pyramid import level_dims

DIMS_640 = level_dims(480, 640, 6)


def test_level_table_at_640x480():
    t = newton.level_table(DIMS_640, 6)
    assert t["h"] == (480, 240, 120, 60, 30, 15)
    assert t["w"] == (640, 320, 160, 80, 40, 20)
    # the coarsest padded level is 31x36: its window is 31x32
    assert t["wh"] == (32, 32, 32, 32, 32, 31)
    assert t["ww"] == (32,) * 6
    assert t["iters"] == (6,) * 6
    assert newton.level_table(DIMS_640, 6, iters_coarse=3)["iters"] == (6, 3, 3, 3, 3, 3)
    assert newton.level_table(DIMS_640, 4, iters_coarse=9)["iters"] == (4,) * 6
    small = newton.level_table(level_dims(6, 8, 3), 6)
    assert (small["wh"], small["ww"]) == ((22, 19, 18), (24, 20, 18))


def test_plane_index_for_int_and_per_lane_offsets():
    assert newton.plane_index(0, 3, 4, "cpu").tolist() == [3, 3, 3, 3]
    off = torch.tensor([0, 6, 12], dtype=torch.int32)
    assert newton.plane_index(off, 2, 3, "cpu").tolist() == [2, 8, 14]
    assert newton.plane_index(torch.tensor(6), 1, 2, "cpu").tolist() == [7, 7]


def _track_inputs(F=5, L=6):
    return dict(pts=torch.zeros((F, 2)), wmask=torch.zeros((13, 13)),
                pos_out=torch.zeros((F, 2)), packed=torch.zeros((F, L, 340)))


def _unpack(P, blob: bytes) -> dict:
    """The fields of a packed block by name (arrays as lists)."""
    flat = list(struct.unpack(P.fmt, blob))
    out = {}
    for name, _, n in P.layout:
        out[name] = flat[0] if n == 1 else flat[:n]
        del flat[:n]
    return out


def _fields(p: dict) -> dict:
    """Every field of the block, as the kernel reads it (unset ones 0)."""
    P = newton.TRACK_PARAMS
    return _unpack(P, P.pack(**p))


def test_track_params_planes_source_with_packed_references():
    F, L = 5, 6
    x = _track_inputs(F, L)
    planes = torch.zeros((2 * L, 496, 656))
    table = newton.level_table(DIMS_640, 6, iters_coarse=2)
    refs, vec16 = newton.packed_refs(x["packed"])
    lvls = torch.full((F,), 3, dtype=torch.int32)
    active = torch.ones((F,), dtype=torch.bool)
    ok = torch.zeros((F,), dtype=torch.bool)
    stack = torch.zeros((F, L, 340))
    p = _fields(newton.track_params(
        F=F, table=table, pts=x["pts"], lvls=lvls, active=active, wmask=x["wmask"], refs=refs,
        ref_vec16=vec16, pos_out=x["pos_out"], threshold=1e-3, planes=planes, offset=6,
        ok_out=ok, stack_out=stack))
    assert (p["F"], p["L"], p["Hp"], p["Wp"]) == (F, L, 496, 656)
    assert p["planes"] == planes.data_ptr() and p["plane_off"] == 0 and p["plane_base"] == 6
    assert p["win"] == 0 and p["lvls"] == lvls.data_ptr() and p["lvls_const"] == 0
    assert p["active"] == active.data_ptr() and p["active_kind"] == newton.ACTIVE_BOOL
    # the packed row: data | valid | mean | sumsq, read in place
    base = x["packed"].data_ptr()
    assert p["ref"] == [base, base + 4 * 169, base + 4 * 338, base + 4 * 339]
    assert p["ref_lane"] == [L * 340] * 4 and p["ref_level"] == [340] * 4
    assert p["ref_vec16"] == 1 and vec16
    assert p["h"] == list(table["h"]) + [0, 0] and p["wh"] == list(table["wh"]) + [0, 0]
    assert p["iters"] == [6, 2, 2, 2, 2, 2, 0, 0]
    assert p["ok_out"] == ok.data_ptr() and p["stack_out"] == stack.data_ptr()
    assert p["status_out"] == 0 and p["org_out"] == 0 and p["bounds"] == 0
    assert p["threshold"] == pytest.approx(1e-3)
    # a per-lane plane base (the matcher's view ring)
    off = torch.arange(F, dtype=torch.long) * L
    p = _fields(newton.track_params(
        F=F, table=table, pts=x["pts"], lvls=4, active=None, wmask=x["wmask"], refs=refs,
        ref_vec16=vec16, pos_out=x["pos_out"], threshold=1e-3, planes=planes, offset=off))
    assert p["plane_off"] == off.data_ptr() and p["lvls"] == 0 and p["lvls_const"] == 4
    assert p["active"] == 0 and p["active_kind"] == newton.ACTIVE_ALL


def test_track_params_window_sources():
    F, L = 4, 6
    x = _track_inputs(F, L)
    table = newton.level_table(DIMS_640, 6)
    refs, vec16 = newton.packed_refs(x["packed"])
    wins, orgs = torch.zeros((F, L, 32, 32)), torch.zeros((F, L, 2))
    p = _fields(newton.track_params(
        F=F, table=table, pts=x["pts"], lvls=6, active=None, wmask=x["wmask"], refs=refs,
        ref_vec16=vec16, pos_out=x["pos_out"], threshold=1e-3, windows=(wins, orgs)))
    assert p["planes"] == 0 and p["win"] == wins.data_ptr() and p["win_org"] == orgs.data_ptr()
    assert (p["win_lane"], p["win_level"], p["win_row"]) == (L * 1024, 1024, 32)
    assert (p["org_lane"], p["org_level"]) == (2 * L, 2)
    assert p["win_vec16"] == 1
    # newton_level's one level: [F, WH, WW] windows, separate references,
    # per-lane bounds and float activity; a 30-wide row cannot take 16 B
    win, org = torch.zeros((F, 31, 30)), torch.zeros((F, 2))
    one = dict(h=[0], w=[0], wh=[31], ww=[30], iters=[6])
    ref, mean = torch.zeros((F, 13, 13)), torch.zeros((F,))
    seprefs = [(ref.data_ptr(), 169, 0), (ref.data_ptr(), 169, 0),
               (mean.data_ptr(), 1, 0), (mean.data_ptr(), 1, 0)]
    active, bounds, status = torch.ones((F,)), torch.zeros((F, 2)), torch.zeros((F,))
    p = _fields(newton.track_params(
        F=F, table=one, pts=x["pts"], lvls=1, active=active, wmask=x["wmask"], refs=seprefs,
        ref_vec16=False, pos_out=x["pos_out"], threshold=1e-3,
        windows=(win[:, None], org[:, None]), bounds=bounds, status_out=status))
    assert (p["L"], p["win_lane"], p["win_row"], p["org_lane"]) == (1, 31 * 30, 30, 2)
    assert p["win_vec16"] == 0 and p["ref_vec16"] == 0
    assert p["active_kind"] == newton.ACTIVE_FLOAT and p["lvls_const"] == 1
    assert p["bounds"] == bounds.data_ptr() and p["status_out"] == status.data_ptr()
    assert p["ref_lane"] == [169, 169, 1, 1]
    # a view one lane in keeps 16-byte alignment; one float in does not
    _, vec16 = newton.packed_refs(x["packed"][1:, :, :])
    assert vec16
    _, vec16 = newton.packed_refs(torch.zeros((F * L * 340 + 1,))[1:].reshape(F, L, 340))
    assert not vec16


def test_parameter_blocks_have_the_c_layout():
    """Pointers, then the 64-bit strides, then the ints and the float, each
    at its C offset (native alignment), the block padded to its alignment:
    18 pointers, 8 int64, 14 + 40 ints and a float in 8-byte steps; the
    pyramid's 23 ints and 15 floats in 4-byte ones."""
    blob = newton.TRACK_PARAMS.pack(ref=[1, 2, 3, 4], plane_base=-1, iters=[6, 3],
                                    threshold=0.5)
    assert len(blob) == 8 * 18 + 8 * 8 + 4 * 54 + 8
    assert blob[32:64] == b"".join(i.to_bytes(8, "little") for i in (1, 2, 3, 4))
    assert blob[144:152] == (-1).to_bytes(8, "little", signed=True)
    fields = _unpack(newton.TRACK_PARAMS, blob)
    assert fields["iters"] == [6, 3] + [0] * 6 and fields["threshold"] == 0.5
    # block() is pack() once the size has been checked against the C struct
    P = newton.TRACK_PARAMS
    P.checked = True  # (the size check needs the built library)
    try:
        values = dict(ref=(5, 6, 7, 8), pts=9, plane_base=-1, iters=(6, 3), threshold=0.5)
        assert P.block(**values) == P.pack(**values)
        assert P.block(**dict(values, pts=10)) == P.pack(**dict(values, pts=10))
    finally:
        P.checked = False
    blob = blur.PYR_PARAMS.pack(L=6, K=2, buf2=7, taps=[0.5] * 15)
    assert len(blob) == 4 * (16 + 7 + 15)
    fields = _unpack(blur.PYR_PARAMS, blob)
    assert (fields["L"], fields["K"], fields["buf2"]) == (6, 2, 7)
    assert fields["taps"] == [0.5] * 15


def test_origin_mismatches_excuse_only_pixel_boundary_starts():
    """The window-origin check of newton_track against the plain loop: an
    origin one pixel off counts, unless the plain loop's start lies within
    the tolerance of a pixel boundary."""
    dims = level_dims(120, 160, 3)
    planes = torch.zeros((3, 136, 176))
    table = newton.level_table(dims, 0)
    starts = [torch.tensor([[40.5, 30.5], [70.25, 50.75]]) / 2 ** lv for lv in range(3)]
    orgs = torch.stack([newton.gather_windows(planes, 0, lv, dims, s, wh, ww)[1]
                        for lv, (s, wh, ww) in enumerate(zip(starts, table["wh"], table["ww"]))],
                       1)
    assert newton.origin_mismatches(planes, dims, orgs, orgs, starts) == 0
    off = orgs.clone()
    off[0, 1, 0] += 1
    off[1, 2, 1] -= 1
    assert newton.origin_mismatches(planes, dims, off, orgs, starts) == 2
    # lane 0 starts 0.0005 px right of a boundary at level 0: floored from
    # 0.0015 px further left, its origin is one lower
    starts[0][0, 0] = 40.0005
    left = orgs.clone()
    left[0, 0, 0] -= 1
    assert newton.origin_mismatches(planes, dims, left, orgs, starts) == 0
    assert newton.origin_mismatches(planes, dims, left, orgs, starts, tol=1e-4) == 1


def test_pyramid_plan_at_640x480_and_small_frames():
    plan = blur.pyramid_plan(480, 640, 6)
    assert plan["K"] == 2 and plan["launches"] == 2
    # a 16x16 tile of level 2 reads a 101x101 region of the frame
    assert plan["buf1"] == 101 * 101
    # level 3 (60 rows) in one strip, reading all of level 2 (120x160)
    assert plan["strip"] == 60 and plan["buf2"] == 120 * 160
    assert 2 * 4 * plan["buf2"] <= blur.WALK_SMEM
    small = blur.pyramid_plan(6, 8, 6)
    assert small["buf1"] == 6 * 8 and small["launches"] == 2
    assert blur.pyramid_plan(47, 63, 3)["launches"] == 1
    one = blur.pyramid_plan(47, 63, 1)
    assert one["K"] == 0 and one["launches"] == 1 and one["buf1"] == 20 * 20
    # a wide frame takes level 3 in strips
    wide = blur.pyramid_plan(1080, 1920, 6)
    assert wide["strip"] < wide["dims"][3][0]
    assert 2 * 4 * wide["buf2"] <= blur.WALK_SMEM
    with pytest.raises(ValueError):
        blur.pyramid_plan(64, 40000, 6)
