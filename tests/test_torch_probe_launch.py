"""The launch path of the probe kernels T3 (``probe_bmm``) and T13
(``probe_layout``) without a card: the C function kept after its first
load, one launch counted a call, the stream handle read anew on every call,
the wrappers' refusals (the layouts' 32-bit element limit among them); and
phase 14's export gate of ``chip_smoke.py`` on hand-made ``trace_detail``
results.

A CPU tensor that says it lies on the card (:class:`_OnCard`) takes a
wrapper's kernel path up to the C call, which a stub takes in place of the
library. The plain versions are held against the JAX probes in
``tests/test_torch_probes.py``, and the kernels against the plain versions
on the card in ``tests/test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import itertools

import numpy as np
import pytest
import torch

import chip_smoke
from slam_robot_tpu_torch.ops.cuda import build
from slam_robot_tpu_torch.ops.cuda import probe_banded as pb

G, ROWS = 4, 26


class _OnCard(torch.Tensor):
    """A CPU tensor whose ``is_cuda`` is True."""

    @property
    def is_cuda(self):
        return True


def on_card(t: torch.Tensor) -> torch.Tensor:
    return torch.Tensor._make_subclass(_OnCard, t)


def _rand(*shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).standard_normal(shape).astype(np.float32))


@pytest.fixture
def c_calls(monkeypatch):
    """Stub C functions for BMM and LAYOUT that record their arguments, and
    a current stream that changes on every read."""
    calls = []
    for kern in (pb.BMM, pb.LAYOUT):
        monkeypatch.setattr(kern, "_fn", lambda *args, _k=kern.name: calls.append((_k, args)) or 0)
        monkeypatch.setattr(kern, "launches", 0)
    handles = itertools.cycle([0x1111, 0x2222])
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: next(handles),
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)  # the tensors' device is cpu
    return calls


def test_kernel_keeps_its_c_function_and_counts_one_launch_a_call(monkeypatch):
    loads, calls = [], []

    def load_library():
        loads.append(1)
        return {"probe_bmm": lambda *args: calls.append(args) or 0}

    monkeypatch.setattr(build, "load_library", load_library)
    kern = build.Kernel("probe_bmm", pb.SOURCE)
    for i in range(3):
        kern.launch(i, 2 * i)
    assert kern.launches == 3 and calls == [(0, 0), (1, 2), (2, 4)] and loads == [1]
    kern.launch(9, kernels=2)
    assert kern.launches == 5 and loads == [1]


def test_a_refused_launch_raises_and_is_not_counted(monkeypatch):
    kern = build.Kernel("probe_layout", pb.SOURCE)
    monkeypatch.setattr(kern, "_fn", lambda *args: 1)  # cudaErrorInvalidValue
    with pytest.raises(RuntimeError, match="probe_layout failed to launch: cudaError 1"):
        kern.launch(0)
    assert kern.launches == 0


def test_stream_handle_takes_a_device_or_its_index(monkeypatch):
    asked = []
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream",
                        lambda index: asked.append(index) or 0x33, raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 5)
    got = [build.stream_handle(torch.device("cuda", 2)), build.stream_handle(3),
           build.stream_handle(torch.device("cuda"))]
    assert got == [0x33] * 3 and asked == [2, 3, 5]


def test_bmm_reads_the_stream_on_every_call(c_calls):
    a, b = on_card(_rand(8, 13, 32)), on_card(_rand(8, 32, 20, seed=1))
    outs = [pb.bmm(a, b) for _ in range(2)]
    assert [args[-1] for _, args in c_calls] == [0x1111, 0x2222]
    for (name, args), out in zip(c_calls, outs):
        assert name == "probe_bmm" and tuple(out.shape) == (8, 13, 20)
        assert args[:7] == (a.data_ptr(), b.data_ptr(), out.data_ptr(), 8, 13, 32, 20)
    assert pb.BMM.launches == 2


@pytest.mark.parametrize("case,shape,out_shape,rows_arg,w_arg", [
    (pb.REPEAT, (16, G), (16, G * ROWS), ROWS, 1),
    (pb.MASKED_SUM, (16, G), (16, G * ROWS), ROWS, 1),
    (pb.BROADCAST, (16, G * ROWS, 30), (16, G * ROWS, G * 30), G * ROWS, 30),
    (pb.BLOCK_TRANSPOSE, (16, G * ROWS, 30), (16, G * 30, ROWS), ROWS, 30),
])
def test_layout_reads_the_stream_on_every_call(c_calls, case, shape, out_shape, rows_arg, w_arg):
    t = on_card(_rand(*shape))
    outs = [pb.layout(t, case, G, ROWS) for _ in range(2)]
    assert [args[-1] for _, args in c_calls] == [0x1111, 0x2222]
    for (name, args), out in zip(c_calls, outs):
        assert name == "probe_layout" and tuple(out.shape) == out_shape
        assert args[:7] == (t.data_ptr(), out.data_ptr(), 16, G, rows_arg, w_arg, case)
    assert pb.LAYOUT.launches == 2


def test_wrappers_refuse_bad_inputs_on_the_card_path(c_calls):
    a, b = _rand(2, 3, 4), _rand(2, 4, 5)
    bad_bmm = [
        (on_card(a), on_card(_rand(2, 5, 4))),                  # K apart
        (on_card(a[0]), on_card(b[0])),                         # not batched
        (on_card(a.double()), on_card(b.double())),             # float64
        (on_card(a), on_card(_rand(2, 5, 4).transpose(1, 2))),  # not contiguous
        (on_card(a), b),                                        # B off the card
        (on_card(torch.zeros(65536, 1, 1)), on_card(torch.zeros(65536, 1, 1))),  # F over the grid
    ]
    for x, y in bad_bmm:
        with pytest.raises(ValueError):
            pb.bmm(x, y)
    t = _rand(16, G * ROWS, 30)
    bad_layout = [
        (on_card(_rand(16, G + 1)), pb.REPEAT),                  # G apart
        (on_card(_rand(16, G).to(torch.int32)), pb.MASKED_SUM),  # int32
        (on_card(t.transpose(1, 2).contiguous().transpose(1, 2)), pb.BROADCAST),  # strided
        (on_card(_rand(16, G * ROWS + 1, 30)), pb.BLOCK_TRANSPOSE),  # rows apart
        (on_card(t), 7),                                         # no such case
    ]
    for x, case in bad_layout:
        with pytest.raises(ValueError):
            pb.layout(x, case, G, ROWS)
    assert c_calls == [] and pb.BMM.launches == 0 and pb.LAYOUT.launches == 0


@pytest.mark.parametrize("case,shape,rows", [
    (pb.REPEAT, (2**16, G), 2**13),                      # 2^31 outputs
    (pb.MASKED_SUM, (2**16 + 1, G), 2**13),
    (pb.BROADCAST, (2**8, 2**10, 2**11), ROWS),          # 2^31 outputs at G = 4
    (pb.BLOCK_TRANSPOSE, (2**11, G * 2**9, 2**9), 2**9),
])
def test_layout_refuses_2_to_the_31_elements_on_either_device(c_calls, case, shape, rows):
    """The kernel indexes in 32 bits, so the wrapper refuses a total of 2^31
    elements or more, on the card's path and on the CPU's (tensors on the
    meta device: nothing is allocated)."""
    t = torch.empty(shape, device="meta")
    for x in (t, on_card(t)):
        with pytest.raises(ValueError, match="32 bits"):
            pb.layout(x, case, G, rows)
    assert c_calls == []


def test_layout_takes_2_to_the_31_less_one_elements(c_calls):
    t = on_card(torch.empty((2**31 - 1) // (G * 3), G, device="meta"))
    out = pb.layout(t, pb.REPEAT, G, 3)
    assert tuple(out.shape) == (t.shape[0], G * 3) and len(c_calls) == 1


def test_bmm_plain_and_layout_plain_at_tail_shapes():
    """The plain versions the card's kernels are held to, at the shapes the
    on-card tests give the kernels (widths that leave a tail after float4
    and after a warp, R other than 26), against numpy."""
    for m, n, k in ((13, 32, 32), (7, 20, 5), (13, 20, 37)):
        a, b = _rand(3, m, k), _rand(3, k, n, seed=1)
        np.testing.assert_allclose(pb.bmm_plain(a, b).numpy(), a.numpy() @ b.numpy(),
                                   rtol=1e-5, atol=1e-5)
    for groups, rows, w in ((G, ROWS, 30), (3, 27, 5), (2, 40, 70)):
        v = _rand(16, groups)
        want = np.repeat(v.numpy(), rows, axis=1)
        for case in (pb.REPEAT, pb.MASKED_SUM):
            np.testing.assert_array_equal(pb.layout(v, case, groups, rows).numpy(), want)
        t = _rand(16, groups * rows, w)
        np.testing.assert_array_equal(pb.layout(t, pb.BROADCAST, groups, rows).numpy(),
                                      np.tile(t.numpy(), (1, 1, groups)))
        np.testing.assert_array_equal(
            pb.layout(t, pb.BLOCK_TRANSPOSE, groups, rows).numpy(),
            np.swapaxes(t.numpy().reshape(16, groups, rows, w), -1, -2)
            .reshape(16, groups * w, rows))


# ---- chip_smoke.py phase 14: the exported trace against the counters ----

SPANS = {"newton_track": {"track_sweep": 28}, "pyramid_flat": {"pyramid": 4}}


def test_export_gate_passes_an_equal_count():
    chip_smoke._gate_export({"newton_track": [28, 28], "pyramid_flat": [4, 4]}, SPANS)


@pytest.mark.parametrize("shortfall", [
    {"newton_track": [28, 28], "pyramid_flat": [2, 4]},    # C6: a frame's B2 pair lost
    {"newton_track": [27, 28], "pyramid_flat": [4, 4]},    # a B1 row lost
    {"newton_track": [28, 28], "pyramid_flat": [5, 4]},    # a row with no counted launch
    {"newton_track": [28, 28]},                            # B2 not counted
    None,                                                  # no launches.json
])
def test_export_gate_fails_a_count_apart(shortfall):
    with pytest.raises(AssertionError, match="differ from the port's counters"):
        chip_smoke._gate_export(shortfall, SPANS)


def test_export_gate_fails_a_row_outside_its_span():
    spans = {"newton_track": {"track_sweep": 27, "matcher": 1}, "pyramid_flat": {"pyramid": 4}}
    with pytest.raises(AssertionError, match="outside their spans"):
        chip_smoke._gate_export({"newton_track": [28, 28], "pyramid_flat": [4, 4]}, spans)
