"""The launch path of the probe kernels T3 (``probe_bmm``), T13
(``probe_layout``) and T8-T10 (``probe_windows_async``), and of B2's
``sep5``, without a card: the C function kept after its first load, one
launch counted a call, the stream handle read anew on every call, the
wrappers' refusals (the layouts' and g3's 32-bit element limit among them; the async
copy's shared memory is refused by its entry point, whose error the wrapper
raises) and the async copy on the CPU; phase 14's export gate of ``chip_smoke.py`` on hand-made
``trace_detail`` results; and the audit that every in-process profile of
the smoke, and every capture of its fresh process, passes (ROADMAP C6), on
hand-made captures.

A CPU tensor that says it lies on the card (:class:`_OnCard`) takes a
wrapper's kernel path up to the C call, which a stub takes in place of the
library. The plain versions are held against the JAX probes in
``tests/test_torch_probes.py``, and the kernels against the plain versions
on the card in ``tests/test_torch_cuda_kernels.py``.
"""

from __future__ import annotations

import itertools
import json

import numpy as np
import pytest
import torch

import chip_smoke
from slam_robot_tpu_torch.ops.cuda import blur as bk
from slam_robot_tpu_torch.ops.cuda import build
from slam_robot_tpu_torch.ops.cuda import probe_banded as pb
from slam_robot_tpu_torch.ops.cuda import probe_windows as pw
from slam_robot_tpu_torch.tools import profile_trace, trace_detail

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


@pytest.fixture
def pair_calls(monkeypatch):
    """A stub C function for BANDED_PAIR that records its arguments."""
    calls = []
    monkeypatch.setattr(pb.BANDED_PAIR, "_fn", lambda *args: calls.append(args) or 0)
    monkeypatch.setattr(pb.BANDED_PAIR, "launches", 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0x1111,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    return calls


@pytest.mark.parametrize("f,groups,size,length", [
    (4, 1, 2**14, 2**16),        # [4, 2^15, 2^16]: 2^33 elements
    (1, 1, 2**14, 2**16),        # [1, 2^15, 2^16]: 2^31
    (2, 2, 2**12, 2**16),        # [1, 2^14, 2^17] at G = 2: 2^31
])
def test_banded_pair_refuses_2_to_the_31_elements_on_either_device(pair_calls, f, groups,
                                                                    size, length):
    """g3's kernel indexes in 32 bits, so the wrapper refuses an output of
    2^31 elements or more before any launch or allocation, on the card's
    path and on the CPU's."""
    frac = torch.zeros(f)
    start = torch.zeros(f, dtype=torch.int32)
    for fr, st in ((frac, start), (on_card(frac), on_card(start))):
        with pytest.raises(ValueError, match="32 bits"):
            pb.banded_pair_grouped(fr, st, length, size, groups)
    assert pair_calls == [] and pb.BANDED_PAIR.launches == 0


def test_banded_pair_takes_an_output_under_2_to_the_31_elements(pair_calls):
    """[1, 2^15, 2^16 - 1]: 2^31 - 2^15 elements go to the entry point (on
    the meta device: nothing is allocated)."""
    frac = on_card(torch.zeros(1, device="meta"))
    start = on_card(torch.zeros(1, dtype=torch.int32, device="meta"))
    out = pb.banded_pair_grouped(frac, start, 2**16 - 1, 2**14, 1)
    assert tuple(out.shape) == (1, 2**15, 2**16 - 1) and len(pair_calls) == 1
    assert pair_calls[0][3:7] == (1, 1, 2**14, 2**16 - 1) and pb.BANDED_PAIR.launches == 1


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


def test_export_gate_fails_a_launch_that_lost_its_kernel():
    shortfall = {"newton_track": [28, 28], "pyramid_flat": [4, 4]}
    chip_smoke._gate_export(shortfall, SPANS, {"kernel_launches": 900, "lost_launches": 0})
    with pytest.raises(AssertionError, match="lost their kernel"):
        chip_smoke._gate_export(shortfall, SPANS, {"kernel_launches": 900, "lost_launches": 3})


# ---- T8-T10's async window copy and B2's sep5 on the card's path ----

class _Calls(list):
    """The C calls a stub recorded, and what the stub returns (``refuse``)."""


@pytest.fixture
def async_calls(monkeypatch):
    """Stub C functions for the async window copy and sep5 that record their
    arguments and return ``refuse[0]`` (0: launched)."""
    calls, refuse = _Calls(), [0]
    for kern in (pw.WINDOWS_ASYNC, bk.KERNEL):
        monkeypatch.setattr(kern, "_fn", lambda *args, _k=kern.name: calls.append((_k, args))
                            or refuse[0])
        monkeypatch.setattr(kern, "launches", 0)
    monkeypatch.setattr(torch._C, "_cuda_getCurrentRawStream", lambda index: 0x4444,
                        raising=False)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    calls.refuse = refuse
    return calls


def _positions(f: int, seed: int = 0) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(seed).integers(-40, 300, (f, 2)),
                           dtype=torch.int32)


def _image(h: int, w: int, offset: int = 0) -> torch.Tensor:
    """An [h, w] float32 image ``offset`` floats into its buffer."""
    return on_card(torch.zeros(h * w + offset)[offset:].view(h, w))


@pytest.mark.parametrize("case", [pw.ONE_BY_ONE, pw.ALL_THEN_WAIT, pw.STAGED])
def test_windows_async_passes_its_inputs_to_the_entry_point(async_calls, case):
    """The entry point takes the route and the lanes a block itself: the
    wrapper passes the image, its positions and dims, the case and the
    stream, whatever the image's row pitch or alignment."""
    img, pos = _image(128, 256), on_card(_positions(8))
    out = pw.windows_async(img, pos, 32, case)
    (name, args), = async_calls
    assert name == "probe_windows_async" and tuple(out.shape) == (8, 32, 32)
    assert args == (img.data_ptr(), pos.data_ptr(), out.data_ptr(), 128, 256, 8, 32, case,
                    0x4444)
    odd = _image(40, 70, 1)
    pw.windows_async(odd, on_card(_positions(300)), 16, case)
    assert async_calls[1][1][:1] + async_calls[1][1][3:] == (odd.data_ptr(), 40, 70, 300, 16,
                                                             case, 0x4444)
    assert pw.WINDOWS_ASYNC.launches == 2


def test_windows_async_refuses_bad_inputs_and_raises_a_refused_launch(async_calls):
    img = _image(128, 256)
    bad = [(img, on_card(_positions(8).to(torch.int64)), 32, pw.ONE_BY_ONE),  # int64 positions
           (img, on_card(_positions(8)[:, :1].contiguous()), 32, pw.ONE_BY_ONE),  # [F, 1]
           (img, on_card(_positions(0)), 32, pw.ONE_BY_ONE),     # no lanes
           (_image(20, 256), on_card(_positions(8)), 32, pw.ONE_BY_ONE),  # window over the image
           (img, on_card(_positions(8)), 32, 3)]                 # no such case
    for args in bad:
        with pytest.raises(ValueError):
            pw.windows_async(*args)
    assert pw.WINDOWS_ASYNC.launches == 0 and not async_calls
    # the entry point's refusal (cudaErrorInvalidValue: a block's shared
    # memory over the card's) raises, and no launch is counted
    async_calls.refuse[0] = 1
    with pytest.raises(RuntimeError, match="probe_windows_async failed to launch: cudaError 1"):
        pw.windows_async(img, on_card(_positions(8)), 32, pw.ALL_THEN_WAIT)
    assert pw.WINDOWS_ASYNC.launches == 0 and len(async_calls) == 1


@pytest.mark.parametrize("shape,offset", [((128, 256), 0), ((40, 70), 0), ((128, 256), 1),
                                          ((37, 41), 3)])
@pytest.mark.parametrize("case", [pw.ONE_BY_ONE, pw.ALL_THEN_WAIT, pw.STAGED])
def test_windows_async_on_the_cpu_is_the_plain_copy(shape, offset, case):
    """A CPU tensor goes to the plain version, whatever the image's pitch or
    offset, with the windows clamped at every edge."""
    h, w = shape
    img = torch.arange(h * w + offset, dtype=torch.float32)[offset:].view(h, w)
    pos = torch.tensor([[-5, -7], [w + 9, -3], [-9, h + 2], [w - 16, h - 16], [3, 4]],
                       dtype=torch.int32)
    got = pw.windows_async(img, pos, 16, case)
    assert torch.equal(got, pw.windows_plain(img, pos, 16, pw.INT))
    assert torch.equal(got[0], img[:16, :16]) and torch.equal(got[2], img[h - 16:, :16])
    assert torch.equal(got[4], img[4:20, 3:19])


@pytest.mark.parametrize("shape,stride,out_shape", [
    ((480, 640), 1, (480, 640)), ((480, 640), 2, (240, 320)), ((15, 20), 2, (8, 10)),
    ((3, 17), 1, (3, 17)), ((17, 3), 2, (9, 2)),
])
def test_sep5_passes_its_output_dims(async_calls, shape, stride, out_shape):
    x = on_card(_rand(*shape))
    out = bk.sep5(x, bk.PYRDOWN_WEIGHTS, stride)
    (name, args), = async_calls
    assert name == "sep5_reflect101" and tuple(out.shape) == out_shape
    assert args[:7] == (x.data_ptr(), out.data_ptr(), *shape, *out_shape, stride)
    assert args[7:12] == pytest.approx(bk.PYRDOWN_WEIGHTS) and args[12] == 0x4444
    for bad in ((on_card(_rand(2, 17)), 1), (on_card(_rand(17, 2)), 2), (x, 3)):
        with pytest.raises(ValueError):
            bk.sep5(bad[0], bk.PYRDOWN_WEIGHTS, bad[1])
    assert bk.KERNEL.launches == 1


# ---- the capture audit (ROADMAP C6) on hand-made captures ----

class _Event:
    """A capture event as Kineto gives it (``profile_trace.capture_events``)."""

    def __init__(self, name, corr, cuda=False, span=False, us=1.0):
        self._name, self._corr, self._cuda, self._span, self._us = name, corr, cuda, span, us

    def name(self):
        return self._name

    def correlation_id(self):
        return self._corr

    def device_type(self):
        return torch.autograd.DeviceType.CUDA if self._cuda else torch.autograd.DeviceType.CPU

    def is_user_annotation(self):
        return self._span

    def duration_ns(self):
        return int(1e3 * self._us)


def _capture(lost=(), extra=()):
    """Three launches and their kernels, a copy and its call, a device-side
    span; the kernels of ``lost`` launches left out, ``extra`` added."""
    events = [_Event("aten::add", 0), _Event("track_sweep", 0, cuda=True, span=True)]
    for corr, kern in ((11, "track_kernel"), (12, "pyramid_tiles_kernel"),
                       (13, "elementwise_kernel")):
        events.append(_Event("cudaLaunchKernel", corr))
        if corr not in lost:
            events.append(_Event(kern, corr, cuda=True))
    events += [_Event("cudaMemcpyAsync", 14), _Event("Memcpy DtoH (Device -> Pinned)", 14,
                                                     cuda=True)]
    return events + list(extra)


def test_audit_of_a_complete_capture_passes():
    a = profile_trace.audit(_capture())
    assert a == {"kernel_launches": 3, "kernels": 3, "lost_launches": 0, "unlaunched_kernels": 0,
                 "lost_at": []}
    chip_smoke._gate_capture("a complete capture", a)
    # a kernel a CUDA graph launched has no *LaunchKernel call, and is not lost
    a = profile_trace.audit(_capture(extra=[_Event("cudaGraphLaunch", 20),
                                            _Event("graph_kernel", 20, cuda=True)]))
    assert a["unlaunched_kernels"] == 1 and a["lost_launches"] == 0
    chip_smoke._gate_capture("a capture with a graph", a)


def test_audit_fails_a_capture_with_a_launch_without_its_kernel():
    a = profile_trace.audit(_capture(lost=(12,)))
    assert a["lost_launches"] == 1 and a["kernel_launches"] == 3 and a["lost_at"] == [1]
    with pytest.raises(AssertionError, match="1 of 3 kernel launches lost their kernel"):
        chip_smoke._gate_capture("phase 2's per-launch profile", a)
    # the busy shares of phase 14's fresh process go through the same gate
    figures = {"audit": a, "wall_ms": 1.0, "device_busy_ms": 0.5, "busy_share": 0.5,
               "kernel_launches": 3, "device_ops": 3}
    with pytest.raises(AssertionError, match="busy share of 5_sharded"):
        chip_smoke._busy_lines({"5_sharded": figures}, "card")


def test_audit_fails_kernels_it_cannot_hold_against_their_launches():
    no_launches = [e for e in _capture() if "LaunchKernel" not in e.name()]
    with pytest.raises(AssertionError, match="3 kernels and no launch"):
        chip_smoke._gate_capture("a capture without runtime events",
                                 profile_trace.audit(no_launches))


def test_export_audit_leaves_out_launches_before_the_start_marker(tmp_path):
    """trace_detail's audit of an export: a warm-up launch (before traced's
    marker kernel) whose kernel fell out of the window is not lost; a run's
    launch without its kernel is."""
    def ev(cat, name, corr, ts):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1, "pid": 0, "tid": 0,
                "args": {"correlation": corr}}
    events = [ev("cuda_runtime", "cudaLaunchKernel", 5, 10),          # warm-up, kernel gone
              ev("cuda_runtime", "cudaLaunchKernel", 6, 1000),
              ev("kernel", "at::cuda::(anonymous namespace)::spin_kernel(long)", 6, 1002),
              ev("cuda_runtime", "cudaLaunchKernel", 7, 1010),
              ev("kernel", "track_kernel", 7, 1012),
              ev("cuda_runtime", "cudaLaunchKernel", 8, 1020)]         # the run's, kernel lost
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    _, audit = trace_detail.read(str(path))
    assert audit["kernel_launches"] == 4 and audit["lost_launches"] == 1


def _card_session(monkeypatch, lost=()):
    """profile_trace's busy session over a hand-made card capture: a
    warm-up launch whose kernel fell out of the window, three lead markers
    (corr 2-4), work a (5), its closing marker (6), work b (7) and its
    closing marker (8); the kernels of ``lost`` left out."""
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    kernels = {2: spin, 3: spin, 4: spin, 5: "track_kernel", 6: spin,
               7: "pyramid_tiles_kernel", 8: spin}
    events = [_Event("cudaLaunchKernel", 1)]
    for corr, kern in kernels.items():
        events.append(_Event("cudaLaunchKernel", corr))
        if corr not in lost:
            events.append(_Event(kern, corr, cuda=True))
    monkeypatch.setattr(profile_trace, "traced", lambda run, dev, acts: None)
    monkeypatch.setattr(profile_trace, "capture_events", lambda prof: events)
    monkeypatch.setattr(profile_trace.profiling, "sync", lambda dev: None)
    return profile_trace._busy_session({"a": lambda: None, "b": lambda: None},
                                       torch.device("cuda"))


@pytest.mark.parametrize("lost", [(), (2,), (2, 3)])
def test_a_card_busy_session_starts_after_its_last_lead_marker_kept(monkeypatch, lost):
    got = _card_session(monkeypatch, lost)
    for name in "ab":
        assert got[name]["kernel_launches"] == 1 and got[name]["device_ops"] == 1
        assert profile_trace.audit_fault(got[name]["audit"]) is None


@pytest.mark.parametrize("lost", [(4,), (6,), (5,), (2, 3, 4)])
def test_a_card_busy_session_that_lost_a_kernel_after_its_start_is_faulty(monkeypatch, lost):
    """A lost closing marker would shift the split, a lost last lead marker
    leaves the start unsure: every line of such a session is faulty (and
    taken again alone), as when a work lost a kernel."""
    got = _card_session(monkeypatch, lost)
    for name in "ab":
        assert got[name]["audit"]["lost_markers"] >= 1
        with pytest.raises(AssertionError, match="markers must tell the run apart"):
            chip_smoke._gate_capture(f"the busy share of {name}", got[name]["audit"])


def test_export_audit_starts_after_the_last_lead_marker_kept(tmp_path):
    """trace_detail's audit of an export: lead markers whose kernels were
    lost before the last one kept are not the run's; the run's launch
    without its kernel is lost."""
    def ev(cat, name, corr, ts):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": 1, "pid": 0, "tid": 0,
                "args": {"correlation": corr}}
    spin = "at::cuda::(anonymous namespace)::spin_kernel(long)"
    events = [ev("cuda_runtime", "cudaLaunchKernel", 5, 10),          # warm-up, kernel gone
              ev("cuda_runtime", "cudaLaunchKernel", 6, 1000),        # lead marker, gone
              ev("cuda_runtime", "cudaLaunchKernel", 7, 1001),
              ev("kernel", spin, 7, 1003),
              ev("cuda_runtime", "cudaLaunchKernel", 8, 1002),
              ev("kernel", spin, 8, 1004),
              ev("cuda_runtime", "cudaLaunchKernel", 9, 1010),
              ev("kernel", "track_kernel", 9, 1012)]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_detail.read(str(path))[1]["lost_launches"] == 0
    events.append(ev("cuda_runtime", "cudaLaunchKernel", 10, 1020))  # the run's, kernel lost
    path.write_text(json.dumps({"traceEvents": events}))
    assert trace_detail.read(str(path))[1]["lost_launches"] == 1
