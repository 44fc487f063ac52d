"""The traced window's reduction (``benchmark/trace.py``) on a capture made
of stand-in events: the window between the last lead marker kept and the
tail marker, the busy union, the kernel count, the categories, the idle gaps
by the host operator that launched the work ending each, and the audit."""

import torch

from benchmark import trace

CUDA, CPU = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU


class Event:
    def __init__(self, name, start, dur, corr, device=CUDA):
        self._n, self._s, self._d, self._c, self._dev = name, start, dur, corr, device

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._d

    def correlation_id(self):
        return self._c

    def device_type(self):
        return self._dev

    def is_user_annotation(self):
        return False


def _launch(corr, at):
    return Event("cudaLaunchKernel", at, 5, corr, CPU)


def _capture(lose_tail=False):
    ev = []
    # two lead markers (the first before the run), the run, a tail marker
    for corr, at in ((1, 0), (2, 100)):
        ev += [_launch(corr, at), Event("void at::cuda::spin_kernel(long)", 1000 + at, 50, corr)]
    kernels = [("index_put_with_sort_kernel", 1200, 300, 3), ("gemv_kernel", 1500, 100, 4),
               ("vectorized_elementwise_kernel", 1700, 100, 5)]
    host = {3: ("aten::index_put_", 200), 4: ("aten::einsum", 300), 5: ("aten::mul", 400)}
    for name, start, dur, corr in kernels:
        op, at = host[corr]
        ev += [Event(op, at - 2, 20, 0, CPU), _launch(corr, at), Event(name, start, dur, corr)]
    ev += [Event("Memcpy DtoH", 1800, 20, 6), Event("cudaMemcpyAsync", 450, 5, 6, CPU)]
    if not lose_tail:
        ev += [_launch(7, 500), Event("void at::cuda::spin_kernel(long)", 1900, 50, 7)]
    return ev


def test_the_window_reduces_to_its_figures():
    fig = trace.reduce_window(_capture())
    # from the second lead marker's end (1150) to the tail marker's start
    assert fig["window_ns"] == 1900 - 1150
    assert fig["busy_ns"] == 300 + 100 + 100 + 20
    assert fig["kernels"] == 3 and fig["audit"]["lost_launches"] == 0
    assert fig["by_category_ns"] == {"scatter and index_put_": 300, "gemm/gemv and bmm": 100,
                                     "elementwise": 100, "memcpy and memset": 20}
    gaps = dict(fig["idle_gaps"])
    assert gaps["aten::index_put_"] == 50 / 1e9           # 1150 -> 1200
    assert gaps["aten::mul"] == 100 / 1e9                 # 1600 -> 1700
    assert gaps["after the last kernel"] == 80 / 1e9      # 1820 -> 1900
    assert abs(sum(gaps.values()) * 1e9 - (fig["window_ns"] - fig["busy_ns"])) < 1e-6


def test_a_capture_that_lost_its_tail_marker_has_no_window():
    assert trace.reduce_window(_capture(lose_tail=True)) is None


def test_a_lost_kernel_shows_in_the_audit():
    ev = [e for e in _capture() if not (e.name() == "gemv_kernel")]
    fig = trace.reduce_window(ev)
    assert fig["audit"]["lost_launches"] == 1 and fig["kernels"] == 2
