"""``profile_trace`` and ``trace_detail`` on the CPU, where the trace's
"device" rows are the CPU's operators: the bench scan's state after 4 warm
frames at tests/test_pipeline.CFG, with every BA iteration cap at 2 to keep
the trace small (each BA iteration adds ~10^4 operator events, which the
profiler takes ~0.1 ms each to read back), traced over 2 frames.

- The categories add up to the total device self time within 1 %.
- ``trace_detail``'s occurrence counts, read from the exported Chrome JSON,
  equal ``key_averages()``'s for every name, and its rows name the spans
  that enclose them.
- Host time by span comes from the unprofiled pass: ``SpanTimer`` turns
  ``device.SPAN_MS`` on and off again, also after an exception, and leaves
  ``record_function`` as it found it.
- ``trace_detail`` prints B1's and B2's rows against the port's counters
  (``launches.json`` beside the trace) and the launches whose kernel the
  trace lost; a hand-made trace shows a shortfall.
- State caches and traces default to the temporary directory, tagged by
  checkout.
- ``category`` sorts the card's kernel names: B1's and B2's kernels, the
  other hand-written ones, and PyTorch's.
"""

import dataclasses
import json
import os
import tempfile

import pytest
import torch

from slam_robot_tpu_torch import bench, device
from slam_robot_tpu_torch.tools import profile_cg, profile_trace, profiling, trace_detail
from slam_robot_tpu_torch.utils.benchscene import make_frames
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

TCFG = dataclasses.replace(port_cfg(CFG), ba_iters_fast=2, ba_iters_slow=2, ba_iters_xslow=2,
                           ba_iters_polish=2, ba_max_iters=2)
N_WARM, N_FRAMES = 4, 2


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    frames = make_frames(TCFG, N_WARM + N_FRAMES, device="cpu")
    cache = str(tmp_path_factory.mktemp("state") / "state.pt")
    lines = []
    ps = profile_trace.get_state(TCFG, frames, N_WARM, torch.device("cpu"), cache=cache,
                                 emit=lines.append)
    again = profile_trace.get_state(TCFG, frames, N_WARM, torch.device("cpu"), cache=cache,
                                    emit=lines.append)
    out = str(tmp_path_factory.mktemp("trace"))
    p = profile_trace.trace_scan(ps, torch.stack(frames[N_WARM:]), TCFG, torch.device("cpu"),
                                 out, top=10, emit=lines.append)
    return p, lines, ps, again


def test_state_cache_round_trips(traced):
    _, lines, ps, again = traced
    assert lines[0].startswith("state: bootstrapped") and lines[1].startswith("state: loaded")
    for a, b in zip(profile_trace.pipeline.PipelineState._fields, zip(ps, again)):
        assert all(torch.equal(x, y) for x, y in zip(*(
            (v if isinstance(v, tuple) else (v,)) for v in b))), a


def test_categories_add_up_to_the_total(traced):
    p, lines, _, _ = traced
    assert set(p["by_category_ms"]) == set(profile_trace.CATEGORIES)
    assert sum(p["by_category_ms"].values()) == pytest.approx(p["device_ms"], rel=1e-2)
    assert p["device_ms"] > 0 and p["units"] == N_FRAMES
    text = [x.strip() for x in lines]
    assert any(x.startswith("total device self time:") for x in text)
    assert "-- by category (ms/frame) --" in text


def test_trace_detail_counts_equal_key_averages(traced):
    p, _, _, _ = traced
    rows = trace_detail.rows(p["trace"])
    assert {r["name"]: r["occ"] for r in rows} == p["counts"]
    spans = set().union(*(r["spans"] for r in rows))
    assert {"slam", "ba_solve", "matcher", "track_sweep"} <= spans


def test_host_time_by_span(traced):
    p, _, _, _ = traced
    spans = p["host_ms_by_span"]
    assert spans["slam"] >= spans["ba_solve"] > 0 and spans["matcher"] > 0
    assert spans["slam"] + spans["matcher"] <= p["wall_ms"] * 1.01
    assert p["syncs"] > 0 and p["span_calls"]["slam"] == N_FRAMES


def test_span_timer_restores_record_function():
    cls = torch.autograd.profiler.record_function
    saved = cls.__enter__, cls.__exit__
    with pytest.raises(RuntimeError):
        with profile_trace.SpanTimer() as t:
            with device.span("outer"):
                with device.span("inner"):
                    pass
                raise RuntimeError("boom")
    assert (cls.__enter__, cls.__exit__) == saved and not device.SPAN_MS.on
    assert t.calls == {"outer": 1, "inner": 1} and t.ms["outer"] >= t.ms["inner"]
    with device.span("outer"):   # off: nothing added
        pass
    assert device.SPAN_MS.calls == {"outer": 1, "inner": 1}


def _event(cat, name, ts, dur, corr, **kw):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 0, "tid": 1,
            "args": {"correlation": corr}, **kw}


def test_trace_detail_audits_the_trace_against_the_counters(tmp_path, capsys):
    """A hand-made card trace: two pyramid launches of which one kernel is
    missing, a newton_track kernel that starts 5 us before its launch."""
    dev = {"pid": 7, "tid": 7}
    events = [
        _event("user_annotation", "pyramid", 0.0, 100.0, None),
        _event("cuda_runtime", "cudaLaunchKernel", 10.0, 2.0, 1),
        _event("cuda_runtime", "cudaLaunchKernel", 20.0, 2.0, 2),
        _event("user_annotation", "track_sweep", 200.0, 100.0, None),
        _event("cuda_driver", "cuLaunchKernel", 210.0, 2.0, 3),
        _event("cuda_runtime", "cudaStreamSynchronize", 250.0, 2.0, 4),
        _event("kernel", "pyramid_tiles_kernel(float const*, float*, PyrParams)", 30.0, 8.0,
               1, **dev),
        _event("kernel", "track_kernel(TrackParams)", 205.0, 9.0, 3, **dev),
    ]
    trace = tmp_path / "trace.json"
    trace.write_text(json.dumps({"traceEvents": events}))
    (tmp_path / profile_trace.LAUNCHES_FILE).write_text(json.dumps(
        {"units": 1, "counted_launches": {"newton_track": 1, "pyramid_flat": 2}}))
    found, audit = trace_detail.read(str(trace))
    assert {r["cat"]: (r["occ"], dict(r["spans"])) for r in found} == {
        "pyramid_flat": (1, {"pyramid": 1}), "newton_track": (1, {"track_sweep": 1})}
    assert audit == {"kernel_launches": 3, "lost_launches": 1,
                     "lost_launch_spans": {"pyramid": 1}, "unlaunched_kernels": 0,
                     "min_launch_to_kernel_us": -5.0}
    assert trace_detail.shortfall(str(trace), found) == {"newton_track": [1, 1],
                                                         "pyramid_flat": [1, 2]}
    assert trace_detail.main(["--trace", str(trace), "--frames", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert "SHORT by {\"pyramid_flat\": 1}" in out[0] and out[1].startswith("launches: ")
    assert trace_detail.main(["--trace", str(trace), "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["audit"] == audit and got["shortfall"] == {"newton_track": [1, 1],
                                                          "pyramid_flat": [1, 2]}
    assert [(r["name"], r["spans"]) for r in got["rows"]] == [
        (r["name"], dict(r["spans"])) for r in found]


def test_trace_detail_finds_the_exported_pass_complete(traced, capsys):
    p, _, _, _ = traced
    assert trace_detail.main(["--trace", p["trace"], "--top", "3"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[0].endswith("complete") and out[1].startswith("launches: ")


def test_state_caches_and_traces_go_to_the_temporary_directory(monkeypatch, tmp_path):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    path = profile_trace.state_cache(TCFG, N_WARM)
    assert os.path.dirname(path) == str(tmp_path)
    assert path == profiling.scratch_path(f"bench_state_torch_160x120_96_w{N_WARM}") + ".pt"
    # one tag a checkout, on the traces' default directories too
    tag = os.path.basename(profiling.scratch_path("x"))[1:]
    assert len(tag) == 9 and tag.startswith("_")
    assert os.path.basename(profile_trace.TRACE_DIR) == "torchtrace" + tag
    assert os.path.basename(profile_cg.TRACE_DIR) == "torchtrace_cg" + tag


@pytest.mark.parametrize("name, cat", [
    ("track_kernel(TrackParams)", "newton_track"),
    ("pyramid_tiles_kernel(float const*, float*, PyrParams)", "pyramid_flat"),
    ("pyramid_walk_kernel(float*, PyrParams)", "pyramid_flat"),
    ("_Z12track_kernel11TrackParams", "newton_track"),
    ("(anonymous namespace)::track_kernel(TrackParams)", "newton_track"),
    ("(anonymous namespace)::pyramid_walk_kernel(float*, PyrParams)", "pyramid_flat"),
    ("void (anonymous namespace)::windows_kernel(float const*, void const*)",
     "other hand-written kernels"),
    ("void at::native::(anonymous namespace)::fill_kernel_impl<float>", "other"),
    ("_Z20pyramid_tiles_kernelPKfPfK9PyrParams", "pyramid_flat"),
    ("_Z16two_level_kernelPKfS0_Pfiiii", "other hand-written kernels"),
    ("sep5_reflect101_kernel(float const*, float*, int, int)", "other hand-written kernels"),
    ("void at::native::vectorized_elementwise_kernel<4, at::native::CUDAFunctor_add<float>>",
     "elementwise"),
    ("void at::native::index_elementwise_kernel<128, 4>", "gather and index"),
    ("void at::native::indexing_backward_kernel<float, 4>", "scatter and index_put_"),
    ("sm90_xmma_gemm_f32f32_f32f32_f32_tn_n_tilesize128x128x16", "gemm/gemv and bmm"),
    ("void gemv2T_kernel_val<int, int, float>", "gemm/gemv and bmm"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float>>", "reductions"),
    ("Memcpy DtoH (Device -> Pageable)", "memcpy and memset"),
    ("aten::copy_", "memcpy and memset"),
    ("aten::bmm", "gemm/gemv and bmm"),
    ("aten::index", "gather and index"),
    ("aten::_index_put_impl_", "scatter and index_put_"),
    ("aten::mul_", "elementwise"),
    ("aten::sum", "reductions"),
    ("aten::cat", "other"),
])
def test_category(name, cat):
    assert profile_trace.category(name) == cat
