"""The port's profiling tools (``slam_robot_tpu_torch/tools/profile_*``,
``probe_live``, ``trace_detail``) held against the JAX package's scripts
in ``tools/``, on the CPU.

- Labels, JSON keys and variant names, read from both sources with
  ``ast`` (as tests/test_torch_bench.py reads ``bench.py``): equal, but for
  what each port tool states it adds (``profile_tracker``'s stage 4 names
  ``newton_track``; ``probe_live``'s four variants without a counterpart
  print a line saying so).
- ``profile_scan``'s variant table: for every variant name, the port's
  ``SlamConfig`` change equals field by field what the original's branch
  does to the JAX ``SlamConfig`` (the original's ``main`` run with its
  ``run_variant`` recording the config it is given).
- ``profile_tpu``, ``profile_tracker`` and ``profile_cg`` run their ``main``
  with ``--small --device cpu`` and exit 0, printing every stage's line.
- Without a card and without ``--device cpu`` every tool exits 1 and
  prints no result line.
"""

import ast
import dataclasses
import importlib.util
import os
import subprocess
import sys

import jax
import pytest
import torch

from slam_robot_tpu.config import SlamConfig as JCfg
from slam_robot_tpu_torch.tools import (probe_live, profile_cg, profile_cg_sharded,
                                        profile_scan, profile_step, profile_tpu,
                                        profile_trace, profile_tracker, profiling,
                                        trace_detail)
from tests.test_pipeline import CFG
from tests.test_torch_config import port_cfg

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("profile_tpu", "profile_step", "profile_tracker", "profile_scan", "probe_live",
         "profile_trace", "profile_cg", "profile_cg_sharded")


def tree(*parts):
    return ast.parse(open(os.path.join(ROOT, *parts)).read())


def template(node: ast.JoinedStr) -> str:
    """An f-string as text, each formatted Name as {name}, others as {}."""
    out = []
    for v in node.values:
        if isinstance(v, ast.Constant):
            out.append(v.value)
        else:
            out.append("{%s}" % v.value.id if isinstance(v.value, ast.Name) else "{}")
    return "".join(out)


def stage_labels(t) -> list:
    """Labels of the stage lines ``<label>:   <time>`` a script prints."""
    out = []
    for node in ast.walk(t):
        if isinstance(node, ast.JoinedStr):
            text = template(node)
            head, sep, tail = text.partition(":")
            if sep and tail.startswith("  ") and tail.lstrip().startswith("{"):
                out.append(head)
    return out


def dict_keys(t, must: str) -> set:
    """Key sets of every dict literal holding key ``must``."""
    return {frozenset(k.value for k in n.keys if isinstance(k, ast.Constant))
            for n in ast.walk(t) if isinstance(n, ast.Dict)
            and any(isinstance(k, ast.Constant) and k.value == must for k in n.keys)}


def default_of(t, flag: str):
    for n in ast.walk(t):
        if isinstance(n, ast.Call) and n.args and isinstance(n.args[0], ast.Constant) \
                and n.args[0].value == flag:
            return next(k.value.value for k in n.keywords if k.arg == "default")
    raise AssertionError(f"no {flag}")


def test_profile_tpu_labels_are_the_originals():
    assert stage_labels(tree("tools", "profile_tpu.py")) == list(profile_tpu.STAGES)
    assert profile_tpu.line("BA window (10,20)", 1.0) == "BA window (10,20):      1.00 ms"


def test_profile_step_labels_are_the_originals():
    assert stage_labels(tree("tools", "profile_step.py")) == list(profile_step.STAGES)
    assert default_of(tree("tools", "profile_step.py"), "--backoff") == 0


def test_profile_tracker_labels_are_the_originals():
    want = [s.format(F=256) for s in stage_labels(tree("tools", "profile_tracker.py"))]
    got = [s.format(F=256, L=6) for s in profile_tracker.LABELS]
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        # stage 4 names the port's B1 entry point, which the stage launches
        assert g == w or (g.startswith(w) and g.endswith("newton_track")), (g, w)


def test_profile_scan_keys_and_default_are_the_originals():
    t = tree("tools", "profile_scan.py")
    (want,) = dict_keys(t, "scan_step_ms")
    p = tree("slam_robot_tpu_torch", "tools", "profile_scan.py")
    (line,) = dict_keys(p, "scan_step_ms")
    (stats,) = dict_keys(p, "median_enabled_err_px")
    assert line | stats == want
    assert profile_scan.DEFAULT == default_of(t, "--variants")


def _jax_variant_names(t) -> set:
    """String constants the original compares variant ``name`` with."""
    return {c.value for n in ast.walk(t) if isinstance(n, ast.Compare)
            and isinstance(n.left, ast.Name) and n.left.id == "name"
            for c in n.comparators if isinstance(c, ast.Constant)}


def test_probe_live_keys_variants_and_default_are_the_originals():
    t = tree("tools", "probe_live.py")
    p = tree("slam_robot_tpu_torch", "tools", "probe_live.py")
    extra = frozenset({"variant", "no_counterpart"})
    assert dict_keys(p, "variant") - {extra} == dict_keys(t, "variant")

    def extra_keys(x):
        return {n.slice.value for n in ast.walk(x) if isinstance(n, ast.Subscript)
                and isinstance(n.value, ast.Name) and n.value.id == "extra"
                and isinstance(n.slice, ast.Constant)}

    assert extra_keys(p) == extra_keys(t) == {"issue_ms_per_frame", "per_dispatch_ms"}
    names = _jax_variant_names(t) | {"rtt"}
    assert set(probe_live.VARIANTS) | set(probe_live.NO_COUNTERPART) == names
    assert set(probe_live.NO_COUNTERPART) == {"aot", "live_fetch", "live_batchfetch",
                                              "live_fetch1"}
    assert probe_live.DEFAULT == default_of(t, "--variants")
    assert not set(probe_live.DEFAULT.split(",")) & set(probe_live.NO_COUNTERPART)


def test_profile_cg_sharded_keys_are_the_originals():
    t = tree("tools", "profile_cg_sharded.py")
    p = tree("slam_robot_tpu_torch", "tools", "profile_cg_sharded.py")
    for key in ("cost_rel_err", "projected_gn_iters_per_s", "validation",
                "measured_single_chip_gn_iters_per_s"):
        assert dict_keys(p, key) == dict_keys(t, key), key


def test_profile_cg_options_are_the_originals():
    t = tree("tools", "profile_cg.py")
    p = tree("slam_robot_tpu_torch", "tools", "profile_cg.py")
    for flag in ("--top", "--gn-iters", "--cg-iters", "--layout"):
        assert default_of(p, flag) == default_of(t, flag), flag


VARIANT_NAMES = ("default", "backoff2", "backoff4", "noslam", "rt0", "rt2", "ladder",
                 "sweeps2", "fast10", "giveup8", "nowincache", "bo3",
                 "set:tracker_impl=lanes", "set:tracker_kind=klt",
                 "set:ba_iters_slow=40;slow_every=4", "set:bwd_window_cache=False",
                 "set:solve_xslow=24x32")


def _jax_variants(monkeypatch, names) -> list:
    """(name, JAX config, run_slam) the original's main gives run_variant."""
    spec = importlib.util.spec_from_file_location(
        "jax_profile_scan", os.path.join(ROOT, "tools", "profile_scan.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    got = []
    monkeypatch.setattr(mod, "run_variant", lambda name, cfg, frames, n_warm, run_slam=True:
                        got.append((name, cfg, run_slam)))
    from slam_robot_tpu.utils import benchscene
    monkeypatch.setattr(benchscene, "make_frames", lambda cfg, n, seed=0: [None] * n)
    # the original points XLA's compile cache at a fixed directory
    monkeypatch.setattr(jax.config, "update", lambda *a, **k: None)
    monkeypatch.setattr(sys, "argv", ["profile_scan.py", "--variants", ",".join(names)])
    mod.main()
    return got


def test_profile_scan_variants_change_the_config_as_the_original(monkeypatch):
    got = _jax_variants(monkeypatch, VARIANT_NAMES)
    assert [g[0] for g in got] == list(VARIANT_NAMES)
    base = port_cfg(JCfg())
    for name, jcfg, run_slam in got:
        cfg, slam = profile_scan.variant_config(name, base)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg), name
        assert slam == run_slam, name
    assert profile_scan.variant_config("set:tracker_impl=lanes", base)[0].tracker_impl == "lanes"
    with pytest.raises(ValueError):
        profile_scan.variant_config("nosuch", base)


def test_small_is_the_tests_config():
    assert dataclasses.asdict(profiling.SMALL) == dataclasses.asdict(port_cfg(CFG))


@pytest.mark.parametrize("tool, argv, want", [
    ("profile_tpu", ["--small"], profile_tpu.STAGES),
    ("profile_tracker", ["--small"], [s.format(F=96, L=4) for s in profile_tracker.LABELS]),
    ("profile_cg", ["--small", "--gn-iters", "2", "--cg-iters", "5"],
     ("solve:", "total device self time:", "-- by category (ms/GN iter) --")),
])
def test_main_runs_on_the_cpu_at_a_small_size(tool, argv, want, capsys, tmp_path):
    mod = {"profile_tpu": profile_tpu, "profile_tracker": profile_tracker,
           "profile_cg": profile_cg}[tool]
    extra = ["--out", str(tmp_path)] if tool == "profile_cg" else []
    assert mod.main(argv + extra + ["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    for label in want:
        assert any(x.startswith(label) for x in lines), (label, lines)
    if tool == "profile_cg":
        assert "layout=scatter" in lines[0]
        assert (tmp_path / "trace.json").exists()


@pytest.mark.parametrize("tool", TOOLS)
def test_without_a_card_a_tool_exits_1_and_prints_no_result(tool, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    mod = {"profile_tpu": profile_tpu, "profile_step": profile_step,
           "profile_tracker": profile_tracker, "profile_scan": profile_scan,
           "probe_live": probe_live, "profile_trace": profile_trace, "profile_cg": profile_cg,
           "profile_cg_sharded": profile_cg_sharded}[tool]
    assert mod.main([]) == 1
    out = capsys.readouterr()
    assert out.out == "" and "no CUDA device" in out.err


def test_python_dash_m_without_a_card_exits_1():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-m", "slam_robot_tpu_torch.tools.profile_step"],
                         capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 1 and res.stdout == ""


def test_trace_detail_without_a_trace_exits_1(tmp_path, capsys):
    assert trace_detail.main(["--trace", str(tmp_path / "none.json")]) == 1
    assert capsys.readouterr().out == ""
