"""What a run loads: nothing whose top-level name is ``jax``, ``jaxlib``,
``flax`` or the JAX package's ``slam_robot_tpu``, compared as whole names
(the port's ``slam_robot_tpu_torch`` only begins with the JAX package's);
and the yardstick (generator, reference, comparison, count, trace) loads
nothing of the port."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

from benchmark import run, spec

CHECKOUT = spec.CHECKOUT
YARDSTICK = ("benchmark.gen.bal", "benchmark.reference.ba", "benchmark.reference.geometry",
             "benchmark.compare", "benchmark.roofline", "benchmark.trace", "benchmark.spec")


def _loaded(code: str, cwd=CHECKOUT) -> set:
    out = subprocess.run([sys.executable, "-c", code + "\nimport sys, json\n"
                          "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
                         cwd=cwd, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_a_cells_import_path_loads_no_jax():
    names = [w["name"] for w in spec.benchmark()["workloads"]]
    code = ("from benchmark import run, spec\n"
            f"for n in {names!r}:\n"
            "    cell = spec.load_cell(n)\n"
            "    spec.driver(cell)\n"
            "    [spec.reader(m['name']) for m in cell['end_to_end'] + cell['per_layer']]\n")
    loaded = _loaded(code)
    assert "slam_robot_tpu_torch" in loaded and "torch" in loaded
    assert not loaded & set(run.FORBIDDEN), loaded & set(run.FORBIDDEN)


def test_the_yardstick_loads_nothing_of_the_port():
    loaded = _loaded("".join(f"import {m}\n" for m in YARDSTICK))
    assert "slam_robot_tpu_torch" not in loaded
    assert not loaded & set(run.FORBIDDEN)


def test_the_check_compares_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "slam_robot_tpu_torch_extra", sys)
    monkeypatch.delitem(sys.modules, "slam_robot_tpu", raising=False)
    assert "slam_robot_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "slam_robot_tpu.ops", sys)
    monkeypatch.setitem(sys.modules, "jaxlib.xla", sys)
    assert {"slam_robot_tpu", "jaxlib"} <= set(run.forbidden_modules())


def test_no_card_no_result():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "ladybug1723.full",
                          "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                         cwd=CHECKOUT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_the_benchmark_alone_does_not_run(tmp_path: Path):
    """A checkout of only BENCHMARK.json and the benchmark's paths has no
    program to measure: the run fails and prints no result."""
    bench = spec.benchmark()
    shutil.copy(CHECKOUT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    for p in bench["paths"]:
        shutil.copytree(CHECKOUT / p, tmp_path / p,
                        ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys\nfrom benchmark import run\n"
            "sys.exit(run.main(['--workload', 'ladybug1723.full', '--seed', '5', "
            "'--seconds', '1'], device='cpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "slam_robot_tpu_torch" in out.stderr
