"""The port's own ``SlamConfig`` against the JAX package's, the port's import
boundary, and its default device.

- ``slam_robot_tpu_torch.config`` is a copy of ``slam_robot_tpu.config``:
  the same field names in the same order, types, defaults and
  ``REFERENCE_EXACT_KW`` (compared exactly).
- Importing every module of the port (``pkgutil.walk_packages``) in a fresh
  interpreter loads no ``jax*`` module and no ``slam_robot_tpu`` or
  ``slam_robot_tpu.*`` module.
- With no device given, the entry points mean the CUDA card: where torch
  sees none (as here) they raise instead of building CPU tensors.
- A mesh may name one device more than once (shards that share a card).

:func:`port_cfg` is how the port's tests hand a JAX-package config to the
port.
"""

import dataclasses
import os
import subprocess
import sys

import pytest
import torch

from slam_robot_tpu import config as j_config
from slam_robot_tpu_torch import SlamConfig
from slam_robot_tpu_torch import config as t_config
from slam_robot_tpu_torch.device import default_device

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def port_cfg(jax_cfg) -> SlamConfig:
    """The port's SlamConfig with every field of a JAX-package SlamConfig."""
    return SlamConfig(**dataclasses.asdict(jax_cfg))


def test_fields_types_and_defaults_match():
    jf = dataclasses.fields(j_config.SlamConfig)
    tf = dataclasses.fields(t_config.SlamConfig)
    assert [f.name for f in tf] == [f.name for f in jf]
    for a, b in zip(tf, jf):
        assert a.type == b.type, a.name
        assert a.default == b.default, a.name
    assert t_config.SlamConfig() == port_cfg(j_config.SlamConfig())
    assert t_config.SlamConfig.__dataclass_params__.frozen


def test_reference_exact_kw_matches():
    assert t_config.REFERENCE_EXACT_KW == j_config.REFERENCE_EXACT_KW
    assert dataclasses.asdict(t_config.reference_exact(image_width=160)) == \
        dataclasses.asdict(j_config.reference_exact(image_width=160))


def test_port_cfg_round_trips_a_non_default_config():
    j = dataclasses.replace(j_config.SlamConfig(), image_width=160, solve_slow=(8, 16),
                            lm_policy="classic")
    t = port_cfg(j)
    assert isinstance(t, t_config.SlamConfig)
    assert dataclasses.asdict(t) == dataclasses.asdict(j)


def test_port_modules_import_nothing_of_the_jax_package():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import slam_robot_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')\n"
        "             or m.startswith('jaxlib') or m == 'slam_robot_tpu'\n"
        "             or m.startswith('slam_robot_tpu.'))\n"
        "assert not bad, bad\n"
        "for want in ('run_replay', 'tools.probe_newton_kernel', 'run_sim', 'stop',\n"
        "             'models.vehicle', 'models.planner', 'models.sim', 'parallel.mesh',\n"
        "             'parallel.rollouts', 'io.usb', 'ops.ba_cg', 'parallel.sharded_ba',\n"
        "             'parallel.multi_robot', 'parallel.dryrun', 'tools.calibrate',\n"
        "             'tools.bench_suite', 'ops.obs_shards'):\n"
        "    assert 'slam_robot_tpu_torch.' + want in names, (want, names)\n"
        "print(len(names))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]
    assert int(res.stdout.strip()) >= 40


def test_solver_layer_imports_nothing_of_the_parallel_layer():
    code = (
        "import importlib, pkgutil, sys\n"
        f"sys.path.insert(0, {ROOT!r})\n"
        "import slam_robot_tpu_torch.ops as ops\n"
        "names = [m.name for m in pkgutil.walk_packages(ops.__path__, ops.__name__ + '.')]\n"
        "for n in names:\n"
        "    importlib.import_module(n)\n"
        "assert 'slam_robot_tpu_torch.ops.ba_cg' in names, names\n"
        "bad = sorted(m for m in sys.modules if m.startswith('slam_robot_tpu_torch.parallel'))\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=env, cwd=ROOT)
    assert res.returncode == 0, res.stderr[-3000:]


def test_entry_points_without_a_device_mean_the_card():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where torch sees no CUDA device")
    from slam_robot_tpu_torch.io.sources import SyntheticSource
    from slam_robot_tpu_torch.models import (localmap, matcher, pipeline, planner, renderer, sim,
                                            vehicle)
    from slam_robot_tpu_torch.parallel import mesh
    from slam_robot_tpu_torch.tools import bench_suite, calibrate
    from slam_robot_tpu_torch.utils import benchscene, synthetic

    cfg = SlamConfig(image_width=160, image_height=120, pyramid_depth=4,
                     max_features=64, max_points=128, max_obs=1024)
    path = planner.shortest_path(torch.zeros(2), 0.0, torch.tensor([4.0, 3.0]), 0.0)[0]
    for call in (lambda: pipeline.init(cfg), lambda: localmap.empty(cfg),
                 lambda: matcher.init(cfg), lambda: benchscene.make_frames(cfg, 1),
                 lambda: SyntheticSource(cfg, n_frames=2),
                 lambda: renderer._background(12, 16), lambda: default_device("cuda"),
                 lambda: vehicle.init_state(), lambda: sim.make_world(10),
                 lambda: sim.rollout([[3.0, 2.0, 0.0]], n_steps=1), lambda: mesh.make_mesh(),
                 lambda: planner.shortest_path([0.0, 0.0], 0.0, [4.0, 3.0], 0.0),
                 lambda: planner.all_paths([0.0, 0.0], 0.0, [4.0, 3.0], 0.0),
                 lambda: planner.interpolate_path([0.0, 0.0], 0.0, path),
                 lambda: planner.path_endpoint([0.0, 0.0], 0.0, path),
                 lambda: synthetic.build_scene(cfg), lambda: synthetic.make_trajectory(4, cfg),
                 lambda: synthetic.build_large_problem(10, 100, 4),
                 lambda: calibrate.main(["--synthetic", "2"]),
                 lambda: bench_suite.main(["--configs", "5", "--small"])):
        with pytest.raises(RuntimeError, match='device="cpu"'):
            call()
    assert default_device("cpu") == torch.device("cpu")
    ps = pipeline.init(cfg, device="cpu")
    assert ps.map.point_loc.device.type == "cpu"


def test_replay_cli_without_a_device_refuses_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("this test checks the refusal where torch sees no CUDA device")
    res = subprocess.run(
        [sys.executable, "-m", "slam_robot_tpu_torch.run_replay", "--synthetic", "2",
         "--width", "160", "--height", "120", "--quiet"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr and '"frames"' not in res.stdout


def test_make_mesh_takes_a_repeated_device():
    from slam_robot_tpu_torch.parallel import mesh

    m = mesh.make_mesh({"model": 4}, devices=["cpu"] * 4)
    assert m.shape == {"model": 4}
    assert m.axis_devices("model") == [torch.device("cpu")] * 4
    grid = mesh.make_mesh({"data": 2, "model": 2}, devices=["cpu"] * 4)
    assert grid.shape == {"data": 2, "model": 2}
    with pytest.raises(ValueError, match="needs 4 devices"):
        mesh.make_mesh({"model": 4}, devices=["cpu"] * 3)
