"""Is the port's parity drift on production_defaults seed 11 a fault or
chaos? One step of each package from the same JAX state, against each
package's own spread under one-ulp nudges of the newest frame's position.

Replays tools/parity.py's production_defaults sequence (seed 11,
``SlamConfig(max_frames=64)``) through the JAX package up to ``--frame``,
carries the state across with ``bridge.from_numpy``, and runs the port's
``tools.parity_nudges.study`` on frame ``--frame`` with JAX as the
reference side and the port on the CPU as the other: one step of each from
the state and from 26 nudges of the newest frame's translation. Prints one
line per nudge and a JSON summary: the port-vs-JAX distance of the newest
pose (mm), each package's nudge spread, and the fast BA's final cost in
each (unnudged, and its range over all 27 steps).

The port's step lying inside both spreads says the two packages differ by
no more than float32 order moves either of them: chaos, not a fault.

    python -m tests.torch_c1_nudges [--frame 14] [--threads 4]
"""

import argparse
import dataclasses
import json
import os

from tests import conftest  # noqa: F401  (JAX on the CPU, the goldens' XLA flags)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from slam_robot_tpu.config import SlamConfig  # noqa: E402
from slam_robot_tpu.io import sources  # noqa: E402
from slam_robot_tpu.models import pipeline as j_pipe  # noqa: E402
from slam_robot_tpu_torch import bridge  # noqa: E402
from slam_robot_tpu_torch.config import SlamConfig as TorchSlamConfig  # noqa: E402
from slam_robot_tpu_torch.models import pipeline as t_pipe  # noqa: E402
from slam_robot_tpu_torch.tools import parity_nudges  # noqa: E402
from tools import parity  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frame", type=int, default=14)
    ap.add_argument("--seed", type=int, default=11)
    ap.add_argument("--threads", type=int, default=min(4, os.cpu_count() or 1))
    args = ap.parse_args(argv)
    torch.set_num_threads(args.threads)

    spec = parity.SEQUENCES["production_defaults"]
    seq = dict(spec["seq"], seed=args.seed)
    cfg = SlamConfig(**spec["cfg"])
    tcfg = TorchSlamConfig(**dataclasses.asdict(cfg))
    src = sources.SyntheticSource(cfg, **seq)
    ps = j_pipe.init(cfg, [jnp.asarray(src.k)] * 2)
    for i in range(args.frame):
        ps, _ = j_pipe.step(ps, jnp.asarray(src.get(i % 2, i)), cfg)
        ps = j_pipe.maybe_polish(ps, i, cfg)
    img = np.asarray(src.get(args.frame % 2, args.frame))
    f = args.frame

    def jax_step(trans):
        s = ps._replace(map=ps.map._replace(frame_trans=jnp.asarray(trans)))
        out, met = j_pipe.step(s, jnp.asarray(img), cfg)
        return np.asarray(out.map.frame_trans[f]), float(met["ba_cost"])

    def port_step(trans):
        s = ps._replace(map=ps.map._replace(frame_trans=jnp.asarray(trans)))
        out, met = t_pipe.step(bridge.from_numpy(s, "cpu"), torch.as_tensor(np.array(img)), tcfg)
        return out.map.frame_trans[f].numpy(), float(met["ba_cost"])

    summary = {"seed": args.seed, **parity_nudges.study(
        np.array(ps.map.frame_trans), f, {"jax": jax_step, "port": port_step})}
    print(json.dumps(summary), flush=True)
    return summary


if __name__ == "__main__":
    main()
