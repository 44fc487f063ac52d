"""Where phase 7's wall time goes, case by case: for every probe case, in
``tools.PROBES`` order and in one fresh process, the wall ms of the kernel's
first call, of the original's expected values, of the plain version and of
a second kernel call, each synchronized. Phase 7 (``chip_smoke.phase_probes``)
makes the same calls; this prints what each one took. Run on the card from
the root of a checkout, or of another tree to compare two in turns:

    python3 <checkout>/tests/torch_probe_first_calls.py TAG

One line a case: ``TAG <module> <case> ms: run .., want .., plain .., run2 ..``.
"""

from __future__ import annotations

import importlib
import sys
import time

sys.path.insert(0, ".")
import torch  # noqa: E402

from slam_robot_tpu_torch import tools  # noqa: E402
from slam_robot_tpu_torch.ops.cuda import build  # noqa: E402


def wall_ms(fn) -> float:
    t = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return 1e3 * (time.perf_counter() - t)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    tag = argv[0] if argv else "tree"
    build.load_library()
    dev = torch.device("cuda")
    for name in tools.PROBES:
        mod = importlib.import_module(f"slam_robot_tpu_torch.tools.{name}")
        for case in mod.CASES:
            args = case.inputs(dev)
            torch.cuda.synchronize()
            parts = [(what, wall_ms(lambda fn=fn: fn(*args)))
                     for what, fn in (("run", case.run), ("want", case.want),
                                      ("plain", case.plain), ("run2", case.run))]
            print(tag, name, case.name, "ms:", ", ".join(f"{w} {ms:.1f}" for w, ms in parts),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
