"""T3's and T13's layout cases by CUDA-graph replay, kernel and library call
in turns, in the checkout this runs from (on the card, from the root of a
checkout: its ``chip_smoke`` and its port). Run it from two checkouts in
turns (parent, change, change, parent) to hold one body against another
on one card; ``chip_smoke.py``'s phase 7 times the same pairs in one
checkout, by events too. Prints one JSON line: per case the lesser of two
graph timings (ms a call) of the kernel and of its library call.

    python3 /path/to/tests/torch_probe_graph.py TAG
"""

import json
import os
import sys

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke  # noqa: E402
from slam_robot_tpu_torch.tools import probe_mosaic, probe_mosaic4  # noqa: E402

CASES = ("P3", "G1", "G2", "G4", "G5")


def main() -> int:
    dev = torch.device("cuda")
    out = {}
    for c in probe_mosaic.CASES + probe_mosaic4.CASES:
        if c.name.split()[0] not in CASES:
            continue
        args = c.inputs(dev)
        kernel, library = (lambda: c.run(*args)), c.library(*args)
        t = [chip_smoke._graph_ms(f) for f in (kernel, library, library, kernel)]
        out[c.name.split()[0]] = {"kernel_graph_ms": min(t[0], t[3]),
                                  "library_graph_ms": min(t[1], t[2])}
    print(sys.argv[1] if len(sys.argv) > 1 else "", json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
