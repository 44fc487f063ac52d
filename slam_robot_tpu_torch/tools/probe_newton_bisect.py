"""The fused Newton skeleton cut into stages (the port of
``tools/probe_newton_bisect.py``), on probe_newton_kernel's inputs:

  extract:   the per-lane score, written to both columns
  grad:      its gradient
  jvp:       the Hessian's first column, H e_x
  fori_grad: six steps of p - 0.01 g

    python -m slam_robot_tpu_torch.tools.probe_newton_bisect [--device cuda|cpu]
"""

from __future__ import annotations

import sys

from slam_robot_tpu_torch.ops.cuda import probe_newton as pn
from slam_robot_tpu_torch.tools import main_for
from slam_robot_tpu_torch.tools.probe_newton_kernel import stage_case

# atol 1e-4 on the CPU, 1e-3 on the card: closed-form against autodiff
# derivatives, sums of 169 terms in another order
CASES = [stage_case(name, pn.STAGES[name], "tools/probe_newton_bisect.py:93", 1e-4, 1e-3)
         for name in ("extract", "grad", "jvp", "fori_grad")]


def main(argv=None) -> int:
    return main_for(__doc__, CASES, argv)


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
