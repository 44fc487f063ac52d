"""Emergency-stop CLI (stop.cpp:3-6): construct a Vehicle, Stop().

    python -m slam_robot_tpu_torch.stop

Port of ``slam_robot_tpu/stop.py``: the same transfer sequence and output
line. The count includes the four transfers of the vehicle's auto-stop on
destruction.
"""

from __future__ import annotations

import sys


def main() -> int:
    from slam_robot_tpu_torch.models.vehicle import emergency_stop

    sent = []
    emergency_stop(lambda *a: sent.append(a))
    print(f"stop sequence issued ({len(sent)} control transfers)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
