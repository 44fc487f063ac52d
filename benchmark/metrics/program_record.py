"""What the program recorded of its own solves while the traced window ran,
for the ``ba_cg.spill_*`` readers: the device spans of ``ops/ba_cg`` by name
(``device.SPAN_MS.read_device``: calls, inclusive and self device ms) and
the counters of its padded plans' spill (``ops/ba_cg.SPILL``). Both are fed
only while a ``torch.profiler`` capture runs, so only the traced run has
them; a program without them, or with no solve recorded, gives None."""

from slam_robot_tpu_torch import device
from slam_robot_tpu_torch.ops import ba_cg


def spans():
    """Device ms by span name, with ``solves`` (the ``ba_cg_solve`` spans),
    or None."""
    read = getattr(device.SPAN_MS, "read_device", None)
    got = read() if read is not None else {}
    solves = got.get("ba_cg_solve", {}).get("calls", 0)
    return dict(got, solves=solves) if solves else None


def spill():
    """The spill counters by name (``<counter>.<side>``), or None."""
    tally = getattr(ba_cg, "SPILL", None)
    got = tally.read() if tally is not None else {}
    return got or None
