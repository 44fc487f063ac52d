"""``ba_cg.spill_point_ms``: the point side's spill in a solve: the self device
ms of the ``ba_cg_seg_p_spill`` span (the cat, the gather of the spill rows
and the accumulating ``index_put_`` of every point-side segment sum) over
the solves the traced window recorded."""

from benchmark.metrics import program_record


def read(rec: dict):
    spans = program_record.spans()
    if spans is None or "ba_cg_seg_p_spill" not in spans:
        return None
    return spans["ba_cg_seg_p_spill"]["self_ms"] / spans["solves"]
