"""``ba_cg.spill_pct``: the share of a solve's device time that the padded
segment sums spend in their spill (the cat, the gather of the spill rows and
the accumulating ``index_put_``): the self device ms of the
``ba_cg_seg_p_spill`` and ``ba_cg_seg_f_spill`` spans over the device ms of
``ba_cg_solve``, over every solve of the traced window."""

from benchmark.metrics import program_record


def read(rec: dict):
    spans = program_record.spans()
    if spans is None:
        return None
    spill = sum(spans.get(f"ba_cg_seg_{side}_spill", {}).get("self_ms", 0.0) for side in "pf")
    return 100.0 * spill / spans["ba_cg_solve"]["ms"]
