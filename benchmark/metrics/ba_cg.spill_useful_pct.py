"""``ba_cg.spill_useful_pct``: the share of the rows a spill sum walks that
are real spill rows (rows ranked past their segment's pad), not the
sentinel: each side's real spill rows over its rows walked, a plan's mean,
weighted by the side's spill-sum calls (``ba_cg_seg_<side>_spill``). The
rest of the walk adds zeros to one scratch segment."""

from benchmark.metrics import program_record


def read(rec: dict):
    spans, counts = program_record.spans(), program_record.spill()
    if spans is None or counts is None:
        return None
    real = walked = 0.0
    for side in "pf":
        calls = spans.get(f"ba_cg_seg_{side}_spill", {}).get("calls", 0)
        plans = counts.get(f"plans.{side}", 0)
        if calls and plans:
            real += calls * counts[f"spill_rows.{side}"] / plans
            walked += calls * counts[f"walked.{side}"] / plans
    return 100.0 * real / walked if walked else None
