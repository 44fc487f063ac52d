"""``ba_cg.spill_run_max``: the longest run of one segment index that a spill
sum walks, over both sides and every plan of the traced window: the larger
of the sentinel's run (the rows walked that do not spill) and the longest
real run (a segment's rows past its pad). The sorted accumulating
``index_put_`` adds each run in turn."""

from benchmark.metrics import program_record


def read(rec: dict):
    counts = program_record.spill()
    if counts is None:
        return None
    runs = [v for k, v in counts.items() if k.startswith("run.")]
    return max(runs) if runs else None
