"""``ba_cg.roofline_pct``: the least time a solve needs on the card
(``benchmark/roofline.py``: the larger of its bytes over the card's
bandwidth and its float32 operations over the card's rate, counted from the
problem's sizes and trip counts) over the time a solve took in the traced
window on the device's clock. Nothing for a card the table of peaks lacks."""

from benchmark import roofline


def read(rec: dict):
    t = rec.get("trace")
    if not t or not rec["solves"]:
        return None
    least = roofline.least_seconds(roofline.solve_terms(**rec["sizes"]), rec["device_kind"])
    if least is None:
        return None
    return 100.0 * least / (t["window_ns"] / 1e9 / rec["solves"])
