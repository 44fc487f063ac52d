"""``ba_cg.kernels_per_gn``: kernels the device ran in the traced window
(copies and sets left out) over the window's solves times their
Gauss-Newton steps: a count that repeats exactly."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or t["audit"]["lost_launches"]:
        return None
    return t["kernels"] / (rec["solves"] * rec["sizes"]["gn_iters"])
