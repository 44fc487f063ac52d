"""``solve_s``: the window's seconds on the host's clock over the solves it
completed (the window ends at the first solve to finish after its seconds)."""


def read(rec: dict):
    return rec["window_s"] / rec["solves"]
