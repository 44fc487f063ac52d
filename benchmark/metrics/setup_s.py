"""``setup_s``: seconds on the host's clock from the harness's first line to
the window's start: imports, the inputs drawn on the card, the warm solve."""


def read(rec: dict):
    return rec["setup_s"]
