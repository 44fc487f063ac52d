"""``device.idle_pct``: the share of the traced window, on the device's clock
between the start and end markers, in which no operation runs on the
device."""


def read(rec: dict):
    t = rec.get("trace")
    if not t or not t["window_ns"]:
        return None
    return 100.0 * (1.0 - t["busy_ns"] / t["window_ns"])
