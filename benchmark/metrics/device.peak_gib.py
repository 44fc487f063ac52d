"""``device.peak_gib``: ``torch.cuda.max_memory_allocated`` over the window,
after ``reset_peak_memory_stats`` at its start, in GiB."""


def read(rec: dict):
    peak = rec.get("peak_window_bytes")
    return None if peak is None else peak / 2**30
