"""Device, precision pins and the host-sync counter.

The JAX package pins ``Precision.HIGHEST`` wherever a matmul touches pixel
coordinates or geometry: reduced-precision matmul inputs quantize a pixel
coordinate near x=640 by ~2 px (``tracker_fused.py:346-348``). The port's
counterpart is to keep every float32 matmul and convolution in full float32:
TF32 off for cuBLAS and for cuDNN (cuDNN defaults to TF32).
"""

from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


class SyncCounter:
    """Counts device-to-host reads made for control flow.

    Each read stalls the host until the device has finished the queued work,
    so the per-frame count is the first number a latency study looks at.
    """

    def __init__(self):
        self.n = 0

    def read(self, t: torch.Tensor):
        """``t.tolist()``, counted as one host sync."""
        self.n += 1
        return t.tolist()


SYNCS = SyncCounter()


def host(t: torch.Tensor):
    """Read a (small) tensor on the host, counting the sync."""
    return SYNCS.read(t)


def span(name: str):
    """A named range for ``torch.profiler`` traces (a function decorator);
    costs ~10 us a call when no profiler runs."""
    return torch.profiler.record_function(name)
