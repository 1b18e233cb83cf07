"""Layer "kernels" (``kernels/conv_dgrad.py``, ``csrc/conv_dgrad*.cu``): the
conv dgrad kernel K1's share of its roofline over the window (least time
from ``costs.k1_cost`` at the cell's shapes, float32 at three TF32
products, bf16 at its peak, over the device time of the kernels below).
Moves ``passes_per_s``."""

from shapbench.roofline import roofline_pct

UNIT = "%"
KERNELS = ("dgrad_kernel", "dgrad_bf16_wgmma_kernel")
COUNTERS = ("conv_dgrad", "conv_dgrad_bf16")


def read(w):
    return roofline_pct(w, "conv_dgrad", KERNELS, COUNTERS)
