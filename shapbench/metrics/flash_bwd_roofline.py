"""Layer "kernels" (``kernels/flash_attention.py``, ``csrc/flash_*.cu``): the
flash backward's share of its roofline over the window, the dq and the
dk/dv kernels together (K3/K4, and K3b/K4f with the rel-pos full bias;
least time from ``costs.flash_cost`` at the cell's shapes). Moves
``passes_per_s``."""

from shapbench.roofline import roofline_pct

UNIT = "%"
KERNELS = ("flash_dq_mma_kernel", "flash_dkv_mma_kernel", "flash_dq_bf16_kernel",
           "flash_dkv_bf16_kernel")
COUNTERS = ("flash_dq", "flash_dkv", "flash_dq_dbias", "flash_dkv_bias", "flash_dq_bf16",
            "flash_dkv_bf16", "flash_dq_dbias_bf16", "flash_dkv_bias_bf16")


def read(w):
    return roofline_pct(w, "flash_bwd", KERNELS, COUNTERS)
