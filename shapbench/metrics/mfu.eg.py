"""Layer "explainer step" (``explain/expected_gradients.py``): model FLOPs
of the window's completed draws over the untraced window's time (host
clock; a traced run times the same clips untraced first), as a share of the
card's peak for the cell's dtype (``costs.product_peak``: bf16 989
TFLOP/s; float32 165, a third of TF32's 495, as the port runs float32
products in 3xTF32; data sheet at 700 W). A draw's FLOPs are one forward
plus T_out input-gradient backwards of the clip (the family's ``flops``):
no weight gradient, no remat recompute, no decode forward. Moves
``passes_per_s``."""

from shapbench.costs import product_peak

UNIT = "%"


def read(w):
    if not w.results or w.window_s <= 0:
        return None
    fwd, bwd = w.family.flops(w.arch, w.workload["clips"]["samples"])
    flops = w.draws * (fwd + w.workload["t_out"] * bwd)
    return 100.0 * flops / w.window_s / product_peak(w.dtype)
