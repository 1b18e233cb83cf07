"""Layer "model": profiler device time of the elementwise and reduction
kernels over the window, per completed draw: every kernel that is not one
of the port's hand-written kernels, a convolution or a library GEMM (and
no copy or fill). Moves ``passes_per_s``."""

UNIT = "ms/draw"
OTHER = ("dgrad_kernel", "dgrad_bf16_wgmma_kernel", "flash_fwd_kernel", "flash_fwd_bf16_kernel",
         "flash_dq_mma_kernel", "flash_dkv_mma_kernel", "flash_dq_bf16_kernel",
         "flash_dkv_bf16_kernel", "cudnn", "convolve", "winograd", "fft", "depthwise", "conv",
         "fprop", "wgrad", "gemm", "cutlass", "xmma", "cublas", "nvjet", "memcpy", "memset")


def read(w):
    if w.trace is None or not w.draws:
        return None
    ops = [op for op in w.trace.ops if not any(k in op[0].lower() for k in OTHER)]
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / 1e6 / w.draws
