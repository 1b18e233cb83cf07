"""Layer "model" (``models/wav2vec2.py``, ``models/w2v2_conformer.py``):
profiler device time of the library GEMMs (cuBLAS, CUTLASS) over the
window, per completed draw. cuDNN's implicit-GEMM convolutions are not
counted here. Moves ``passes_per_s``."""

UNIT = "ms/draw"
KEYS = ("gemm", "cutlass", "xmma", "cublas", "nvjet")
NOT = ("conv", "fprop", "dgrad", "wgrad", "cudnn")


def read(w):
    if w.trace is None or not w.draws:
        return None
    ops = [op for op in w.trace.kernels(KEYS) if not any(k in op[0].lower() for k in NOT)]
    if not ops:
        return None
    return sum(e - s for _, s, e in ops) / 1e6 / w.draws
