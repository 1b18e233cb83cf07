"""Build and load the hand-written CUDA kernels.

Each source ``asr_shap_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into its own shared library with a plain C interface, loaded with
``ctypes``. Libraries go to ``asr_shap_torch/_build/`` (listed in
``.gitignore``) under a name that carries a hash of the sources and flags,
so an edited source is rebuilt and an unchanged one is loaded as it is.
``build_all`` starts one ``nvcc`` per missing library, all at once.
Nothing is built or loaded at import time.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Sequence, Tuple

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("conv_dgrad", "conv_dgrad_bf16", "flash_attention", "flash_bwd_bf16",
           "flash_fwd_bf16", "gemm_tf32x3")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# Launches per kernel since the last reset: each wrapper adds one where it
# launches its kernel, and nowhere else.
LAUNCHES: Dict[str, int] = {
    "conv_dgrad": 0, "flash_fwd": 0, "flash_dq": 0, "flash_dkv": 0,
    "flash_fwd_bias": 0, "flash_dq_dbias": 0, "flash_dkv_bias": 0,
    "conv_dgrad_bf16": 0, "flash_fwd_bf16": 0, "flash_dq_bf16": 0, "flash_dkv_bf16": 0,
    "flash_fwd_bias_bf16": 0, "flash_dq_dbias_bf16": 0, "flash_dkv_bias_bf16": 0,
    "gemm_tf32x3": 0,
}

_loaded: Dict[str, ctypes.CDLL] = {}
_entries: Dict[Tuple[str, str], ctypes._CFuncPtr] = {}
# The current stream's handle as an int, without building a torch.cuda.Stream
# (CUDA builds of torch have it; the CPU build never launches).
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def accumulation_dtype(dtype: torch.dtype) -> torch.dtype:
    """The dtype the kernels and their plain versions sum in: float32 for
    bf16 and float32 inputs, as the reference kernels' float32
    accumulators; float64 stays float64 (the card's accuracy checks)."""
    return torch.promote_types(dtype, torch.float32)


def kernel_input(t):
    """``t`` contiguous and 16-byte aligned (float4 loads), copied only if
    it is not already."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([os.path.join(home, "bin", "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc",
    ]:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Path]:
    """Compile every library in ``names`` that is not built yet, one nvcc
    process per source, all started together. Returns name -> library."""
    BUILD_DIR.mkdir(exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    todo = [n for n, p in paths.items() if not p.exists()]
    if not todo:
        return paths
    nvcc = _nvcc()
    procs = {}
    try:
        for name in todo:
            tmp = paths[name].with_suffix(f".{os.getpid()}.tmp")
            cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
            with open(paths[name].with_suffix(".log"), "w") as log:
                procs[name] = (subprocess.Popen(cmd, stdout=log,
                                                stderr=subprocess.STDOUT), tmp)
    finally:
        rcs = {name: proc.wait() for name, (proc, _) in procs.items()}
    failed = []
    for name, (_, tmp) in procs.items():
        if rcs[name] == 0:
            os.replace(tmp, paths[name])
        else:
            failed.append(f"{name} (rc {rcs[name]}): "
                          + paths[name].with_suffix(".log").read_text()[-4000:])
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas register and shared-memory report) for ``name``."""
    log = _lib_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def c_function(lib_name: str, fn_name: str,
               argtypes: Sequence[type]) -> ctypes._CFuncPtr:
    """``fn_name`` of library ``lib_name`` (built and loaded first if
    needed), declared to take ``argtypes`` and return the int CUDA error.
    Resolved once: later calls return the cached entry point."""
    fn = _entries.get((lib_name, fn_name))
    if fn is not None:
        return fn
    lib = _loaded.get(lib_name)
    if lib is None:
        lib = ctypes.CDLL(str(build_all([lib_name])[lib_name]))
        _loaded[lib_name] = lib
    fn = getattr(lib, fn_name)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    _entries[(lib_name, fn_name)] = fn
    return fn


def stream_of(t: torch.Tensor) -> int:
    """Handle of PyTorch's current stream on the CUDA device of ``t``."""
    if _raw_stream is not None:
        return _raw_stream(t.get_device())
    return torch.cuda.current_stream(t.device).cuda_stream
