"""The host runtime: ctypes bindings to ``native/asr_shap_native.cpp``.

Two services: the word-level Levenshtein counts of many transcript pairs in
one call (the sweep's WER), and float32 ``.npy`` writes, synchronous or
queued on a C++ worker pool whose threads write while the caller goes on
(``--async-writes``). The files are the reference store's bytes: the
length and data of ``np.save``'s, and a header that spells a 2-D shape
"(r, c, )" where ``np.save`` spells "(r, c)" (one dim: ``np.save``'s bytes).
Each lands through a temporary file and a rename, so a resumed run never
reads a partial one.

The library is built at first use by ``g++`` with the flags of
``native/Makefile`` into ``asr_shap_torch/_build/`` (listed in
``.gitignore``), under a name that carries a hash of the source and the
flags, so an edited source is rebuilt and an unchanged one is loaded as it
is. Nothing is built or loaded at import time. A build or load that fails
raises with the compiler's output: there is no Python fallback here. The
pure-Python versions the tests hold these against are
``metrics/wer.py::word_edit_counts`` and ``np.save``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np

_ROOT = Path(__file__).resolve().parent.parent
SOURCE = _ROOT / "native" / "asr_shap_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-Wextra", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


def build() -> Path:
    """Compile ``SOURCE`` with ``$CXX`` or g++ unless its library is built
    already; the library's path, which carries a hash of the source and the
    flags. Raises RuntimeError with the compiler's output when the build
    fails."""
    source = SOURCE
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(source.read_bytes())
    out = BUILD_DIR / f"libasr_shap_native-{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the native host runtime needs g++ (or $CXX) to build "
                           f"{source}")
    BUILD_DIR.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(source)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {source} failed (rc {proc.returncode}):\n"
                           f"{proc.stderr[-4000:]}")
    os.replace(tmp, out)
    return out


def _register(lib: ctypes.CDLL) -> ctypes.CDLL:
    i32p, f32p = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_float)
    lib.wer_counts.argtypes = [i32p, ctypes.c_int32, i32p, ctypes.c_int32, i32p]
    lib.wer_counts.restype = None
    lib.batch_wer_counts.argtypes = [i32p, i32p, i32p, i32p, ctypes.c_int32, i32p]
    lib.batch_wer_counts.restype = None
    lib.write_npy_f32.argtypes = [ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int64]
    lib.write_npy_f32.restype = ctypes.c_int32
    lib.npy_writer_create.argtypes = [ctypes.c_int32, ctypes.c_int64]
    lib.npy_writer_create.restype = ctypes.c_void_p
    lib.npy_writer_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f32p,
                                      ctypes.c_int64, ctypes.c_int64]
    lib.npy_writer_submit.restype = None
    lib.npy_writer_flush.argtypes = [ctypes.c_void_p]
    lib.npy_writer_flush.restype = ctypes.c_int64
    lib.npy_writer_destroy.argtypes = [ctypes.c_void_p]
    lib.npy_writer_destroy.restype = None
    return lib


def load() -> ctypes.CDLL:
    """The library, built and loaded at the first call; raises when it
    cannot be built or loaded."""
    global _lib
    with _lock:
        if _lib is None:
            _lib = _register(ctypes.CDLL(str(build())))
        return _lib


def _i32ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))


def _ids(seq: Sequence[int]) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(seq, dtype=np.int64).astype(np.int32))


def wer_counts_native(ref_ids: Sequence[int],
                      hyp_ids: Sequence[int]) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) of two id sequences."""
    lib = load()
    ref, hyp = _ids(ref_ids), _ids(hyp_ids)
    out = np.zeros(4, np.int32)
    lib.wer_counts(_i32ptr(ref), len(ref), _i32ptr(hyp), len(hyp), _i32ptr(out))
    return tuple(int(v) for v in out)


def batch_wer_native(refs: List[Sequence[int]], hyps: List[Sequence[int]]) -> np.ndarray:
    """[n, 4] (S, D, I, H) counts of each pair, in one call."""
    if len(refs) != len(hyps):
        raise ValueError("refs and hyps must have equal length")
    lib = load()
    ref_lens = np.asarray([len(r) for r in refs], np.int32)
    hyp_lens = np.asarray([len(h) for h in hyps], np.int32)
    refs_c = _ids(np.concatenate([np.asarray(r, np.int64) for r in refs])
                  if ref_lens.sum() else [])
    hyps_c = _ids(np.concatenate([np.asarray(h, np.int64) for h in hyps])
                  if hyp_lens.sum() else [])
    out = np.zeros((len(refs), 4), np.int32)
    lib.batch_wer_counts(_i32ptr(refs_c), _i32ptr(ref_lens), _i32ptr(hyps_c),
                         _i32ptr(hyp_lens), len(refs), _i32ptr(out))
    return out


def _native_layout(array: np.ndarray):
    """(contiguous float32 array, rows, cols) as the C writer takes them
    (cols -1 for one dim), or None for an array it does not write."""
    if array.dtype != np.float32 or array.ndim not in (1, 2):
        return None
    a = np.ascontiguousarray(array)
    return a, a.shape[0], (a.shape[1] if a.ndim == 2 else -1)


def save_npy_atomic(path: str, array: np.ndarray) -> None:
    """``np.save`` through a temporary file and a rename."""
    tmp = path + ".tmp.npy"
    try:
        np.save(tmp, array)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


def write_npy_f32_native(path: str, array: np.ndarray) -> None:
    """Write a float32 array of one or two dims as ``.npy``, synchronously;
    raises ValueError for another array and OSError when the write fails."""
    layout = _native_layout(np.asarray(array))
    if layout is None:
        raise ValueError(f"the native writer takes float32 arrays of 1 or 2 dims, "
                         f"got {np.asarray(array).dtype} of {np.ndim(array)} dims")
    a, rows, cols = layout
    rc = load().write_npy_f32(os.fsencode(path),
                              a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), rows, cols)
    if rc != 0:
        raise OSError(f"native npy write of {path} failed (code {rc})")


class NpyWriterPool:
    """Asynchronous ``.npy`` writes on a C++ worker pool. ``submit`` copies
    the array into memory the pool owns and returns; a worker thread writes
    it without the interpreter lock. At most ``max_pending`` writes are
    outstanding (``submit`` blocks beyond), which bounds the copies held.
    ``flush`` waits for every write and returns the count of failed ones
    since the last flush. Arrays the native writer does not take (three or
    more dims, another dtype) are written at once by ``np.save`` through a
    temporary file and a rename."""

    def __init__(self, n_threads: int = 2, max_pending: int = 4):
        self._lib = load()
        self._pool = self._lib.npy_writer_create(n_threads, max_pending)
        if not self._pool:
            raise RuntimeError("npy_writer_create returned no pool")

    @property
    def native(self) -> bool:
        """True while the pool is open: writes go through the C++ workers."""
        return self._pool is not None

    def submit(self, path: str, array: np.ndarray) -> None:
        if self._pool is None:
            raise RuntimeError("submit on a closed NpyWriterPool")
        layout = _native_layout(np.asarray(array))
        if layout is None:
            save_npy_atomic(path, np.asarray(array))
            return
        a, rows, cols = layout
        self._lib.npy_writer_submit(self._pool, os.fsencode(path),
                                    a.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                                    rows, cols)

    def flush(self) -> int:
        if self._pool is None:
            return 0
        return int(self._lib.npy_writer_flush(self._pool))

    def close(self) -> int:
        """Flush, then stop the workers; the count of failed writes."""
        if self._pool is None:
            return 0
        failed = self.flush()
        self._lib.npy_writer_destroy(self._pool)
        self._pool = None
        return failed

    def __enter__(self) -> "NpyWriterPool":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        if getattr(self, "_pool", None) is not None:
            self.close()
