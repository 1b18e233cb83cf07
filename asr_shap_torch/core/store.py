"""The ``data/`` npy persistence contract.

One (audio, noise, shap_values, text) quadruple per test sample, as four
``.npy`` files named ``{kind}_sample_{i}_{type}_{snr}.npy``. The naming is
the reference package's exactly, so a store written by either package is
read by the other. Writes are atomic (temporary file, then rename), so a
resumed run never sees a partial file.
"""

from __future__ import annotations

import json
import os
import re
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional

import numpy as np

from asr_shap_torch import native

KINDS = ("audio", "noise", "shap_values", "text")
_FNAME_RE = re.compile(
    r"^(audio|noise|shap_values|text)_sample_(\d+)_([a-z]+)_(inf|[-0-9.]+)\.npy$"
)


@dataclass(frozen=True)
class SampleKey:
    index: int
    type: str       # "clean" | "noisy"
    snr: str        # "inf" or the dB value as formatted by the pipeline

    def filename(self, kind: str) -> str:
        return f"{kind}_sample_{self.index}_{self.type}_{self.snr}.npy"


def key_for(index: int, type_: str, snr_db: float) -> SampleKey:
    """float("inf") formats as "inf", integer SNRs as "5", others as str."""
    if np.isinf(snr_db):
        snr = "inf"
    elif float(snr_db) == int(snr_db):
        snr = str(int(snr_db))
    else:
        snr = str(snr_db)
    return SampleKey(index=index, type=type_, snr=snr)


class AttributionStore:
    """Filesystem store for attribution quadruples under ``data_dir``.

    ``async_writes=True`` queues the float32 arrays on a native writer pool
    of ``writer_threads`` threads: ``save`` returns after a copy, the disk
    writes overlap the next sample's device work, and ``flush`` (called by
    ``write_manifest``) waits for them and raises IOError on a failed one.
    The library is built at the store's creation, so a store that cannot
    have it raises before any work."""

    def __init__(self, data_dir: str = "data", async_writes: bool = False,
                 writer_threads: int = 2):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)
        self._pool = native.NpyWriterPool(writer_threads) if async_writes else None

    def _path(self, key: SampleKey, kind: str) -> str:
        return os.path.join(self.data_dir, key.filename(kind))

    def save(self, key: SampleKey, audio: np.ndarray, noise: np.ndarray,
             shap_values: np.ndarray, text: str) -> None:
        self._save_array(self._path(key, "audio"), np.asarray(audio))
        self._save_array(self._path(key, "noise"), np.asarray(noise))
        self._save_array(self._path(key, "shap_values"), np.asarray(shap_values))
        native.save_npy_atomic(self._path(key, "text"), np.asarray(text))

    def flush(self) -> None:
        """Wait for the queued writes; raise IOError if any failed."""
        if self._pool is not None:
            failed = self._pool.flush()
            if failed:
                raise IOError(f"{failed} async npy write(s) failed in {self.data_dir}")

    def _save_array(self, path: str, arr: np.ndarray) -> None:
        if arr.dtype == np.float32 and arr.ndim in (1, 2):
            if self._pool is not None:
                self._pool.submit(path, arr)
            else:
                native.write_npy_f32_native(path, arr)
            return
        native.save_npy_atomic(path, arr)

    def load(self, key: SampleKey) -> Dict[str, object]:
        return {
            "audio": np.load(self._path(key, "audio")),
            "noise": np.load(self._path(key, "noise")),
            "shap_values": np.load(self._path(key, "shap_values")),
            "text": str(np.load(self._path(key, "text"))),
        }

    def array_shape(self, key: SampleKey, kind: str) -> tuple:
        """Shape of a stored array from its npy header alone, so a large
        store can be length-bucketed without loading its phi matrices."""
        with open(self._path(key, kind), "rb") as f:
            version = np.lib.format.read_magic(f)
            if version == (1, 0):
                shape, _, _ = np.lib.format.read_array_header_1_0(f)
            elif version == (2, 0):
                shape, _, _ = np.lib.format.read_array_header_2_0(f)
            else:
                raise ValueError(f"{f.name}: npy format version {version} is not read")
        return tuple(shape)

    def completed(self, key: SampleKey) -> bool:
        """True if all four files exist (what resume skips on)."""
        return all(os.path.exists(self._path(key, k)) for k in KINDS)

    def keys(self) -> List[SampleKey]:
        """Stored samples, found by their audio files."""
        found = []
        for name in sorted(os.listdir(self.data_dir)):
            m = _FNAME_RE.match(name)
            if m and m.group(1) == "audio":
                found.append(SampleKey(index=int(m.group(2)), type=m.group(3),
                                       snr=m.group(4)))
        return found

    def iter_samples(self) -> Iterator[Dict[str, object]]:
        for key in self.keys():
            if self.completed(key):
                d = self.load(key)
                d["key"] = key
                yield d

    def write_manifest(self, extra: Optional[dict] = None) -> None:
        self.flush()  # the manifest describes files that have landed
        manifest = {"samples": [{"index": k.index, "type": k.type, "snr": k.snr}
                                for k in self.keys()]}
        if extra:
            manifest.update(extra)
        with open(os.path.join(self.data_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
