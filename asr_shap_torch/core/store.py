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
    """Filesystem store for attribution quadruples under ``data_dir``."""

    def __init__(self, data_dir: str = "data"):
        self.data_dir = data_dir
        os.makedirs(data_dir, exist_ok=True)

    def _path(self, key: SampleKey, kind: str) -> str:
        return os.path.join(self.data_dir, key.filename(kind))

    def save(self, key: SampleKey, audio: np.ndarray, noise: np.ndarray,
             shap_values: np.ndarray, text: str) -> None:
        self._save_array(self._path(key, "audio"), np.asarray(audio))
        self._save_array(self._path(key, "noise"), np.asarray(noise))
        self._save_array(self._path(key, "shap_values"), np.asarray(shap_values))
        self._save_array(self._path(key, "text"), np.asarray(text))

    @staticmethod
    def _save_array(path: str, arr: np.ndarray) -> None:
        tmp = path + ".tmp.npy"
        np.save(tmp, arr)
        os.replace(tmp, path)

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
        manifest = {"samples": [{"index": k.index, "type": k.type, "snr": k.snr}
                                for k in self.keys()]}
        if extra:
            manifest.update(extra)
        with open(os.path.join(self.data_dir, "manifest.json"), "w") as f:
            json.dump(manifest, f, indent=2)
