"""Faults planted in the port's timed path, to see ``correct`` come out
false: the CPU tests plant them at tiny widths, ``calibrate.py`` on the
card at a cell's own sizes. The benchmark's runs never import this module.
Each fault is a context manager that patches one function of the port and
puts it back on exit."""

from __future__ import annotations

import contextlib
import importlib

import numpy as np


@contextlib.contextmanager
def _patched(module: str, attr: str, make):
    """``module.attr`` (``attr`` may be ``Class.method``) replaced by
    ``make(original)`` inside the block."""
    owner = importlib.import_module(module)
    *path, name = attr.split(".")
    for part in path:
        owner = getattr(owner, part)
    orig = getattr(owner, name)
    setattr(owner, name, make(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def half_the_draws():
    """Half of each draw chunk left out, the mean taken over the rest."""
    def make(orig):
        def half(f, x, b, t, output_chunk):
            keep = max(1, b.shape[0] // 2)
            return orig(f, x, b[:keep], t[:keep], output_chunk) * (b.shape[0] / keep)
        return half
    return _patched("asr_shap_torch.explain.expected_gradients", "_chunk_phi", make)


def last_rows_altered():
    """The rows of each draw chunk's last ``output_chunk`` slice scaled by
    1.25: a fault that touches only some cotangent rows."""
    def make(orig):
        def last(f, x, b, t, output_chunk):
            acc = orig(f, x, b, t, output_chunk)
            t_out = acc.shape[0]
            step = output_chunk if 0 < output_chunk < t_out else t_out
            acc[(t_out - 1) // step * step:] *= 1.25
            return acc
        return last
    return _patched("asr_shap_torch.explain.expected_gradients", "_chunk_phi", make)


def token_altered():
    """The transcript's first letter replaced where it is produced."""
    def make(orig):
        def altered(*a, **k):
            text = orig(*a, **k)
            return ("Q" if text[:1] != "Q" else "Z") + text[1:]
        return altered
    return _patched("asr_shap_torch.pipeline.run_shap", "ctc_ids_to_text", make)


def answer_altered():
    """Every clip's phi scaled by 1.25 where it is produced."""
    return _patched("asr_shap_torch.pipeline.run_shap", "chunked_phi",
                    lambda orig: lambda *a: orig(*a) * 1.25)


def stored_answer_altered():
    """The stored phi off by one from what the call returns."""
    def make(orig):
        def save(self, key, audio, noise, shap_values, text):
            return orig(self, key, audio, noise, np.asarray(shap_values) + 1.0, text)
        return save
    return _patched("asr_shap_torch.core.store", "AttributionStore.save", make)


FAULTS = {f.__name__: f for f in (half_the_draws, last_rows_altered, token_altered,
                                  answer_altered, stored_answer_altered)}
