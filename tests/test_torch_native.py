"""The port's host runtime (asr_shap_torch/native.py) against the reference's
(asr_shap/native.py) and against the pure-Python versions: the WER counts,
the .npy bytes of the writer, the pool and the store, and the failures that
must raise rather than fall back."""

import os

import numpy as np
import pytest

from asr_shap import native as jax_native
from asr_shap.core.store import AttributionStore as JaxStore
from asr_shap.core.store import key_for as jax_key_for
from asr_shap.metrics.wer import batch_wer as jax_batch_wer
from asr_shap_torch import native
from asr_shap_torch.core.store import AttributionStore, key_for
from asr_shap_torch.metrics.wer import batch_wer, wer, word_edit_counts


def _pairs(rng, n):
    def seq(lo):
        return [int(v) for v in rng.integers(0, 12, rng.integers(lo, 25))]

    return [seq(1) for _ in range(n)], [seq(0) for _ in range(n)]


def test_wer_counts_match_reference_and_plain_dp(rng):
    assert jax_native.available()
    refs, hyps = _pairs(rng, 60)
    for r, h in zip(refs, hyps):
        want = word_edit_counts([str(v) for v in r], [str(v) for v in h])
        assert native.wer_counts_native(r, h) == jax_native.wer_counts_native(r, h) == want


def test_batch_counts_match_reference_and_plain_dp(rng):
    refs, hyps = _pairs(rng, 200)
    refs.append([3, 1])
    hyps.append([])  # no hypothesis word: two deletions
    got = native.batch_wer_native(refs, hyps)
    np.testing.assert_array_equal(got, jax_native.batch_wer_native(refs, hyps))
    want = [word_edit_counts([str(v) for v in r], [str(v) for v in h])
            for r, h in zip(refs, hyps)]
    np.testing.assert_array_equal(got, np.asarray(want, np.int32))


def test_batch_wer_matches_reference():
    references = ["the cat sat", "a b c d", "", "  one  two ", "x"]
    hypotheses = ["the dog sat", "a b d", "anything", "one two three", ""]
    got, want = batch_wer(references, hypotheses), jax_batch_wer(references, hypotheses)
    assert np.isnan(got[2]) and np.isnan(want[2])
    assert [v for v in got if v == v] == [v for v in want if v == v]
    assert wer("the cat sat", "the dog sat") == pytest.approx(1 / 3)


def _files(d):
    return {n: (d / n).read_bytes() for n in sorted(os.listdir(d))
            if n.endswith(".npy")}


def test_store_bytes_equal_reference_store(tmp_path, rng):
    """The port's store, synchronous and async, writes the reference store's
    bytes: the same C writer for float32 arrays of one or two dims, np.save
    for the rest."""
    audio = rng.standard_normal(1600).astype(np.float32)
    noise = np.zeros_like(audio)
    phi = rng.standard_normal((1600, 9)).astype(np.float32)
    stores = {"jax": JaxStore(str(tmp_path / "jax")),
              "sync": AttributionStore(str(tmp_path / "sync")),
              "async": AttributionStore(str(tmp_path / "async"), async_writes=True)}
    for name, store in stores.items():
        key = (jax_key_for if name == "jax" else key_for)(3, "noisy", 5.0)
        store.save(key, audio, noise, phi, "HELLO WORLD")
        store.write_manifest()
    want = _files(tmp_path / "jax")
    assert len(want) == 4
    assert _files(tmp_path / "sync") == want
    assert _files(tmp_path / "async") == want
    got = stores["async"].load(key_for(3, "noisy", 5.0))
    np.testing.assert_array_equal(got["shap_values"], phi)
    assert got["text"] == "HELLO WORLD"
    assert not [p for p in (tmp_path / "async").iterdir() if ".tmp" in p.name]


@pytest.mark.parametrize("shape", [(77,), (48, 7), (2, 3, 4)])
def test_writer_and_pool_bytes_against_np_save(tmp_path, rng, shape):
    """The writer and the pool write the same bytes. One dim: np.save's,
    header included. Two dims: np.save's length and data, a header whose
    shape the C writer spells "(r, c, )" where np.save spells "(r, c)"
    (native/asr_shap_native.cpp:89-91). Three dims: the pool's np.save."""
    a = rng.standard_normal(shape).astype(np.float32)
    np.save(tmp_path / "plain.npy", a)
    plain = (tmp_path / "plain.npy").read_bytes()
    with native.NpyWriterPool(2, max_pending=2) as pool:
        pool.submit(str(tmp_path / "pool.npy"), a)
        assert pool.flush() == 0
    pooled = (tmp_path / "pool.npy").read_bytes()
    np.testing.assert_array_equal(np.load(tmp_path / "pool.npy"), a)
    if len(shape) == 3:
        assert pooled == plain
        with pytest.raises(ValueError):
            native.write_npy_f32_native(str(tmp_path / "w.npy"), a)
        return
    native.write_npy_f32_native(str(tmp_path / "w.npy"), a)
    assert (tmp_path / "w.npy").read_bytes() == pooled
    if len(shape) == 1:
        assert pooled == plain
    else:
        assert len(pooled) == len(plain) and pooled[128:] == plain[128:]
        assert pooled[:128].replace(b"7, ), }", b"7), }  ") == plain[:128]


def test_flush_raises_on_failed_write(tmp_path, rng):
    store = AttributionStore(str(tmp_path / "d"), async_writes=True)
    phi = rng.standard_normal((10, 3)).astype(np.float32)
    store._pool.submit(str(tmp_path / "missing_dir" / "x.npy"), phi)
    with pytest.raises(IOError, match="1 async npy write"):
        store.flush()
    store.flush()  # the count was taken: a later flush is clean
    with pytest.raises(OSError):
        native.write_npy_f32_native(str(tmp_path / "missing_dir" / "y.npy"), phi)


def test_failed_build_raises_without_fallback(tmp_path, monkeypatch):
    """No library, no service: a source that does not compile, or no
    compiler, raises with the reason, and neither the WER nor the async
    store falls back to Python."""
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "_build")
    with pytest.raises(RuntimeError, match="broken.cpp failed"):
        batch_wer(["a b"], ["a c"])
    with pytest.raises(RuntimeError):
        AttributionStore(str(tmp_path / "s"), async_writes=True)
    monkeypatch.delenv("CXX", raising=False)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="needs g\\+\\+"):
        wer("a b", "a c")
    assert not list((tmp_path / "_build").glob("*.so"))
