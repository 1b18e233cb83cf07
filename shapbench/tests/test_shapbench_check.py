"""The transcript's gap against a search over every alignment, the
confidence and the greedy transcript."""

import itertools

import numpy as np
import pytest

from shapbench import check


def _collapse(ids):
    out, prev = [], -1
    for i in ids:
        if i != prev and i != check.PAD_ID:
            out.append(check.VOCAB[i])
        prev = i
    return "".join(out).replace("|", " ").strip()


@pytest.mark.parametrize("seed", range(6))
def test_transcript_gap_equals_a_search_over_alignments(seed):
    rng = np.random.default_rng(seed)
    t, ids = 5, [0, 4, 5, 6]  # blank, "|", "E", "T"
    logits = np.full((t, 32), -50.0)
    logits[:, ids] = rng.normal(size=(t, 4))
    best = {}
    for path in itertools.product(ids, repeat=t):
        text = _collapse(path)
        gap = max(logits[i].max() - logits[i, p] for i, p in enumerate(path))
        best[text] = min(best.get(text, np.inf), gap)
    for text, gap in best.items():
        assert check.transcript_gap(logits, text) == pytest.approx(gap, abs=1e-12), text
    assert check.transcript_gap(logits, "EEEEEEE") == np.inf
    assert check.transcript_gap(logits, check.greedy_text(logits)) == 0.0


def test_confidence_and_text():
    logits = np.zeros((3, 32))
    logits[0, 5] = logits[1, 5] = logits[2, 1] = 10.0
    assert check.greedy_text(logits) == "E<s>"
    assert check.text_ids("E<s> T") == [5, 1, 4, 6]
    p = np.exp(10.0) / (np.exp(10.0) + 31)
    assert check.confidence(logits) == pytest.approx(p)
