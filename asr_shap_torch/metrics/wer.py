"""Word Error Rate with jiwer semantics: strip, split on whitespace, then the
word-level Levenshtein distance over the number of reference words. The
counts come from the native host runtime (``asr_shap_torch/native.py``), a
batch of pairs in one call; ``word_edit_counts`` is the pure-Python DP the
tests hold it against."""

from __future__ import annotations

from typing import List, Sequence, Tuple

from asr_shap_torch import native


def _words(s: str) -> List[str]:
    return s.strip().split()


def word_edit_counts(reference: Sequence[str], hypothesis: Sequence[str]
                     ) -> Tuple[int, int, int, int]:
    """(substitutions, deletions, insertions, hits) via Wagner-Fischer DP."""
    n, m = len(reference), len(hypothesis)
    # prev[j] = (cost, subs, dels, ins, hits) for ref[:i] vs hyp[:j]
    prev = [(j, 0, 0, j, 0) for j in range(m + 1)]
    for i in range(1, n + 1):
        cur = [(i, 0, i, 0, 0)] + [None] * m
        ri = reference[i - 1]
        for j in range(1, m + 1):
            if ri == hypothesis[j - 1]:
                c, s, d, a, h = prev[j - 1]
                cur[j] = (c, s, d, a, h + 1)
            else:
                sub, dele, ins = prev[j - 1], prev[j], cur[j - 1]
                best = min(sub[0], dele[0], ins[0])
                if sub[0] == best:
                    cur[j] = (sub[0] + 1, sub[1] + 1, sub[2], sub[3], sub[4])
                elif dele[0] == best:
                    cur[j] = (dele[0] + 1, dele[1], dele[2] + 1, dele[3], dele[4])
                else:
                    cur[j] = (ins[0] + 1, ins[1], ins[2], ins[3] + 1, ins[4])
        prev = cur
    _, s, d, a, h = prev[m]
    return s, d, a, h


def _tokenize_pair(ref_w: Sequence[str], hyp_w: Sequence[str]):
    """The two word lists as ids of one shared vocabulary."""
    ids: dict = {}

    def enc(ws):
        return [ids.setdefault(w, len(ids)) for w in ws]

    return enc(ref_w), enc(hyp_w)


def wer(reference: str, hypothesis: str) -> float:
    """(S + D + I) / number of reference words."""
    ref_w, hyp_w = _words(reference), _words(hypothesis)
    if not ref_w:
        raise ValueError("reference must contain at least one word")
    s, d, i, _ = native.wer_counts_native(*_tokenize_pair(ref_w, hyp_w))
    return (s + d + i) / len(ref_w)


def batch_wer(references: Sequence[str], hypotheses: Sequence[str]) -> List[float]:
    """Per-pair WER, the counts of every pair in one native call; a pair
    whose reference has no word gives nan (the sweep's mark for a row that
    cannot be scored)."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must have equal length")
    pairs = [(_words(r), _words(h)) for r, h in zip(references, hypotheses)]
    scoreable = [i for i, (rw, _) in enumerate(pairs) if rw]
    out = [float("nan")] * len(pairs)
    if not scoreable:
        return out
    toks = [_tokenize_pair(*pairs[i]) for i in scoreable]
    counts = native.batch_wer_native([t[0] for t in toks], [t[1] for t in toks])
    for row, i in enumerate(scoreable):
        s, d, ins, _ = (int(v) for v in counts[row])
        out[i] = (s + d + ins) / len(pairs[i][0])
    return out
