"""Word Error Rate with jiwer semantics: strip, split on whitespace, then the
word-level Levenshtein distance over the number of reference words. Pure
Python: the reference's native batch scorer gives the same counts."""

from __future__ import annotations

from typing import List, Sequence, Tuple


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


def wer(reference: str, hypothesis: str) -> float:
    """(S + D + I) / number of reference words."""
    ref_w, hyp_w = _words(reference), _words(hypothesis)
    if not ref_w:
        raise ValueError("reference must contain at least one word")
    s, d, i, _ = word_edit_counts(ref_w, hyp_w)
    return (s + d + i) / len(ref_w)


def batch_wer(references: Sequence[str], hypotheses: Sequence[str]) -> List[float]:
    """Per-pair WER; a pair whose reference has no word gives nan (the
    sweep's mark for a row that cannot be scored)."""
    if len(references) != len(hypotheses):
        raise ValueError("references and hypotheses must have equal length")
    out = []
    for ref, hyp in zip(references, hypotheses):
        ref_w = _words(ref)
        if not ref_w:
            out.append(float("nan"))
            continue
        s, d, i, _ = word_edit_counts(ref_w, _words(hyp))
        out.append((s + d + i) / len(ref_w))
    return out
