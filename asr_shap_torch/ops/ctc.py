"""Greedy CTC decoding: argmax per frame, collapse repeats, drop the blank,
map "|" to a space, strip; its inverse for label text; and the CTC loss.

The loss is the forward algorithm in log space with the reference's
arithmetic (``asr_shap/ops/ctc.py::ctc_loss``): impossible states hold
-1e30, not -inf, so an impossible alignment gives a huge finite loss and a
finite gradient where ``F.ctc_loss`` gives inf, and the batch mean is not
divided by the label lengths. No Pallas kernel computes it (the reference
scans over frames with ``lax.scan``); here it is a loop over frames in
plain PyTorch, a few small ops per frame.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from asr_shap_torch.core.config import PAD_ID, WAV2VEC2_VOCAB


def ctc_greedy_decode(logits: torch.Tensor, blank_id: int = PAD_ID):
    """logits [B, T, V] -> (ids [B, T], keep [B, T]); keep marks the first
    frame of each non-blank group."""
    ids = logits.argmax(dim=-1)
    prev = torch.cat([torch.full_like(ids[:, :1], -1), ids[:, :-1]], dim=1)
    keep = (ids != prev) & (ids != blank_id)
    return ids, keep


def ctc_ids_to_text(ids, keep, vocab: Sequence[str] = WAV2VEC2_VOCAB,
                    word_delimiter: str = "|") -> str:
    """String assembly for one sequence (HF tokenizer semantics)."""
    ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
    keep = keep.cpu().numpy() if isinstance(keep, torch.Tensor) else np.asarray(keep)
    toks = [vocab[i] for i, k in zip(ids, keep) if k]
    return "".join(toks).replace(word_delimiter, " ").strip()


def text_to_ids(text: str, vocab: Sequence[str] = WAV2VEC2_VOCAB,
                word_delimiter: str = "|", unk_id: int = 3) -> List[int]:
    """Uppercase characters to vocab ids, spaces to the word delimiter;
    characters outside the vocab map to <unk>."""
    lut = {c: i for i, c in enumerate(vocab)}
    return [lut.get(word_delimiter if c == " " else c, unk_id)
            for c in text.upper().strip()]


def ctc_decode_batch(logits: torch.Tensor, lengths: Optional[Sequence[int]] = None,
                     vocab: Sequence[str] = WAV2VEC2_VOCAB) -> List[str]:
    """Greedy-decode a logits batch [B, T, V] to strings; ``lengths`` (frames
    per row) masks the padded frames of shorter rows."""
    ids, keep = ctc_greedy_decode(logits)
    ids, keep = ids.cpu().numpy(), keep.cpu().numpy()
    if lengths is not None:
        keep = keep & (np.arange(ids.shape[1])[None, :] < np.asarray(lengths)[:, None])
    return [ctc_ids_to_text(i, k, vocab) for i, k in zip(ids, keep)]


class _LogAddExp(torch.autograd.Function):
    """``torch.logaddexp`` with the reference's gradient, exp(x - out) for
    each input. Where both inputs hold -1e30 (an impossible alignment), out
    rounds to -1e30 too and each input takes the whole cotangent; torch's
    own gradient would split it in half."""

    @staticmethod
    def forward(ctx, a, b):
        out = torch.logaddexp(a, b)
        ctx.save_for_backward(a, b, out)
        return out

    @staticmethod
    def backward(ctx, g):
        a, b, out = ctx.saved_tensors
        return g * torch.exp(a - out), g * torch.exp(b - out)


def _logaddexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    return m + torch.log(torch.exp(a - m) + torch.exp(b - m) + torch.exp(c - m))


def ctc_log_likelihood(logits: torch.Tensor, logit_lengths: torch.Tensor,
                       labels: torch.Tensor, label_lengths: torch.Tensor,
                       blank_id: int = PAD_ID) -> torch.Tensor:
    """Per-row CTC log-likelihood [B] of ``labels`` [B, L] (padded with
    anything, masked by ``label_lengths``) under ``logits`` [B, T, V] read
    out at frame ``logit_lengths - 1``; impossible alignments give about
    -1e30."""
    b, t, _ = logits.shape
    dev = logits.device
    l = labels.shape[1]
    s = 2 * l + 1
    log_probs = F.log_softmax(logits.to(torch.float32), dim=-1)
    neg_inf = -1e30
    rows = torch.arange(b, device=dev)

    # extended labels: [blank, l1, blank, l2, ..., blank]
    ext = torch.full((b, s), blank_id, dtype=torch.long, device=dev)
    ext[:, 1::2] = labels.to(device=dev, dtype=torch.long)
    # skip from s-2 only onto a label that differs from the one before it
    ext_prev2 = F.pad(ext[:, :-2], (2, 0), value=blank_id)
    can_skip = (ext != blank_id) & (ext != ext_prev2)
    can_skip[:, :2] = False

    emit = log_probs.gather(2, ext[:, None, :].expand(b, t, s))     # [B, T, S]
    first = [emit[:, 0, :1]]
    if l > 0:
        first.append(emit[:, 0, 1:2])
    alpha = torch.cat(first + [emit.new_full((b, s - len(first)), neg_inf)], dim=1)
    pad = emit.new_full((b, 2), neg_inf)
    alphas = [alpha]
    for i in range(1, t):
        shifted = torch.cat([pad, alpha], dim=1)
        move = shifted[:, 1:-1]
        skip = torch.where(can_skip, shifted[:, :-2], neg_inf)
        alpha = _logaddexp3(alpha, move, skip) + emit[:, i]
        alphas.append(alpha)
    final = torch.stack(alphas)[logit_lengths.to(device=dev, dtype=torch.long) - 1, rows]

    send = 2 * label_lengths.to(device=dev, dtype=torch.long)     # final blank
    last_blank = final.gather(1, send[:, None])[:, 0]
    last_label = final.gather(1, torch.clamp(send - 1, min=0)[:, None])[:, 0]
    last_label = torch.where(send > 0, last_label, neg_inf)
    return _LogAddExp.apply(last_blank, last_label)


def ctc_loss(logits: torch.Tensor, logit_lengths: torch.Tensor, labels: torch.Tensor,
             label_lengths: torch.Tensor, blank_id: int = PAD_ID) -> torch.Tensor:
    """Mean negative CTC log-likelihood over the batch (float32 scalar); the
    arguments are ``ctc_log_likelihood``'s."""
    return -ctc_log_likelihood(logits, logit_lengths, labels, label_lengths, blank_id).mean()
