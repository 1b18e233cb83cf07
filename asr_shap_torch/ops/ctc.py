"""Greedy CTC decoding: argmax per frame, collapse repeats, drop the blank,
map "|" to a space, strip; and its inverse for label text."""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

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
