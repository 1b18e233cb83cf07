"""The comparison that decides ``correct``: what the timed call returned and
stored for a sample of its clips, against the plain reference.

Numbers (each compared with its limit from the cell's file; an exact
comparison has the limit 0):

* ``phi_err``: max |phi - phi_ref| / max |phi_ref| over the compared
  columns of the sampled clips (the explainer, the model, the kernels);
* ``phi_col_max``: the largest over the compared columns of each column's
  relative error ||phi_j - ref_j|| / ||ref_j||. A cell with a ``margin``
  compares only the frames whose top-2 reference logits stay at least
  that far apart (in units of the clip's logit spread) at every draw's
  point: the max head's gradient jumps where a frame's argmax does, and
  rounding below float32 flips the argmax of near ties, so on the other
  frames phi differs by a choice of row, not by rounding;
* ``decode_err``: the decode forward, the larger of ``conf_err`` and the
  transcript's gap: over every frame alignment whose greedy CTC collapse
  gives the returned transcript, the least of the widest gap by which the
  aligned token's reference logit lies below that frame's best, over the
  reference logits' spread (std);
* ``conf_err``: |conf - conf_ref|, the mean max-softmax confidence alone;
* ``store_mismatches``: stored arrays or texts that differ from what the
  call returned or was given (exact).
"""

from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch

PAD_ID, DELIM_ID = 0, 4
VOCAB = ("<pad>", "<s>", "</s>", "<unk>", "|",
         "E", "T", "A", "O", "N", "I", "H", "S", "R", "D", "L", "U",
         "M", "W", "C", "F", "G", "Y", "P", "B", "V", "K", "'", "X",
         "J", "Q", "Z")


def greedy_text(logits: np.ndarray) -> str:
    """Greedy CTC transcript of logits [T, V]: argmax per frame, repeats
    collapsed, blanks dropped, "|" a space, stripped."""
    ids = logits.argmax(axis=-1)
    out, prev = [], -1
    for i in ids:
        if i != prev and i != PAD_ID:
            out.append(VOCAB[i])
        prev = i
    return "".join(out).replace("|", " ").strip()


def confidence(logits: np.ndarray) -> float:
    """Mean over frames of the largest softmax probability."""
    z = logits - logits.max(axis=-1, keepdims=True)
    p = np.exp(z)
    return float((p.max(axis=-1) / p.sum(axis=-1)).mean())


def text_ids(text: str) -> List[int]:
    """The token ids a transcript spells (multi-letter symbols first)."""
    ids, i = [], 0
    while i < len(text):
        for j, sym in enumerate(VOCAB):
            if len(sym) > 1 and text.startswith(sym, i):
                ids.append(j)
                i += len(sym)
                break
        else:
            c = "|" if text[i] == " " else text[i]
            if c not in VOCAB:
                return []
            ids.append(VOCAB.index(c))
            i += 1
    return ids


def transcript_gap(logits: np.ndarray, text: str) -> float:
    """Least over the alignments that collapse to ``text`` of the widest
    per-frame gap max(logits[t]) - logits[t, id_t]; inf where none does.
    The stripped leading and trailing spaces allow any run of blanks and
    "|" before and after the tokens."""
    gap = logits.max(axis=-1, keepdims=True) - logits          # [T, V]
    tokens = text_ids(text) if text else []
    if text and not tokens:
        return float("inf")
    # states: 0 = lead ({blank, |}), then CTC's blank-interleaved tokens
    # 1..2L+1 (odd: blank, even: token), then 2L+2 = tail ({blank, |})
    ext = [PAD_ID]
    for tok in tokens:
        ext += [tok, PAD_ID]
    n_s = len(ext) + 2
    inf = float("inf")
    lead_tail = np.minimum(gap[:, PAD_ID], gap[:, DELIM_ID])
    alpha = np.full(n_s, inf)
    alpha[0] = lead_tail[0]
    if tokens:
        alpha[2] = gap[0, ext[1]]
    else:
        alpha[-1] = lead_tail[0]
    for t in range(1, gap.shape[0]):
        new = np.full(n_s, inf)
        new[0] = max(alpha[0], lead_tail[t])
        for s in range(1, len(ext) + 1):
            e = ext[s - 1]
            best = min(alpha[s], alpha[s - 1])
            if s >= 2 and e != PAD_ID and s - 2 >= 1 and ext[s - 3] != e:
                best = min(best, alpha[s - 2])
            if s == 2:  # the first token straight after the lead
                best = min(best, alpha[0])
            new[s] = max(best, gap[t, e])
        prev = [n_s - 2, n_s - 3] if tokens else [0]
        new[-1] = max(min([alpha[-1]] + [alpha[p] for p in prev]), lead_tail[t])
        alpha = new
    ends = [n_s - 1, n_s - 2, n_s - 3] if tokens else [0, n_s - 1]
    return float(min(alpha[e] for e in ends))


def store_mismatches(store_dir: str, results: Sequence[Dict], clips: Sequence[Dict]) -> int:
    """Stored files that do not read back as what the call returned (phi)
    or was given (audio, noise, text), or are missing."""
    import os

    bad = 0
    for r in results:
        clip = clips[r["index"]]
        key = r["key"]
        want = {"audio": np.asarray(clip["audio"], np.float32),
                "noise": np.asarray(clip["noise"], np.float32),
                "shap_values": r["shap_values"]}
        for kind, arr in want.items():
            path = os.path.join(store_dir, key.filename(kind))
            if not os.path.exists(path):
                bad += 1
                continue
            got = np.load(path)
            bad += int(got.shape != arr.shape or got.dtype != arr.dtype
                       or not np.array_equal(got, arr))
        path = os.path.join(store_dir, key.filename("text"))
        bad += int(not os.path.exists(path) or str(np.load(path)) != clip["text"])
    return bad


def column_errors(phi: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Each column's ||phi_j - ref_j|| / ||ref_j|| of phi [N, F] against
    ref [N, F]."""
    phi, ref = phi.astype(np.float64), ref.astype(np.float64)
    return np.linalg.norm(phi - ref, axis=0) / np.maximum(np.linalg.norm(ref, axis=0), 1e-30)


def phi_numbers(phi: np.ndarray, ref: np.ndarray) -> Dict[str, float]:
    """phi_err and phi_col_max of phi [N, F] against ref [N, F]."""
    return {"phi_err": _max_err(phi.astype(np.float64), ref.astype(np.float64)),
            "phi_col_max": float(column_errors(phi, ref).max())}


def _max_err(phi: np.ndarray, ref: np.ndarray) -> float:
    return float(np.abs(phi - ref).max() / max(np.abs(ref).max(), 1e-30))


def decode_numbers(ref_logits: np.ndarray, text: str, conf: float) -> Dict[str, float]:
    """conf_err = |conf - conf_ref|; text_gap = the transcript's gap over
    the reference logits' spread; decode_err = the larger."""
    spread = max(float(ref_logits.std()), 1e-30)
    conf_err = abs(conf - confidence(ref_logits))
    gap = transcript_gap(ref_logits.astype(np.float64), text) / spread
    return {"conf_err": conf_err, "text_gap": gap, "decode_err": max(conf_err, gap)}


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every limited number present, finite and within its limit."""
    return all(name in numbers and np.isfinite(numbers[name]) and numbers[name] <= lim
               for name, lim in limits.items())


def as_numpy(t: torch.Tensor) -> np.ndarray:
    return t.detach().to("cpu", torch.float32).numpy()
