"""Train a CTC model that transcribes, on the text-conditional synthetic
corpus (``pipeline/testset.py::synthesize_text``): the port of
``asr_shap/pipeline/train_synthetic.py``.

A seeded synthetic language whose utterance text determines the waveform,
a batch stream over it, and a driver around ``pipeline/train.py::train()``
that runs until early stopping and then scores held-out greedy-decode WER.

The corpus is numpy throughout: utterance i of a split draws from
``np.random.default_rng(SeedSequence([seed, offset + i]))``, and
``synthesize_text``/``synthetic_text`` equal the reference's under the same
Generator, so ``synthetic_batches`` gives the reference's batches byte for
byte. Train, validation and the evaluation test set (``testset.py``,
1000 + i) draw from disjoint offsets. A random init from a seed uses the
port's numpy init, whose draws differ from the reference's JAX init.
"""

from __future__ import annotations

import logging
import time
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    WAV2VEC2_VOCAB,
    TrainConfig,
    Wav2Vec2Config,
    Wav2Vec2ConformerConfig,
)
from asr_shap_torch.core.device import matmul_precision_scope, params_device, resolve_device
from asr_shap_torch.metrics.wer import batch_wer
from asr_shap_torch.models.heads import model_logits_fn
from asr_shap_torch.models.wav2vec2 import feature_lengths
from asr_shap_torch.ops.ctc import ctc_decode_batch, text_to_ids
from asr_shap_torch.pipeline.testset import CHAR_DURATION, synthesize_text, synthetic_text

logger = logging.getLogger(__name__)

# utterance-key namespaces: corpus splits and the evaluation test set
# (testset.py uses 1000 + i) stay disjoint
TRAIN_OFFSET = 1_000_000
VAL_OFFSET = 2_000_000


def make_utterance(rng: np.random.Generator, clip_samples: int) -> Tuple[np.ndarray, str, int]:
    """One (audio, text, real_length) whose synthesis fits inside
    ``clip_samples`` (no truncation: the labels always match the waveform).
    The reference's numpy path; its JAX-key path has no counterpart here."""
    if not isinstance(rng, np.random.Generator):
        raise TypeError("make_utterance takes a numpy Generator (the reference's "
                        "JAX-key path is not ported)")
    kt, ka = rng.spawn(2)
    max_chars = clip_samples // CHAR_DURATION
    # draw words until the next one would overflow the character budget
    words = synthetic_text(kt, 32).split(" ")
    text, used = [], 0
    for w in words:
        need = len(w) + (1 if text else 0)
        if used + need > max_chars:
            break
        text.append(w)
        used += need
    if not text:  # a clip shorter than any word: one truncated word
        text = [words[0][: max(1, max_chars)]]
    text_s = " ".join(text)
    audio = synthesize_text(ka, text_s)
    n_real = min(len(audio), clip_samples)
    if len(audio) < clip_samples:
        audio = np.pad(audio, (0, clip_samples - len(audio)))
    return audio[:clip_samples], text_s, n_real


def synthetic_batches(
    seed: int,
    num_batches: int,
    batch_size: int,
    clip_samples: int,
    max_label_len: int,
    snrs_db: Tuple[float, ...] = (),
    offset: int = TRAIN_OFFSET,
    noise_prob: float = 0.5,
) -> Iterable[Dict]:
    """Seeded batch stream for ``pipeline.train.train()``, numpy arrays.

    With ``snrs_db`` non-empty, each clip is mixed with white noise at an
    SNR from the list with probability ``noise_prob``, over its real
    (unpadded) span's power. ``_texts`` holds the host-side transcripts."""
    i = 0
    for _ in range(num_batches):
        audios, lengths, labels, label_lens, texts = [], [], [], [], []
        for _ in range(batch_size):
            rng = np.random.default_rng(np.random.SeedSequence([seed, offset + i]))
            audio, text, n_real = make_utterance(rng, clip_samples)
            if snrs_db and rng.random() < noise_prob:
                snr_db = float(snrs_db[rng.integers(0, len(snrs_db))])
                sig_pow = float(np.mean(audio[:n_real] ** 2)) or 1e-12
                noise_pow = sig_pow / (10.0 ** (snr_db / 10.0))
                audio = audio + rng.standard_normal(len(audio)).astype(
                    np.float32) * np.sqrt(noise_pow)
            ids = text_to_ids(text)[:max_label_len]
            audios.append(audio)
            lengths.append(n_real)
            labels.append(ids + [0] * (max_label_len - len(ids)))
            label_lens.append(len(ids))
            texts.append(text)
            i += 1
        yield {
            "audio": np.stack(audios).astype(np.float32),
            "audio_lengths": np.asarray(lengths, np.int32),
            "labels": np.asarray(labels, np.int32),
            "label_lengths": np.asarray(label_lens, np.int32),
            "_texts": texts,  # host-only; stripped before the device step
        }


def _device_batch(batch: Dict) -> Dict:
    return {k: v for k, v in batch.items() if not k.startswith("_")}


def greedy_wer(params, model_cfg: Wav2Vec2Config, batches: Iterable[Dict],
               vocab=WAV2VEC2_VOCAB) -> Tuple[float, List[Tuple[str, str]]]:
    """Corpus-level greedy-decode WER over ``batches`` (per-utterance WER
    weighted by reference word counts), and the (reference, hypothesis)
    pairs. Forward only, under ``torch.no_grad()``, on the params' device."""
    family_logits = model_logits_fn(model_cfg)
    device = params_device(params)
    pairs: List[Tuple[str, str]] = []
    with torch.no_grad(), matmul_precision_scope(model_cfg.matmul_precision):
        for batch in batches:
            lens = torch.as_tensor(batch["audio_lengths"]).to(device)
            x = zero_mean_unit_var(torch.as_tensor(batch["audio"]).to(device), lens)
            logits = family_logits(params, model_cfg, x, lengths=lens)
            f_lens = feature_lengths(model_cfg, lens).cpu().numpy()
            hyps = ctc_decode_batch(logits, lengths=f_lens, vocab=vocab)
            pairs.extend(zip(batch["_texts"], hyps))
    refs = [r for r, _ in pairs]
    hyps = [h for _, h in pairs]
    weights = np.asarray([len(r.split()) for r in refs], np.float64)
    wer = float(np.sum(np.asarray(batch_wer(refs, hyps)) * weights) / np.sum(weights))
    return wer, pairs


def train_synthetic(
    model_cfg: Wav2Vec2Config,
    train_cfg: Optional[TrainConfig] = None,
    params=None,
    clip_seconds: float = 2.0,
    batches_per_epoch: int = 100,
    val_batches_count: int = 8,
    target_wer: float = 0.1,
    seed: int = 0,
    sr: int = 16_000,
    mesh=None,
    checkpointer=None,
    device: str | torch.device = "cuda",
) -> Tuple[Dict, Dict]:
    """Train ``model_cfg`` from a random init (or continue ``params``) on the
    synthetic corpus until early stopping; returns (params, summary).

    ``params`` None: the port's numpy init from ``seed`` on ``device`` (the
    mesh's device with ``mesh``); else training runs on the params' device.
    Runs ``pipeline/train.py::train()`` (CTC loss, AdamW, clip, validation,
    early stopping, optional checkpoints), then the held-out greedy WER.
    With ``mesh`` every rank draws the same batches and ``train`` takes its
    rows of each (``shard_batch``); the replicas stay equal, so every rank
    scores the whole held-out set alike and returns the same params and
    summary (``train_wall_s`` is each rank's own clock)."""
    from asr_shap_torch.pipeline.train import train

    train_cfg = train_cfg or TrainConfig(
        learning_rate=3e-4, num_epochs=40, batch_size=8,
        early_stopping_patience=5, freeze_feature_encoder=False, seed=seed,
        # clean by default, as the CLI's --train-snrs: TrainConfig's own
        # snrs_db is the fine-tuning noise ladder
        snrs_db=(),
    )
    if train_cfg.freeze_feature_encoder:
        raise ValueError(
            "training from scratch requires freeze_feature_encoder=False "
            "(a frozen random conv stack cannot learn the synthesis patterns)")
    if params is None:
        device = mesh.device if mesh is not None else resolve_device(device)
        if isinstance(model_cfg, Wav2Vec2ConformerConfig):
            from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params

            params = init_w2v2_conformer_params(seed, model_cfg, device=device)
        else:
            from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params

            params = init_wav2vec2_params(seed, model_cfg, device=device)

    clip_samples = int(round(clip_seconds * sr))
    max_label_len = max(8, clip_samples // CHAR_DURATION + 2)
    epoch_counter = {"n": 0}

    def train_stream():
        # fresh utterances every epoch
        s = seed + 31 * epoch_counter["n"]
        epoch_counter["n"] += 1
        return (_device_batch(b) for b in synthetic_batches(
            s, batches_per_epoch, train_cfg.batch_size, clip_samples, max_label_len,
            snrs_db=train_cfg.snrs_db, offset=TRAIN_OFFSET))

    def val_stream():
        return (_device_batch(b) for b in synthetic_batches(
            seed, val_batches_count, train_cfg.batch_size, clip_samples, max_label_len,
            snrs_db=(), offset=VAL_OFFSET))

    with matmul_precision_scope(model_cfg.matmul_precision):
        t0 = time.perf_counter()
        params, _, history = train(params, model_cfg, train_cfg, train_stream, val_stream,
                                   mesh=mesh, checkpointer=checkpointer)
        wall = time.perf_counter() - t0
        val_eval = list(synthetic_batches(seed, val_batches_count, train_cfg.batch_size,
                                          clip_samples, max_label_len, snrs_db=(),
                                          offset=VAL_OFFSET))
        wer, pairs = greedy_wer(params, model_cfg, val_eval)
    summary = {
        "epochs_run": len(history),
        "final_train_loss": history[-1]["train_loss"] if history else None,
        "final_val_loss": history[-1]["val_loss"] if history else None,
        "heldout_greedy_wer": round(wer, 4),
        "target_wer": target_wer,
        "reached_target": wer <= target_wer,
        "train_wall_s": round(wall, 1),
        "n_eval_utterances": len(pairs),
        "example_pairs": pairs[:3],
    }
    logger.info("train_synthetic: %s", summary)
    return params, summary
