"""End-to-end attribution pipeline, one device.

Per sample: normalize -> one forward for the confidence and the greedy
transcript -> the attribution matrix of ``ExplainerConfig.method``
(expected gradients "grad", DeepSHAP "deep", KernelSHAP "kernel" or LIME
"lime") -> persist the
(audio, noise, shap_values, text) quadruple under the store's naming
contract. The model config's type selects the forward (Wav2Vec2 or
Wav2Vec2-Conformer, ``models.heads.model_logits_fn``); both share the
vocabulary. Samples already complete in the store are skipped (resume).
Samples run in exact-length buckets, shortest first, one at a time. The
background, the draws and the k-means initial rows of sample i come from
the streams (seed, i, 0), (seed, i, 1) and (seed, i, 2) (``core.prng``,
the reference's key paths), so a sample's result does not depend on
bucketing or on which other samples the run holds.

``ExplainerConfig.kmeans_background`` > 0 reduces the background to that
many centroids before explaining, for every method. DeepSHAP explains
against each background row, with the dual forward of the model's family.
KernelSHAP and LIME take the mean background row as their baseline and draw
their coalitions from the draws' stream (seed, i, 1). ``host_draw_chunk`` > 0
(expected gradients only, as in the reference) splits the draws
into ceil(nsamples / host_draw_chunk) chunks of ``nsamples=host_draw_chunk``
each (rounded up to ``draw_chunk``), chunk c drawing from (seed, i, 1, c);
phi is the mean of the chunk means, as in the reference.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    ExplainerConfig,
    PipelineConfig,
    WAV2VEC2_VOCAB,
    Wav2Vec2ConformerConfig,
)
from asr_shap_torch.core.device import matmul_precision_scope, resolve_device
from asr_shap_torch.core.prng import generator
from asr_shap_torch.core.store import AttributionStore, key_for
from asr_shap_torch.explain.baselines import kmeans_background, zeros_noise_background
from asr_shap_torch.explain.deepshap import (
    deep_shap_values,
    w2v2_conformer_dual_fn,
    wav2vec2_dual_fn,
)
from asr_shap_torch.explain.expected_gradients import (
    Draws,
    expected_phi,
    num_draws,
    sample_draws,
)
from asr_shap_torch.explain.kernel_shap import kernel_shap_attributions
from asr_shap_torch.explain.lime import lime_attributions
from asr_shap_torch.metrics.confidence import mean_max_softmax_confidence
from asr_shap_torch.models.heads import make_batched_fn, make_explained_fn, model_logits_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute
from asr_shap_torch.ops.ctc import ctc_greedy_decode, ctc_ids_to_text
from asr_shap_torch.utils.debug import check_finite

logger = logging.getLogger(__name__)

_BACKGROUND, _DRAWS, _KMEANS = 0, 1, 2  # generator streams of one sample


def draw_chunks(ec: ExplainerConfig) -> List[ExplainerConfig]:
    """The explainer config of each host chunk: ``ec`` alone when
    ``host_draw_chunk`` is 0, else ceil(nsamples / host_draw_chunk) chunks
    of ``nsamples=host_draw_chunk``."""
    hdc = ec.host_draw_chunk
    if hdc <= 0:
        return [ec]
    chunk = dataclasses.replace(ec, nsamples=hdc, host_draw_chunk=0)
    return [chunk] * -(-ec.nsamples // hdc)


def chunked_phi(f, x: torch.Tensor, background: torch.Tensor,
                chunks: List[ExplainerConfig], chunk_draws: List[Draws]) -> torch.Tensor:
    """phi [N, T_out]: the mean over the chunks of each chunk's
    expected-gradients mean, accumulated in float32."""
    acc = None
    for ec, draws in zip(chunks, chunk_draws):
        phi = expected_phi(f, x, background, config=ec, draws=draws)
        acc = phi if acc is None else acc + phi
    return acc / len(chunks)


def explain_phi(params, cfg: PipelineConfig, x: torch.Tensor, background: torch.Tensor,
                generator: Optional[torch.Generator] = None,
                masks: Optional[torch.Tensor] = None) -> torch.Tensor:
    """phi [N, T_out] of the "deep", "kernel" or "lime" method at x against
    ``background`` (after k-means). The coalitions of KernelSHAP and LIME
    come from ``generator``, or are ``masks`` when given (the tests feed the
    reference's)."""
    mc, ec = cfg.model, cfg.explainer
    if ec.method == "deep":
        dual_builder = (w2v2_conformer_dual_fn if isinstance(mc, Wav2Vec2ConformerConfig)
                        else wav2vec2_dual_fn)
        return deep_shap_values(dual_builder(params, mc, ec), x, background,
                                ec.output_chunk).values
    f_batch = make_batched_fn(params, mc, ec)
    if ec.method == "kernel":
        return kernel_shap_attributions(
            f_batch, x, generator, num_segments=ec.kernel_num_segments,
            num_samples=ec.nsamples, baseline=background.mean(dim=0), masks=masks).values
    if ec.method == "lime":
        return lime_attributions(
            f_batch, x, generator, num_segments=ec.lime_num_segments,
            num_samples=ec.lime_num_samples, keep_prob=ec.lime_keep_prob,
            ridge_alpha=ec.lime_ridge_alpha, baseline=background.mean(dim=0),
            masks=masks).values
    raise ValueError(f"unknown explainer method {ec.method!r}")


def _explain_sample(params, cfg: PipelineConfig, x: torch.Tensor, index: int):
    """(phi [N, T_out], confidence, ids [T], keep [T]) for one sample."""
    mc, ec = cfg.model, cfg.explainer
    with torch.no_grad():
        logits = model_logits_fn(mc)(params, mc, x[None, :])
        conf = mean_max_softmax_confidence(logits)[0]
        ids, keep = ctc_greedy_decode(logits)
    bg = zeros_noise_background(generator(cfg.seed, index, _BACKGROUND),
                                x.shape[0], ec.num_background,
                                ec.background_sigma, device=x.device)
    if ec.kmeans_background > 0:
        init = torch.randperm(bg.shape[0], generator=generator(cfg.seed, index, _KMEANS))
        bg = kmeans_background(bg, ec.kmeans_background, init[:ec.kmeans_background])
    if ec.method != "grad":
        phi = explain_phi(params, cfg, x, bg, generator(cfg.seed, index, _DRAWS))
        return phi, conf, ids[0], keep[0]
    chunks = draw_chunks(ec)
    if ec.host_draw_chunk <= 0:
        streams = [generator(cfg.seed, index, _DRAWS)]
    else:
        streams = [generator(cfg.seed, index, _DRAWS, c) for c in range(len(chunks))]
    draws = [sample_draws(g, num_draws(c), bg.shape[0]) for g, c in zip(streams, chunks)]
    phi = chunked_phi(make_explained_fn(params, mc, ec), x, bg, chunks, draws)
    return phi, conf, ids[0], keep[0]


def _run_sample(params, cfg: PipelineConfig, store: AttributionStore, sample: Dict,
                i: int, device: torch.device) -> Dict:
    """Explain, check, score and store sample ``i``; its result dict."""
    skey = key_for(i, sample["type"], sample["snr"])
    audio = torch.as_tensor(np.asarray(sample["audio"], np.float32), device=device)
    t0 = time.perf_counter()
    phi, conf, ids, keep = _explain_sample(params, cfg, zero_mean_unit_var(audio), i)
    phi = phi.cpu().numpy()
    conf = float(conf)
    wall = time.perf_counter() - t0
    check_finite(phi, f"shap_values[sample {i}]")
    transcription = ctc_ids_to_text(ids, keep, WAV2VEC2_VOCAB)
    store.save(skey, sample["audio"], sample["noise"], phi, sample["text"])
    logger.info("sample %d (%s, snr=%s): %.2fs, conf=%.3f, '%s'",
                i, sample["type"], sample["snr"], wall, conf, transcription[:50])
    return {
        "index": i, "key": skey, "shap_values": phi,
        "transcription": transcription, "confidence": conf,
        "wall_s": wall, "snr": sample["snr"], "type": sample["type"],
    }


def run_shap_pipeline(params, cfg: PipelineConfig, test_set: List[Dict],
                      store: Optional[AttributionStore] = None,
                      resume: bool = True,
                      device: str | torch.device = "cuda") -> List[Dict]:
    """Compute and persist attributions for every sample in ``test_set``
    (dicts with "audio", "noise", "text", "type", "snr"). ``params`` must
    already be on ``device``. Returns per-sample result dicts in test-set
    order. The run holds the config's matmul precision scope; a bf16 config's
    params are cast once, before the first draw."""
    device = resolve_device(device)
    store = store or AttributionStore(cfg.data_dir)

    pending: List[int] = []
    for i, sample in enumerate(test_set):
        skey = key_for(i, sample["type"], sample["snr"])
        if resume and store.completed(skey):
            logger.info("sample %d (%s) already computed — skipping", i, skey)
            continue
        pending.append(i)

    buckets: Dict[int, List[int]] = {}
    for i in pending:
        buckets.setdefault(len(test_set[i]["audio"]), []).append(i)

    results = []
    params = cast_params_for_compute(params, cfg.model.dtype)
    with matmul_precision_scope(cfg.model.matmul_precision):
        for length in sorted(buckets):
            for i in buckets[length]:
                results.append(_run_sample(params, cfg, store, test_set[i], i, device))
    store.write_manifest()
    results.sort(key=lambda r: r["index"])
    return results
