"""End-to-end attribution pipeline, on one device or over a process mesh.

Per sample: normalize -> one forward for the confidence and the greedy
transcript -> the attribution matrix of ``ExplainerConfig.method``
(expected gradients "grad", DeepSHAP "deep", KernelSHAP "kernel" or LIME
"lime") -> persist the
(audio, noise, shap_values, text) quadruple under the store's naming
contract. The model config's type selects the forward (Wav2Vec2 or
Wav2Vec2-Conformer, ``models.heads.model_logits_fn``); both share the
vocabulary. Samples already complete in the store are skipped (resume).
The background, the draws and the k-means initial rows of sample i come
from the streams (seed, i, 0), (seed, i, 1) and (seed, i, 2)
(``core.prng``, the reference's key paths), so a sample's result does not
depend on bucketing, grouping or the mesh.

Samples run in exact-length buckets, shortest first, in groups of
``PipelineConfig.sample_batch`` (0: ``_auto_group_size``), one group call
each (``_build_group_step``). Without a mesh a group's samples run one
after another inside its call, the reference's ``lax.scan``: the results
equal ``sample_batch=1``. Under a mesh (``parallel/mesh.py``) a group of
one shards the draws over the data axis (``expected_phi_sharded``) and a
group of at least the axis size shards its samples, each rank explaining
its block, the last group padded with copies of its first sample whose
results are dropped; a model axis of more than one rank splits the params
(``parallel/tp.py``). Mesh rank 0 decides what is pending and alone writes
the store. A group call that fails degrades the run to one sample per
call; a lost device (``_is_device_unavailable``) is waited out
(``crash_backoff_s`` times the attempt) and the params re-staged from a
host copy, up to ``crash_retries`` times.

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
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import (
    ExplainerConfig,
    PipelineConfig,
    WAV2VEC2_VOCAB,
    Wav2Vec2ConformerConfig,
)
from asr_shap_torch.core.device import matmul_precision_scope, resolve_device
from asr_shap_torch.core.params_io import map_leaves
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
    expected_phi_sharded,
    num_draws,
    sample_draws,
)
from asr_shap_torch.explain.kernel_shap import kernel_shap_attributions
from asr_shap_torch.explain.lime import lime_attributions
from asr_shap_torch.metrics.confidence import mean_max_softmax_confidence
from asr_shap_torch.models.heads import make_batched_fn, make_explained_fn, model_logits_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute
from asr_shap_torch.ops.ctc import ctc_greedy_decode, ctc_ids_to_text
from asr_shap_torch.parallel.mesh import Mesh
from asr_shap_torch.parallel.tp import shard_params_tp
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
                masks: Optional[torch.Tensor] = None, tp: Optional[Mesh] = None) -> torch.Tensor:
    """phi [N, T_out] of the "deep", "kernel" or "lime" method at x against
    ``background`` (after k-means). The coalitions of KernelSHAP and LIME
    come from ``generator``, or are ``masks`` when given (the tests feed the
    reference's). ``tp``: the tensor-parallel mesh of sharded ``params``."""
    mc, ec = cfg.model, cfg.explainer
    if ec.method == "deep":
        dual_builder = (w2v2_conformer_dual_fn if isinstance(mc, Wav2Vec2ConformerConfig)
                        else wav2vec2_dual_fn)
        return deep_shap_values(dual_builder(params, mc, ec, tp=tp), x, background,
                                ec.output_chunk).values
    f_batch = make_batched_fn(params, mc, ec, tp=tp)
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


def _explain_sample(params, cfg: PipelineConfig, x: torch.Tensor, index: int,
                    draw_mesh: Optional[Mesh] = None, tp: Optional[Mesh] = None):
    """(phi [N, T_out], confidence, ids [T], keep [T]) for one sample; with
    ``draw_mesh`` the expected-gradients draws shard over its data axis."""
    mc, ec = cfg.model, cfg.explainer
    with torch.no_grad():
        logits = model_logits_fn(mc)(params, mc, x[None, :], tp=tp)
        conf = mean_max_softmax_confidence(logits)[0]
        ids, keep = ctc_greedy_decode(logits)
    bg = zeros_noise_background(generator(cfg.seed, index, _BACKGROUND),
                                x.shape[0], ec.num_background,
                                ec.background_sigma, device=x.device)
    if ec.kmeans_background > 0:
        init = torch.randperm(bg.shape[0], generator=generator(cfg.seed, index, _KMEANS))
        bg = kmeans_background(bg, ec.kmeans_background, init[:ec.kmeans_background])
    if ec.method != "grad":
        phi = explain_phi(params, cfg, x, bg, generator(cfg.seed, index, _DRAWS), tp=tp)
        return phi, conf, ids[0], keep[0]
    f = make_explained_fn(params, mc, ec, tp=tp)
    if draw_mesh is not None:
        phi = expected_phi_sharded(f, x, bg, draw_mesh, generator(cfg.seed, index, _DRAWS),
                                   config=ec)
        return phi, conf, ids[0], keep[0]
    chunks = draw_chunks(ec)
    if ec.host_draw_chunk <= 0:
        streams = [generator(cfg.seed, index, _DRAWS)]
    else:
        streams = [generator(cfg.seed, index, _DRAWS, c) for c in range(len(chunks))]
    draws = [sample_draws(g, num_draws(c), bg.shape[0]) for g, c in zip(streams, chunks)]
    phi = chunked_phi(f, x, bg, chunks, draws)
    return phi, conf, ids[0], keep[0]


def _is_device_unavailable(e: BaseException) -> bool:
    """True for the loss of the device or of a peer, where the right
    reaction is to wait, re-stage the params and go on, not to shrink the
    program: a ``torch.AcceleratorError``, or a ``torch.distributed``
    backend or network error, whose text says the device or peer is
    unavailable or lost. Never for running out of memory, and never for
    another exception that merely carries such words."""
    if isinstance(e, torch.OutOfMemoryError):
        return False
    kinds = tuple(k for k in (getattr(torch, "AcceleratorError", None),
                              getattr(dist, "DistBackendError", None),
                              getattr(dist, "DistNetworkError", None)) if k is not None)
    if not isinstance(e, kinds):
        return False
    text = str(e).lower()
    return any(w in text for w in ("unavailable", "lost", "fallen off the bus",
                                   "closed by peer", "reset by peer"))


def _auto_group_size(length: int, nsamples: int = 200) -> int:
    """``sample_batch=0``: the reference's policy. Grouping pays only while
    a sample's fixed costs (its decode forward) are visible beside the draw
    loop: 2 for clips under 100,000 samples with fewer than 32 draws, else
    1."""
    return 2 if (length < 100_000 and nsamples < 32) else 1


def _group_size(cfg: PipelineConfig, mesh: Optional[Mesh], length: int) -> int:
    """The fixed group size of one exact-length bucket: ``sample_batch``
    (0: ``_auto_group_size``) without a mesh. Under a mesh DeepSHAP,
    KernelSHAP and LIME (no draw axis) always shard samples, the group
    rounded up to a multiple of the data axis; expected gradients takes the
    group rounded down to a multiple of the axis, or 1 (draw-sharded) when
    the group is smaller than the axis."""
    g = cfg.sample_batch if cfg.sample_batch > 0 else _auto_group_size(
        length, cfg.explainer.nsamples)
    if mesh is None:
        return g
    ndev = mesh.data_size
    if cfg.explainer.method in ("deep", "kernel", "lime"):
        return max(ndev, -(-g // ndev) * ndev)
    if g >= ndev:
        return (g // ndev) * ndev
    return 1


def _explain_samples(params, cfg: PipelineConfig, xs: torch.Tensor, idxs: List[int],
                     draw_mesh: Optional[Mesh], tp: Optional[Mesh]):
    """The samples of ``xs`` one after another: stacked (phis, confs, ids,
    keeps)."""
    outs = [_explain_sample(params, cfg, xs[j], i, draw_mesh, tp)
            for j, i in enumerate(idxs)]
    return tuple(torch.stack(col) for col in zip(*outs))


def _gather_samples(mesh: Mesh, local, g: int):
    """Every data rank's block of a sample-sharded group, on every rank: one
    broadcast per rank and output, into the group's slots."""
    per = g // mesh.data_size
    out = []
    for t in local:
        wire = t.to(torch.uint8) if t.dtype == torch.bool else t
        full = wire.new_empty((g,) + tuple(wire.shape[1:]))
        full[mesh.data_rank * per:(mesh.data_rank + 1) * per] = wire
        for d in range(mesh.data_size):
            dist.broadcast(full[d * per:(d + 1) * per], src=mesh.data_src(d),
                           group=mesh.data_group)
        out.append(full.to(t.dtype))
    return tuple(out)


def _build_group_step(cfg: PipelineConfig, mesh: Optional[Mesh], g: int) -> Callable:
    """(params, xs [g, N], idxs) -> (phis [g, N, T_out], confs [g], ids [g, T],
    keeps [g, T]) of one group, on the params' device:

    * no mesh: the g samples one after another;
    * mesh, g == 1: the draws shard over the data axis;
    * mesh, g >= the axis size: the samples shard, each rank explaining its
      g / ndev, and the blocks are broadcast to every rank.

    A model axis of more than one rank runs the forward tensor-parallel."""
    tp = mesh if mesh is not None and mesh.model_size > 1 else None
    if mesh is None:
        return lambda params, xs, idxs: _explain_samples(params, cfg, xs, idxs, None, None)
    if g == 1:
        return lambda params, xs, idxs: _explain_samples(params, cfg, xs, idxs, mesh, tp)
    if g % mesh.data_size:
        raise ValueError(f"a sample-sharded group of {g} does not split over "
                         f"{mesh.data_size} data ranks")
    per = g // mesh.data_size

    def sharded(params, xs, idxs):
        block = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
        local = _explain_samples(params, cfg, xs[block], idxs[block], None, tp)
        return _gather_samples(mesh, local, g)

    return sharded


def _host_copy(params):
    """A CPU copy of the CUDA leaves of ``params`` (CPU leaves as they are):
    what crash recovery re-stages from."""
    return map_leaves(params, lambda t: t.to("cpu", copy=True)
                      if torch.is_tensor(t) and t.is_cuda else t)


def _stage_params(params_host, device: torch.device):
    """The host copy's leaves on ``device`` again."""
    return map_leaves(params_host, lambda t: t.to(device) if torch.is_tensor(t) else t)


def _pending(cfg: PipelineConfig, test_set: List[Dict], store: AttributionStore,
             resume: bool, mesh: Optional[Mesh]) -> List[int]:
    """The samples to compute: mesh rank 0 reads the store and broadcasts
    its list, so every rank runs the same groups."""
    pending: List[int] = []
    if mesh is None or mesh.is_main:
        for i, sample in enumerate(test_set):
            skey = key_for(i, sample["type"], sample["snr"])
            if resume and store.completed(skey):
                logger.info("sample %d (%s) already computed — skipping", i, skey)
                continue
            pending.append(i)
    if mesh is not None:
        box = [pending]
        nccl = dist.get_backend(mesh.group) == "nccl"
        dist.broadcast_object_list(box, src=mesh.ranks[0], group=mesh.group,
                                   device=mesh.device if nccl else None)
        pending = box[0]
    return pending


def run_shap_pipeline(params, cfg: PipelineConfig, test_set: List[Dict],
                      store: Optional[AttributionStore] = None,
                      resume: bool = True,
                      device: str | torch.device = "cuda",
                      mesh: Optional[Mesh] = None) -> List[Dict]:
    """Compute and persist attributions for every sample in ``test_set``
    (dicts with "audio", "noise", "text", "type", "snr"). ``params`` must
    already be on ``device`` (under a mesh: on the mesh's device, whole;
    a model axis shards them here). Returns per-sample result dicts in
    test-set order, on every rank of a mesh. The run holds the config's
    matmul precision scope; a bf16 config's params are cast once, before
    the first draw."""
    device = mesh.device if mesh is not None else resolve_device(device)
    store = store or AttributionStore(cfg.data_dir)
    writes = mesh is None or mesh.is_main
    buckets: Dict[int, List[int]] = {}
    for i in _pending(cfg, test_set, store, resume, mesh):
        buckets.setdefault(len(test_set[i]["audio"]), []).append(i)

    results = []
    if buckets:
        if mesh is not None and mesh.model_size > 1:
            params = shard_params_tp(params, mesh)
        state = _RunState(cast_params_for_compute(params, cfg.model.dtype))
        params_host = _host_copy(state.params) if cfg.crash_retries > 0 else None
        with matmul_precision_scope(cfg.model.matmul_precision):
            for length in sorted(buckets):
                results += _run_bucket(state, params_host, cfg, test_set, buckets[length],
                                       length, store if writes else None, mesh, device)
    if writes:
        store.write_manifest()
    results.sort(key=lambda r: r["index"])
    return results


class _RunState:
    """What one run's fallbacks change for the rest of it: the params
    (re-staged after a lost device), the cap on the group size, the
    recoveries taken."""

    def __init__(self, params):
        self.params = params
        self.g_cap = 0
        self.crashes = 0


def _run_bucket(state: _RunState, params_host, cfg: PipelineConfig, test_set: List[Dict],
                bucket: List[int], length: int, store: Optional[AttributionStore],
                mesh: Optional[Mesh], device: torch.device) -> List[Dict]:
    """One exact-length bucket in fixed-size groups, with the fallbacks;
    stores each sample when ``store`` is given."""
    g = _group_size(cfg, mesh, length)
    if state.g_cap:
        g = min(g, state.g_cap)
    step = _build_group_step(cfg, mesh, g)
    groups = [bucket[s:s + g] for s in range(0, len(bucket), g)]
    results = []
    while groups:
        idxs = groups.pop(0)
        xs = torch.stack([zero_mean_unit_var(torch.as_tensor(
            np.asarray(test_set[i]["audio"], np.float32), device=device)) for i in idxs])
        run_idxs = list(idxs)
        pad = g - len(idxs) if mesh is not None and g > 1 else 0
        if pad:  # the sharded group's fixed size; the copies are dropped below
            xs = torch.cat([xs, xs[:1].expand(pad, -1)])
            run_idxs += [idxs[0]] * pad
        t0 = time.perf_counter()
        try:
            phis, confs, ids, keeps = step(state.params, xs, run_idxs)
            # every copy to the host inside the try: a lost device can
            # surface on any of them, and recovery must see it
            phis, confs = phis.cpu().numpy(), confs.cpu().numpy()
            ids, keeps = ids.cpu().numpy(), keeps.cpu().numpy()
        except Exception as e:
            if (params_host is not None and _is_device_unavailable(e)
                    and state.crashes < cfg.crash_retries):
                state.params = _recover(e, params_host, cfg, device, state)
                if g > 1:  # the grouped call's memory is suspect: one sample per call
                    groups = [[i] for grp in [idxs] + groups for i in grp]
                    g = state.g_cap = 1
                else:
                    groups.insert(0, idxs)
                step = _build_group_step(cfg, mesh, g)
                continue
            if g == 1:
                raise
            logger.warning("sample group of %d failed (%s: %.200s); falling back to "
                           "sample_batch=1 for the rest of the run", g, type(e).__name__, e)
            groups = [[i] for grp in [idxs] + groups for i in grp]
            g = state.g_cap = 1
            step = _build_group_step(cfg, mesh, g)
            continue
        wall = time.perf_counter() - t0
        for j, i in enumerate(idxs):
            results.append(_finish_sample(cfg, test_set[i], i, phis[j], float(confs[j]),
                                          ids[j], keeps[j], wall / len(idxs), store))
        logger.info("group len=%d g=%d: %d samples in %.2fs (%.2fs/sample)",
                    length, g, len(idxs), wall, wall / len(idxs))
    return results


def _recover(e: BaseException, params_host, cfg: PipelineConfig, device: torch.device,
             state: _RunState):
    """Wait out a lost device (``crash_backoff_s`` times the attempt) and
    re-stage the params from the host copy; a re-staging that fails the
    same way takes a further attempt. Returns the re-staged params."""
    state.crashes += 1
    wait = cfg.crash_backoff_s * state.crashes
    logger.warning("device unavailable (%s: %.200s); waiting %.0fs, then re-staging "
                   "params (recovery %d/%d)", type(e).__name__, e, wait, state.crashes,
                   cfg.crash_retries)
    while True:
        time.sleep(wait)
        try:
            return _stage_params(params_host, device)
        except Exception as e2:
            if _is_device_unavailable(e2) and state.crashes < cfg.crash_retries:
                state.crashes += 1
                wait = cfg.crash_backoff_s * state.crashes
                logger.warning("device still unavailable at re-staging (%s: %.200s); "
                               "waiting %.0fs more (recovery %d/%d)", type(e2).__name__,
                               e2, wait, state.crashes, cfg.crash_retries)
                continue
            raise


def _finish_sample(cfg: PipelineConfig, sample: Dict, i: int, phi: np.ndarray, conf: float,
                   ids: np.ndarray, keep: np.ndarray, wall: float,
                   store: Optional[AttributionStore]) -> Dict:
    """Check and (on the writing rank) store sample ``i``; its result dict."""
    skey = key_for(i, sample["type"], sample["snr"])
    check_finite(phi, f"shap_values[sample {i}]")
    transcription = ctc_ids_to_text(ids, keep, WAV2VEC2_VOCAB)
    if store is not None:
        store.save(skey, sample["audio"], sample["noise"], phi, sample["text"])
    logger.info("sample %d (%s, snr=%s): %.2fs/sample, conf=%.3f, '%s'",
                i, sample["type"], sample["snr"], wall, conf, transcription[:50])
    return {
        "index": i, "key": skey, "shap_values": phi,
        "transcription": transcription, "confidence": conf,
        "wall_s": wall, "snr": sample["snr"], "type": sample["type"],
    }
