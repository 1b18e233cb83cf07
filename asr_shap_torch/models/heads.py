"""Aggregation heads: what gets explained, as functions of the logits, and
the dispatch from a Wav2Vec2-family config to its forward.

The dispatch covers the two Wav2Vec2 families, as the reference's does. The
mel Conformer and the NeMo BPE-CTC Conformer (``models/conformer.py``,
``models/nemo_ctc.py``) take features, not waveforms, and are explained as
the reference explains them: a caller's own f over the flattened features,
through ``explain.expected_gradients.expected_gradients`` or
``explain.deepshap.deep_shap_values``, with ``aggregation_head`` on the
logits."""

from __future__ import annotations

from typing import Callable

import torch

from asr_shap_torch.core.config import (
    ExplainerConfig,
    Wav2Vec2Config,
    Wav2Vec2ConformerConfig,
)


def aggregation_head(logits: torch.Tensor, kind: str, token_timestep: int = 0,
                     token_id: int = 0) -> torch.Tensor:
    """logits [..., T, V] -> explained outputs [..., T_out]; T_out = T for
    "max"/"mean", 1 for "token"/"mean_time"."""
    if kind == "max":
        return logits.amax(dim=-1)
    if kind == "mean":
        return logits.mean(dim=-1)
    if kind == "token":
        return logits[..., token_timestep, token_id][..., None]
    if kind == "mean_time":
        return logits.mean(dim=(-2, -1))[..., None]
    raise ValueError(f"unknown aggregation head {kind!r}")


def model_logits_fn(model_cfg: Wav2Vec2Config):
    """The forward for a model config, selected by its type as the
    reference's pipeline does (the conformer config subclasses Wav2Vec2's)."""
    if isinstance(model_cfg, Wav2Vec2ConformerConfig):
        from asr_shap_torch.models.w2v2_conformer import w2v2_conformer_logits

        return w2v2_conformer_logits
    if type(model_cfg) is not Wav2Vec2Config:
        raise NotImplementedError(
            f"{type(model_cfg).__name__}: the pipeline takes the Wav2Vec2 families; "
            "explain a mel model through its own f (see the module docstring)")
    from asr_shap_torch.models.wav2vec2 import wav2vec2_logits

    return wav2vec2_logits


def make_batched_fn(params, model_config: Wav2Vec2Config,
                    explainer_config: ExplainerConfig,
                    remat: bool | None = None, tp=None
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """f: normalized waveforms [B, N] -> explained outputs [B, T_out], one
    batched forward (the perturbation explainers' batches). ``tp``: the
    tensor-parallel mesh of sharded ``params``, or None."""
    logits_fn = model_logits_fn(model_config)
    use_remat = explainer_config.remat if remat is None else remat
    ec = explainer_config

    def f(xs: torch.Tensor) -> torch.Tensor:
        logits = logits_fn(params, model_config, xs, remat=use_remat, tp=tp)
        return aggregation_head(logits, ec.aggregation, ec.token_timestep, ec.token_id)

    return f


def make_explained_fn(params, model_config: Wav2Vec2Config,
                      explainer_config: ExplainerConfig,
                      remat: bool | None = None, tp=None
                      ) -> Callable[[torch.Tensor], torch.Tensor]:
    """f: normalized waveform [N] -> explained outputs [T_out]."""
    f_batch = make_batched_fn(params, model_config, explainer_config, remat, tp)
    return lambda x: f_batch(x[None, :])[0]
