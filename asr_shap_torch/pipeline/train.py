"""Noise-robust CTC fine-tuning: the port of ``asr_shap/pipeline/train.py``.

One train step is the CTC loss (``ops/ctc.py``), its gradients by autograd
through the model and the kernels' Functions (K1's input gradient, the
flash backwards, K3b's d(bias) on the rel-pos conformer), a clip by the
global norm and AdamW: ``optax.chain(clip_by_global_norm, adamw)`` with
optax's arithmetic, written over the params dict with ``torch._foreach``
ops. The epoch loop adds validation, early stopping and checkpoints, with
batches made on a host thread and copied to the device ahead of the step
(``pipeline/prefetch.py``).

Where the reference zeroes the frozen feature encoder's gradients and
updates, the port leaves those leaves out: they do not require grad, they
are not in the global norm or the optimizer, and so they stay bit-equal and
K1 is not launched at all. A bf16 model (``dtype="bfloat16"``) keeps
float32 master params and casts them inside each step's graph (the model
does it), so the gradients land on the float32 leaves. The loss asks its
model for ``remat=True``, as the reference's does: each encoder layer
keeps only its inputs and runs again in the backward (``ops/remat.py``;
the layer's param leaves are the recompute's explicit inputs, so their
gradients flow), so the flash forward runs twice per layer and step.
Checkpoints are ``torch.save`` files, not orbax directories.

Data parallelism (``mesh=``, a ``parallel/mesh.py`` mesh of processes):
each rank takes its rows of the batch over the mesh's data axis
(``shard_batch``; ranks on the model axis take their data-index peers'
rows) and starts from mesh rank 0's params (``replicate_params``). After
the local backward, the loss and the trainable leaves' gradients, in one
flat buffer, are averaged over the data axis by one all-reduce, before the
clip: the clip sees the global norm and every rank applies the same update,
as the reference's jitted step over a sharded batch does. The reference's
loss is the batch mean, so with equal shards the mean of the local losses
is the global one. Every rank runs the same epoch loop and takes the same
early-stopping decision from the same averaged losses; mesh rank 0 alone
writes the checkpoints.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
from typing import Any, Dict, Iterable, Iterator, Optional, Sequence, Tuple

import numpy as np
import torch

from asr_shap_torch.audio.noise import mix_at_snr
from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core.config import TrainConfig, Wav2Vec2Config
from asr_shap_torch.core.device import matmul_precision_scope, params_device
from asr_shap_torch.core.params_io import map_leaves
from asr_shap_torch.models.heads import model_logits_fn
from asr_shap_torch.models.wav2vec2 import feature_lengths
from asr_shap_torch.ops.ctc import ctc_loss
from asr_shap_torch.parallel.mesh import Mesh, data_mean, replicate, shard_rows
from asr_shap_torch.pipeline.prefetch import prefetch_to_device, to_device

logger = logging.getLogger(__name__)

Params = Dict[str, Any]


def named_leaves(tree: Any, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of each leaf of a params tree, in its order; list
    items are ``#i`` (``core/params_io.py``'s names)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from named_leaves(v, f"{prefix}{k}/")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from named_leaves(v, f"{prefix}#{i}/")
    else:
        yield prefix[:-1], tree


def clone_params(params: Params) -> Params:
    """A detached copy of a params tree."""
    return map_leaves(params, lambda t: t.detach().clone())


def trainable_leaves(params: Params, train_cfg: TrainConfig) -> Dict[str, torch.Tensor]:
    """The leaves the optimizer updates, by path: every floating leaf, less
    the feature encoder's when ``freeze_feature_encoder``."""
    return {name: t for name, t in named_leaves(params)
            if t.is_floating_point() and not (
                train_cfg.freeze_feature_encoder and name.startswith("feature_encoder/"))}


# ---------------------------------------------------------------- optimizer

@dataclasses.dataclass(frozen=True)
class ClippedAdamW:
    """``optax.chain(clip_by_global_norm(max_norm), adamw(learning_rate,
    weight_decay=weight_decay))`` over a dict of leaves, in place.

    The clip is optax's: g unchanged where the global norm is below
    ``max_norm``, else ``(g / norm) * max_norm`` (no epsilon, unlike
    ``clip_grad_norm_``). AdamW: moments ``b*m + (1-b)*g``, bias correction
    counted from 1, ``m_hat / (sqrt(v_hat) + eps)`` plus the decoupled decay
    ``weight_decay * p`` on every leaf it is given, times -lr. The state is
    ``{"count": int, "mu": {path: tensor}, "nu": {path: tensor}}``."""

    learning_rate: float
    weight_decay: float
    max_norm: float
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8

    def init(self, leaves: Dict[str, torch.Tensor]) -> Dict[str, Any]:
        return {"count": 0,
                "mu": {k: torch.zeros_like(v) for k, v in leaves.items()},
                "nu": {k: torch.zeros_like(v) for k, v in leaves.items()}}

    @torch.no_grad()
    def apply(self, leaves: Dict[str, torch.Tensor], grads: Dict[str, torch.Tensor],
              state: Dict[str, Any]) -> Dict[str, Any]:
        """Update ``leaves`` and ``state`` in place from ``grads``; returns
        ``state``."""
        names = list(leaves)
        p = [leaves[k] for k in names]
        g = [grads[k] for k in names]
        mu = [state["mu"][k] for k in names]
        nu = [state["nu"][k] for k in names]
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(g)))
        below = norm < self.max_norm
        one = torch.ones((), device=norm.device)
        g = torch._foreach_div(g, torch.where(below, one, norm))
        torch._foreach_mul_(g, torch.where(below, one, torch.full_like(one, self.max_norm)))

        state["count"] += 1
        count = state["count"]
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, g, alpha=1.0 - self.b1)
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_addcmul_(nu, g, g, value=1.0 - self.b2)
        # two temporaries: m_hat, which becomes the update, and the denominator
        update = torch._foreach_div(mu, 1.0 - self.b1 ** count)
        denom = torch._foreach_div(nu, 1.0 - self.b2 ** count)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_div_(update, denom)
        del denom
        torch._foreach_add_(update, p, alpha=self.weight_decay)
        torch._foreach_add_(p, update, alpha=-self.learning_rate)
        return state


def make_optimizer(cfg: TrainConfig) -> ClippedAdamW:
    return ClippedAdamW(cfg.learning_rate, cfg.weight_decay, cfg.grad_clip_norm)


def _loss_fn(model_cfg: Wav2Vec2Config):
    logits_fn = model_logits_fn(model_cfg)

    def loss_fn(params: Params, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        lengths = batch["audio_lengths"]
        x = zero_mean_unit_var(batch["audio"], lengths)
        logits = logits_fn(params, model_cfg, x, lengths=lengths, remat=True)
        return ctc_loss(logits, feature_lengths(model_cfg, lengths), batch["labels"],
                        batch["label_lengths"])

    return loss_fn


def _mean_over_data(mesh: Mesh, loss: torch.Tensor, grads: Dict[str, torch.Tensor]):
    """(loss, grads) averaged over the mesh's data axis: one all-reduce of a
    flat float32 buffer, the loss first; the gradients come back as views of
    it."""
    flat = torch.cat([loss.reshape(1).to(torch.float32)]
                     + [g.reshape(-1) for g in grads.values()])
    data_mean(mesh, flat)
    out, offset = {}, 1
    for k, g in grads.items():
        out[k] = flat[offset:offset + g.numel()].view(g.shape)
        offset += g.numel()
    return flat[0], out


def make_loss_and_grads(model_cfg: Wav2Vec2Config, train_cfg: TrainConfig,
                        mesh: Optional[Mesh] = None):
    """(params, batch) -> (loss, {path: gradient}) over the trainable leaves
    (``trainable_leaves``): the step's forward and backward, without the
    update. The leaves require grad only inside the call. With ``mesh``,
    ``batch`` is this rank's shard (``shard_batch``) and both results are
    the means over the data axis, equal on every rank. On CUDA it runs
    inside ``matmul_precision_scope(model_cfg.matmul_precision)``."""
    loss_fn = _loss_fn(model_cfg)

    def loss_and_grads(params: Params, batch: Dict):
        leaves = trainable_leaves(params, train_cfg)
        for t in leaves.values():
            t.requires_grad_(True)
        try:
            loss = loss_fn(params, batch)
            grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        finally:
            for t in leaves.values():
                t.requires_grad_(False)
        grads = {k: torch.zeros_like(t) if g is None else g
                 for (k, t), g in zip(leaves.items(), grads)}
        if mesh is not None:
            return _mean_over_data(mesh, loss.detach(), grads)
        return loss.detach(), grads

    return loss_and_grads


def make_train_step(model_cfg: Wav2Vec2Config, train_cfg: TrainConfig,
                    optimizer: ClippedAdamW, mesh: Optional[Mesh] = None):
    """(params, opt_state, batch) -> (params, opt_state, loss). The step
    updates ``params`` and ``opt_state`` in place, as torch optimizers do,
    and returns them. batch: tensors on the params' device, audio [B, N]
    (raw), audio_lengths [B], labels [B, L], label_lengths [B]. With
    ``mesh``: replicated params and state (``replicate_params``), this
    rank's shard of the batch, and the gradients and the loss averaged over
    the data axis before the clip. On CUDA it runs inside
    ``matmul_precision_scope(model_cfg.matmul_precision)``."""
    loss_and_grads = make_loss_and_grads(model_cfg, train_cfg, mesh)

    def train_step(params: Params, opt_state: Dict[str, Any], batch: Dict):
        loss, grads = loss_and_grads(params, batch)
        optimizer.apply(trainable_leaves(params, train_cfg), grads, opt_state)
        return params, opt_state, loss

    return train_step


def make_eval_step(model_cfg: Wav2Vec2Config, mesh: Optional[Mesh] = None):
    """Loss-only validation step, (params, batch) -> loss: forward and CTC
    loss under ``torch.no_grad()``, no optimizer state. With ``mesh``, the
    loss of this rank's shard averaged over the data axis."""
    loss_fn = _loss_fn(model_cfg)

    def eval_step(params: Params, batch: Dict) -> torch.Tensor:
        with torch.no_grad():
            loss = loss_fn(params, batch)
        if mesh is not None:
            loss = data_mean(mesh, loss.reshape(1).to(torch.float32))[0]
        return loss

    return eval_step


def shard_batch(batch: Dict[str, Any], mesh: Mesh) -> Dict[str, torch.Tensor]:
    """This rank's rows of every leaf of a batch (numpy arrays, tensors or
    what ``torch.as_tensor`` takes) over the mesh's data axis
    (``shard_rows``), on ``mesh.device``. A leading axis that does not
    split evenly raises ValueError. Keys starting with ``_`` are host-only
    (``train_synthetic``'s transcripts) and are dropped."""
    rows = {}
    for k, v in batch.items():
        if k.startswith("_"):
            continue
        if isinstance(v, np.ndarray):
            v = np.ascontiguousarray(v)
        rows[k] = shard_rows(mesh, torch.as_tensor(v))
    return to_device(rows, mesh.device)


def replicate_params(tree: Any, mesh: Mesh) -> Any:
    """Mesh rank 0's leaves on every rank, on ``mesh.device``: a params
    tree or an optimizer state (its integer step count included), each
    tensor leaf a copy broadcast by ``replicate``."""
    def leaf(v):
        if isinstance(v, torch.Tensor):
            return replicate(mesh, v)
        if isinstance(v, int):
            return int(replicate(mesh, torch.tensor(v, dtype=torch.int64)).item())
        raise TypeError(f"replicate_params: a leaf of type {type(v).__name__}")

    return map_leaves(tree, leaf)


# ------------------------------------------------------- host-side utilities

class EarlyStopping:
    """Patience-based early stopping on the validation loss."""

    def __init__(self, patience: int = 3, min_delta: float = 0.0):
        self.patience = patience
        self.min_delta = min_delta
        self.best = float("inf")
        self.count = 0
        self.should_stop = False

    def update(self, value: float) -> bool:
        if value < self.best - self.min_delta:
            self.best = value
            self.count = 0
        else:
            self.count += 1
            if self.count >= self.patience:
                self.should_stop = True
        return self.should_stop


class Checkpointer:
    """Params and optimizer state as ``torch.save`` files, one per step
    (``step_<n>.pt``), with the reference's orbax manager's rules: the
    ``keep`` best steps by ``val_loss`` stay (lowest wins, the newer of
    equals; a step is dropped as soon as it falls out, itself included),
    ``best_step`` is the best kept, ``restore(None)`` the newest kept. The
    steps' losses live in ``checkpoints.json``, so a new Checkpointer on
    the same directory resumes."""

    INDEX = "checkpoints.json"

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self._losses: Dict[int, float] = {}
        index = os.path.join(self.directory, self.INDEX)
        if os.path.exists(index):
            with open(index) as fh:
                self._losses = {int(k): v for k, v in json.load(fh).items()}

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step}.pt")

    def _ranked(self):
        """Kept steps, worst first (orbax's stable sort, newer of equals last)."""
        return sorted(sorted(self._losses), key=lambda s: self._losses[s], reverse=True)

    def save(self, step: int, params: Params, opt_state: Dict[str, Any],
             val_loss: float) -> None:
        tmp = self._path(step) + ".tmp"
        torch.save({"step": step, "params": params, "opt_state": opt_state}, tmp)
        os.replace(tmp, self._path(step))
        self._losses[step] = float(val_loss)
        ranked = self._ranked()
        for s in ranked[:max(0, len(ranked) - self.keep)]:
            os.remove(self._path(s))
            del self._losses[s]
        with open(os.path.join(self.directory, self.INDEX), "w") as fh:
            json.dump({str(k): v for k, v in sorted(self._losses.items())}, fh)

    def restore(self, step: Optional[int], params_like: Params,
                opt_state_like: Optional[Dict[str, Any]] = None):
        """(step, params, opt_state) of ``step`` (None: the newest kept) on
        ``params_like``'s device, or None when no step is kept.
        ``opt_state_like`` is accepted for the reference's signature."""
        step = max(self._losses, default=None) if step is None else step
        if step is None:
            return None
        data = torch.load(self._path(step), map_location=params_device(params_like),
                          weights_only=True)
        return step, data["params"], data["opt_state"]

    @property
    def best_step(self) -> Optional[int]:
        ranked = self._ranked()
        return ranked[-1] if ranked else None


# ------------------------------------------------------------- data mixing

def make_noisy_batch(
    speech,                     # [B, N] clean speech (padded)
    speech_lengths,             # [B]
    labels,                     # [B, L]
    label_lengths,              # [B]
    noises,                     # [K, M] noise bank
    snrs_db: Sequence[float],
    generator: Optional[torch.Generator] = None,
    draws: Optional[Tuple[Any, Any, Any]] = None,
) -> Dict[str, torch.Tensor]:
    """Training-time augmentation: each utterance gets a noise clip from the
    bank mixed at an SNR from ``snrs_db``. ``draws`` = (noise_idx,
    snr_idx, starts), each [B], as the reference draws them from its key
    (noise index in [0, K), SNR index, start in [0, max(1, M - N + 1)));
    else they are drawn from ``generator``. Tensors on the speech's
    device (numpy inputs: the CPU)."""
    speech = torch.as_tensor(speech, dtype=torch.float32)
    dev = speech.device
    noises = torch.as_tensor(noises, dtype=torch.float32, device=dev)
    b, n = speech.shape
    k, m = noises.shape
    if draws is None:
        if generator is None:
            raise ValueError("make_noisy_batch: pass draws= or a generator")
        gd = generator.device
        draws = (torch.randint(0, k, (b,), generator=generator, device=gd),
                 torch.randint(0, len(snrs_db), (b,), generator=generator, device=gd),
                 torch.randint(0, max(1, m - n + 1), (b,), generator=generator, device=gd))
    noise_idx, snr_idx, starts = (torch.as_tensor(d, dtype=torch.long).to(dev) for d in draws)
    width = min(n, m)
    # a start past the bank's end is clamped, as lax.dynamic_slice clamps it
    starts = starts.clamp(0, m - width)
    windows = noises[noise_idx[:, None], starts[:, None] + torch.arange(width, device=dev)]
    snr = torch.as_tensor(snrs_db, dtype=torch.float32, device=dev)[snr_idx][:, None]
    return {
        "audio": mix_at_snr(speech, windows, snr),
        "audio_lengths": torch.as_tensor(speech_lengths).to(dev),
        "labels": torch.as_tensor(labels).to(dev),
        "label_lengths": torch.as_tensor(label_lengths).to(dev),
    }


# ---------------------------------------------------------------- main loop

def train(
    params: Params,
    model_cfg: Wav2Vec2Config,
    train_cfg: TrainConfig,
    train_batches: Iterable[Dict],
    val_batches: Optional[Iterable[Dict]] = None,
    mesh: Optional[Mesh] = None,
    checkpointer: Optional[Checkpointer] = None,
):
    """Epoch loop with validation, early stopping and checkpoints; returns
    (params, opt_state, history). ``train_batches``/``val_batches`` are
    callables returning a fresh iterable per epoch, or plain lists, of
    batches of numpy arrays or tensors. Runs on the params' device, inside
    ``matmul_precision_scope(model_cfg.matmul_precision)``, on a copy of
    ``params`` (the caller's stay as they are).

    With ``mesh`` every rank of it calls ``train`` with the same batches:
    it runs on ``mesh.device`` from mesh rank 0's params, each step on its
    shard of the batch (the batch size must split over the data axis), and
    returns the same params, state and history on every rank; only mesh
    rank 0 writes to ``checkpointer``."""
    if mesh is not None:
        device = mesh.device
        params = replicate_params(params, mesh)
    else:
        device = params_device(params)
        params = clone_params(params)
    optimizer = make_optimizer(train_cfg)
    # made from the replicated params: zeros on every rank, no broadcast
    opt_state = optimizer.init(trainable_leaves(params, train_cfg))
    step_fn = make_train_step(model_cfg, train_cfg, optimizer, mesh)
    eval_fn = make_eval_step(model_cfg, mesh)
    writes = checkpointer is not None and (mesh is None or mesh.is_main)
    stopper = EarlyStopping(train_cfg.early_stopping_patience,
                            train_cfg.early_stopping_min_delta)

    history = []
    with matmul_precision_scope(model_cfg.matmul_precision):
        for epoch in range(train_cfg.num_epochs):
            ep_losses = []
            batches = train_batches() if callable(train_batches) else train_batches
            # batch synthesis, noise mixing and the copy to the device
            # overlap the step through the background producer
            for batch in prefetch_to_device(iter(batches), depth=2, mesh=mesh,
                                            device=device):
                params, opt_state, loss = step_fn(params, opt_state, batch)
                ep_losses.append(float(loss))

            val_loss = float("nan")
            if val_batches is not None:
                vb = val_batches() if callable(val_batches) else val_batches
                vl = [float(eval_fn(params, batch))
                      for batch in prefetch_to_device(iter(vb), depth=2, mesh=mesh,
                                                      device=device)]
                val_loss = float(np.mean(vl)) if vl else float("nan")

            train_loss = float(np.mean(ep_losses)) if ep_losses else float("nan")
            history.append({"epoch": epoch, "train_loss": train_loss, "val_loss": val_loss})
            logger.info("epoch %d: train=%.4f val=%.4f", epoch, train_loss, val_loss)

            metric = val_loss if np.isfinite(val_loss) else train_loss
            if writes:
                checkpointer.save(epoch, params, opt_state, metric)
            if stopper.update(metric):
                logger.info("early stopping at epoch %d (best=%.4f)", epoch, stopper.best)
                break

    return params, opt_state, history
