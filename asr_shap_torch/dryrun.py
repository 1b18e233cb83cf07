"""The port's twin of ``__graft_entry__.py::dryrun_multichip``: the sharding
story on an n-process mesh, at a tiny Wav2Vec2.

``dryrun_multichip(n, device)`` spawns n ranks of a ``torch.distributed``
group and runs in each, on a (n, 1) mesh, the reference's four parts:

1. one data-parallel training step (``TrainConfig(batch_size=n,
   freeze_feature_encoder=False)``: the batch sharded over the data axis,
   params and optimizer state replicated, the gradients all-reduced before
   the clip), its loss finite;
2. one draw-sharded ``expected_gradients_sharded``, phi of shape [1600,
   frames_for_samples(1600)], finite;
3. one sample-sharded group of n clips (``pipeline/run_shap.py::
   _build_group_step``), finite;
4. a tensor-parallel forward on a (n // 2, 2) mesh (``parallel/tp.py::
   shard_params_tp``) within rtol 1e-4, atol 1e-5 of the unsharded logits.

Where the reference re-executes itself on a virtual CPU mesh, the port
provisions processes: gloo ranks on the CPU for ``device="cpu"``; NCCL, one
rank per card, for ``device="cuda"`` with n cards; with fewer cards, gloo
ranks sharing ``cuda:0`` (NCCL refuses two ranks on one card), which the
launch line says. n must be even, for part 4's mesh. The init is the port's
numpy init and the draws come from ``core/prng.py``: nothing is downloaded.
A failed rank makes the call raise RuntimeError with its traceback.

    python -m asr_shap_torch.dryrun N [--device cpu|cuda]
"""

from __future__ import annotations

import argparse
import datetime
import multiprocessing
import os
import queue
import sys
import tempfile
import time
import traceback
from typing import Callable, Dict

import numpy as np
import torch
import torch.distributed as dist

from asr_shap_torch.core.config import (
    ExplainerConfig,
    MeshConfig,
    PipelineConfig,
    TrainConfig,
    Wav2Vec2Config,
)
from asr_shap_torch.core.device import matmul_precision_scope, resolve_device
from asr_shap_torch.core.prng import generator
from asr_shap_torch.explain.baselines import zeros_noise_background
from asr_shap_torch.explain.expected_gradients import expected_gradients_sharded
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params, wav2vec2_logits
from asr_shap_torch.parallel.mesh import make_mesh
from asr_shap_torch.parallel.tp import shard_params_tp
from asr_shap_torch.pipeline.run_shap import _build_group_step
from asr_shap_torch.pipeline.train import (
    make_optimizer,
    make_train_step,
    replicate_params,
    shard_batch,
    trainable_leaves,
)

# the reference's tiny model (__graft_entry__.py:117-122)
TINY = Wav2Vec2Config(
    hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
    intermediate_size=128, conv_dim=(32, 32), conv_stride=(5, 2),
    conv_kernel=(10, 3), num_conv_pos_embeddings=16,
    num_conv_pos_embedding_groups=4, feat_proj_dim=32,
)
N_AUDIO, N_LABEL = 1600, 6
RANK_TIMEOUT_S = 600     # the whole launch, from the spawn
GRACE_S = 10             # after one rank fails, for the others' reports


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def _dryrun_body(n: int, device: torch.device) -> Dict:
    """One rank's share of the four parts; what it saw."""
    cfg = TINY
    mesh = make_mesh(MeshConfig(), device=device)
    with matmul_precision_scope(cfg.matmul_precision):
        # ---- 1. training step: dp-sharded batch, replicated params ----
        tcfg = TrainConfig(batch_size=n, freeze_feature_encoder=False)
        optimizer = make_optimizer(tcfg)
        params = replicate_params(init_wav2vec2_params(0, cfg, device=device), mesh)
        opt_state = replicate_params(optimizer.init(trainable_leaves(params, tcfg)), mesh)
        rng = np.random.default_rng(0)
        batch = {
            "audio": rng.standard_normal((n, N_AUDIO)).astype(np.float32),
            "audio_lengths": np.full((n,), N_AUDIO, np.int32),
            "labels": rng.integers(1, cfg.vocab_size, (n, N_LABEL)).astype(np.int32),
            "label_lengths": np.full((n,), N_LABEL, np.int32),
        }
        step = make_train_step(cfg, tcfg, optimizer, mesh)
        params, opt_state, loss = step(params, opt_state, shard_batch(batch, mesh))
        loss = float(loss)
        _require(np.isfinite(loss), f"train loss not finite: {loss}")

        # ---- 2. draw-sharded expected-gradients explanation ----
        ecfg = ExplainerConfig(nsamples=2 * n, draw_chunk=2, num_background=2)
        f = make_explained_fn(params, cfg, ecfg)
        x = torch.from_numpy(rng.standard_normal(N_AUDIO).astype(np.float32)).to(device)
        bg = zeros_noise_background(generator(1), N_AUDIO, 2, 0.01, device=device)
        phi = expected_gradients_sharded(f, x, bg, mesh, generator(2), config=ecfg).values
        _require(tuple(phi.shape) == (N_AUDIO, cfg.frames_for_samples(N_AUDIO)),
                 f"phi shape {tuple(phi.shape)}")
        _require(bool(torch.isfinite(phi).all()), "phi not finite")

        # ---- 3. sample-sharded pipeline group (run_shap throughput mode) ----
        group_step = _build_group_step(PipelineConfig(model=cfg, explainer=ecfg,
                                                      sample_batch=n), mesh, n)
        xs = torch.from_numpy(rng.standard_normal((n, N_AUDIO)).astype(np.float32)).to(device)
        phis = group_step(params, xs, list(range(n)))[0]
        _require(phis.shape[0] == n and bool(torch.isfinite(phis).all()),
                 f"sample-sharded group {tuple(phis.shape)} not finite")

        # ---- 4. tensor-parallel forward on a (dp, tp) mesh ----
        tp_mesh = make_mesh(MeshConfig(data_parallel=n // 2, model_parallel=2), device=device)
        with torch.no_grad():
            ref = wav2vec2_logits(params, cfg, xs[:1])
            got = wav2vec2_logits(shard_params_tp(params, tp_mesh), cfg, xs[:1], tp=tp_mesh)
        tp_err = float((got - ref).abs().max())
        _require(torch.allclose(got, ref, rtol=1e-4, atol=1e-5),
                 f"TP logits off the unsharded by {tp_err:.3e}")
    return {"loss": loss, "phi_shape": tuple(phi.shape), "group_shape": tuple(phis.shape),
            "tp_mesh": {"data": tp_mesh.data_size, "model": tp_mesh.model_size},
            "tp_max_abs_err": tp_err}


def _rank_main(rank: int, n: int, backend: str, device: str, init_file: str,
               body: Callable, results) -> None:
    """A spawned rank: joins the group, runs ``body(n, device)`` and puts
    (rank, result, None) or (rank, None, its traceback) on ``results``."""
    try:
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        else:
            # the tiny model's ops gain nothing from a pool, and n ranks share the host
            torch.set_num_threads(1)
        dist.init_process_group(backend, init_method=f"file://{init_file}", rank=rank,
                                world_size=n, timeout=datetime.timedelta(seconds=300))
        results.put((rank, body(n, dev), None))
    except Exception:
        results.put((rank, None, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _launch(n: int, device: str, body: Callable) -> Dict:
    """Run ``body`` on n spawned ranks; rank 0's result, or RuntimeError
    with every failed rank's traceback."""
    if n < 2 or n % 2:
        raise ValueError(f"dryrun_multichip: n = {n}; an even n >= 2 is needed for the "
                         "(n // 2, 2) tensor-parallel mesh")
    kind = resolve_device(device).type
    if kind == "cuda" and torch.cuda.device_count() >= n:
        backend, devices = "nccl", [f"cuda:{r}" for r in range(n)]
        where = f"one rank per card on {n} cards"
    elif kind == "cuda":
        backend, devices = "gloo", ["cuda:0"] * n
        where = (f"{torch.cuda.device_count()} card(s) for {n} ranks: the ranks share "
                 "cuda:0 over gloo")
    else:
        backend, devices = "gloo", ["cpu"] * n
        where = "on the CPU"
    print(f"dryrun_multichip: {n} {backend} ranks, {where}", flush=True)
    ctx = multiprocessing.get_context("spawn")
    results = ctx.Queue()
    got, errors = {}, {}
    with tempfile.TemporaryDirectory(prefix="dryrun_") as tmp:
        procs = [ctx.Process(target=_rank_main, args=(r, n, backend, devices[r],
                                                      os.path.join(tmp, "init"), body,
                                                      results))
                 for r in range(n)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANK_TIMEOUT_S
        try:
            while len(got) + len(errors) < n and time.monotonic() < deadline:
                try:
                    rank, out, err = results.get(timeout=1.0)
                except queue.Empty:
                    # a rank that died without reporting (a crash, a kill)
                    for r, p in enumerate(procs):
                        if r not in got and r not in errors and p.exitcode not in (None, 0):
                            errors[r] = f"exited with code {p.exitcode} without a report"
                    continue
                if err is None:
                    got[rank] = out
                else:
                    errors[rank] = err
                    deadline = min(deadline, time.monotonic() + GRACE_S)
        finally:
            for p in procs:
                # a rank still running after another failed waits in a collective
                p.join(timeout=2 if errors else 30)
                if p.is_alive():
                    p.kill()
                    p.join()
    missing = [r for r in range(n) if r not in got and r not in errors]
    for r in missing:
        errors[r] = "no report before the launch's deadline"
    if errors:
        raise RuntimeError("dryrun_multichip failed:\n" + "\n".join(
            f"--- rank {r}: {errors[r]}" for r in sorted(errors)))
    return got[0]


def dryrun_multichip(n_devices: int, device: str = "cuda") -> Dict:
    """Validate the multi-device sharding story on ``n_devices`` ranks (see
    the module's docstring); returns rank 0's result and prints the
    reference's summary line."""
    t0 = time.perf_counter()
    out = _launch(n_devices, device, _dryrun_body)
    print(f"dryrun_multichip OK on {n_devices} devices: train loss={out['loss']:.4f}, "
          f"phi shape={out['phi_shape']}, sample-sharded group {out['group_shape']}, "
          f"tp mesh {out['tp_mesh']} ({time.perf_counter() - t0:.1f} s with the spawn)",
          flush=True)
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m asr_shap_torch.dryrun",
                                description=dryrun_multichip.__doc__)
    p.add_argument("n", type=int, help="number of ranks (even)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    args = p.parse_args(argv)
    dryrun_multichip(args.n, args.device)
    return 0


if __name__ == "__main__":
    # through the importable module, so the spawned ranks find its functions by name
    from asr_shap_torch import dryrun as _module

    sys.exit(_module.main())
