"""The port's training path against the reference's on the CPU: the CTC
loss, train steps (float32, frozen feature encoder, the rel-pos conformer;
bf16 on the port alone), the synthetic corpus, the host utilities
(early stopping, checkpoints, prefetch, noise mixing), ``train_synthetic``
and ``python -m asr_shap_torch train``.

Params are drawn by numpy and fed to both packages. The reference runs its
XLA impls, each step function jitted once; the port runs the kernel impls,
so its steps go through the kernels' Functions (K1's input and weight
gradients, the flash backwards, K3b's d(bias)) with their plain versions
inside."""

import dataclasses
import gc
import json
import threading
import time

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F

from asr_shap.core.config import TrainConfig as JaxTrainConfig
from asr_shap.core.params_io import load_config as jax_load_config
from asr_shap.core.params_io import load_params as jax_load_params
from asr_shap.ops.ctc import ctc_loss as jax_ctc_loss
from asr_shap.pipeline import train as jtrain
from asr_shap.pipeline import train_synthetic as jsyn
from asr_shap_torch.cli import main as cli
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import params_to_jax
from asr_shap_torch.ops.ctc import ctc_log_likelihood, ctc_loss
from asr_shap_torch.parallel.mesh import make_mesh
from asr_shap_torch.pipeline import train as ptrain
from asr_shap_torch.pipeline import train_synthetic as psyn
from asr_shap_torch.pipeline.prefetch import background_iterator, prefetch_to_device
from torch_port_configs import conformer_params, narrow_conformer_config, narrow_config
from torch_port_configs import port_cfg, shared_params

LR = 1e-3


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The port's steps at these widths are a few ms of work per op: one
    thread runs them tens of times faster than a pool that contends with
    the other test workers for the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xla(cfg):
    """The reference's config at its XLA impls (the kernels' math, as held
    in earlier slices, without interpret mode's cost)."""
    return dataclasses.replace(cfg, attention_impl="xla", conv_impl="lax")


def _tree_np(tree):
    return jax.tree.map(np.asarray, tree)


# ------------------------------------------------------------------ CTC loss

def _ctc_case():
    """Ragged logit and label lengths, repeated labels, an empty label, and
    row 3: four equal labels need 7 frames and get 5 (impossible)."""
    rng = np.random.default_rng(0)
    logits = (2 * rng.standard_normal((5, 12, 8))).astype(np.float32)
    logit_lengths = np.array([12, 9, 12, 5, 7], np.int32)
    labels = np.array([[1, 2, 3, 4], [2, 2, 3, 0], [5, 0, 0, 0], [1, 1, 1, 1], [3, 4, 3, 4]],
                      np.int32)
    label_lengths = np.array([4, 3, 0, 4, 4], np.int32)
    return logits, logit_lengths, labels, label_lengths


def _port_ctc(logits, *rest):
    x = torch.from_numpy(logits).requires_grad_()
    loss = ctc_loss(x, *(torch.from_numpy(a) for a in rest))
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


def test_ctc_loss_matches_reference():
    """Value and d/dlogits at rtol 1e-5, the impossible row included (a
    huge finite loss, a finite gradient: both packages keep -1e30 for
    impossible states, and the read-out's logaddexp passes each input
    exp(x - out))."""
    case = _ctc_case()
    want, want_g = jax.jit(jax.value_and_grad(jax_ctc_loss))(*map(jnp.asarray, case))
    got, got_g = _port_ctc(*case)
    assert np.isfinite(float(got)) and float(got) > 1e29
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)
    np.testing.assert_allclose(got_g.numpy(), np.asarray(want_g), rtol=1e-5, atol=1e-7)
    assert torch.isfinite(got_g).all()


def test_ctc_loss_matches_torch_where_finite():
    """On the rows F.ctc_loss finds possible: the per-row negative
    log-likelihood and the mean's gradient against F.ctc_loss(reduction=
    "none").mean() (rtol 1e-5), which gives inf on the impossible row."""
    logits, logit_lengths, labels, label_lengths = _ctc_case()
    lp = F.log_softmax(torch.from_numpy(logits), -1).transpose(0, 1)
    per_row = F.ctc_loss(lp, torch.from_numpy(labels).long(), torch.from_numpy(logit_lengths).long(),
                         torch.from_numpy(label_lengths).long(), reduction="none")
    ok = torch.isfinite(per_row).numpy()
    assert ok.tolist() == [True, True, True, False, True]
    sub = [a[ok] for a in (logits, logit_lengths, labels, label_lengths)]
    nll = -ctc_log_likelihood(*(torch.from_numpy(a) for a in sub))
    np.testing.assert_allclose(nll.numpy(), per_row[torch.from_numpy(ok)].numpy(), rtol=1e-5)
    _, got_g = _port_ctc(*sub)
    x = torch.from_numpy(sub[0]).requires_grad_()
    want = F.ctc_loss(F.log_softmax(x, -1).transpose(0, 1), torch.from_numpy(sub[2]).long(),
                      torch.from_numpy(sub[1]).long(), torch.from_numpy(sub[3]).long(),
                      reduction="none").mean()
    (want_g,) = torch.autograd.grad(want, x)
    np.testing.assert_allclose(got_g.numpy(), want_g.numpy(), rtol=1e-5, atol=1e-7)


# --------------------------------------------------------------- train steps

def _batch(rng, b=4, n=1600, length=6):
    return {"audio": rng.standard_normal((b, n)).astype(np.float32),
            "audio_lengths": np.array([n, n - 200, n - 400, n][:b], np.int32),
            "labels": rng.integers(5, 32, (b, length)).astype(np.int32),
            "label_lengths": np.array([length, 4, 0, 5][:b], np.int32)}


def _family(name):
    if name == "conformer":
        cfg = narrow_conformer_config()
        params, tree = conformer_params(cfg, seed=2)
        return cfg, params, jax.tree.map(jnp.asarray, tree)
    cfg = narrow_config()
    params, ref = shared_params(cfg)
    return cfg, params, ref


def _port_steps(cfg, params, tcfg, batch, n):
    opt = ptrain.make_optimizer(tcfg)
    step = ptrain.make_train_step(port_cfg(cfg), tcfg, opt)
    p = ptrain.clone_params(params)
    state = opt.init(ptrain.trainable_leaves(p, tcfg))
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    losses = []
    for _ in range(n):
        p, state, loss = step(p, state, tb)
        losses.append(float(loss))
    return p, state, losses


def _moment_tree(params, moments):
    """An optimizer moment {path: tensor} laid out as the reference's tree
    (zeros where the port keeps none: the frozen leaves)."""
    def walk(node, prefix):
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}#{i}/") for i, v in enumerate(node)]
        return moments.get(prefix[:-1], torch.zeros_like(node))

    return params_to_jax(walk(params, ""))


# Losses at rtol 2e-5 (float32 through a few layers, another summation
# order). Gradients: AdamW's first moment (an average of the clipped
# gradients) of every leaf within 1e-4 of the largest |first moment| of
# the model (measured: under 1e-5). Params: AdamW moves an element by about
# lr per step whatever its gradient's size, so where a gradient is near
# zero the two packages may step either way; each leaf is held within a
# tenth of lr per step of the reference's on all but 0.1% of its elements,
# and within 2 lr per step everywhere.
@pytest.mark.parametrize("name,frozen,steps", [("base", False, 3), ("frozen", True, 1),
                                               ("conformer", False, 2)])
def test_train_steps_match_reference(name, frozen, steps):
    cfg, params, ref = _family("conformer" if name == "conformer" else "base")
    batch = _batch(np.random.default_rng(1))
    kw = dict(learning_rate=LR, freeze_feature_encoder=frozen)
    jcfg = JaxTrainConfig(**kw)
    opt = jtrain.make_optimizer(jcfg)
    jstep = jax.jit(jtrain.make_train_step(_xla(cfg), jcfg, opt))
    jp, js = ref, opt.init(ref)
    want = []
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    for _ in range(steps):
        jp, js, loss = jstep(jp, js, jb)
        want.append(float(loss))
    got_p, state, got = _port_steps(cfg, params, pc.TrainConfig(**kw), batch, steps)
    np.testing.assert_allclose(got, want, rtol=2e-5)
    assert state["count"] == steps

    mu_ref = _tree_np(js[1][0].mu)
    scale = max(float(np.abs(m).max()) for m in jax.tree.leaves(mu_ref))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(mu_ref),
                            jax.tree.leaves(_moment_tree(got_p, state["mu"]))):
        np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=1e-4 * scale,
                                   err_msg=jax.tree_util.keystr(path))

    step_lr = LR * steps
    for (path, a), b, a0 in zip(jax.tree_util.tree_leaves_with_path(_tree_np(jp)),
                                jax.tree.leaves(params_to_jax(got_p)),
                                jax.tree.leaves(_tree_np(ref))):
        b, where = np.asarray(b), jax.tree_util.keystr(path)
        err = np.abs(b - a)
        assert (err > 0.1 * step_lr).mean() <= 1e-3, where
        np.testing.assert_allclose(b, a, rtol=0, atol=2 * step_lr, err_msg=where)
        if frozen and where.startswith("['feature_encoder']"):
            np.testing.assert_array_equal(b, a0, err_msg=where)   # bit-equal
    if frozen:
        assert not any(k.startswith("feature_encoder/") for k in state["mu"])


def test_optimizer_matches_optax(rng):
    """ClippedAdamW against optax.chain(clip_by_global_norm, adamw) on the
    same gradients, three steps of which the middle one clips: params and
    both moments at rtol 1e-6."""
    tcfg = pc.TrainConfig(learning_rate=LR, weight_decay=0.05, grad_clip_norm=1.0)
    p0 = {"a": rng.standard_normal((3, 4)).astype(np.float32),
          "b": rng.standard_normal(5).astype(np.float32)}
    opt = jtrain.make_optimizer(JaxTrainConfig(**dataclasses.asdict(tcfg)))

    @jax.jit
    def ref_step(p, s, g):
        u, s = opt.update(g, s, p)
        return jax.tree.map(lambda x, y: x + y, p, u), s

    jp, js = p0, opt.init(p0)
    ours = ptrain.make_optimizer(tcfg)
    leaves = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    state = ours.init(leaves)
    for scale in (0.1, 3.0, 0.2):   # global norms about 0.45, 13.4, 0.9
        g = {k: (scale * rng.standard_normal(v.shape)).astype(np.float32)
             for k, v in p0.items()}
        jp, js = ref_step(jp, js, g)
        ours.apply(leaves, {k: torch.from_numpy(v) for k, v in g.items()}, state)
    for k in p0:
        np.testing.assert_allclose(leaves[k].numpy(), np.asarray(jp[k]), rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state["mu"][k].numpy(), np.asarray(js[1][0].mu[k]),
                                   rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(state["nu"][k].numpy(), np.asarray(js[1][0].nu[k]),
                                   rtol=1e-6, atol=1e-12)
    assert state["count"] == int(js[1][0].count) == 3


def test_bf16_train_steps():
    """Four bf16 steps ("default" precision) of the narrow model: finite,
    decreasing losses, float32 masters and optimizer state, the first loss
    within 2% of the float32 step's (bf16 activations through 2 layers)."""
    cfg = narrow_config()
    params, _ = shared_params(cfg)
    batch = _batch(np.random.default_rng(1))
    tcfg = pc.TrainConfig(learning_rate=LR, freeze_feature_encoder=False)
    _, _, f32 = _port_steps(cfg, params, tcfg, batch, 1)
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16", matmul_precision="default")
    p, state, losses = _port_steps(cfg16, params, tcfg, batch, 4)
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses
    np.testing.assert_allclose(losses[0], f32[0], rtol=2e-2)
    leaves = dict(ptrain.named_leaves(p))
    assert all(t.dtype == torch.float32 for t in leaves.values())
    assert all(t.dtype == torch.float32 for t in state["mu"].values())
    assert not any(t.requires_grad for t in leaves.values())


# ------------------------------------------------------------ the corpus

@pytest.mark.parametrize("snrs", [(), (0.0, 10.0)])
def test_synthetic_batches_byte_equal(snrs):
    args = (7, 2, 3, 4_800, 8)
    want = list(jsyn.synthetic_batches(*args, snrs_db=snrs, offset=jsyn.VAL_OFFSET))
    got = list(psyn.synthetic_batches(*args, snrs_db=snrs, offset=psyn.VAL_OFFSET))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys() and g["_texts"] == w["_texts"]
        for k in ("audio", "audio_lengths", "labels", "label_lengths"):
            assert g[k].dtype == w[k].dtype and g[k].tobytes() == w[k].tobytes(), k


def test_make_utterance_takes_a_numpy_generator():
    with pytest.raises(TypeError, match="numpy Generator"):
        psyn.make_utterance(torch.Generator(), 3_200)


def test_noisy_batch_matches_reference(rng):
    """make_noisy_batch with the reference's draws (its key split three
    ways, as its body draws them), at 1e-6 of the mix's scale."""
    b, n = 4, 1000
    speech = rng.standard_normal((b, n)).astype(np.float32)
    noises = rng.standard_normal((3, 2000)).astype(np.float32)
    labels = rng.integers(1, 32, (b, 5)).astype(np.int32)
    snrs = (0.0, 10.0)
    key = jax.random.key(0)
    want = jtrain.make_noisy_batch(key, speech, np.full(b, n), labels, np.full(b, 5), noises,
                                   snrs)
    k1, k2, k3 = jax.random.split(key, 3)
    draws = (jax.random.randint(k1, (b,), 0, 3), jax.random.randint(k2, (b,), 0, len(snrs)),
             jax.random.randint(k3, (b,), 0, 2000 - n + 1))
    got = ptrain.make_noisy_batch(speech, np.full(b, n), labels, np.full(b, 5), noises, snrs,
                                  draws=tuple(np.array(d) for d in draws))
    np.testing.assert_allclose(got["audio"].numpy(), np.asarray(want["audio"]), rtol=0,
                               atol=1e-6 * float(np.abs(np.asarray(want["audio"])).max()))
    np.testing.assert_array_equal(got["labels"].numpy(), labels)
    drawn = ptrain.make_noisy_batch(speech, np.full(b, n), labels, np.full(b, 5), noises, snrs,
                                    generator=torch.Generator().manual_seed(0))
    for i in range(b):
        nz = drawn["audio"][i].numpy() - speech[i]
        snr = 10 * np.log10(np.mean(speech[i] ** 2) / np.mean(nz ** 2))
        assert min(abs(snr - 0.0), abs(snr - 10.0)) < 1e-3, snr


# ------------------------------------------------------------ host utilities

def test_early_stopping_matches_reference():
    seq = [1.0, 0.9, 0.95, 0.92, 0.91, 0.5, 0.6, 0.7]
    for patience, delta in ((2, 0.0), (3, 0.05)):
        ours, ref = ptrain.EarlyStopping(patience, delta), jtrain.EarlyStopping(patience, delta)
        assert [ours.update(v) for v in seq] == [ref.update(v) for v in seq]
        assert (ours.best, ours.count) == (ref.best, ref.count)


@pytest.mark.parametrize("losses", [[1.0, 0.5, 0.7, 0.9, 0.6], [1.0, 1.0, 1.0, 1.0],
                                    [3.0, 2.0, 1.0, 0.5]])
def test_checkpointer_keeps_what_the_reference_keeps(tmp_path, losses):
    """keep=2 over a loss sequence: the same kept steps, best step and
    newest step as the reference's orbax manager; restore(None) gives the
    newest kept step's params and optimizer state back, also through a new
    Checkpointer on the same directory."""
    ours = ptrain.Checkpointer(str(tmp_path / "ours"), keep=2)
    ref = jtrain.Checkpointer(str(tmp_path / "ref"), keep=2)
    params = {"w": torch.zeros(3), "layers": [{"b": torch.zeros(2)}]}
    for step, vl in enumerate(losses):
        p = {"w": torch.full((3,), float(step)), "layers": [{"b": torch.full((2,), -step)}]}
        ours.save(step, p, {"count": step, "mu": {"w": p["w"] * 2}}, vl)
        ref.save(step, {"w": np.full(3, step, np.float32)}, {"c": np.int32(step)}, vl)
        assert sorted(ours._losses) == ref.mngr.all_steps()
        assert ours.best_step == ref.best_step
    for ck in (ours, ptrain.Checkpointer(str(tmp_path / "ours"), keep=2)):
        step, rp, rs = ck.restore(None, params)
        assert step == ref.mngr.latest_step() == len(losses) - 1
        torch.testing.assert_close(rp["w"], torch.full((3,), float(step)), rtol=0, atol=0)
        torch.testing.assert_close(rp["layers"][0]["b"], torch.full((2,), -step), rtol=0,
                                   atol=0)
        assert rs["count"] == step and torch.equal(rs["mu"]["w"], rp["w"] * 2)
    assert ptrain.Checkpointer(str(tmp_path / "empty")).restore(None, params) is None


def test_background_iterator_order_and_errors():
    assert list(background_iterator(range(10), maxsize=3)) == list(range(10))

    def boom():
        yield 1
        raise ValueError("producer failed")

    it = background_iterator(boom())
    assert next(it) == 1
    with pytest.raises(ValueError, match="producer failed"):
        next(it)


def test_background_iterator_starts_eagerly_and_releases_its_producer():
    """Production begins at construction; closing the consumer stops the
    producer; an iterator dropped before its first next() leaves no thread
    behind (the reference's contract, tests/test_train.py)."""
    started = threading.Event()

    def first():
        started.set()
        yield 1

    it = background_iterator(first(), maxsize=2)
    assert started.wait(timeout=5.0)
    assert list(it) == [1]

    produced = []

    def counting():
        for i in range(1000):
            produced.append(i)
            yield i

    it = background_iterator(counting(), maxsize=2)
    assert next(it) == 0
    it.close()
    time.sleep(0.3)
    n_after = len(produced)
    time.sleep(0.2)
    assert len(produced) == n_after < 1000

    before = set(threading.enumerate())
    gen = background_iterator(iter(range(1000)), maxsize=2)
    time.sleep(0.2)
    assert set(threading.enumerate()) - before   # the producer, blocked on a full queue
    del gen
    gc.collect()
    deadline = time.time() + 3.0
    while set(threading.enumerate()) - before and time.time() < deadline:
        time.sleep(0.05)
    assert not set(threading.enumerate()) - before


def test_prefetch_to_device_and_mesh(rng, tmp_path):
    """prefetch_to_device: tensors on the device, host-only "_" keys passed
    through; with a mesh (a world of one gloo rank) the batch's rows through
    shard_batch, the "_" keys dropped. train(mesh=) on that world: bit-equal
    to train() without a mesh (the all-reduce of one rank, divided by 1)."""
    batches = [{"audio": rng.standard_normal((2, 100)).astype(np.float32),
                "audio_lengths": np.array([100, 80], np.int32), "_texts": ["a", "b"]}
               for _ in range(4)]
    out = list(prefetch_to_device(iter(batches), depth=2, device="cpu"))
    assert len(out) == 4
    for src, got in zip(batches, out):
        assert isinstance(got["audio"], torch.Tensor) and got["_texts"] == src["_texts"]
        np.testing.assert_array_equal(got["audio"].numpy(), src["audio"])
        assert got["audio_lengths"].dtype == torch.int32
    cfg = narrow_config()
    params, _ = shared_params(cfg)
    tcfg = pc.TrainConfig(learning_rate=LR, num_epochs=1, freeze_feature_encoder=False)
    batch = _batch(np.random.default_rng(1), b=2)
    want = ptrain.train(params, port_cfg(cfg), tcfg, [batch], [batch])
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        mesh = make_mesh(pc.MeshConfig(), device="cpu")
        meshed = list(prefetch_to_device(iter(batches), depth=2, mesh=mesh))
        got = ptrain.train(params, port_cfg(cfg), tcfg, [batch], [batch], mesh=mesh)
    finally:
        dist.destroy_process_group()
    assert len(meshed) == 4
    for src, b in zip(batches, meshed):
        assert b.keys() == {"audio", "audio_lengths"}
        np.testing.assert_array_equal(b["audio"].numpy(), src["audio"])
        assert b["audio_lengths"].dtype == torch.int32
    assert got[2] == want[2] and np.isfinite(got[2][0]["val_loss"])
    for (name, a), (_, b) in zip(ptrain.named_leaves(got[0]), ptrain.named_leaves(want[0])):
        assert torch.equal(a, b), name
    for part in ("mu", "nu"):
        for name, a in got[1][part].items():
            assert torch.equal(a, want[1][part][name]), f"{part} {name}"


# ------------------------------------------------------- the loop, the CLI

def test_train_synthetic_matches_reference(tmp_path):
    """One epoch of 2 batches of 2 clips of 0.2 s, one validation batch,
    the same params through both packages: equal history (rtol 2e-5),
    equal held-out WER and pairs, the same summary keys; the port's
    checkpoint of the epoch holds the params it returned, and the caller's
    params are untouched."""
    cfg = narrow_config()
    params, ref = shared_params(cfg)
    before = {k: t.clone() for k, t in ptrain.named_leaves(params)}
    kw = dict(learning_rate=LR, num_epochs=1, batch_size=2, freeze_feature_encoder=False,
              snrs_db=())
    args = dict(clip_seconds=0.2, batches_per_epoch=2, val_batches_count=1, target_wer=10.0,
                seed=3)
    jp, want = jsyn.train_synthetic(_xla(cfg), JaxTrainConfig(**kw), params=ref, **args)
    ck = ptrain.Checkpointer(str(tmp_path / "ck"), keep=1)
    p, got = psyn.train_synthetic(port_cfg(cfg), pc.TrainConfig(**kw), params=params,
                                  checkpointer=ck, **args)
    assert got.keys() == want.keys()
    for k in ("final_train_loss", "final_val_loss"):
        np.testing.assert_allclose(got[k], want[k], rtol=2e-5)
    for k in ("epochs_run", "heldout_greedy_wer", "reached_target", "n_eval_utterances"):
        assert got[k] == want[k], k
    assert [list(x) for x in got["example_pairs"]] == [list(x) for x in want["example_pairs"]]
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(_tree_np(jp)),
                            jax.tree.leaves(params_to_jax(p))):
        np.testing.assert_allclose(np.asarray(b), a, rtol=0, atol=0.1 * LR * 2,
                                   err_msg=jax.tree_util.keystr(path))
    _, saved, _ = ck.restore(None, p)
    for (name, t), (_, s) in zip(ptrain.named_leaves(p), ptrain.named_leaves(saved)):
        assert torch.equal(t, s), name
    for name, t in ptrain.named_leaves(params):
        assert torch.equal(t, before[name]), name


def test_cli_train_writes_an_archive_the_reference_reads(tmp_path, capsys):
    out = tmp_path / "trained.npz"
    cli(["train", "--device", "cpu", "--tiny", "--random-init", "--epochs", "1",
         "--batches-per-epoch", "1", "--batch-size", "2", "--clip-seconds", "0.2",
         "--lr", "1e-3", "--seed", "1", "--out", str(out)])
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(summary) == {"epochs_run", "final_train_loss", "final_val_loss",
                            "heldout_greedy_wer", "target_wer", "reached_target",
                            "train_wall_s", "n_eval_utterances", "example_pairs",
                            "params_path"}
    assert summary["params_path"] == str(out) and summary["epochs_run"] == 1
    assert np.isfinite(summary["final_train_loss"])
    cfg = jax_load_config(str(out))
    assert type(cfg).__name__ == "Wav2Vec2Config" and cfg.conv_dim == (32, 32)
    tree = jax_load_params(str(out))
    assert tree["lm_head"]["kernel"].shape == (64, 32)
    assert tree["encoder"]["layers"]["attention"]["q"]["kernel"].shape == (2, 64, 64)
