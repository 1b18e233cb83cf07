"""Expected gradients' draw chunks and per-layer remat in the port, against
the reference package on the CPU.

A chunk's draws go through one ``vmap(f)`` forward and one vmapped VJP of
its cotangent rows; the kernels' Functions fold the draws into their batch
(``FlashAttention``'s and ``Conv1d``'s vmap rules) and the rows outside
them (``FlashBackward``'s). ``remat`` recomputes each encoder layer in the
backward (``ops/remat.py``). The port runs its kernel path (the plain
versions inside the same Functions and rules on the CPU); the reference
runs its XLA impls (the Pallas kernels' math, which the port's other tests
hold in interpret mode), with ``remat=True``, each program jitted once. The
draws are the reference's, derived from its key path. Params and inputs are
made by numpy from a seed.
"""

import dataclasses
import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import ConformerConfig as JaxConformerConfig
from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain.expected_gradients import expected_gradients as jax_eg
from asr_shap.models.conformer import conformer_logits as jax_conformer_logits
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap_torch.audio.normalize import zero_mean_unit_var
from asr_shap_torch.core import config as pc
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.kernels import LAUNCHES
from asr_shap_torch.kernels.conv_dgrad import Conv1d, conv1d_forward
from asr_shap_torch.kernels.flash_attention import FlashAttention
from asr_shap_torch.models.conformer import conformer_logits
from asr_shap_torch.models.heads import aggregation_head, make_explained_fn
from asr_shap_torch.models.w2v2_conformer import w2v2_conformer_logits
from asr_shap_torch.models.wav2vec2 import (
    cast_params_for_compute,
    feature_lengths,
    wav2vec2_logits,
)
from asr_shap_torch.ops import remat as remat_mod
from asr_shap_torch.ops.attention import _xla_attention
from asr_shap_torch.ops.ctc import ctc_loss
from asr_shap_torch.pipeline import train as ptrain
from torch_port_configs import (
    conformer_params,
    jax_draws,
    mel_conformer_params,
    narrow_conformer_config,
    narrow_config,
    port_cfg,
    shared_params,
)

N = 400            # samples: T_out = 19 on the narrow Wav2Vec2 families
DRAWS = 4
MEL_T, MEL_F = 24, 16
BF16 = dict(dtype="bfloat16", matmul_precision="default")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """The narrow models' ops are small: one thread runs them faster than a
    pool contending with the other test workers."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _xla(cfg):
    if isinstance(cfg, JaxConformerConfig):
        return dataclasses.replace(cfg, attention_impl="xla")
    return dataclasses.replace(cfg, attention_impl="xla", conv_impl="lax")


def _mel_config():
    """The mel Conformer with rel-pos attention (the full-bias Functions)."""
    return JaxConformerConfig(vocab_size=17, input_dim=MEL_F, hidden_size=64, num_layers=2,
                              num_attention_heads=2, ffn_expansion=2, conv_kernel_size=7,
                              pos_encoding="relative", attention_impl="pallas")


@functools.lru_cache(maxsize=None)
def _family(name):
    """(reference config, port params, reference params, x, background)."""
    rng = np.random.default_rng(3)
    if name == "mel":
        cfg = _mel_config()
        params, tree = mel_conformer_params(cfg, 0)
        n = MEL_T * MEL_F
    else:
        cfg = narrow_conformer_config() if name == "conformer" else narrow_config()
        if name == "conformer":
            params, tree = conformer_params(cfg, 0)
            tree = jax.tree.map(jnp.asarray, tree)
        else:
            params, tree = shared_params(cfg)
        n = N
    x = rng.standard_normal(n).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, n))).astype(np.float32)
    return cfg, params, tree, x, bg


def _mel_f(logits_fn, params, cfg, remat):
    return lambda a: aggregation_head(
        logits_fn(params, cfg, a.reshape(MEL_T, MEL_F), remat=remat), "max")


@functools.lru_cache(maxsize=None)
def _reference(name, numerics=()):
    """The reference's phi with remat=True (its default policy, "full")
    over DRAWS draws of key 7, one chunk; ``numerics`` as (field, value)
    pairs of the model config."""
    cfg, _, tree, x, bg = _family(name)
    cfg = dataclasses.replace(_xla(cfg), **dict(numerics))
    ec = JaxExplainerConfig(nsamples=DRAWS, draw_chunk=DRAWS, output_chunk=0,
                            num_background=3, remat=True)
    if name == "mel":
        f = lambda a: jnp.max(jax_conformer_logits(tree, cfg, a.reshape(MEL_T, MEL_F),
                                                   remat=True), axis=-1)
    else:
        f = jax_make_f(tree, cfg, ec)
    out = jax.jit(lambda a, b, k: jax_eg(f, a, b, k, ec).values)(
        jnp.asarray(x), jnp.asarray(bg), jax.random.key(7))
    return np.asarray(out)


def _port_phi(name, draw_chunk, output_chunk, remat=True, policy="full", numerics=()):
    """The port's phi over the same draws (each setting computed once)."""
    return _port_phi_once(name, draw_chunk, output_chunk, remat, policy, numerics)


@functools.lru_cache(maxsize=None)
def _port_phi_once(name, draw_chunk, output_chunk, remat, policy, numerics):
    cfg, params, _, x, bg = _family(name)
    pcfg = dataclasses.replace(port_cfg(cfg), **dict(numerics))
    ec = pc.ExplainerConfig(nsamples=DRAWS, draw_chunk=draw_chunk, output_chunk=output_chunk,
                            num_background=3, remat=remat)
    if name == "mel":
        f = _mel_f(conformer_logits, params, pcfg, remat)
    else:
        pcfg = dataclasses.replace(pcfg, remat_policy=policy)
        f = make_explained_fn(cast_params_for_compute(params, pcfg.dtype), pcfg, ec)
    before = dict(LAUNCHES)
    phi = expected_phi(f, torch.from_numpy(x), torch.from_numpy(bg), config=ec,
                       draws=jax_draws(jax.random.key(7), DRAWS, 3))
    assert LAUNCHES == before  # the CPU path never launches a kernel
    assert phi.dtype == torch.float32
    return phi.numpy()


# float32: against the reference within 2e-3 of max|phi| (float32 through 2
# layers, another summation order in every product: the port's other phi
# tests' tolerance); against the port's own draw_chunk 1 within 1e-5 of
# max|phi| (the same products, the chunk's sums in another order). bf16:
# no further from the reference's float32 phi than twice the reference's
# own bf16 phi is (test_torch_bf16.py's rule), and within 2e-2 of max|phi|
# of the port's bf16 draw_chunk 1 (bf16 products batched in another shape).
@pytest.mark.parametrize("name,dtype,draw_chunk,output_chunk", [
    ("wav2vec2", "float32", 2, 0), ("wav2vec2", "float32", 4, 3),
    ("wav2vec2", "bfloat16", 2, 3), ("wav2vec2", "bfloat16", 4, 0),
    ("conformer", "float32", 2, 0)])
def test_chunked_phi_matches_reference(name, dtype, draw_chunk, output_chunk):
    numerics = tuple(BF16.items()) if dtype == "bfloat16" else ()
    got = _port_phi(name, draw_chunk, output_chunk, numerics=numerics)
    one = _port_phi(name, 1, 0, numerics=numerics)
    want32 = _reference(name)
    assert got.shape == want32.shape
    assert np.isfinite(got).all()
    scale = np.abs(want32).max()
    if dtype == "float32":
        np.testing.assert_allclose(got, want32, rtol=0, atol=2e-3 * scale)
        np.testing.assert_allclose(got, one, rtol=0, atol=1e-5 * np.abs(one).max())
    else:
        want16 = _reference(name, numerics)
        assert np.linalg.norm(got - want32) <= 2 * np.linalg.norm(want16 - want32)
        np.testing.assert_allclose(got, one, rtol=0, atol=2e-2 * np.abs(one).max())


# Against the reference's remat=True within 2e-3 of max|phi| (as above;
# its "dots" policy gives its "full" values, so "full" is the yardstick of
# both); against the port's remat=False within 1e-6 of max|phi| (the
# recompute repeats the forward's products exactly; on the CPU it is
# bit-equal).
@pytest.mark.parametrize("name,policy", [("wav2vec2", "full"), ("wav2vec2", "dots"),
                                         ("conformer", "dots"), ("mel", "full")])
def test_remat_matches_reference(name, policy):
    got = _port_phi(name, 2, 0, remat=True, policy=policy)
    plain = _port_phi(name, 2, 0, remat=False)
    want = _reference(name)
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-3 * np.abs(want).max())
    np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * np.abs(plain).max())


def test_remat_policy_unknown_raises():
    cfg, params, _, x, _ = _family("wav2vec2")
    bad = dataclasses.replace(port_cfg(cfg), remat_policy="offload")
    with pytest.raises(ValueError, match="remat_policy"):
        wav2vec2_logits(params, bad, torch.from_numpy(x)[None], remat=True)


def test_train_step_with_remat_equals_without(monkeypatch):
    """The training loss asks for remat (one recompute per layer and step)
    and its gradients equal those of the same loss without remat, within
    1e-6 of each leaf's max|g| (bit-equal on the CPU)."""
    cfg, params, _, _, _ = _family("conformer")
    pcfg = port_cfg(cfg)
    rng = np.random.default_rng(1)
    batch = {"audio": torch.from_numpy(rng.standard_normal((2, N)).astype(np.float32)),
             "audio_lengths": torch.tensor([N, N - 80]),
             "labels": torch.from_numpy(rng.integers(5, 32, (2, 4)).astype(np.int32)),
             "label_lengths": torch.tensor([4, 3])}
    tcfg = pc.TrainConfig()
    calls = []
    backward = remat_mod.Recompute.backward

    def counted(ctx, *grads):
        calls.append(1)
        return backward(ctx, *grads)

    monkeypatch.setattr(remat_mod.Recompute, "backward", staticmethod(counted))
    loss, grads = ptrain.make_loss_and_grads(pcfg, tcfg)(params, batch)
    assert len(calls) == cfg.num_hidden_layers

    leaves = ptrain.trainable_leaves(params, tcfg)
    for t in leaves.values():
        t.requires_grad_(True)
    try:
        lengths = batch["audio_lengths"]
        logits = w2v2_conformer_logits(params, pcfg, zero_mean_unit_var(batch["audio"], lengths),
                                       lengths=lengths, remat=False)
        plain_loss = ctc_loss(logits, feature_lengths(pcfg, lengths), batch["labels"],
                              batch["label_lengths"])
        plain = torch.autograd.grad(plain_loss, list(leaves.values()), allow_unused=True)
    finally:
        for t in leaves.values():
            t.requires_grad_(False)
    assert len(calls) == cfg.num_hidden_layers
    assert float(loss) == float(plain_loss.detach())
    for (key, g), p in zip(grads.items(), plain):
        p = torch.zeros_like(g) if p is None else p
        torch.testing.assert_close(g, p, rtol=0, atol=1e-6 * float(p.abs().max()) + 1e-30,
                                   msg=key)


def _attention_inputs(case, v=3, b=2, h=2, t=9, d=8):
    g = torch.Generator().manual_seed(11)
    q, k, val = (torch.randn(v, b, h, t, d, generator=g) for _ in range(3))
    if case == "no bias":
        bias = None
    elif case == "mask":       # per draw and clip
        bias = torch.where(torch.arange(t) < torch.tensor([[t], [t - 3]])[None], 0.0,
                           -1e9).expand(v, b, t)[:, :, None, None, :].clone()
    elif case == "shared mask":
        bias = torch.where(torch.arange(t) < t - 2, 0.0, -1e9)[None, None, None, :]
    else:                      # "full bias": depends on the draw, as rel-pos scores do
        bias = torch.randn(v, b, h, t, t, generator=g)
    return q, k, val, bias


# The vmap rules against a loop over the vmapped axis through the plain
# math (ops.attention._xla_attention, F.conv1d): outputs, and the Jacobian
# rows of a vmapped VJP (the explainer's order: the VJP of the vmapped
# forward, its cotangent rows vmapped outside; and a vmapped VJP whose
# rows are vmapped inside, as a layer recomputed under the draws' vmap
# meets them). float32 at rtol 1e-4, atol 1e-5 (another summation order
# and the flash form of the softmax).
@pytest.mark.parametrize("case", ["no bias", "mask", "shared mask", "full bias", "conv1d"])
def test_vmap_rules_match_loop(case):
    tol = dict(rtol=1e-4, atol=1e-5)
    if case == "conv1d":
        g = torch.Generator().manual_seed(12)
        x = torch.randn(3, 2, 21, 4, generator=g)
        w = torch.randn(3, 4, 5, generator=g)
        fn = lambda a: Conv1d.apply(a, w, 2)
        plain = lambda a: conv1d_forward(a, w, 2)
        args = (x,)
    else:
        q, k, val, bias = _attention_inputs(case)
        shared = case == "shared mask"
        fn = lambda a, b_, c, *bb: FlashAttention.apply(a, b_, c, bb[0] if bb else bias)[0]
        plain = lambda a, b_, c, *bb: _xla_attention(a, b_, c, bb[0] if bb else bias)
        args = (q, k, val) + (() if shared or bias is None else (bias,))
    nv = args[0].shape[0]
    y = torch.func.vmap(fn)(*args)
    want = torch.stack([plain(*(a[i] for a in args)) for i in range(nv)])
    torch.testing.assert_close(y, want, **tol)

    rows = torch.randn(4, *y.shape, generator=torch.Generator().manual_seed(13))
    _, vjp_fn = torch.func.vjp(torch.func.vmap(fn), *args)
    outer = torch.func.vmap(vjp_fn)(rows)
    inner = torch.func.vmap(
        lambda *a: torch.func.vmap(torch.func.vjp(fn, *a[:-1])[1])(a[-1]),
        in_dims=(0,) * len(args) + (1,))(*args, rows)
    for j in range(len(args)):
        if case == "mask" and j == 3:
            continue  # the kernel path's mask is a constant, the plain math's is not
        want_j = torch.stack([torch.stack([
            torch.func.vjp(plain, *(a[i] for a in args))[1](rows[r, i])[j]
            for i in range(nv)]) for r in range(rows.shape[0])])
        torch.testing.assert_close(outer[j], want_j, **tol)
        torch.testing.assert_close(inner[j].transpose(0, 1), want_j, **tol)
