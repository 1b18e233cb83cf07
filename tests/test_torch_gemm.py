"""The 3xTF32 input-gradient GEMM (asr_shap_torch/kernels/gemm.py) and the
route of ``ops/remat.py::dot`` to it, on the CPU: the plain version, the
vmap rule under the explainer's nested vjp and vmaps, the shape rule at
every linear of the benchmark's configurations and their tensor-parallel
shards, the routing predicate, and the kernel's arithmetic emulated."""

import dataclasses
import json
import types
from pathlib import Path

import numpy as np
import pytest
import torch

from asr_shap_torch.core import config as port_config
from asr_shap_torch.core.config import ExplainerConfig
from asr_shap_torch.core.device import matmul_precision_scope
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.kernels import LAUNCHES, conv_dgrad, gemm
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params
from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params
from asr_shap_torch.ops import remat
from asr_shap_torch.parallel.tp import shard_params_tp

CONFIGS = Path(__file__).resolve().parent.parent / "shapbench" / "configs"
INITS = {"Wav2Vec2Config": init_wav2vec2_params,
         "Wav2Vec2ConformerConfig": init_w2v2_conformer_params}


def _t(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape).astype(np.float32))


@pytest.fixture
def on_card(monkeypatch):
    """``gemm.takes`` with CPU tensors standing in for the card's, and the
    launcher replaced by a recorder of its operands that runs the plain
    version: the route and the folds, with no card."""
    calls = []
    takes = gemm.takes

    def card(t):
        return types.SimpleNamespace(device=torch.device("cuda"), dtype=t.dtype)

    def launch(a, b):
        calls.append(a)
        return gemm.gemm_nt_plain(a, b)

    monkeypatch.setattr(gemm, "takes", lambda g, w: takes(card(g), w))
    monkeypatch.setattr(gemm, "gemm_nt", launch)
    return calls


@pytest.mark.parametrize("shape", [(5, 12), (3, 4, 12), (0, 12)])
def test_plain_version_is_matmul(rng, shape):
    a, b = _t(rng, *shape), _t(rng, 8, 12)
    want = a @ b.T
    assert torch.equal(gemm.gemm_nt(a.reshape(-1, 12), b), want.reshape(-1, 8))
    assert torch.equal(gemm.GemmNT.apply(a, b), want)
    with pytest.raises(ValueError, match="K"):
        gemm.gemm_nt(a.reshape(-1, 12), b[:, :8])
    with pytest.raises(ValueError, match="device"):
        gemm.gemm_nt(a.reshape(-1, 12).to("meta"), b.to("meta"))


@pytest.mark.parametrize("policy", [None, "full", "dots"])
def test_vmap_rule_folds_rows_and_draws_into_one_launch(rng, on_card, policy):
    """The explainer's structure, vjp of vmap(f) over the draws then vmap
    over the cotangent rows, through ``dot`` (bare, or in a layer under
    remat "full" or "dots"): one launch per product per backward call, its
    M every row of every draw, folded from the cotangent as a view, and the
    same input gradients as ``x @ w`` through the same transforms."""
    draws, b, t, n_in, n_out, rows = 3, 2, 5, 12, 8, 4
    w1, w2 = _t(rng, n_in, n_out), _t(rng, n_out, n_out)
    x = _t(rng, draws, b, t, n_in)
    cts = _t(rng, rows, draws, b, t, n_out)

    def layer(h, w1, w2, mm):
        return mm(torch.tanh(mm(h, w1)), w2)

    def model(mm):
        if policy is None:
            return lambda h: layer(h, w1, w2, mm)
        return lambda h: remat.checkpoint_layer(
            lambda h, p: layer(h, p["w1"], p["w2"], mm), h, (), {"w1": w1, "w2": w2},
            policy)

    def jacobian(mm):
        _, vjp_fn = torch.func.vjp(torch.func.vmap(model(mm)), x)
        return torch.func.vmap(lambda ct: vjp_fn(ct)[0])(cts)

    with matmul_precision_scope("highest"):
        got = jacobian(remat.dot)
    want = jacobian(torch.matmul)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
    assert [tuple(a.shape) for a in on_card] == [(rows * draws * b * t, n_out)] * 2
    # the outer product's cotangent is the rows' own tensor, read in place
    assert on_card[0].data_ptr() == cts.data_ptr()


@pytest.mark.parametrize("family,policy", [("Wav2Vec2Config", "full"),
                                           ("Wav2Vec2ConformerConfig", "full"),
                                           ("Wav2Vec2ConformerConfig", "dots")])
def test_one_launch_per_linear_and_backward_call(rng, on_card, monkeypatch, family, policy):
    """Expected gradients through the model (2 draw chunks, the rows in 2
    backward calls, remat on): each backward call launches the GEMM once
    for each linear at an eligible shape (lm_head [16, 30] is not: K = 30)
    but the rel-pos projection of the constant position table, and nothing
    else does; phi equals the run with every product on torch.matmul."""
    cfg = getattr(port_config, family)(
        hidden_size=16, num_hidden_layers=2, num_attention_heads=2, intermediate_size=32,
        vocab_size=30, conv_dim=(8, 8), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_conv_pos_embeddings=8, num_conv_pos_embedding_groups=2, feat_proj_dim=8,
        remat_policy=policy)
    params = INITS[family](0, cfg, device="cpu")
    x, bg = _t(rng, 800), _t(rng, 3, 800) * 0.01
    ec = ExplainerConfig(nsamples=4, num_background=3, draw_chunk=2,
                         output_chunk=-(-cfg.frames_for_samples(800) // 2))
    draws = (torch.tensor([0, 2, 1, 2]), torch.tensor([0.2, 0.9, 0.5, 0.7]))
    f = make_explained_fn(params, cfg, ec)
    with matmul_precision_scope("highest"):
        phi = expected_phi(f, x, bg, config=ec, draws=draws)
        launches = len(on_card)
        monkeypatch.setattr(gemm, "takes", lambda g, w: False)
        want = expected_phi(f, x, bg, config=ec, draws=draws)
    # per layer q, k, v, out and the FFN's two (the conformer: a second FFN,
    # pw1 and pw2; not pos), and the feature projection
    per_layer = 10 if family == "Wav2Vec2ConformerConfig" else 6
    assert launches == 2 * 2 * (per_layer * cfg.num_hidden_layers + 1)
    torch.testing.assert_close(phi, want, rtol=1e-5, atol=1e-6 * float(want.abs().max()))


def test_vmap_rule_moves_a_last_vmapped_dim_and_refuses_batched_weights(rng):
    a, b = _t(rng, 6, 12), _t(rng, 8, 12)
    out = torch.func.vmap(gemm.GemmNT.apply, in_dims=(1, None))(a.T.contiguous(), b)
    torch.testing.assert_close(out, a @ b.T)
    with pytest.raises(NotImplementedError, match="batched weights"):
        torch.func.vmap(gemm.GemmNT.apply, in_dims=(None, 0))(a, torch.stack([b, b]))


@pytest.mark.parametrize("name", ["wav2vec2-base-960h",
                                  "wav2vec2-conformer-rel-pos-large-960h-ft"])
def test_every_linear_of_the_benchmark_configs_is_eligible(name):
    """Every linear weight (a 2-D kernel) of the configuration at its
    published widths, and of its tensor-parallel shards over 2 and 4 model
    ranks, is a shape the kernel takes (one layer: depth changes no
    shape)."""
    spec = json.loads((CONFIGS / f"{name}.json").read_text())
    arch = {k: tuple(v) if isinstance(v, list) else v for k, v in spec["arch"].items()}
    cfg = dataclasses.replace(getattr(port_config, spec["port_config"])(**arch),
                              num_hidden_layers=1)
    params = INITS[spec["port_config"]](0, cfg, device="cpu")
    trees = [params] + [shard_params_tp(params, types.SimpleNamespace(model_size=mp,
                                                                     model_rank=0))
                        for mp in (2, 4)]
    shapes = set()

    def walk(node):
        if isinstance(node, dict):
            for key, value in node.items():
                if key == "kernel" and torch.is_tensor(value) and value.ndim == 2:
                    shapes.add(tuple(value.shape))
                else:
                    walk(value)
        elif isinstance(node, (list, tuple)):
            for value in node:
                walk(value)

    for tree in trees:
        walk(tree)
    h = cfg.hidden_size
    assert {(h, h), (h, cfg.intermediate_size), (cfg.intermediate_size, h),
            (cfg.feat_proj_dim, h), (h, cfg.vocab_size)} <= shapes
    assert all(gemm.eligible(*s) for s in shapes), sorted(shapes)


def test_route_takes_only_float32_on_the_card_under_highest():
    def t(device, dtype, shape=(4,)):
        return types.SimpleNamespace(device=torch.device(device), dtype=dtype,
                                     ndim=len(shape), shape=shape)

    w = t("cuda", torch.float32, (768, 3072))
    g = t("cuda", torch.float32)
    with matmul_precision_scope("highest"):
        assert gemm.takes(g, w)
        assert not gemm.takes(t("cpu", torch.float32), t("cpu", torch.float32, (768, 3072)))
        assert not gemm.takes(t("cuda", torch.bfloat16), t("cuda", torch.bfloat16, (768, 3072)))
        assert not gemm.takes(t("cuda", torch.float16), t("cuda", torch.float16, (768, 3072)))
        assert not gemm.takes(g, t("cuda", torch.float32, (768, 30)))
    with matmul_precision_scope("default"):
        assert not gemm.takes(g, w)


@pytest.mark.parametrize("dtype,precision,routed", [
    (torch.float32, "highest", True), (torch.bfloat16, "highest", False),
    (torch.float32, "default", False)])
def test_dot_routes_only_the_input_gradient(rng, on_card, dtype, precision, routed):
    """Plain autograd through ``dot`` (training's case): the input gradient
    goes to the kernel for float32 under "highest" only; the weight gradient
    never does, and both equal ``x @ w``'s."""
    x = _t(rng, 2, 5, 12).to(dtype).requires_grad_()
    w = _t(rng, 12, 8).to(dtype).requires_grad_()
    g = _t(rng, 2, 5, 8).to(dtype)
    with matmul_precision_scope(precision):
        remat.dot(x, w).backward(g)
    assert len(on_card) == int(routed)
    if routed:
        assert tuple(on_card[0].shape) == (10, 8) and on_card[0].data_ptr() == g.data_ptr()
    want_x, want_w = torch.autograd.grad(x @ w, (x, w), g)
    torch.testing.assert_close(x.grad, want_x)
    torch.testing.assert_close(w.grad, want_w)


@pytest.mark.parametrize("weight_grad", [False, True])
def test_dot_keeps_its_input_only_for_a_weight_gradient(rng, on_card, weight_grad):
    """``Dot`` saves ``x`` for its backward only where the weight takes a
    gradient (training), as autograd's own matmul does; the explainer's
    input gradients keep the weight alone."""
    x = _t(rng, 2, 5, 12).requires_grad_()
    w = _t(rng, 12, 8).requires_grad_(weight_grad)
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t) or t, lambda t: t):
        with matmul_precision_scope("highest"):
            y = remat.dot(x, w)
    assert [t.data_ptr() for t in saved] == [x.data_ptr()] * weight_grad + [w.data_ptr()]
    g = _t(rng, 2, 5, 8)
    with matmul_precision_scope("highest"):
        y.backward(g)
    torch.testing.assert_close(x.grad, g @ w.detach().T)
    if weight_grad:
        torch.testing.assert_close(w.grad, x.detach().reshape(10, 12).T @ g.reshape(10, 8))


def test_cpu_path_counts_no_launches(rng):
    before = dict(LAUNCHES)
    x = _t(rng, 3, 12).requires_grad_()
    with matmul_precision_scope("highest"):
        remat.dot(x, _t(rng, 12, 8)).sum().backward()
    assert LAUNCHES == before and LAUNCHES["gemm_tf32x3"] == 0


def test_3xtf32_emulation_keeps_float32_accuracy(rng):
    """The kernel's arithmetic at a 768 x 3072 product (N x K): operands
    split by ``tf32_split``, per 32-wide step lo*hi + hi*lo, then hi*hi from
    a zero partial, added to the running sum in float32, is no further from
    float64 than the plain float32 product is, x2; one TF32 product (hi*hi
    alone) is far outside that."""
    m, n, k = 16, 768, 3072
    a = _t(rng, m, k)
    b = _t(rng, n, k) * (1.0 / k) ** 0.5
    ref = a.double() @ b.double().T
    (ah, al), (bh, bl) = conv_dgrad.tf32_split(a), conv_dgrad.tf32_split(b)
    acc = torch.zeros(m, n)
    for k0 in range(0, k, 32):
        s = slice(k0, k0 + 32)
        acc += (al[:, s] @ bh[:, s].T + ah[:, s] @ bl[:, s].T) + ah[:, s] @ bh[:, s].T
    f32_err = float((a @ b.T - ref).abs().max())
    assert float((acc - ref).abs().max()) <= 2 * f32_err
    assert float((ah @ bh.T - ref).abs().max()) > 2 * f32_err
