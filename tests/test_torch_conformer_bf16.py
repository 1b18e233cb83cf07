"""The port's bf16 Wav2Vec2-Conformer (``dtype="bfloat16"``,
``matmul_precision="default"``) against the reference package on the CPU:
the plain versions of the full-bias flash kernels K2f, K3b and K4f against
the reference's Pallas kernels in interpret mode on the same bf16 inputs;
the narrow conformer's logits and one expected-gradients phi; rotary
positions in bf16, which both packages refuse; and ``run-shap`` then
``sweep`` on a bf16 conformer archive. Inputs and params are made by numpy
from a seed; each reference program is jitted once."""

import dataclasses
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain.expected_gradients import expected_gradients as jax_eg
from asr_shap.kernels.flash_attention import flash_attention as jax_flash
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap.models.w2v2_conformer import w2v2_conformer_logits as jax_logits
from asr_shap_torch.cli import main as cli
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.params_io import load_config, save_params
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.kernels import LAUNCHES, flash_attention as fa
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.w2v2_conformer import (
    init_w2v2_conformer_params,
    w2v2_conformer_logits as port_logits,
)
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute
from torch_port_configs import (
    bf16_pair,
    conformer_params,
    jax_draws,
    narrow_conformer_config,
    port_cfg,
)

BF16 = dict(dtype="bfloat16", matmul_precision="default")


@pytest.fixture(scope="module")
def full_bias_outputs():
    """{name: (reference, port)} as float32 numpy: the flash forward with a
    full bias (K2f's o) and its backward (K3b's dq and d(bias), K4f's dk and
    dv) at [1, 2, 37, 32], q, k, v, g and a rel-pos-like [1, 2, 37, 37]
    score bias in bf16 (its last 7 keys at -1e9, as on padded frames), the
    bias requiring grad."""
    rng = np.random.default_rng(0)
    b, h, t, d = 1, 2, 37, 32
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        bf16_pair(rng.standard_normal((b, h, t, d))) for _ in range(4))
    bias = 0.5 * rng.standard_normal((b, h, t, t))
    bias[..., 30:] = -1e9
    bj, bt = bf16_pair(bias)

    @jax.jit
    def reference(q, k, v, s, g):
        o, vjp = jax.vjp(jax_flash, q, k, v, s)
        return (o,) + vjp(g)

    refs = reference(qj, kj, vj, bj, gj)
    qt, kt, vt, bt = (x.requires_grad_() for x in (qt, kt, vt, bt))
    before = dict(LAUNCHES)
    o = fa.flash_attention(qt, kt, vt, bt)
    got = (o,) + torch.autograd.grad(o, (qt, kt, vt, bt), gt)
    assert LAUNCHES == before  # the CPU tensors take the plain versions
    out = {}
    for name, r, p in zip(("K2f o", "K3b dq", "K4f dk", "K4f dv", "K3b dbias"), refs, got):
        # d(bias) in the bias's dtype, as the reference returns it
        assert r.dtype == jnp.bfloat16 and p.dtype == torch.bfloat16, name
        out[name] = (np.asarray(r.astype(jnp.float32)), p.detach().float().numpy())
    return out


# one bf16 ulp apart at most: rtol 2^-7, atol 2^-8 of max|ref| (float32
# sums in another order can round an output to the neighbouring bf16)
@pytest.mark.parametrize("name", ["K2f o", "K3b dq", "K4f dk", "K4f dv", "K3b dbias"])
def test_bf16_full_bias_plain_versions_match_pallas(full_bias_outputs, name):
    ref, got = full_bias_outputs[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -8 * np.abs(ref).max())


@pytest.mark.parametrize("position,lengths", [
    ("relative", None), ("relative", (1600, 1100)), ("none", (1600, 1100))])
def test_bf16_conformer_logits_match_reference(rng, position, lengths):
    """The port's bf16 + "default" logits sit as close to the reference's
    float32 logits as the reference's own bf16 logits do (the mean error at
    most twice theirs), and within 5% of max|logit| of the reference's bf16
    logits; padded at B = 2, the rel-pos bias carries -1e9 on the padded
    keys."""
    cfg32 = narrow_conformer_config(position_embeddings_type=position)
    cfg16 = dataclasses.replace(cfg32, **BF16)
    params, tree = conformer_params(cfg32, 0)
    x = rng.standard_normal((1 if lengths is None else 2, 1600)).astype(np.float32)
    n = None if lengths is None else np.array(lengths)

    @jax.jit
    def reference(p, a, n_):
        return [jax_logits(p, c, a, lengths=n_) for c in (cfg16, cfg32)]

    jax16, jax32 = (np.asarray(v) for v in reference(tree, jnp.asarray(x), n))
    port16 = port_logits(params, port_cfg(cfg16), torch.from_numpy(x),
                         lengths=None if n is None else torch.from_numpy(n))
    assert port16.dtype == torch.float32 and port16.shape == jax16.shape
    port16 = port16.numpy()
    ref_err = np.abs(jax16 - jax32).mean()
    assert 0 < ref_err  # the reference's bf16 path does move the logits
    assert np.abs(port16 - jax32).mean() <= 2 * ref_err
    assert np.abs(port16 - jax16).max() <= 0.05 * np.abs(jax32).max()


def test_bf16_conformer_phi_matches_reference_with_shared_draws(rng):
    """One expected-gradients phi (2 shared draws) at bf16, through the
    kernels' Functions: float32, no further from the reference's float32
    phi than twice the reference's own bf16 phi is, and correlated with the
    reference's bf16 phi (corr >= 0.98) on every frame whose max head is
    defined at bf16: the top two float32 logits at each draw's x_t further
    apart than twice the largest bf16 logit error of either package there.
    Where they are closer, bf16 rounding picks either token, and the
    frame's gradient row is another token's in each package. The float32
    phi and logits are the port's (one reference compile fewer): the
    float32 conformer tests hold them to the reference's
    (test_torch_conformer.py)."""
    cfg32 = narrow_conformer_config()
    cfg16 = dataclasses.replace(cfg32, **BF16)
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=1, output_chunk=0, num_background=3,
                            remat=False)
    params, tree = conformer_params(cfg32, 1)
    x = rng.standard_normal(800).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, 800))).astype(np.float32)
    key = jax.random.key(7)
    draws = jax_draws(key, 2, 3)
    x_t = np.stack([bg[i] + t * (x - bg[i]) for i, t in zip(*(d.numpy() for d in draws))])

    @jax.jit
    def reference(p, a, b, k, xt):
        return jax_eg(jax_make_f(p, cfg16, ec), a, b, k, ec).values, jax_logits(p, cfg16, xt)

    jax16, jlog16 = jax.tree.map(np.asarray, reference(
        tree, jnp.asarray(x), jnp.asarray(bg), key, jnp.asarray(x_t)))
    xt = torch.from_numpy(x_t)
    log32 = port_logits(params, port_cfg(cfg32), xt).numpy()
    log16 = port_logits(params, port_cfg(cfg16), xt).numpy()
    err = np.maximum(np.abs(jlog16 - log32), np.abs(log16 - log32)).max(axis=(0, 2))
    top2 = np.sort(log32, axis=-1)[..., -2:]
    defined = (top2[..., 1] - top2[..., 0]).min(axis=0) > 2 * err      # [T_out]
    pec = pc.ExplainerConfig(**dataclasses.asdict(ec))
    before = dict(LAUNCHES)
    port16, port32 = (expected_phi(make_explained_fn(cast_params_for_compute(params, c.dtype),
                                                     port_cfg(c), pec),
                                   torch.from_numpy(x), torch.from_numpy(bg), config=pec,
                                   draws=draws) for c in (cfg16, cfg32))
    assert LAUNCHES == before
    assert port16.dtype == torch.float32 and port16.shape == jax16.shape
    port16, port32 = port16.numpy(), port32.numpy()
    assert np.isfinite(port16).all()
    assert np.linalg.norm(port16 - port32) <= 2 * np.linalg.norm(jax16 - port32)
    assert defined.mean() >= 0.5  # the gate covers most frames
    corr = np.corrcoef(port16[:, defined].ravel(), jax16[:, defined].ravel())[0, 1]
    assert corr >= 0.98


def test_bf16_conformer_raises():
    """Rotary positions in bf16 raise in both packages: the reference's
    float32 cos and sin promote q and k, and its depthwise conv then meets a
    float32 input and a bf16 kernel (shown by tracing alone)."""
    cfg = narrow_conformer_config(position_embeddings_type="rotary", **BF16)
    params, tree = conformer_params(dataclasses.replace(cfg, dtype="float32"), 0)
    with pytest.raises(TypeError, match="same dtypes"):
        jax.eval_shape(lambda p, a: jax_logits(p, cfg, a), tree,
                       jax.ShapeDtypeStruct((1, 1600), jnp.float32))
    with pytest.raises(NotImplementedError, match="rotary positions in bfloat16"):
        port_logits(params, port_cfg(cfg), torch.zeros(1, 1600))


def test_bf16_conformer_archive_runs_through_cli(tmp_path, capsys):
    """run-shap then sweep on the CPU on a conformer archive whose embedded
    config says bf16 (float32 master params): the CLI takes the dtype from
    the archive; phi is finite and the sweep's rows complete."""
    cfg = pc.Wav2Vec2ConformerConfig(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3), feat_proj_dim=32,
        conv_depthwise_kernel_size=7, attention_impl="pallas", conv_impl="pallas", **BF16)
    archive, d = str(tmp_path / "conformer_bf16.npz"), tmp_path / "data"
    save_params(archive, init_w2v2_conformer_params(5, cfg, device="cpu"), cfg)
    assert load_config(archive) == cfg
    model = ["--device", "cpu", "--params", archive, "--arch", "w2v2-conformer",
             "--data-dir", str(d)]
    before = dict(LAUNCHES)
    cli(["run-shap", *model, "--num-samples", "1", "--snrs", "5", "--min-length", "800",
         "--max-length", "800", "--nsamples", "2"])
    lines = [json.loads(s) for s in capsys.readouterr().out.splitlines() if s.startswith("{")]
    assert lines[-1]["computed"] == 2
    for stem in ("0_clean_inf", "1_noisy_5"):
        phi = np.load(d / f"shap_values_sample_{stem}.npy")
        assert phi.shape == (800, cfg.frames_for_samples(800)) and phi.dtype == np.float32
        assert np.isfinite(phi).all() and np.abs(phi).max() > 0
    cli(["sweep", *model])
    *records, summary = [json.loads(s) for s in capsys.readouterr().out.splitlines()
                         if s.startswith("{")]
    assert LAUNCHES == before
    assert sorted(r["type"] for r in records) == ["clean", "noisy"]
    for r in records:
        assert set(r) == {"index", "type", "snr", "wer", "eta_raw", "reference", "hypothesis"}
        assert np.isfinite(r["wer"]) and np.isfinite(r["eta_raw"])
    assert summary["n"] == 2
