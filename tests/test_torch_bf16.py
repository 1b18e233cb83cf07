"""The port's bf16 mixed-precision path (``dtype="bfloat16"``,
``matmul_precision="default"``) against the reference package on the CPU:
the plain versions of K1-K4 against the reference's Pallas kernels in
interpret mode on the same bf16 inputs; the narrow model's logits and one
expected-gradients phi; the precision switches; the params cast; and
``python -m asr_shap_torch bench``. Inputs are made by numpy from a seed;
each reference program is jitted once."""

import dataclasses
import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap.explain.expected_gradients import expected_gradients as jax_eg
from asr_shap.kernels.conv_dgrad import conv1d_dgrad as jax_conv1d_dgrad
from asr_shap.kernels.flash_attention import flash_attention as jax_flash
from asr_shap.models.heads import make_explained_fn as jax_make_f
from asr_shap.models.wav2vec2 import cast_params_for_compute as jax_cast
from asr_shap.models.wav2vec2 import wav2vec2_logits as jax_logits
from asr_shap_torch import cli
from asr_shap_torch.core import config as port_config
from asr_shap_torch.core import device as port_device
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.kernels import LAUNCHES, conv_dgrad, flash_attention as fa
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute, wav2vec2_logits
from asr_shap_torch.pipeline import benchmarks
from torch_port_configs import bf16_pair, jax_draws, narrow_config, port_cfg, shared_params

BF16 = dict(dtype="bfloat16", matmul_precision="default")


@pytest.fixture(scope="module")
def kernel_outputs():
    """{name: (reference, port)} as float32 numpy: K1's xbar at [2, 20, 128]
    (K = 3, s = 2), and the flash forward (K2's o) and backward (K3's dq,
    K4's dk and dv) at [1, 2, 37, 32] with a bf16 key mask, all bf16."""
    rng = np.random.default_rng(0)
    out = {}
    k, s, t_out, c = 3, 2, 20, 128
    t_in = (t_out - 1) * s + k
    yj, yt = bf16_pair(rng.standard_normal((2, t_out, c)))
    wj, wt = bf16_pair(rng.standard_normal((k, c, c)) * 0.1)
    b, h, t, d = 1, 2, 37, 32
    (qj, qt), (kj, kt), (vj, vt), (gj, gt) = (
        bf16_pair(rng.standard_normal((b, h, t, d))) for _ in range(4))
    mask = np.zeros((b, 1, 1, t), np.float32)
    mask[..., 30:] = -1e9
    mj, mt = bf16_pair(mask)

    @jax.jit
    def reference(y, w, q, k_, v, g, m):
        o, vjp = jax.vjp(lambda *qkv: jax_flash(*qkv, m), q, k_, v)
        return (jax_conv1d_dgrad(y, w, s, t_in), o) + vjp(g)

    ref, o_ref, dq_ref, dk_ref, dv_ref = reference(yj, wj, qj, kj, vj, gj, mj)
    got = conv_dgrad.conv1d_dgrad(yt, wt, s, t_in)
    assert ref.dtype == jnp.bfloat16 and got.dtype == torch.bfloat16
    out["K1 xbar"] = (ref, got)
    qt, kt, vt = (x.requires_grad_() for x in (qt, kt, vt))
    o = fa.flash_attention(qt, kt, vt, mt)
    dq, dk, dv = torch.autograd.grad(o, (qt, kt, vt), gt)
    for name, r, p in (("K2 o", o_ref, o), ("K3 dq", dq_ref, dq), ("K4 dk", dk_ref, dk),
                       ("K4 dv", dv_ref, dv)):
        assert r.dtype == jnp.bfloat16 and p.dtype == torch.bfloat16, name
        out[name] = (r, p)
    return {name: (np.asarray(r.astype(jnp.float32)), p.detach().float().numpy())
            for name, (r, p) in out.items()}


# one bf16 ulp apart at most: rtol 2^-7, atol 2^-8 of max|ref| (float32
# sums in another order can round an output to the neighbouring bf16)
@pytest.mark.parametrize("name", ["K1 xbar", "K2 o", "K3 dq", "K4 dk", "K4 dv"])
def test_bf16_plain_versions_match_pallas(kernel_outputs, name):
    ref, got = kernel_outputs[name]
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=2 ** -7, atol=2 ** -8 * np.abs(ref).max())


def test_bf16_logits_match_reference(rng):
    """The port's bf16 + "default" logits sit as close to the reference's
    float32 logits as the reference's own bf16 logits do (the mean error at
    most twice theirs), and within 5% of max|logit| of the reference's bf16
    logits."""
    cfg16, cfg32 = narrow_config(**BF16), narrow_config()
    params, jparams = shared_params(cfg32)
    x = rng.standard_normal((1, 4000)).astype(np.float32)
    jlog = jax.jit(jax_logits, static_argnums=1)
    jax16 = np.asarray(jlog(jparams, cfg16, jnp.asarray(x)))
    jax32 = np.asarray(jlog(jparams, cfg32, jnp.asarray(x)))
    port16 = wav2vec2_logits(params, port_cfg(cfg16), torch.from_numpy(x))
    assert port16.dtype == torch.float32 and port16.shape == jax16.shape
    port16 = port16.numpy()
    ref_err = np.abs(jax16 - jax32).mean()
    assert 0 < ref_err  # the reference's bf16 path does move the logits
    assert np.abs(port16 - jax32).mean() <= 2 * ref_err
    assert np.abs(port16 - jax16).max() <= 0.05 * np.abs(jax32).max()


def test_bf16_phi_matches_reference_with_shared_draws(rng):
    """One expected-gradients phi (2 shared draws) at bf16: float32, no
    further from the reference's float32 phi than twice the reference's
    own bf16 phi is, and correlated with the reference's bf16 phi
    (corr >= 0.98) on every frame whose max head is defined at bf16: the
    top two float32 logits at each draw's x_t more than 0.05 apart, twice
    the reference's own largest bf16 logit error (0.025 at this config).
    Where they are closer, bf16 rounding picks either token, and the
    frame's gradient row is another token's in each package."""
    cfg16, cfg32 = narrow_config(**BF16), narrow_config()
    ec = JaxExplainerConfig(nsamples=2, draw_chunk=1, output_chunk=0, num_background=3,
                            remat=False)
    params, jparams = shared_params(cfg32)
    x = rng.standard_normal(1600).astype(np.float32)
    bg = (0.01 * rng.standard_normal((3, 1600))).astype(np.float32)
    key = jax.random.key(7)
    draws = jax_draws(key, 2, 3)
    x_t = np.stack([bg[i] + t * (x - bg[i]) for i, t in zip(*(d.numpy() for d in draws))])

    @jax.jit
    def ref_phi(p, a, b, k):
        return [jax_eg(jax_make_f(p, c, ec), a, b, k, ec).values for c in (cfg16, cfg32)]

    jax16, jax32 = (np.asarray(v) for v in ref_phi(jparams, jnp.asarray(x),
                                                     jnp.asarray(bg), key))
    # the float32 logits at x_t (the port's, equal to the reference's within 1e-4)
    logits = wav2vec2_logits(params, port_cfg(cfg32), torch.from_numpy(x_t))
    top2 = logits.sort(dim=-1).values[..., -2:].numpy()
    defined = (top2[..., 1] - top2[..., 0]).min(axis=0) > 0.05      # [T_out]
    pec = port_config.ExplainerConfig(**dataclasses.asdict(ec))
    port16 = expected_phi(make_explained_fn(cast_params_for_compute(params, "bfloat16"),
                                            port_cfg(cfg16), pec),
                          torch.from_numpy(x), torch.from_numpy(bg), config=pec, draws=draws)
    assert port16.dtype == torch.float32 and port16.shape == jax16.shape
    port16 = port16.numpy()
    assert np.isfinite(port16).all()
    assert np.linalg.norm(port16 - jax32) <= 2 * np.linalg.norm(jax16 - jax32)
    assert defined.mean() >= 0.5  # the gate covers most frames
    corr = np.corrcoef(port16[:, defined].ravel(), jax16[:, defined].ravel())[0, 1]
    assert corr >= 0.98


def test_float32_default_precision_equals_highest_and_reference(rng):
    """On the CPU "default" changes nothing for float32 (TF32 is a CUDA
    switch): the port's logits equal its "highest" ones, and the
    reference's "default" ones within the float32 model tolerance."""
    cfg_d = narrow_config(matmul_precision="default")
    params, jparams = shared_params(cfg_d)
    x = rng.standard_normal((1, 1600)).astype(np.float32)
    out_d = wav2vec2_logits(params, port_cfg(cfg_d), torch.from_numpy(x))
    out_h = wav2vec2_logits(params, port_cfg(narrow_config()), torch.from_numpy(x))
    assert torch.equal(out_d, out_h)
    ref = np.asarray(jax.jit(jax_logits, static_argnums=1)(jparams, cfg_d, jnp.asarray(x)))
    np.testing.assert_allclose(out_d.numpy(), ref, atol=1e-4, rtol=1e-3)


@pytest.mark.parametrize("precision,switches", [("highest", (False, False, False)),
                                                ("default", (True, True, True))])
def test_precision_scope_sets_and_restores_switches(precision, switches):
    m, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn

    def read():
        return (m.allow_tf32, cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction)

    saved = read()
    try:
        outside = tuple(not s for s in switches)
        m.allow_tf32, cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction = outside
        assert not port_device.precision_active(precision)
        with port_device.matmul_precision_scope(precision):
            assert read() == switches
            assert port_device.precision_active(precision)
        assert read() == outside
    finally:
        m.allow_tf32, cudnn.allow_tf32, m.allow_bf16_reduced_precision_reduction = saved
    with pytest.raises(NotImplementedError, match="matmul_precision"):
        with port_device.matmul_precision_scope("bfloat16_3x"):
            pass


def test_cast_params_gives_reference_leaf_dtypes():
    params, jparams = shared_params(narrow_config())
    for dtype in ("bfloat16", "float32"):
        ref = {str(a.dtype) for a in jax.tree.leaves(jax_cast(jparams, jnp.dtype(dtype)))}
        got = {str(t.dtype).replace("torch.", "")
               for t in jax.tree.leaves(cast_params_for_compute(params, dtype))}
        assert ref == got == {dtype}
    once = cast_params_for_compute(params, "bfloat16")
    # a leaf already in the compute dtype is returned as it is
    assert cast_params_for_compute(once, "bfloat16")["lm_head"]["kernel"] is (
        once["lm_head"]["kernel"])
    assert cast_params_for_compute(params, "float32") is params


def test_bench_cli_writes_reference_rows(tmp_path, capsys):
    out = tmp_path / "bench.json"
    before = dict(LAUNCHES)
    cli.main(["bench", "--device", "cpu", "--tiny", "--lengths", "1600", "--nsamples", "2",
              "--json", str(out)])
    assert LAUNCHES == before
    rows = json.loads(out.read_text())
    assert [set(r) for r in rows] == [{"length", "t_frames", "nsamples", "wall_s",
                                       "compile_s", "passes_per_s", "status"}]
    assert rows[0]["status"] == "ok" and rows[0]["length"] == 1600
    assert rows[0]["t_frames"] == 159 and rows[0]["nsamples"] == 2
    assert "passes/s" in capsys.readouterr().out


def test_bench_propagates_what_is_not_an_oom(monkeypatch):
    """Only an out-of-memory error becomes a "failed" row; any other
    exception (a kernel that does not launch) leaves run_length_sweep."""
    def broken(*args, **kw):
        raise RuntimeError("kernel launch failed")

    monkeypatch.setattr(benchmarks, "expected_phi", broken)
    cfg = port_config.Wav2Vec2Config(
        hidden_size=64, num_hidden_layers=2, num_attention_heads=2, intermediate_size=128,
        conv_dim=(32, 32), conv_stride=(5, 2), conv_kernel=(10, 3),
        num_conv_pos_embeddings=16, num_conv_pos_embedding_groups=4, feat_proj_dim=32)
    with pytest.raises(RuntimeError, match="kernel launch failed"):
        benchmarks.run_length_sweep(lengths=(1600,), nsamples=1, model_config=cfg,
                                    device="cpu")
    # --plot draws where matplotlib imports, and refuses before any work
    # where it does not
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    with pytest.raises(ImportError, match="plot"):
        cli.main(["bench", "--device", "cpu", "--tiny", "--plot", "runtime.png"])
