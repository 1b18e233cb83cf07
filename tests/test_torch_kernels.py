"""The port's kernels (asr_shap_torch/kernels) against the reference Pallas
kernels run in interpret mode. On the CPU each wrapper takes its plain
PyTorch version, inside the same autograd Functions and vmap rules that the
CUDA path uses. Inputs are made by numpy from a seed and handed to both
packages."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from asr_shap.kernels.conv_dgrad import conv1d_dgrad as jax_conv1d_dgrad
from asr_shap.kernels.flash_attention import flash_attention as jax_flash
from asr_shap.models.wav2vec2 import _conv1d as jax_conv1d
from asr_shap_torch.kernels import LAUNCHES, _build, conv_dgrad, flash_attention as fa
from torch_port_configs import bf16_pair


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


# conv dgrad: atol 2e-3 / rtol 1e-4, the reference kernel test's tolerance
# (float32 sums over K*C = up to 640 products taken in another order)
@pytest.mark.parametrize("k,s,t", [(3, 2, 498), (2, 2, 61), (5, 3, 200)])
def test_conv_dgrad_plain_matches_pallas(rng, k, s, t):
    c = 128
    w = rng.standard_normal((k, c, c)).astype(np.float32) * 0.1
    t_out = (t - k) // s + 1
    ybar = rng.standard_normal((2, t_out, c)).astype(np.float32)
    ref = np.asarray(jax_conv1d_dgrad(jnp.asarray(ybar), jnp.asarray(w), s, t))
    out = conv_dgrad.conv1d_dgrad(_t(ybar), _t(w), s, t)
    assert out.shape == (2, t, c)
    np.testing.assert_allclose(out.numpy(), ref, atol=2e-3, rtol=1e-4)


def test_conv_dgrad_vmapped_rows_match_pallas(rng):
    """The explainer's pattern: one-hot cotangent rows vmapped through the
    VJP of the kernel's Function (the vmap rule folds them into B)."""
    k, s, t, c = 3, 2, 340, 128
    x = rng.standard_normal((1, t, c)).astype(np.float32)
    w = rng.standard_normal((k, c, c)).astype(np.float32) * 0.1

    def jax_rows():
        f = lambda a: jax_conv1d(a, jnp.asarray(w), stride=s, impl="pallas").sum(-1)[0]
        y, vjp_fn = jax.vjp(f, jnp.asarray(x))
        return jax.vmap(lambda e: vjp_fn(e)[0])(jnp.eye(y.shape[0], dtype=y.dtype))

    wt = _t(w)
    f = lambda a: conv_dgrad.conv1d(a, wt, s).sum(-1)[0]
    y, vjp_fn = torch.func.vjp(f, _t(x))
    rows = torch.func.vmap(lambda e: vjp_fn(e)[0])(torch.eye(y.shape[0]))
    np.testing.assert_allclose(rows.numpy(), np.asarray(jax_rows()), atol=2e-3, rtol=1e-4)
    # forward is F.conv1d; it must match lax.conv
    np.testing.assert_allclose(
        conv_dgrad.conv1d(_t(x), wt, s).numpy(),
        np.asarray(jax_conv1d(jnp.asarray(x), jnp.asarray(w), stride=s, impl="lax")),
        atol=2e-4, rtol=1e-5)


# bf16 conv dgrad: one bf16 ulp (rtol 2^-7, atol 2^-8 x max|ref|), the card
# check's gate for the bf16 kernel (float32 sums in another order may round
# to the neighbouring bf16)
@pytest.mark.parametrize("k,s", [(3, 2), (2, 2), (5, 3)])
@pytest.mark.parametrize("t_out", [1, 7])
def test_conv_dgrad_bf16_plain_matches_pallas(rng, k, s, t_out):
    """The bf16 plain version, which the card holds the bf16 kernel to,
    against the Pallas kernel in interpret mode on bf16 inputs: 3 clips,
    tiny T (one output row, and a tile that ends ragged) and s - 1 rows past
    the taps' reach, which must be zero."""
    c, b = 128, 3
    t_in = (t_out - 1) * s + k + s - 1
    yj, yt = bf16_pair(rng.standard_normal((b, t_out, c)))
    wj, wt = bf16_pair(rng.standard_normal((k, c, c)) * 0.1)
    ref = jax_conv1d_dgrad(yj, wj, s, t_in)
    assert ref.dtype == jnp.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    out = conv_dgrad.conv1d_dgrad(yt, wt, s, t_in)
    assert out.dtype == torch.bfloat16 and out.shape == (b, t_in, c)
    out = out.float().numpy()
    np.testing.assert_allclose(out, ref, atol=2.0 ** -8 * np.abs(ref).max(), rtol=2.0 ** -7)
    assert not out[:, (t_out - 1) * s + k:].any()


def test_conv_dgrad_wrapper_rejects_what_the_kernel_cannot_take():
    w = torch.zeros(3, 128, 128)
    with pytest.raises(ValueError):
        conv_dgrad.conv1d_dgrad(torch.zeros(1, 10, 128), w, 2, 30)  # T_out mismatch
    with pytest.raises(ValueError):
        conv_dgrad.conv1d_dgrad(torch.zeros(1, 10, 128, device="meta"),
                                w.to("meta"), 2, 21)
    assert not conv_dgrad.eligible(1, 512, 5, 1, 0)      # C_in = 1 first layer
    assert not conv_dgrad.eligible(48, 768, 1, 16, 64)   # grouped, padded pos conv
    assert conv_dgrad.eligible(512, 512, 2, 1, 0)


@pytest.mark.parametrize("scale", [1.0, 1e3])
def test_conv_dgrad_3xtf32_keeps_the_card_checks_tolerance(rng, scale):
    """The numeric contract of the tensor-core kernels: operands split by
    ``tf32_split`` (cvt.rna rounding) and summed as lo*hi + hi*lo + hi*hi
    stay within the card check's K1 tolerance of float64 (atol 5e-4 x the
    input scale, rtol 1e-4), with at most twice plain float32's error; one
    TF32 product (hi*hi alone) does not. K = 3, s = 2, C = 512, He-scaled
    weights, as on the main path."""
    one = torch.tensor([1 + 2.0 ** -11, -(1 + 2.0 ** -11), 1 + 2.0 ** -11 - 2.0 ** -23],
                       dtype=torch.float64).float()
    assert conv_dgrad.tf32_round(one).tolist() == [1 + 2.0 ** -10, -(1 + 2.0 ** -10), 1.0]
    k, s, c, t_out = 3, 2, 512, 16
    t_in = (t_out - 1) * s + k
    ybar = _t(rng.standard_normal((2, t_out, c)) * scale)
    w = _t(rng.standard_normal((k, c, c)) * (2.0 / (k * c)) ** 0.5)
    ref = conv_dgrad.conv1d_dgrad_plain(ybar.double(), w.double(), s, t_in)
    yh, yl = conv_dgrad.tf32_split(ybar)
    wh, wl = conv_dgrad.tf32_split(w)
    for part in (yh, yl, wh, wl):  # every operand is a TF32 value
        assert torch.equal(conv_dgrad.tf32_round(part), part)
    dgrad = lambda a, b: conv_dgrad.conv1d_dgrad_plain(a, b, s, t_in).double()
    three = dgrad(yl, wh) + dgrad(yh, wl) + dgrad(yh, wh)
    one_product = dgrad(yh, wh)
    f32 = dgrad(ybar, w)

    def excess(x):  # > 0: outside atol + rtol * |ref|
        return float(((x - ref).abs() - 1e-4 * ref.abs()).max()) - 5e-4 * scale

    assert excess(three) <= 0
    assert float((three - ref).abs().max()) <= 2 * float((f32 - ref).abs().max())
    assert excess(one_product) > 0


def _qkv(rng, b, h, t, d):
    return [rng.standard_normal((b, h, t, d)).astype(np.float32) for _ in range(3)]


def _mask(t, valid):
    m = (np.arange(t)[None, :] < np.asarray(valid)[:, None])
    return np.where(m, 0.0, -1e9).astype(np.float32)[:, None, None, :]


# flash forward: rtol 2e-4 / atol 2e-5, the reference kernel test's tolerance
@pytest.mark.parametrize("t,masked", [(49, False), (70, False), (90, True)])
def test_flash_forward_matches_pallas(rng, t, masked):
    q, k, v = _qkv(rng, 2, 3, t, 64)
    bias = _mask(t, [t, t - 30]) if masked else None
    ref = np.asarray(jax_flash(*map(jnp.asarray, (q, k, v)),
                               None if bias is None else jnp.asarray(bias),
                               interpret=True))
    out = fa.flash_attention(_t(q), _t(k), _t(v), None if bias is None else _t(bias))
    np.testing.assert_allclose(out.numpy(), ref, rtol=2e-4, atol=2e-5)


# flash backward: rtol 5e-4 / atol 5e-5, the reference kernel test's tolerance
@pytest.mark.parametrize("masked", [False, True])
def test_flash_backward_matches_pallas(rng, masked):
    b, h, t, d = 2, 2, 50, 32
    q, k, v = _qkv(rng, b, h, t, d)
    bias = _mask(t, [t, 30]) if masked else None

    def jloss(q_, k_, v_):
        o = jax_flash(q_, k_, v_, None if bias is None else jnp.asarray(bias),
                      interpret=True)
        return jnp.sum(jnp.sin(o))

    ref = jax.grad(jloss, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    tb = None if bias is None else _t(bias).requires_grad_()
    torch.sin(fa.flash_attention(tq, tk, tv, tb)).sum().backward()
    for got, want in zip((tq.grad, tk.grad, tv.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    if tb is not None:  # a mask is a constant on the kernel path
        assert torch.count_nonzero(tb.grad) == 0


def test_flash_vmapped_backward_matches_pallas(rng):
    """The Jacobian by a vmapped VJP, as the explainer takes it: cotangent
    rows fold into the kernels' leading dim through FlashBackward's rule."""
    b, h, t, d = 1, 2, 40, 32
    q, k, v = _qkv(rng, b, h, t, d)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    def jf(x):
        return jax_flash(jq + x, jk, jv, None, interpret=True).sum(axis=(0, 1, 3))

    _, jvjp = jax.vjp(jf, jnp.zeros_like(jq))
    ref = jax.vmap(lambda ct: jvjp(ct)[0])(jnp.eye(t))

    tq, tk, tv = _t(q), _t(k), _t(v)
    f = lambda x: fa.flash_attention(tq + x, tk, tv).sum(dim=(0, 1, 3))
    _, vjp_fn = torch.func.vjp(f, torch.zeros_like(tq))
    jac = torch.func.vmap(lambda ct: vjp_fn(ct)[0])(torch.eye(t))
    np.testing.assert_allclose(jac.numpy(), np.asarray(ref), rtol=5e-4, atol=5e-5)


def _mm_3xtf32(a, b):
    """a @ b as the tensor-core kernels take it: operands split by
    ``tf32_split``, lo*hi + hi*lo, then hi*hi, in float32."""
    ah, al = conv_dgrad.tf32_split(a)
    bh, bl = conv_dgrad.tf32_split(b)
    return (al @ bh + ah @ bl) + ah @ bh


def _mm_tf32(a, b):
    """a @ b in one TF32 product (hi*hi alone)."""
    return conv_dgrad.tf32_round(a) @ conv_dgrad.tf32_round(b)


def _flash_backward(q, k, v, o, lse, g, bias, mm_scores, mm):
    """K3's dq and K4's dk, dv, then ds (K3b's d(bias)), with the scores'
    product ``mm_scores`` and every other product (dP, dq, dk, dv)
    ``mm``; g [V, BH, T, D] reads residual row BH, as in the kernels;
    ``bias`` a [T] key mask or a full [BH, T, T] score bias."""
    scale = q.shape[-1] ** -0.5
    p = torch.exp(mm_scores(q * scale, k.transpose(1, 2)) + bias - lse[..., None])
    dd = (g * o).sum(-1)
    ds = p * (mm(g, v.transpose(1, 2)) - dd[..., None])
    return (scale * mm(ds, k), mm(ds.transpose(-1, -2), q * scale),
            mm(p.transpose(1, 2), g), ds)


# the mask cases keep their ids; "full" is a [BH, T, T] score bias (K3b, K4f)
@pytest.mark.parametrize("full,masked", [
    pytest.param(False, False, id="False"), pytest.param(False, True, id="True"),
    pytest.param(True, False, id="full-False"), pytest.param(True, True, id="full-True")])
def test_flash_backward_3xtf32_keeps_the_card_checks_tolerance(rng, full, masked):
    """The numeric contract of the tensor-core K3 and K4 (and of K3b and
    K4f, with a full bias): scores, dP, dq, dk and dv each in 3xTF32 stay
    within the card check's backward tolerance of float64 (atol 5e-5, rtol
    5e-4), with at most twice plain float32's error, and so does d(bias) =
    ds with a full bias; one TF32 product for dP, dq, dk and dv (the scores
    still in 3xTF32) does not. T = 149, D = 64, as on the main paths; BH = 2
    with 4 cotangent rows per residual row; the bias a key mask of zeros or
    a unit-normal [BH, T, T] score bias; ``masked``: the last 29 keys at
    -1e9."""
    bh, t, d, rows = 2, 149, 64, 4
    q, k, v = (_t(rng.standard_normal((bh, t, d))) for _ in range(3))
    g = _t(rng.standard_normal((rows, bh, t, d)))
    bias = _t(rng.standard_normal((bh, t, t))) if full else torch.zeros(t)
    if masked:
        bias[..., t - 29:] = -1e9
    o64, lse64 = fa.flash_fwd_plain(q.double(), k.double(), v.double(),
                                    bias.double() if full else bias.double()[None], bh)
    ref = _flash_backward(q.double(), k.double(), v.double(), o64, lse64, g.double(),
                          bias.double(), torch.matmul, torch.matmul)
    args = (q, k, v, o64.float(), lse64.float(), g, bias)
    three = _flash_backward(*args, _mm_3xtf32, _mm_3xtf32)
    f32 = _flash_backward(*args, torch.matmul, torch.matmul)
    one_product = _flash_backward(*args, _mm_3xtf32, _mm_tf32)
    held = 4 if full else 3  # ds is an output (d(bias)) only with a full bias

    def excess(x, want):  # > 0: outside atol + rtol * |want|
        return float(((x.double() - want).abs() - 5e-4 * want.abs()).max()) - 5e-5

    for got, plain, want in list(zip(three, f32, ref))[:held]:
        assert excess(got, want) <= 0
        assert (float((got.double() - want).abs().max())
                <= 2 * float((plain.double() - want).abs().max()))
    assert all(excess(x, want) > 0 for x, want in list(zip(one_product, ref))[:held])


def _mm_bf16_split(a, b):
    """a @ b as the bf16 backward kernels take it, b bf16-valued: a split by
    ``bf16_split`` into two bf16 terms, lo.b + hi.b, in float32 (a bf16 a
    has lo = 0: one bf16 product)."""
    hi, lo = fa.bf16_split(a)
    return lo @ b + hi @ b


def _mm_bf16_one(a, b):
    """a @ b with a rounded to one bf16 term (hi alone)."""
    return fa.bf16_split(a)[0] @ b


@pytest.mark.parametrize("full,masked", [
    pytest.param(False, False, id="False"), pytest.param(False, True, id="True"),
    pytest.param(True, False, id="full-False"), pytest.param(True, True, id="full-True")])
def test_flash_backward_bf16_split_keeps_the_card_checks_gate(rng, full, masked):
    """The numeric contract of the bf16 K3 and K4 (and of K3b and K4f, with
    a full bias): q, k, v, g and o rounded to bf16; bf16 x bf16 products
    (the scores, dP) in float32; p, p^T and ds split by ``bf16_split`` into
    two bf16 terms for dq, dk and dv. Against float64 on the same bf16
    inputs, dq, dk and dv rounded to bf16 stay within 1.25x the plain
    version's error (the plain version: float32 products, outputs rounded
    to bf16) and d(bias) = ds within 2x: the card check's gates
    (``chip_smoke.py``, BF16_F64_RATIO and BF16_F32_OUT_RATIO). With p and
    ds rounded to one bf16 term, an output of each case exceeds 1.25x.
    T = 149, D = 64; BH = 2 with 4 cotangent rows per residual row; the bias
    a key mask of zeros or a unit-normal [BH, T, T] score bias; ``masked``:
    the last 29 keys at -1e9."""
    bh, t, d, rows = 2, 149, 64, 4
    r16 = lambda shape: _t(rng.standard_normal(shape)).to(torch.bfloat16).float()
    q, k, v = (r16((bh, t, d)) for _ in range(3))
    g = r16((rows, bh, t, d))
    bias = _t(rng.standard_normal((bh, t, t))) if full else torch.zeros(t)
    if masked:
        bias[..., t - 29:] = -1e9
    o64, lse64 = fa.flash_fwd_plain(q.double(), k.double(), v.double(),
                                    bias.double() if full else bias.double()[None], bh)
    o64 = o64.to(torch.bfloat16).double()  # the kernels take o in bf16
    ref = _flash_backward(q.double(), k.double(), v.double(), o64, lse64, g.double(),
                          bias.double(), torch.matmul, torch.matmul)
    args = (q, k, v, o64.float(), lse64.float(), g, bias)
    runs = {"two": _flash_backward(*args, torch.matmul, _mm_bf16_split),
            "one": _flash_backward(*args, torch.matmul, _mm_bf16_one),
            "plain": _flash_backward(*args, torch.matmul, torch.matmul)}

    def err(run, i):  # dq, dk, dv rounded to bf16 as the kernels store them
        x = runs[run][i]
        x = x.to(torch.bfloat16) if i < 3 else x
        return float((x.double() - ref[i]).abs().max())

    for i in range(3):
        assert err("two", i) <= 1.25 * err("plain", i)
    if full:  # d(bias) = ds is an output only with a full bias
        assert err("two", 3) <= 2 * err("plain", 3)
    assert max(err("one", i) / err("plain", i) for i in range(3)) > 1.25


def _flash_forward_bf16(q, k, v, bias, mm, splits=4):
    """o and lse as the bf16 K2 (K2f) computes them, in float32: scores
    (q.k^T) * scale + bias; each of ``splits`` warps takes every
    ``splits``-th 16-key tile, with its own row max m_w, p = exp(s - m_w),
    l_w = sum p and O_w = ``mm``(p, v); then o = sum_w e^(m_w - M) O_w / L
    and lse = M + log L, M = max_w m_w, L = sum_w e^(m_w - M) l_w."""
    s = (q @ k.transpose(1, 2)) * q.shape[-1] ** -0.5 + bias
    tile = torch.arange(q.shape[1]) // 16
    parts = []
    for w in range(splits):
        keys = tile % splits == w
        m = s[..., keys].amax(-1, keepdim=True)
        p = torch.exp(s[..., keys] - m)
        parts.append((m, p.sum(-1, keepdim=True), mm(p, v[:, keys])))
    m_all = torch.stack([m for m, _, _ in parts]).amax(0)
    l_all = sum(torch.exp(m - m_all) * l for m, l, _ in parts)
    o = sum(torch.exp(m - m_all) * o_w for m, _, o_w in parts) / l_all
    return o, (m_all + torch.log(l_all))[..., 0]


@pytest.mark.parametrize("full,masked", [
    pytest.param(False, False, id="False"), pytest.param(False, True, id="True"),
    pytest.param(True, False, id="full-False"), pytest.param(True, True, id="full-True")])
def test_flash_forward_bf16_split_keeps_the_card_checks_gate(rng, full, masked):
    """The numeric contract of the bf16 K2 (and of K2f, with a full bias):
    q, k, v rounded to bf16; bf16 x bf16 scores in float32; each of four
    key splits' p split by ``bf16_split`` into two bf16 terms for p.v; the
    splits merged in float32 and o rounded to bf16. Against float64 on the
    same bf16 inputs, o stays within 1.25x the plain version's error (the
    plain version: float32 products, o rounded to bf16) and lse within 2x:
    the card check's gates (``chip_smoke.py``, BF16_F64_RATIO and
    BF16_F32_OUT_RATIO). With p rounded to one bf16 term, o exceeds 1.25x
    in the case with neither a full bias nor masked keys (1.30x; in the
    other three cases one term stayed at 1.00x on these inputs, but the
    card checks more shapes and inputs, so the kernel takes two terms).
    T = 149, D = 64, BH = 2; the bias a key mask of zeros or a unit-normal
    [BH, T, T] score bias; ``masked``: the last 29 keys at -1e9."""
    bh, t, d = 2, 149, 64
    r16 = lambda shape: _t(rng.standard_normal(shape)).to(torch.bfloat16).float()
    q, k, v = (r16((bh, t, d)) for _ in range(3))
    bias = _t(rng.standard_normal((bh, t, t))) if full else torch.zeros(t)
    if masked:
        bias[..., t - 29:] = -1e9
    kernel_bias = bias if full else bias[None]
    o64, lse64 = fa.flash_fwd_plain(q.double(), k.double(), v.double(), kernel_bias.double(), bh)
    runs = {"plain": fa.flash_fwd_plain(*(x.to(torch.bfloat16) for x in (q, k, v)),
                                        kernel_bias, bh),
            "two": _flash_forward_bf16(q, k, v, bias, _mm_bf16_split),
            "one": _flash_forward_bf16(q, k, v, bias, _mm_bf16_one)}

    def err(run, i):  # o rounded to bf16, as the kernel stores it; lse float32
        x = runs[run][i]
        x = x.to(torch.bfloat16) if i == 0 else x
        return float((x.double() - (o64, lse64)[i]).abs().max())

    assert runs["plain"][0].dtype == torch.bfloat16
    assert err("two", 0) <= 1.25 * err("plain", 0)
    assert err("two", 1) <= 2 * err("plain", 1)
    if not full and not masked:
        assert err("one", 0) > 1.25 * err("plain", 0)


def _full_bias(rng, shape, masked_keys=0):
    """A random score bias; the last ``masked_keys`` keys of batch entry 0
    get -1e9, as the conformer's rel + mask does on a padded clip."""
    bias = rng.standard_normal(shape).astype(np.float32)
    if masked_keys:
        bias[0, ..., -masked_keys:] = -1e9
    return bias


# full score bias: forward rtol 2e-4 / atol 2e-5, gradients rtol 5e-4 /
# atol 5e-5, the reference kernel tests' tolerances
@pytest.mark.parametrize("kind", ["masked", "broadcast"])
def test_flash_full_bias_matches_pallas(rng, kind):
    """Forward and dq/dk/dv/d(bias) of a differentiable score bias: a
    [B, H, T, T] bias with -1e9 entries on batch entry 0 (entry 1 is a
    plain full bias), and a [1, H, T, T] bias whose cotangent must come
    back in its own shape."""
    b, h, t, d = 2, 2, 40, 32
    q, k, v = _qkv(rng, b, h, t, d)
    shape = (1, h, t, t) if kind == "broadcast" else (b, h, t, t)
    bias = _full_bias(rng, shape, masked_keys=13 if kind == "masked" else 0)

    def jloss(q_, k_, v_, b_):
        o = jax_flash(q_, k_, v_, b_, interpret=True)
        return jnp.sum(jnp.sin(o)), o

    jargs = tuple(map(jnp.asarray, (q, k, v, bias)))
    ref, ref_out = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3), has_aux=True))(*jargs)
    tq, tk, tv, tb = (_t(a).requires_grad_() for a in (q, k, v, bias))
    out = fa.flash_attention(tq, tk, tv, tb)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref_out), rtol=2e-4, atol=2e-5)
    torch.sin(out).sum().backward()
    assert tb.grad.shape == bias.shape
    for got, want in zip((tq.grad, tk.grad, tv.grad, tb.grad), ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)
    if kind == "masked":
        assert torch.count_nonzero(tb.grad[0, ..., -13:]) == 0


def test_flash_vmapped_backward_with_dbias_matches_pallas(rng):
    """The explainer's batched VJP through a full bias: the cotangent rows
    fold into the kernels' leading dim through FlashBackward's rule, and
    d(bias) comes back with the vmapped axis first, [V, B, H, T, T].
    Tolerance rtol 5e-4 / atol 5e-5, as the reference kernel tests."""
    b, h, t, d = 1, 2, 40, 32
    q, k, v = _qkv(rng, b, h, t, d)
    bias = _full_bias(rng, (b, h, t, t), masked_keys=9)
    jq, jk, jv = map(jnp.asarray, (q, k, v))

    @jax.jit  # one compiled program: the eager interpret path costs seconds
    def jac_ref(x, b_):
        jf = lambda x_, bb: jax_flash(jq + x_, jk, jv, bb, interpret=True).sum(axis=(0, 1, 3))
        _, jvjp = jax.vjp(jf, x, b_)
        return jax.vmap(jvjp)(jnp.eye(t))

    ref = jac_ref(jnp.zeros_like(jq), jnp.asarray(bias))

    tq, tk, tv = _t(q), _t(k), _t(v)
    f = lambda x, b_: fa.flash_attention(tq + x, tk, tv, b_).sum(dim=(0, 1, 3))
    _, vjp_fn = torch.func.vjp(f, torch.zeros_like(tq), _t(bias))
    jac = torch.func.vmap(vjp_fn)(torch.eye(t))
    assert jac[1].shape == (t, b, h, t, t)
    for got, want in zip(jac, ref):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4, atol=5e-5)


def test_flash_plain_kernels_fold_cotangent_rows(rng):
    """dq/dkv with V cotangents per residual row equal V separate calls."""
    bh, t, d, heads = 4, 33, 32, 2
    q, k, v = (_t(a) for a in _qkv(rng, 1, bh, t, d))
    q, k, v = q[0], k[0], v[0]
    bias = _t(_mask(t, [t, 20]))[:, 0, 0, :]
    o, lse = fa.flash_fwd(q, k, v, bias, heads)
    g = _t(rng.standard_normal((3 * bh, t, d)))
    dq, dd, dbias = fa.flash_dq(q, k, v, o, lse, g, bias, heads)
    assert dbias is None  # a mask has no d(bias) output
    dk, dv = fa.flash_dkv(q, k, v, lse, g, dd, bias, heads)
    for i in range(3):
        gi = g[i * bh:(i + 1) * bh]
        dq_i, dd_i, _ = fa.flash_dq(q, k, v, o, lse, gi, bias, heads)
        dk_i, dv_i = fa.flash_dkv(q, k, v, lse, gi, dd_i, bias, heads)
        for got, want in ((dq, dq_i), (dk, dk_i), (dv, dv_i)):
            torch.testing.assert_close(got[i * bh:(i + 1) * bh], want)


def test_flash_wrappers_reject_what_the_kernels_cannot_take():
    q = torch.zeros(4, 10, 32)
    lse = torch.zeros(4, 10)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_dq(q, q, q, q, lse[:, :9], torch.zeros(8, 10, 32), None, 2)
    with pytest.raises(ValueError, match="divide"):
        fa.flash_dq(q, q, q, q, lse, torch.zeros(6, 10, 32), None, 2)
    with pytest.raises(ValueError, match="bias"):
        fa.flash_fwd(q, q, q, torch.zeros(4, 10), 2)
    with pytest.raises(ValueError, match="device"):
        meta = q.to("meta")
        fa.flash_fwd(meta, meta, meta, None, 2)


@pytest.mark.parametrize("nvcc_ok", [True, False])
def test_build_starts_one_nvcc_per_source_and_reuses_libraries(tmp_path, monkeypatch,
                                                               nvcc_ok):
    """The build logic with a stand-in nvcc that records its arguments and
    writes its -o file (or fails): one process per source, sm_90a, results
    reused by content hash, failures raised with the compiler's output."""
    calls = tmp_path / "calls"
    nvcc = tmp_path / "cuda" / "bin" / "nvcc"
    nvcc.parent.mkdir(parents=True)
    body = ('while [ $# -gt 0 ]; do [ "$1" = -o ] && { shift; : > "$1"; }; shift; done'
            if nvcc_ok else 'echo "error: no card"; exit 2')
    nvcc.write_text(f'#!/bin/sh\necho "$@" >> "{calls}"\n{body}\n')
    nvcc.chmod(0o755)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "cuda"))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    if not nvcc_ok:
        with pytest.raises(RuntimeError, match="no card"):
            _build.build_all()
        return
    paths = _build.build_all()
    assert sorted(paths) == ["conv_dgrad", "conv_dgrad_bf16", "flash_attention",
                             "flash_bwd_bf16", "flash_fwd_bf16", "gemm_tf32x3"]
    assert all(p.exists() and p.parent == tmp_path / "build" for p in paths.values())
    lines = calls.read_text().splitlines()
    assert len(lines) == 6 and all("arch=compute_90a,code=sm_90a" in l for l in lines)
    assert _build.build_all() == paths
    assert len(calls.read_text().splitlines()) == 6


@pytest.mark.parametrize("shape", [(2, 16), (2, 1, 16)])
def test_kernel_attention_refuses_other_bias_ranks(rng, monkeypatch, shape):
    """Under impl="pallas" a bias the kernels cannot take raises; it never
    falls back to the plain math."""
    from asr_shap_torch.ops import attention

    def no_plain(*args):
        raise AssertionError("the plain attention ran under impl='pallas'")

    monkeypatch.setattr(attention, "_xla_attention", no_plain)
    q, k, v = (_t(a) for a in _qkv(rng, 2, 2, 16, 32))
    with pytest.raises(NotImplementedError, match="bias"):
        attention.multi_head_attention(q, k, v, torch.zeros(shape), impl="pallas")


def test_cpu_path_counts_no_launches(rng):
    before = dict(LAUNCHES)
    q, k, v = (_t(a) for a in _qkv(rng, 1, 2, 16, 32))
    fa.flash_attention(q, k, v)
    assert LAUNCHES == before
    # a full score bias runs its plain versions on the CPU, forward and
    # backward with d(bias), and counts no launch either
    q.requires_grad_()
    bias = _t(rng.standard_normal((1, 2, 16, 16))).requires_grad_()
    fa.flash_attention(q, k, v, bias).sum().backward()
    assert bias.grad.shape == bias.shape and torch.isfinite(bias.grad).all()
    assert LAUNCHES == before
