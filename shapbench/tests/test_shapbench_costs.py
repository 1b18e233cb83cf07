"""The yardstick's arithmetic: the copies in ``costs.py`` equal
``chip_smoke.py``'s formulas, reproduce the bounds of PERF.md's kernel
table, and the FLOP count of a draw equals a count by hand."""

import pytest

import chip_smoke
from shapbench import costs, registry
from shapbench.reference import w2v2_conformer, wav2vec2

SHAPES = [(12, 12 * 149, 149, 64), (16, 16 * 149, 149, 64), (96, 96 * 64, 149, 64),
          (48, 48 * 64, 312, 64)]


@pytest.mark.parametrize("bh,n,t,d", SHAPES)
def test_cost_copies_equal_chip_smoke(bh, n, t, d):
    assert costs.flash_costs(bh, n, t, d) == chip_smoke.flash_costs(bh, n, t, d)
    assert costs.bf16_flash_costs(bh, n, t, d) == chip_smoke.bf16_flash_costs(bh, n, t, d)
    for kind in ("fwd", "dq", "dkv"):
        for full in (False, True):
            assert (costs.flash_cost(kind, bh, n, t, d, "float32", full)
                    == chip_smoke.flash_cost(kind, bh, n, t, d, chip_smoke.torch.float32, full))
            assert (costs.flash_cost(kind, bh, n, t, d, "bfloat16", full)
                    == chip_smoke.flash_cost(kind, bh, n, t, d, chip_smoke.BF16, full))
    args = (n, 3, 2, 512, 512, 2 * t + 1, t)
    assert costs.k1_cost(*args) == chip_smoke.k1_cost(*args)
    for f in ("bound", "bound_bf16", "bound_3xtf32"):
        assert getattr(costs, f)(1e12, 1e9) == getattr(chip_smoke, f)(1e12, 1e9)


def _one_draw(cell):
    """The least ms per draw of K1 and of each flash backward kernel at one
    draw (draw_chunk 1, output_chunk 0): PERF.md's table rows."""
    wl, cfg, _ = registry.cell(cell)
    arch, dtype = cfg["arch"], wl["numerics"]["dtype"]
    t, h = wl["t_out"], arch["num_attention_heads"]
    k1 = 0.0
    for k, s, ci, co, ti, to in costs.dgrad_layers(arch, wl["clips"]["samples"]):
        fl, nb = costs.k1_cost(t, k, s, ci, co, ti, to)
        k1 += costs.kernel_bound(fl, nb / 2 if dtype == "bfloat16" else nb, dtype)[0]
    full = arch.get("position_embeddings_type") == "relative"
    layers = arch["num_hidden_layers"]
    flash = {kind: layers * costs.kernel_bound(*costs.flash_cost(
        kind, h, t * h, t, arch["hidden_size"] // h, dtype, full), dtype)[0]
        for kind in ("dq", "dkv")}
    return k1, flash


def test_bounds_reproduce_the_kernel_table():
    k1, flash = _one_draw("eg-w2v2-base-f32-3s")
    assert round(k1, 2) == 13.20
    assert (round(flash["dq"], 3), round(flash["dkv"], 3)) == (0.742, 1.111)
    k1, flash = _one_draw("eg-w2v2-conformer-f32-3s")
    assert (round(flash["dq"], 3), round(flash["dkv"], 3)) == (2.858, 2.963)
    k1, flash = _one_draw("eg-w2v2-base-bf16-3s")
    assert round(k1, 2) == 2.20
    assert (round(flash["dq"], 3), round(flash["dkv"], 3)) == (0.251, 0.373)


def test_clip_plan_counts_the_launches():
    wl, cfg, _ = registry.cell("eg-w2v2-base-f32-3s")
    plan = costs.clip_plan(wl, cfg["arch"])
    # 4 chunks of 8 draws x 3 slices (64, 64, 21 rows): 6 K1 layers, 12 x (dq + dkv)
    assert plan["conv_dgrad"][3] == 4 * 3 * 6
    assert plan["flash_bwd"][3] == 4 * 3 * 12 * 2
    assert [c for c in costs.backward_calls(wl)][:3] == [(8, 64), (8, 64), (8, 21)]


def test_draw_flops_by_hand():
    arch = dict(registry.load_json("configs", "wav2vec2-base-960h")["arch"],
                hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                intermediate_size=128, conv_dim=[128, 128], conv_stride=[5, 2],
                conv_kernel=[10, 3], num_conv_pos_embeddings=16,
                num_conv_pos_embedding_groups=4, vocab_size=32)
    # 1600 samples -> 319 -> 159 frames
    conv = 2 * 319 * 10 * 1 * 128 + 2 * 159 * 3 * 128 * 128
    dense = 2 * 159 * 128 * 64 + 2 * 159 * 16 * 16 * 64 + 2 * 159 * 64 * 32
    layer = 2 * 159 * (4 * 64 * 64 + 2 * 64 * 128)
    attn = 4 * 159 * 159 * 64
    fwd, bwd = wav2vec2.flops(arch, 1600)
    assert fwd == conv + dense + 2 * (layer + attn)
    assert bwd == conv + dense + 2 * (layer + 2 * attn)


def test_conformer_flops_by_hand():
    arch = dict(registry.load_json("configs", "wav2vec2-conformer-rel-pos-large-960h-ft")["arch"],
                hidden_size=64, num_hidden_layers=1, num_attention_heads=2,
                intermediate_size=128, conv_dim=[128], conv_stride=[5], conv_kernel=[10],
                conv_depthwise_kernel_size=7)
    t = 319
    conv = 2 * t * 10 * 128
    dense = 2 * t * 128 * 64 + 2 * t * 64 * 32
    ffns = 2 * 2 * t * (64 * 128 + 128 * 64)
    mixers = 2 * t * (4 * 64 * 64 + 64 * 128 + 64 * 64 + 7 * 64)
    attn = 4 * t * t * 64
    rel = 2 * t * (2 * t - 1) * 64
    pos = 2 * (2 * t - 1) * 64 * 64
    fwd, bwd = w2v2_conformer.flops(arch, 1600)
    assert fwd == conv + dense + ffns + mixers + attn + rel + pos
    assert bwd == conv + dense + ffns + mixers + 2 * attn + rel

