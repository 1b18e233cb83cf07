"""The plain reference against the port at tiny widths, both families: the
same weights (made by the benchmark), the same clip, the same draws."""

import numpy as np
import pytest
import torch

from shapbench import registry
from shapbench.params import make_params
from shapbench.reference.expected_gradients import (
    background_and_draws,
    normalize,
    phi_columns,
)
from shapbench.run import pipeline_config
from shapbench.traffic.generate import make_clips


@pytest.mark.parametrize("cell", ["tiny-base", "tiny-conformer"])
def test_reference_matches_the_port(cell, tiny_root, tmp_path):
    from asr_shap_torch.explain.expected_gradients import expected_phi
    from asr_shap_torch.models.heads import make_explained_fn, model_logits_fn

    wl, cfg, fam = registry.cell(cell, tiny_root)
    seed = 2**31 + 77
    params = make_params(fam.param_specs(cfg["arch"]), seed, "cpu")
    pcfg = pipeline_config(wl, cfg, seed, str(tmp_path))
    clip = make_clips(wl["clips"], seed, 1)[0]
    x = normalize(torch.from_numpy(clip["audio"]))
    with torch.no_grad():
        got = model_logits_fn(pcfg.model)(params, pcfg.model, x[None])[0]
        want = fam.logits(params, cfg["arch"], x[None])[0]
    assert got.shape == want.shape == (wl["t_out"], 32)
    assert (got - want).abs().max() <= 1e-5 * want.abs().max()

    bg, idx, t = background_and_draws(seed, 0, x.shape[0], wl["explainer"])
    phi = expected_phi(make_explained_fn(params, pcfg.model, pcfg.explainer), x, bg,
                       config=pcfg.explainer, draws=(idx, t))

    def f(xt):
        return fam.logits(params, cfg["arch"], xt).amax(dim=-1)

    frames = [0, 2, wl["t_out"] - 1]
    ref = phi_columns(f, x, bg, idx, t, frames, draw_block=3, row_block=2)
    assert (phi[:, frames] - ref).abs().max() <= 1e-5 * ref.abs().max()
    assert np.isfinite(ref.numpy()).all() and ref.abs().max() > 0
