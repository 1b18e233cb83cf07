"""Plain expected gradients over given draws, and the derivation of a
pipeline sample's background rows and draws from the run seed.

phi[n, j] = mean over draws (b, t) of dF_j/dx_n (b + t (x - b)) (x_n - b_n),
F_j the largest logit of frame j. The background and the draws of sample i
come from the streams (seed, i, 0) and (seed, i, 1), drawn as the
pipeline's contract states: sigma * N(0, 1) rows, then (background index,
t) pairs, ``nsamples`` rounded up to a multiple of ``draw_chunk``."""

from __future__ import annotations

import math
from typing import Callable, Sequence, Tuple

import torch

from shapbench.traffic.prng import generator


def background_and_draws(seed: int, index: int, n_input: int, explainer) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(background [B, N], background index [D], t [D]) on the CPU."""
    nb = explainer["num_background"]
    g = generator(seed, index, 0)
    bg = explainer["background_sigma"] * torch.randn((nb, n_input), generator=g,
                                                     dtype=torch.float32)
    chunk = max(1, explainer["draw_chunk"])
    total = math.ceil(explainer["nsamples"] / chunk) * chunk
    g = generator(seed, index, 1)
    idx = torch.randint(0, nb, (total,), generator=g)
    t = torch.rand((total,), generator=g, dtype=torch.float32)
    return bg, idx, t


def normalize(audio: torch.Tensor) -> torch.Tensor:
    """Zero mean, unit variance (biased variance, eps 1e-7 under the root),
    computed in float64."""
    a = audio.to(torch.float64)
    a = (a - a.mean()) / torch.sqrt(a.var(unbiased=False) + 1e-7)
    return a.to(torch.float32)


def _points(x: torch.Tensor, background: torch.Tensor, idx: torch.Tensor,
            t: torch.Tensor, draw_block: int):
    """Each block of ``draw_block`` draws: (x - b [C, N], the points
    b + t (x - b) [C, N])."""
    idx, t = idx.to(x.device), t.to(x.device)
    for s in range(0, idx.shape[0], draw_block):
        b = background[idx[s:s + draw_block]]
        d = x[None] - b
        yield d, b + t[s:s + draw_block, None] * d


def least_margin(gap: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                 background: torch.Tensor, idx: torch.Tensor, t: torch.Tensor,
                 draw_block: int) -> torch.Tensor:
    """[T_out]: each frame's least ``gap`` over the draws' points (gap:
    waveforms [C, N] -> [C, T_out], forward only)."""
    least = None
    with torch.no_grad():
        for _, xt in _points(x, background, idx, t, draw_block):
            g = gap(xt).amin(dim=0)
            least = g if least is None else torch.minimum(least, g)
    return least


def phi_columns(f: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
                background: torch.Tensor, idx: torch.Tensor, t: torch.Tensor,
                frames: Sequence[int], draw_block: int, row_block: int) -> torch.Tensor:
    """phi[:, frames] [N, len(frames)], float32.
    f: waveforms [C, N] -> explained outputs [C, T_out]. Draws go
    ``draw_block`` at a time through one forward under ``torch.func.vjp``;
    the one-hot rows of ``frames``, ``row_block`` at a time, through a
    vmapped VJP."""
    frames = torch.as_tensor(list(frames), dtype=torch.long, device=x.device)
    acc = torch.zeros((len(frames), x.shape[0]), dtype=torch.float32, device=x.device)
    for d, xt in _points(x, background, idx, t, draw_block):
        y, vjp_fn = torch.func.vjp(f, xt)
        rows = torch.func.vmap(lambda ct: vjp_fn(ct)[0])
        for r in range(0, len(frames), row_block):
            fr = frames[r:r + row_block]
            cts = torch.zeros((len(fr),) + tuple(y.shape), dtype=y.dtype, device=y.device)
            cts[torch.arange(len(fr), device=x.device), :, fr] = 1.0
            acc[r:r + len(fr)] += (rows(cts) * d[None]).sum(dim=1)
        del y, vjp_fn
    return (acc / idx.shape[0]).T.contiguous()
