"""Expected gradients, the equivalent of shap.GradientExplainer.

For input x and background rows B, draw pairs (b ~ Uniform(B), t ~ U(0, 1)),
take the input Jacobian of f at x_t = b + t (x - b), multiply by (x - b) and
average:

    phi[n, j] = E_{b,t}[ dF_j/dx_n (b + t (x - b)) * (x_n - b_n) ]

The draws go ``draw_chunk`` at a time, as the reference's vmap inside a
chunk: a chunk is one forward of ``torch.func.vmap(f)`` over its C
interpolation points under ``torch.func.vjp``, then the T_out one-hot
cotangent rows, each set on every draw, pushed through the VJP by one
``torch.func.vmap`` (per ``output_chunk`` slice of rows). The kernels'
vmap rules fold the draws into their batch and the rows outside them, so
a chunk launches each kernel once per layer and pass. Chunks run one
after another and accumulate in float32; draw i is draw i whatever the
chunk, so phi at any ``draw_chunk`` equals phi at 1 up to the order of the
sums. The draws come from a ``torch.Generator`` or are given explicitly as
(background index, t) pairs. The base value is one ``vmap(f)`` forward
over the background.
``expected_phi_sharded`` splits the draws over a mesh's data axis and sums
the ranks' float32 partial sums with one all_reduce.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from asr_shap_torch.core.config import ExplainerConfig

Draws = Tuple[torch.Tensor, torch.Tensor]  # (background index [n], t [n])


class Explanation(NamedTuple):
    """values [N_input, T_out]; base_values [T_out] = mean f over the
    background; model_output [T_out] = f(x)."""

    values: torch.Tensor
    base_values: torch.Tensor
    model_output: torch.Tensor


def _jacobian(f: Callable, x: torch.Tensor, output_chunk: int) -> torch.Tensor:
    """Jacobian of f: R^N -> R^T at x, one forward and a batched VJP of the
    one-hot cotangent rows (``output_chunk`` rows at a time). [T, N]."""
    y, vjp_fn = torch.func.vjp(f, x)
    t = y.shape[0]
    eye = torch.eye(t, dtype=y.dtype, device=y.device)
    rows = torch.func.vmap(lambda ct: vjp_fn(ct)[0])
    if output_chunk <= 0 or output_chunk >= t:
        return rows(eye)
    return torch.cat([rows(eye[s:s + output_chunk])
                      for s in range(0, t, output_chunk)])


def _chunk_phi(f: Callable, x: torch.Tensor, b: torch.Tensor, t: torch.Tensor,
               output_chunk: int) -> torch.Tensor:
    """Sum over one chunk of draws (background rows b [C, N], t [C]) of the
    per-draw phi, float32, [T, N]: one forward of ``vmap(f)`` over the C
    interpolation points, then the one-hot cotangent rows, each set on
    every draw ([rows, C, T]), through one vmapped VJP per slice of
    ``output_chunk`` rows. The draws are folded into the kernels' batch by
    their vmap rules, and the rows outside them."""
    d = x - b                                                    # [C, N]
    x_t = b + t[:, None] * d
    y, vjp_fn = torch.func.vjp(torch.func.vmap(f), x_t)          # y [C, T]
    t_out = y.shape[1]
    eye = torch.eye(t_out, dtype=y.dtype, device=y.device)
    rows = torch.func.vmap(lambda ct: vjp_fn(ct)[0])
    step = output_chunk if 0 < output_chunk < t_out else t_out
    acc = torch.empty((t_out, x.shape[0]), dtype=torch.float32, device=x.device)
    for s in range(0, t_out, step):
        cts = eye[s:s + step, None, :].expand(-1, d.shape[0], -1)
        jac = rows(cts)                                          # [rows, C, N]
        acc[s:s + step] = (jac * d[None]).to(torch.float32).sum(dim=1)
    return acc


def num_draws(config: ExplainerConfig) -> int:
    """``nsamples`` rounded up to a multiple of ``draw_chunk``."""
    chunk = max(1, config.draw_chunk)
    return -(-config.nsamples // chunk) * chunk


def sample_draws(generator: torch.Generator, total: int,
                 num_background: int) -> Draws:
    """(background index, t) for ``total`` draws from ``generator``."""
    idx = torch.randint(0, num_background, (total,), generator=generator,
                        device=generator.device)
    t = torch.rand((total,), generator=generator, dtype=torch.float32,
                   device=generator.device)
    return idx, t


def _phi_sum(f: Callable, x: torch.Tensor, background: torch.Tensor,
             draws: Draws, output_chunk: int, draw_chunk: int) -> torch.Tensor:
    """Sum over the draws of the per-draw phi, float32, [T, N]: the draws
    taken ``draw_chunk`` at a time in their order, each chunk one batch
    (``_chunk_phi``)."""
    idx, ts = (d.to(x.device) for d in draws)
    chunk = max(1, draw_chunk)
    acc = None
    for s in range(0, idx.shape[0], chunk):
        phi = _chunk_phi(f, x, background[idx[s:s + chunk]], ts[s:s + chunk], output_chunk)
        acc = phi if acc is None else acc + phi
    return acc


def base_value(f: Callable, background: torch.Tensor) -> torch.Tensor:
    """The mean of f over the background rows, one forward of ``vmap(f)``,
    as the reference's ``jnp.mean(jax.vmap(f)(background))``. [T_out]."""
    with torch.no_grad():
        return torch.func.vmap(f)(background).mean(dim=0)


def expected_phi(f: Callable, x: torch.Tensor, background: torch.Tensor,
                 generator: Optional[torch.Generator] = None,
                 config: ExplainerConfig = ExplainerConfig(),
                 draws: Optional[Draws] = None) -> torch.Tensor:
    """The attribution matrix alone, [N, T_out]; see ``expected_gradients``."""
    total = num_draws(config)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = sample_draws(generator, total, background.shape[0])
    elif draws[0].shape[0] != total:
        raise ValueError(f"{draws[0].shape[0]} explicit draws given, the "
                         f"config asks for {total}")
    acc = _phi_sum(f, x, background, draws, config.output_chunk, config.draw_chunk)
    # float32 whatever the model's compute dtype: x_t stays float32 and the
    # model casts it, so its gradient comes back float32
    if acc.dtype != torch.float32:
        raise TypeError(f"phi accumulated in {acc.dtype}, float32 expected")
    return (acc / total).T.contiguous()


def expected_gradients(f: Callable[[torch.Tensor], torch.Tensor],
                       x: torch.Tensor, background: torch.Tensor,
                       generator: Optional[torch.Generator] = None,
                       config: ExplainerConfig = ExplainerConfig(),
                       draws: Optional[Draws] = None) -> Explanation:
    """Explain f at x. f: [N] -> [T_out]; background [B, N]; x [N].

    The draw count is ``nsamples`` rounded up to a multiple of
    ``draw_chunk``. ``draws`` (background index [n], t [n]) replaces the
    generator, so that a test can feed the reference package's draws."""
    phi = expected_phi(f, x, background, generator, config, draws)
    with torch.no_grad():
        fx = f(x)
    return Explanation(values=phi, base_values=base_value(f, background), model_output=fx)


def sharded_draws(config: ExplainerConfig, ndev: int) -> Tuple[int, int]:
    """(draws per rank, total) of the draw-sharded explainer:
    ceil(nsamples / (draw_chunk * ndev)) chunks per rank, so the total is
    ``nsamples`` rounded up to a multiple of draw_chunk * ndev."""
    chunk = max(1, config.draw_chunk)
    per_rank = -(-config.nsamples // (chunk * ndev)) * chunk
    return per_rank, per_rank * ndev


def expected_phi_sharded(f: Callable, x: torch.Tensor, background: torch.Tensor, mesh,
                         generator: Optional[torch.Generator] = None,
                         config: ExplainerConfig = ExplainerConfig(),
                         draws: Optional[Draws] = None) -> torch.Tensor:
    """``expected_phi`` with the draws split over ``mesh``'s data axis
    (``parallel/mesh.py``), the reference's ``expected_gradients_sharded``.
    Every rank takes the same ``total`` draws (``sharded_draws``) from
    ``generator``, or ``draws`` given explicitly, and explains the slice
    [d * per_rank, (d + 1) * per_rank) of its data index d; the float32 sums
    are all-reduced over the data axis, then divided by ``total``. So phi
    differs from the unsharded explainer's over the same draws only in the
    order of the sum. Every rank returns it."""
    per_rank, total = sharded_draws(config, mesh.data_size)
    if draws is None:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        draws = sample_draws(generator, total, background.shape[0])
    elif draws[0].shape[0] != total:
        raise ValueError(f"{draws[0].shape[0]} explicit draws given, {total} expected "
                         f"over {mesh.data_size} data ranks")
    start = mesh.data_rank * per_rank
    local = tuple(d[start:start + per_rank] for d in draws)
    acc = _phi_sum(f, x, background, local, config.output_chunk, config.draw_chunk)
    if acc.dtype != torch.float32:
        raise TypeError(f"phi accumulated in {acc.dtype}, float32 expected")
    dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=mesh.data_group)
    return (acc / total).T.contiguous()


def expected_gradients_sharded(f: Callable[[torch.Tensor], torch.Tensor],
                               x: torch.Tensor, background: torch.Tensor, mesh,
                               generator: Optional[torch.Generator] = None,
                               config: ExplainerConfig = ExplainerConfig(),
                               draws: Optional[Draws] = None) -> Explanation:
    """``expected_gradients`` with the draws sharded over ``mesh``
    (``expected_phi_sharded``)."""
    phi = expected_phi_sharded(f, x, background, mesh, generator, config, draws)
    with torch.no_grad():
        fx = f(x)
    return Explanation(values=phi, base_values=base_value(f, background), model_output=fx)


class GradientExplainer:
    """``shap.GradientExplainer``-style API: construct with f and the
    background, then ``shap_values(x)``."""

    def __init__(self, f: Callable[[torch.Tensor], torch.Tensor],
                 background: torch.Tensor,
                 config: ExplainerConfig = ExplainerConfig()):
        self.f = f
        self.background = background
        self.config = config

    def explain(self, x: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> Explanation:
        return expected_gradients(self.f, x, self.background, generator,
                                  self.config)

    def shap_values(self, x: torch.Tensor,
                    generator: Optional[torch.Generator] = None) -> np.ndarray:
        """[N] or [1, N] input -> [N, T_out] numpy attribution matrix."""
        if x.ndim == 2:
            x = x[0]
        phi = expected_phi(self.f, x, self.background, generator, self.config)
        return phi.cpu().numpy()

    @property
    def expected_value(self) -> np.ndarray:
        return base_value(self.f, self.background).cpu().numpy()
