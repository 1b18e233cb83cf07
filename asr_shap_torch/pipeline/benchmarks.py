"""Explainer runtime against input length: the wall of one full
expected-gradients explanation at each length, OOM-guarded, printed as a
table, with the effective perturbation passes per second and a JSON
artifact (the reference's ``asr_shap/pipeline/benchmarks.py``).

Run: ``python -m asr_shap_torch bench [--lengths ...] [--nsamples N]``.

The default model is Wav2Vec2-base at the reference's throughput numerics,
``dtype="bfloat16", matmul_precision="default"``. Differences from the
reference, deliberate:

* the guard catches only ``torch.cuda.OutOfMemoryError``: any other
  exception (a kernel that fails to build or launch) propagates, where the
  reference turns every exception into a ``"failed: ..."`` row;
* with ``plot_path`` and no matplotlib, raises before any work;
* ``compile_s`` is the first call's wall, which loads (and at first use
  builds) the kernels; the port has no compile step beside that.
"""

from __future__ import annotations

import json
import time
from typing import List, Optional

import numpy as np
import torch

from asr_shap_torch.core.config import ExplainerConfig, Wav2Vec2Config
from asr_shap_torch.core.device import matmul_precision_scope, resolve_device
from asr_shap_torch.core.prng import generator
from asr_shap_torch.explain.baselines import zeros_noise_background
from asr_shap_torch.explain.expected_gradients import expected_phi
from asr_shap_torch.models.heads import make_explained_fn
from asr_shap_torch.models.wav2vec2 import cast_params_for_compute, init_wav2vec2_params
from asr_shap_torch.viz.static import pyplot, require_matplotlib

DEFAULT_LENGTHS = (2500, 5000, 10000, 20000, 40000, 80000)  # runtime_analysis.py:111


def run_length_sweep(
    lengths=DEFAULT_LENGTHS,
    nsamples: int = 16,
    draw_chunk: int = 1,
    model_config: Optional[Wav2Vec2Config] = None,
    params=None,
    plot_path: Optional[str] = None,
    json_path: Optional[str] = None,
    device: str | torch.device = "cuda",
) -> List[dict]:
    """One row per length: length, t_frames, nsamples (draws), wall_s (the
    least of 3 timed explanations), compile_s, passes_per_s, status. The
    background comes from stream 1, the first call's draws from stream 2
    and the timed calls' from streams 3-5 (``core.prng``)."""
    if plot_path:
        require_matplotlib(f"plot_path {plot_path!r} (--plot)", "drop the plot")
    device = resolve_device(device)
    cfg = model_config or Wav2Vec2Config(dtype="bfloat16", matmul_precision="default")
    if params is None:
        params = init_wav2vec2_params(0, cfg, device=device)
    params = cast_params_for_compute(params, cfg.dtype)

    ecfg = ExplainerConfig(nsamples=nsamples, draw_chunk=draw_chunk, remat=True)
    f = make_explained_fn(params, cfg, ecfg)
    results = []
    rng = np.random.default_rng(0)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    with matmul_precision_scope(cfg.matmul_precision):
        for n in lengths:
            t_frames = cfg.frames_for_samples(n)
            try:
                x = torch.from_numpy(rng.standard_normal(n).astype(np.float32)).to(device)
                bg = zeros_noise_background(generator(1), n, ecfg.num_background,
                                            ecfg.background_sigma, device=device)

                def run(stream: int):
                    expected_phi(f, x, bg, generator(stream), ecfg)
                    sync()

                t0 = time.perf_counter()
                run(2)
                compile_s = time.perf_counter() - t0
                wall = float("inf")
                for r in range(3):
                    t0 = time.perf_counter()
                    run(3 + r)
                    wall = min(wall, time.perf_counter() - t0)
                chunk = max(1, draw_chunk)
                total_draws = -(-nsamples // chunk) * chunk
                results.append({
                    "length": n,
                    "t_frames": t_frames,
                    "nsamples": total_draws,
                    "wall_s": wall,
                    "compile_s": compile_s,
                    "passes_per_s": total_draws * t_frames / wall,
                    "status": "ok",
                })
            except torch.cuda.OutOfMemoryError as e:  # runtime_analysis.py:128-130
                results.append({"length": n, "status": f"failed: {type(e).__name__}"})
                break

    _print_table(results)
    if plot_path:
        _plot(results, plot_path)
    if json_path:
        with open(json_path, "w") as fh:
            json.dump(results, fh, indent=2)
    return results


def _print_table(results: List[dict]) -> None:
    print(f"{'length':>8} {'frames':>7} {'draws':>6} {'wall[s]':>9} "
          f"{'compile[s]':>11} {'passes/s':>10}")
    for r in results:
        if r["status"] != "ok":
            print(f"{r['length']:>8} {r['status']}")
            continue
        print(f"{r['length']:>8} {r['t_frames']:>7} {r['nsamples']:>6} "
              f"{r['wall_s']:>9.3f} {r['compile_s']:>11.1f} {r['passes_per_s']:>10.1f}")


def _plot(results: List[dict], path: str) -> None:
    plt = pyplot()
    ok = [r for r in results if r["status"] == "ok"]
    fig, ax = plt.subplots(figsize=(8, 5))
    ax.plot([r["length"] for r in ok], [r["wall_s"] for r in ok], "o-")
    ax.set_xlabel("input length [samples]")
    ax.set_ylabel("wall-clock per explanation [s]")
    ax.set_title("expected-gradients runtime vs input length")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
