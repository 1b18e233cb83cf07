"""The benchmark's one command:

    python -m shapbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

One run of one cell: set-up (the kernels built, the weights made on the
card from the seed, the clips generated, one warm ``run_shap_pipeline``
call on one clip of the cell's shape, one draw chunk of it), then one
timed call of ``run_shap_pipeline`` on ``clips_for(cell, seconds)`` fresh
clips into a fresh store, then the comparison with the plain reference
(``check.py``) once the window has closed and its peak memory is read.
The last line on standard output is one JSON object; the numbers compared
and their limits are the last lines on standard error and the result's
last key, "checks". ``--trace 1`` runs the window a second time on the
same clips under the profiler, and reports the per-layer metrics
(``metrics/``) in place of the end-to-end ones: those of the host clock
from the untraced window, those of the device from the traced one.

It needs a CUDA card (as many as the cell asks for) and the port beside
it, and has no CPU fallback: without either it exits non-zero and prints
no result.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import Dict, List, Optional, Tuple

import numpy as np

from shapbench import check, isolation, registry
from shapbench.params import make_params
from shapbench.traffic.generate import WARMUP_FIRST, make_clips
from shapbench.traffic.prng import numpy_rng
from shapbench.window import Window, read_metrics

_T0 = time.perf_counter()

GIB = float(2 ** 30)


MIN_CLIPS = 2
REF_SAMPLES = 400_000  # waveform samples the reference runs through one forward


def clips_for(wl: Dict, seconds: float) -> int:
    """The window's clips: ``seconds`` over the cell's ``clip_s`` (what a
    clip took on the card when the cell was defined), rounded, at least
    ``MIN_CLIPS``. A fixed amount of work for a given length, so that no
    noisy estimate moves it from run to run."""
    return max(MIN_CLIPS, round(seconds / wl["clip_s"]))


def ref_blocks(samples: int) -> Tuple[int, int]:
    """(draws per forward, one-hot rows per VJP) of the reference: a
    fixed number of waveform samples per forward, four rows a draw."""
    draw_block = max(1, REF_SAMPLES // samples)
    return draw_block, 4 * draw_block


def setup_seconds() -> float:
    """Seconds since this process started: Linux's /proc clock (10 ms
    ticks), else since this module's import."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return max(0.0, up - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T0


def pipeline_config(wl: Dict, cfg: Dict, seed: int, data_dir: str,
                    numerics: Optional[Dict] = None):
    """The port's ``PipelineConfig`` of a cell: the configuration's
    architecture, the cell's numerics (``numerics`` overrides some) and
    explainer, the run seed."""
    from asr_shap_torch.core import config as pc

    arch = {k: tuple(v) if isinstance(v, list) else v for k, v in cfg["arch"].items()}
    model = getattr(pc, cfg["port_config"])(**arch, **{**wl["numerics"], **(numerics or {})})
    return pc.PipelineConfig(model=model, explainer=pc.ExplainerConfig(**wl["explainer"]),
                             seed=seed, data_dir=data_dir)


def timed_call(params, pcfg, clips: List[Dict], data_dir: str, device, trace: bool):
    """One ``run_shap_pipeline`` call into a fresh store at ``data_dir``:
    (results or None, the call's wall, its trace, the port's launch counts,
    the error's text or None)."""
    import torch

    from asr_shap_torch.core.store import AttributionStore
    from asr_shap_torch.kernels import _build
    from asr_shap_torch.pipeline.run_shap import run_shap_pipeline
    from shapbench.trace import traced

    store = AttributionStore(data_dir)
    _build.reset_launches()
    results, error = None, None
    with traced(trace) as holder:
        t0 = time.perf_counter()
        try:
            results = run_shap_pipeline(params, pcfg, clips, store=store, resume=False,
                                        device=device)
        except Exception:  # a failed call fails its clips; the run reports it
            error = traceback.format_exc()
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    return results, wall, holder.trace, dict(_build.LAUNCHES), error


def reference_outputs(wl: Dict, cfg: Dict, fam, params, seed: int, clips: List[Dict],
                      results: List[Dict], device, prec=None,
                      picked: Optional[List[int]] = None,
                      all_frames: bool = False) -> List[Dict]:
    """The plain reference, recomputed in float32 with TF32 off, or in the
    lower precision ``prec`` (the control), for ``check.clips`` results
    taken in an order drawn from the seed (``picked``: these results).
    Per clip: its result's index in ``results``, the frames compared, the
    reference logits [T, V] and phi [N, frames]. A cell with a
    ``check.margin`` also gets each frame's least top-2 logit gap over the
    draws' points ("margin" [T_out], in units of the clip's logit spread);
    only the frames at or above the margin are compared, and a clip with
    none is passed over (``all_frames``: every frame, every clip)."""
    import torch

    from shapbench.reference.common import PLAIN
    from shapbench.reference.expected_gradients import (
        background_and_draws,
        normalize,
        phi_columns,
    )

    ck, arch, t_out = wl["check"], cfg["arch"], wl["t_out"]
    floor = ck.get("margin")
    prec = prec or PLAIN
    if picked is None:
        order, count = numpy_rng(seed, 3000).permutation(len(results)).tolist(), ck["clips"]
    else:
        order, count = list(picked), len(picked)
    draw_block, row_block = ref_blocks(wl["clips"]["samples"])
    out = []
    saved = _tf32_off()
    try:
        for j in order:
            if len(out) == count:
                break
            i = results[j]["index"]
            x = normalize(torch.as_tensor(np.asarray(clips[i]["audio"], np.float32))).to(device)
            with torch.no_grad():
                logits = check.as_numpy(fam.logits(params, arch, x[None], prec)[0])
            bg, idx, t = background_and_draws(seed, i, x.shape[0], wl["explainer"])
            bg = bg.to(device)
            ref = {"result": j, "frames": list(range(t_out)), "logits": logits}
            if floor is not None:
                ref["margin"] = clip_margin(wl, cfg, fam, params, prec, x, bg, idx, t, logits)
                if not all_frames:
                    ref["frames"] = np.flatnonzero(ref["margin"] >= floor).tolist()
                    if not ref["frames"]:
                        continue

            def f(xt):
                return fam.logits(params, arch, xt, prec).amax(dim=-1)

            ref["phi"] = check.as_numpy(phi_columns(f, x, bg, idx, t, ref["frames"],
                                                    draw_block, row_block))
            out.append(ref)
    finally:
        _tf32_restore(saved)
    return out


def clip_margin(wl: Dict, cfg: Dict, fam, params, prec, x, bg, idx, t,
                logits: np.ndarray) -> np.ndarray:
    """Each frame's least top-2 reference logit gap over the clip's draws'
    points [T_out], in units of the spread (std) of the clip's ``logits``."""
    from shapbench.reference.expected_gradients import least_margin

    spread = max(float(logits.std()), 1e-30)

    def gap(xt):
        top2 = fam.logits(params, cfg["arch"], xt, prec).topk(2, dim=-1).values
        return (top2[..., 0] - top2[..., 1]) / spread

    draw_block, _ = ref_blocks(wl["clips"]["samples"])
    return check.as_numpy(least_margin(gap, x, bg, idx, t, draw_block))


def compare(results: List[Dict], refs: List[Dict], floor: Optional[float] = None
            ) -> Dict[str, float]:
    """The numbers of ``check.py`` for ``results`` against the reference
    outputs, the worst over the sampled clips; with ``floor``, phi only on
    the frames whose margin is at least ``floor``."""
    numbers: Dict[str, float] = {}
    for ref in refs:
        r = results[ref["result"]]
        found = check.decode_numbers(ref["logits"], r["transcription"], r["confidence"])
        keep = [k for k, fr in enumerate(ref["frames"])
                if floor is None or ref["margin"][fr] >= floor]
        if keep:
            frames = [ref["frames"][k] for k in keep]
            found.update(check.phi_numbers(r["shap_values"][:, frames], ref["phi"][:, keep]))
        for k, v in found.items():
            numbers[k] = max(numbers.get(k, 0.0), v)
    return numbers


def _tf32_off():
    import torch

    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return saved


def _tf32_restore(saved):
    import torch

    torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def device_info(device) -> Dict:
    import torch

    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def run(name: str, seed: int, seconds: float, trace: bool, device="cuda",
        root: Path = registry.ROOT) -> Tuple[Dict, List[str]]:
    """One run of cell ``name``: (the result line's object, the check lines).
    With ``trace`` the window runs twice on the same clips: untraced, for
    the host clock's metrics, then under the profiler, for the device's."""
    import torch

    wl, cfg, fam = registry.cell(name, root)
    on_card = torch.device(device).type == "cuda"
    phases = {"start": setup_seconds()}
    if on_card:
        from asr_shap_torch.kernels import _build

        _build.build_all()
    phases["build"] = setup_seconds()
    params = make_params(fam.param_specs(cfg["arch"]), seed, device)
    if on_card:
        torch.cuda.synchronize()
    phases["weights"] = setup_seconds()
    tmp = tempfile.mkdtemp(prefix="shapbench-")
    try:
        warm = make_clips(wl["clips"], seed, 1, first=WARMUP_FIRST)
        pcfg = pipeline_config(wl, cfg, seed, os.path.join(tmp, "warm"))
        # one draw chunk warms every shape a clip runs: the chunks are alike
        pcfg = dataclasses.replace(pcfg, explainer=dataclasses.replace(
            pcfg.explainer, nsamples=pcfg.explainer.draw_chunk))
        phases["warm clip"] = setup_seconds()
        res, _, _, _, err = timed_call(params, pcfg, warm, pcfg.data_dir, device, False)
        if err:
            raise RuntimeError(f"the warm-up call failed:\n{err}")
        phases["warm call"] = setup_seconds()
        shutil.rmtree(pcfg.data_dir)
        n = clips_for(wl, seconds)
        clips = make_clips(wl["clips"], seed, n)
        pcfg = pipeline_config(wl, cfg, seed, os.path.join(tmp, "window"))
        if on_card:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = phases["clips"] = setup_seconds()
        prev = 0.0
        for k, v in phases.items():
            print(f"shapbench: set-up {k} at {v:.3f} s (+{v - prev:.3f})", file=sys.stderr)
            prev = v

        results, window_s, _, launches, err = timed_call(params, pcfg, clips, pcfg.data_dir,
                                                         device, False)
        dev = device_info(device)
        results = results or []
        windows = [(pcfg.data_dir, results)]
        print(f"shapbench: warm chunk {res[0]['wall_s']:.4f} s, {n} clips, window "
              f"{window_s:.4f} s, clips' wall_s {[round(r['wall_s'], 4) for r in results]}",
              file=sys.stderr)
        tr, breakdown = None, None
        if trace and not err:
            traced_dir = os.path.join(tmp, "traced")
            traced_results, traced_s, tr, launches, err = timed_call(
                params, pcfg, clips, traced_dir, device, True)
            windows.append((traced_dir, traced_results or []))
            err = err or (None if traced_results and len(traced_results) == n
                          else "the traced window completed fewer clips")
            print(f"shapbench: traced window {traced_s:.4f} s, {traced_s / window_s:.4f} x the "
                  f"untraced one", file=sys.stderr)
        w = Window(workload=wl, arch=cfg["arch"], family=fam, results=results,
                   window_s=window_s, launches=launches, trace=tr)
        if trace:
            metrics = read_metrics(w)
            if tr is not None:
                dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
                breakdown = tr.breakdown()
        else:
            passes = w.draws * wl["t_out"]
            metrics = {"passes_per_s": {"value": passes / window_s, "unit": "passes/s"},
                       "peak_mem_gib": {"value": dev["memory_peak_bytes"] / GIB, "unit": "GiB"},
                       "setup_s": {"value": setup_s, "unit": "s"}}
        numbers: Dict[str, float] = {}
        if results:
            numbers["store_mismatches"] = float(sum(
                check.store_mismatches(d, rs, clips) for d, rs in windows))
            del tr, w
            if on_card:
                torch.cuda.empty_cache()
            t0 = time.perf_counter()
            refs = reference_outputs(wl, cfg, fam, params, seed, clips, results, device)
            for _, rs in windows:
                for k, v in compare(rs, refs, wl["check"].get("margin")).items():
                    numbers[k] = max(numbers.get(k, 0.0), v)
            print(f"shapbench: reference {time.perf_counter() - t0:.2f} s over "
                  f"{[len(r['frames']) for r in refs]} frames", file=sys.stderr)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    limits = wl["check"]["limits"]
    correct = not err and len(results) == n and check.judge(numbers, limits)
    lines = [f"check {k}: {numbers.get(k)!r} (limit {v!r})" for k, v in limits.items()]
    # JSON has no inf or nan: a number that is missing or not finite is null
    checks = {k: {"value": numbers[k] if np.isfinite(numbers.get(k, np.nan)) else None,
                  "limit": v} for k, v in limits.items()}
    if err:
        lines.insert(0, f"the timed call failed:\n{err}")
    result = {"correct": bool(correct), "attempted": n, "failed": n - len(results),
              "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = checks
    return result, lines


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    wl = registry.load_json("workloads", args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"shapbench: cell {args.workload!r} needs {wl['chips']} CUDA card(s); "
              f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    try:
        import asr_shap_torch  # noqa: F401
    except ImportError as e:
        print(f"shapbench: the port asr_shap_torch is not importable here: {e}",
              file=sys.stderr)
        return 4
    result, lines = run(args.workload, args.seed, args.seconds, bool(args.trace))
    found = isolation.forbidden(sys.modules)
    if found:
        print(f"shapbench: loaded modules the benchmark may not load: {found}", file=sys.stderr)
        return 5
    sys.stdout.flush()
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
