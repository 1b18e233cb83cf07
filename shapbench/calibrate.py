"""The readings that a cell's limits are set from, and its control and
faults judged at the cell's own sizes (not run by the benchmark):

    python -m shapbench.calibrate --workload <cell> --seeds 1 2 ... \\
        [--control-seeds 1 2 3] [--fault-seeds 1 2 3] \\
        [--faults half_the_draws ...] [--frames N] [--out FILE]

For each seed, in one process: the weights and ``check.clips`` clips of
the cell made from the seed, the port's timed path on them
(``run_shap_pipeline`` with the cell's settings), the plain float32
reference on every frame of each, and the numbers of ``check.py`` with
``check.judge``'s verdict against the cell's limits (the lower readings).
For each control seed, the control against the same reference, judged
alike: the port with the cell's ``check.control.numerics`` (its own
lower-precision path), and the reference itself in the lower precision
``check.control.precision`` put in the program's place. For each fault
seed, the port under each of ``--faults`` (``faults.py``). With
``--frames N`` (cells with a ``check.margin``), each compared clip's
per-frame margin and errors, and the margins of the first N clips of the
seed, a window's. One JSON line per seed on standard output (and
``--out``).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import numpy as np

from shapbench import check


def as_results(low: List[Dict], results: List[Dict]) -> List[Dict]:
    """``results`` with the reference outputs ``low`` (every frame) put in
    the program's place: phi, the greedy transcript and the confidence."""
    out = [dict(r) for r in results]
    for ref in low:
        r = out[ref["result"]]
        phi = np.zeros_like(r["shap_values"])
        phi[:, ref["frames"]] = ref["phi"]
        r.update(shap_values=phi, transcription=check.greedy_text(ref["logits"]),
                 confidence=check.confidence(ref["logits"]))
    return out


def column_errors(results: List[Dict], refs: List[Dict]) -> List[List[float]]:
    """Per compared clip, each frame's relative error of phi."""
    return [[round(float(c), 5) for c in check.column_errors(
        results[ref["result"]]["shap_values"][:, ref["frames"]], ref["phi"])] for ref in refs]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=["half_the_draws"])
    ap.add_argument("--frames", type=int, default=0)
    ap.add_argument("--out", default="")
    args = ap.parse_args(argv)

    import torch

    from shapbench import registry
    from shapbench.faults import FAULTS
    from shapbench.params import make_params
    from shapbench.reference.common import Precision
    from shapbench.run import compare, pipeline_config, reference_outputs, timed_call
    from shapbench.traffic.generate import make_clips

    if not torch.cuda.is_available():
        print("calibrate: needs a CUDA card", file=sys.stderr)
        return 3
    from asr_shap_torch.kernels import _build

    _build.build_all()
    wl, cfg, fam = registry.cell(args.workload)
    ck = wl["check"]
    floor, control, limits = ck.get("margin"), ck.get("control", {}), ck["limits"]
    for seed in args.seeds:
        t0 = time.perf_counter()
        params = make_params(fam.param_specs(cfg["arch"]), seed, "cuda")
        clips = make_clips(wl["clips"], seed, ck["clips"])
        tmp = tempfile.mkdtemp(prefix="shapbench-cal-")

        def program(tag, numerics=None, fault=None):
            pcfg = pipeline_config(wl, cfg, seed, os.path.join(tmp, tag), numerics=numerics)
            with fault() if fault else contextlib.nullcontext():
                res, wall, _, _, err = timed_call(params, pcfg, clips, pcfg.data_dir, "cuda",
                                                  False)
            if err:
                return None, wall, err
            return res, wall, check.store_mismatches(pcfg.data_dir, res, clips)

        def judged(res, refs, store):
            nums = dict(compare(res, refs, floor), store_mismatches=float(store))
            return dict(nums, correct=check.judge(nums, limits))

        try:
            res, wall, store = program("p")
            if res is None:
                print(store, file=sys.stderr)
                return 1
            line = {"workload": args.workload, "seed": seed, "call_s": wall}
            t1 = time.perf_counter()
            picked = list(range(len(res)))
            refs = reference_outputs(wl, cfg, fam, params, seed, clips, res, "cuda",
                                     picked=picked, all_frames=True)
            line["reference_s"] = time.perf_counter() - t1
            line["program"] = judged(res, refs, store)
            frames = {"program": column_errors(res, refs)}
            if seed in args.control_seeds:
                if "numerics" in control:
                    res_c, _, store_c = program("c", numerics=control["numerics"])
                    line["control_program"] = ({"error": store_c[-400:]} if res_c is None
                                               else judged(res_c, refs, 0))
                    if res_c is not None:
                        frames["control_program"] = column_errors(res_c, refs)
                if "precision" in control:
                    low = reference_outputs(wl, cfg, fam, params, seed, clips, res, "cuda",
                                            prec=Precision(control["precision"]),
                                            picked=picked, all_frames=True)
                    res_l = as_results(low, res)
                    line["control_reference"] = judged(res_l, refs, 0)
                    frames["control_reference"] = column_errors(res_l, refs)
            if seed in args.fault_seeds:
                for name in args.faults:
                    res_f, _, store_f = program(name, fault=FAULTS[name])
                    line[name] = ({"error": store_f[-400:]} if res_f is None
                                  else judged(res_f, refs, store_f))
                    if res_f is not None:
                        frames[name] = column_errors(res_f, refs)
            if args.frames and floor is not None:
                line["frames"] = frames
                line["margin"] = [[round(float(m), 5) for m in ref["margin"]] for ref in refs]
                line["screen"] = screen(wl, cfg, fam, params, seed, args.frames)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        del params
        torch.cuda.empty_cache()
        line["seconds"] = time.perf_counter() - t0
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
    return 0


def screen(wl, cfg, fam, params, seed: int, n: int) -> List[List[float]]:
    """The least top-2 margin of every frame of the seed's first ``n``
    clips (a window's), over each clip's draws, forward only."""
    import torch

    from shapbench.reference.common import PLAIN
    from shapbench.reference.expected_gradients import background_and_draws, normalize
    from shapbench.run import _tf32_off, _tf32_restore, clip_margin
    from shapbench.traffic.generate import make_clips

    out = []
    saved = _tf32_off()
    try:
        for i, clip in enumerate(make_clips(wl["clips"], seed, n)):
            x = normalize(torch.as_tensor(np.asarray(clip["audio"], np.float32))).cuda()
            with torch.no_grad():
                logits = check.as_numpy(fam.logits(params, cfg["arch"], x[None])[0])
            bg, idx, t = background_and_draws(seed, i, x.shape[0], wl["explainer"])
            least = clip_margin(wl, cfg, fam, params, PLAIN, x, bg.cuda(), idx, t, logits)
            out.append([round(float(m), 5) for m in least])
    finally:
        _tf32_restore(saved)
    return out


if __name__ == "__main__":
    sys.exit(main())
