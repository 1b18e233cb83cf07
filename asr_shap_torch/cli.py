"""Command-line entry points of the port, ``python -m asr_shap_torch``:

  run-shap     : build the controlled test set, compute and persist
                 attributions (expected gradients, DeepSHAP, KernelSHAP or
                 LIME)
  sweep        : eta_raw-vs-WER sweep over the store, with correlation
                 statistics
  faithfulness : deletion/insertion faithfulness curves over the store
  metric       : single-sample eta_raw from stored npy files
  visualize    : interactive per-character attribution viewer
  compare      : LIME-vs-SHAP comparison on one clip (4-panel figure + wavs)
  transcribe   : greedy CTC transcription of wav/npy clips
  bench        : explainer runtime-vs-length sweep
  train        : CTC training on the text-conditional synthetic corpus

The flags, defaults and printed JSON lines are the reference package's
(``python -m asr_shap``), plus ``--device {cuda,cpu}``: every command runs
on the GPU unless asked for the CPU, and raises where there is no GPU.
Options the port does not have yet raise ``NotImplementedError`` before any
work, naming the ``ROADMAP.md`` item that ports them. A command asked to
draw (``--plot``, ``compare --out-dir``, ``visualize``) raises before any
work where matplotlib does not import, and ``--hf`` where transformers does
not. ``sweep --plot`` defaults to none.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import sys

logger = logging.getLogger(__name__)


def _add_device_arg(ap):
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where to run (default cuda; no fallback to the CPU)")


def _add_model_args(ap):
    ap.add_argument("--arch", choices=["wav2vec2", "w2v2-conformer"],
                    default="wav2vec2",
                    help="model family (w2v2-conformer = the rel-pos conformer)")
    ap.add_argument("--params", type=str, default=None,
                    help=".npz params archive (core/params_io.py); its embedded "
                         "config beats the preset flags")
    ap.add_argument("--hf", type=str, default=None,
                    help="HF Wav2Vec2ForCTC (--arch w2v2-conformer: "
                         "Wav2Vec2ConformerForCTC) checkpoint name/path; needs "
                         "transformers")
    ap.add_argument("--random-init", action="store_true",
                    help="random weights from seed 0 (smoke runs)")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny architecture (CPU smoke runs; x10 downsample)")
    ap.add_argument("--small", action="store_true",
                    help="small architecture with the full 7-layer conv stack "
                         "(x320 downsample, realistic frame counts)")
    ap.add_argument("--hidden", type=int, default=0,
                    help="override encoder hidden size of --tiny/--small")
    ap.add_argument("--layers", type=int, default=0,
                    help="override encoder layer count of --tiny/--small")
    ap.add_argument("--heads", type=int, default=0,
                    help="override attention head count of --tiny/--small")
    ap.add_argument("--conv-channels", type=int, default=0,
                    help="override conv feature-encoder channels of --tiny/--small")
    _add_device_arg(ap)


def _check_arch(args, cfg):
    """The forward follows the model config: an --arch that disagrees with
    it (an archive's embedded config) raises ValueError."""
    from asr_shap_torch.core.config import Wav2Vec2ConformerConfig

    if (args.arch == "w2v2-conformer") != isinstance(cfg, Wav2Vec2ConformerConfig):
        raise ValueError(f"--arch {args.arch} disagrees with the archive's "
                         f"{type(cfg).__name__}")


def _preset_config(args):
    """The model config of the preset flags (--arch, --tiny/--small and
    their overrides), the reference CLI's exactly."""
    from asr_shap_torch.core.config import Wav2Vec2Config, Wav2Vec2ConformerConfig

    conformer = args.arch == "w2v2-conformer"
    small_kw = dict(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                    intermediate_size=128)
    if args.hidden:
        small_kw["hidden_size"] = args.hidden
        small_kw["intermediate_size"] = 2 * args.hidden
    if args.layers:
        small_kw["num_hidden_layers"] = args.layers
    if args.heads:
        small_kw["num_attention_heads"] = args.heads
    cc = args.conv_channels or 32
    # the projection maps conv_dim[-1] -> hidden, so it tracks the channels
    small_kw["feat_proj_dim"] = cc
    if args.tiny:
        kw = dict(small_kw, conv_dim=(cc, cc), conv_stride=(5, 2), conv_kernel=(10, 3))
    elif args.small:
        kw = dict(small_kw, conv_dim=(cc,) * 7)
    else:
        kw = None
    if conformer:
        return (Wav2Vec2ConformerConfig(**kw, conv_depthwise_kernel_size=7)
                if kw else Wav2Vec2ConformerConfig())
    if kw:
        return Wav2Vec2Config(**kw, num_conv_pos_embeddings=16,
                              num_conv_pos_embedding_groups=4)
    return Wav2Vec2Config()


def _load_model(args):
    """(params on the device, model config). A --hf checkpoint's config, or
    an archive's embedded one, beats the preset flags: the weights know what
    they are. --hf loads through ``models/convert_hf.py``, which imports
    transformers: without it this raises ImportError before any work."""
    from asr_shap_torch.core.config import Wav2Vec2ConformerConfig
    from asr_shap_torch.core.device import resolve_device

    device = resolve_device(args.device)
    cfg = _preset_config(args)
    if args.hf:
        from asr_shap_torch.models import convert_hf

        load = (convert_hf.load_pretrained_conformer if args.arch == "w2v2-conformer"
                else convert_hf.load_pretrained)
        return load(args.hf, device=device)
    if args.params:
        from asr_shap_torch.core.params_io import load_config, load_params

        embedded = load_config(args.params)
        return load_params(args.params, device=device), embedded or cfg
    if not args.random_init:
        logger.warning("no --params/--hf given; falling back to random init "
                       "(transcripts will be garbage; fine for runtime testing)")
    if isinstance(cfg, Wav2Vec2ConformerConfig):
        from asr_shap_torch.models.w2v2_conformer import init_w2v2_conformer_params

        return init_w2v2_conformer_params(0, cfg, device=device), cfg
    from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params

    return init_wav2vec2_params(0, cfg, device=device), cfg


def cmd_run_shap(args):
    from asr_shap_torch.core.config import ExplainerConfig, PipelineConfig, TestSetConfig
    from asr_shap_torch.core.store import AttributionStore
    from asr_shap_torch.pipeline.run_shap import run_shap_pipeline
    from asr_shap_torch.pipeline.testset import create_test_set

    mesh = _run_shap_mesh(args)
    params, cfg = _load_model(args)
    tcfg = TestSetConfig(num_samples=args.num_samples, snrs_db=tuple(args.snrs),
                         min_length=args.min_length, max_length=args.max_length,
                         seed=args.seed, noise_kind=args.noise_kind)
    pcfg = PipelineConfig(
        model=cfg,
        explainer=ExplainerConfig(nsamples=args.nsamples, draw_chunk=args.draw_chunk,
                                  output_chunk=args.output_chunk,
                                  host_draw_chunk=args.host_draw_chunk,
                                  method=args.method,
                                  num_background=args.num_background,
                                  kmeans_background=args.kmeans,
                                  kernel_num_segments=args.kernel_segments,
                                  # --method lime reads the shared flags:
                                  # --nsamples = perturbations, --kernel-
                                  # segments = coalition features
                                  lime_num_samples=args.nsamples,
                                  lime_num_segments=args.kernel_segments),
        testset=tcfg, data_dir=args.data_dir, seed=args.seed,
        sample_batch=args.sample_batch,
    )
    test_set = create_test_set(tcfg)
    store = AttributionStore(args.data_dir, async_writes=args.async_writes)
    results = run_shap_pipeline(params, pcfg, test_set, store,
                                resume=not args.no_resume, device=args.device, mesh=mesh)
    if mesh is None or mesh.is_main:
        print(json.dumps({
            "computed": len(results),
            "total_wall_s": round(sum(r["wall_s"] for r in results), 2),
            "data_dir": args.data_dir,
        }))


def _run_shap_mesh(args):
    """run-shap's mesh: from torchrun's environment under ``--mesh`` with a
    world of more than one process (each rank on ``cuda:LOCAL_RANK``, or the
    CPU), else None. A world of one runs unsharded, as the reference does on
    one device."""
    import os

    if not args.mesh:
        return None
    if int(os.environ.get("WORLD_SIZE", "1")) <= 1:
        logger.info("--mesh: a world of one process (no torchrun environment with "
                    "WORLD_SIZE > 1); running unsharded")
        return None
    from asr_shap_torch.core.config import MeshConfig
    from asr_shap_torch.parallel.mesh import init_mesh_from_env

    return init_mesh_from_env(MeshConfig(), device=args.device)


def cmd_sweep(args):
    from asr_shap_torch.core.config import MetricConfig
    from asr_shap_torch.core.store import AttributionStore
    from asr_shap_torch.pipeline.sweep import eta_wer_sweep, sweep_summary

    if args.plot:
        from asr_shap_torch.viz.static import require_matplotlib

        require_matplotlib(f"--plot {args.plot}", "drop --plot")
    params, cfg = _load_model(args)
    _check_arch(args, cfg)
    store = AttributionStore(args.data_dir)
    mcfg = MetricConfig(segment_ms=args.segment_ms, percentile=args.percentile,
                        itm_variant=args.itm)
    records = eta_wer_sweep(params, cfg, store, mcfg, batch=args.batch,
                            device=args.device)
    for r in records:
        print(json.dumps(r))
    summary = sweep_summary(records)
    # the headline r leaves out the snr=inf rows, whose eta_raw is 1 by construction
    print(json.dumps({"pearson_r": summary["pearson_r_noisy"],
                      "n": len(records), **summary}))
    if args.plot:
        from asr_shap_torch.viz.static import plot_eta_wer_scatter

        plot_eta_wer_scatter(records, out_path=args.plot)
        print(f"wrote {args.plot}")


def cmd_faithfulness(args):
    import numpy as np

    from asr_shap_torch.core.store import AttributionStore
    from asr_shap_torch.metrics.faithfulness import (
        faithfulness_curve,
        faithfulness_summary,
        make_transcribe_fn,
    )

    if args.plot:
        from asr_shap_torch.viz.static import require_matplotlib

        require_matplotlib(f"--plot {args.plot}", "drop --plot")
    params, cfg = _load_model(args)
    store = AttributionStore(args.data_dir)
    transcribe = make_transcribe_fn(params, cfg)

    records = []
    with open(args.out, "w") if args.out else contextlib.nullcontext() as out_fh:
        for i, data in enumerate(store.iter_samples()):
            if args.limit and i >= args.limit:
                break
            rec = faithfulness_curve(
                transcribe, np.asarray(data["audio"]), np.asarray(data["shap_values"]),
                str(data["text"]), fractions=tuple(args.fractions), mode=args.mode,
                fill=args.fill, n_random=args.n_random, seed=args.seed + i)
            k = data["key"]
            rec["key"] = f"sample_{k.index}_{k.type}_{k.snr}"
            records.append(rec)
            line = json.dumps(rec)
            print(line)
            if out_fh:
                out_fh.write(line + "\n")
                out_fh.flush()
        summary = faithfulness_summary(records)
        summary["mode"] = args.mode
        summary["fill"] = args.fill
        summary["fractions"] = list(args.fractions)
        print(json.dumps(summary))
        if out_fh:
            out_fh.write(json.dumps(summary) + "\n")
    if args.plot:
        from asr_shap_torch.viz.static import plot_faithfulness_curves

        plot_faithfulness_curves({args.data_dir: records}, out_path=args.plot)
        print(f"wrote {args.plot}")


def cmd_metric(args):
    import numpy as np
    import torch

    from asr_shap_torch.core.config import MetricConfig
    from asr_shap_torch.core.device import resolve_device
    from asr_shap_torch.metrics.eta_raw import eta_raw

    device = resolve_device(args.device)
    mixed = np.load(args.audio)
    noise = np.load(args.noise)
    shap = np.load(args.shap)
    clean = mixed - noise
    mcfg = MetricConfig(segment_ms=args.segment_ms, percentile=args.percentile,
                        itm_variant=args.itm)
    val = float(eta_raw(*(torch.from_numpy(a).to(device) for a in (clean, noise, shap)),
                        mcfg))
    print(json.dumps({"eta_raw": val, "segment_ms": args.segment_ms,
                      "percentile": args.percentile, "itm": args.itm}))


def cmd_transcribe(args):
    import numpy as np
    import torch

    from asr_shap_torch.audio.normalize import zero_mean_unit_var
    from asr_shap_torch.audio.resample import resample
    from asr_shap_torch.core.device import matmul_precision_scope, resolve_device
    from asr_shap_torch.metrics.confidence import mean_max_softmax_confidence
    from asr_shap_torch.models.heads import model_logits_fn
    from asr_shap_torch.ops.ctc import ctc_greedy_decode, ctc_ids_to_text
    from asr_shap_torch.viz.wav_io import read_wav

    params, cfg = _load_model(args)
    device = resolve_device(args.device)
    logits_fn = model_logits_fn(cfg)
    for path in args.inputs:
        if path.endswith(".npy"):
            audio = np.load(path).astype(np.float32).ravel()
            sr = args.sr
        else:
            audio, sr = read_wav(path)
            audio = np.asarray(audio, np.float32).ravel()
        if sr != 16_000:
            audio = resample(torch.from_numpy(audio), sr, 16_000).numpy()
        x = zero_mean_unit_var(torch.from_numpy(audio).to(device))[None]
        with torch.no_grad(), matmul_precision_scope(cfg.matmul_precision):
            logits = logits_fn(params, cfg, x)
        ids, keep = ctc_greedy_decode(logits)
        text = ctc_ids_to_text(ids[0], keep[0])
        conf = float(mean_max_softmax_confidence(logits[0]))
        print(json.dumps({
            "path": path,
            "transcript": text,
            "confidence": round(conf, 4),
            "samples": int(audio.shape[0]),
            "frames": int(logits.shape[1]),
        }))


def cmd_visualize(args):
    import numpy as np

    from asr_shap_torch.core.store import AttributionStore
    from asr_shap_torch.viz.interactive import AttributionViewer, load_attribution_view
    from asr_shap_torch.viz.static import require_matplotlib

    require_matplotlib("visualize", "the viewer is a figure; run it where matplotlib imports")
    params, cfg = _load_model(args)
    store = AttributionStore(args.data_dir)
    keys = store.keys()
    if not keys:
        sys.exit(f"no samples found in {args.data_dir}")
    data = store.load(keys[args.sample])
    view = load_attribution_view(params, cfg, np.asarray(data["audio"]),
                                 np.asarray(data["shap_values"]))
    viewer = AttributionViewer(view)
    if args.save:
        viewer.savefig(args.save)
        print(f"wrote {args.save}")
    else:
        viewer.show()


def cmd_compare(args):
    import numpy as np

    from asr_shap_torch.core.config import ExplainerConfig
    from asr_shap_torch.core.prng import generator
    from asr_shap_torch.pipeline.compare import comparison_record, lime_shap_comparison
    from asr_shap_torch.viz.static import require_matplotlib

    if args.out_dir:
        require_matplotlib(f"--out-dir {args.out_dir}", "pass --out-dir '' for the record alone")
    params, cfg = _load_model(args)
    _check_arch(args, cfg)
    if args.audio:
        audio = np.load(args.audio)
    else:
        from asr_shap_torch.pipeline.testset import synthetic_speech

        audio = synthetic_speech(generator(args.seed), int(round(args.clip_seconds * 16_000)))
    ecfg = ExplainerConfig(
        nsamples=args.nsamples,
        lime_num_samples=args.lime_samples,
        lime_num_segments=args.lime_segments,
        lime_keep_prob=args.lime_keep_prob,
        lime_ridge_alpha=args.ridge_alpha,
    )
    result = lime_shap_comparison(params, cfg, ecfg, audio, seed=args.seed,
                                  clip_seconds=args.clip_seconds, out_dir=args.out_dir)
    print(comparison_record(result))


def cmd_train(args):
    from asr_shap_torch.core.config import TrainConfig
    from asr_shap_torch.core.params_io import save_params
    from asr_shap_torch.pipeline.train_synthetic import train_synthetic

    params, cfg = _load_model(args)
    tcfg = TrainConfig(
        learning_rate=args.lr, num_epochs=args.epochs, batch_size=args.batch_size,
        snrs_db=tuple(args.train_snrs), early_stopping_patience=args.patience,
        freeze_feature_encoder=False, seed=args.seed,
    )
    # random init from --seed unless weights were given, as the reference
    params, summary = train_synthetic(
        cfg, tcfg, params=None if args.random_init or not (args.params or args.hf) else params,
        clip_seconds=args.clip_seconds, batches_per_epoch=args.batches_per_epoch,
        target_wer=args.target_wer, seed=args.seed, device=args.device,
    )
    save_params(args.out, params, config=cfg)
    summary["params_path"] = args.out
    print(json.dumps(summary))


def cmd_bench(args):
    from asr_shap_torch.core.config import Wav2Vec2Config
    from asr_shap_torch.pipeline.benchmarks import run_length_sweep

    numerics = dict(dtype=args.dtype, matmul_precision=args.precision,
                    attention_impl=args.attn)
    if args.tiny:
        model_config = Wav2Vec2Config(
            hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
            intermediate_size=128, conv_dim=(32, 32), conv_stride=(5, 2),
            conv_kernel=(10, 3), num_conv_pos_embeddings=16,
            num_conv_pos_embedding_groups=4, feat_proj_dim=32, **numerics,
        )
    else:
        model_config = Wav2Vec2Config(**numerics)
    run_length_sweep(lengths=tuple(args.lengths), nsamples=args.nsamples,
                     model_config=model_config, plot_path=args.plot, json_path=args.json,
                     device=args.device)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="asr_shap_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("run-shap", help="compute+persist attributions")
    _add_model_args(p)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--num-samples", type=int, default=20)
    p.add_argument("--snrs", type=float, nargs="+", default=[5.0, 2.0, 1.0])
    p.add_argument("--min-length", type=int, default=100_000)
    p.add_argument("--max-length", type=int, default=0)
    p.add_argument("--noise-kind", choices=["white", "pink", "babble"], default="white",
                   help="noise family mixed at each SNR")
    p.add_argument("--nsamples", type=int, default=200)
    p.add_argument("--draw-chunk", type=int, default=1)
    p.add_argument("--output-chunk", type=int, default=128,
                   help="cotangent rows per backward batch (0 = all T_frames at once)")
    p.add_argument("--host-draw-chunk", type=int, default=0,
                   help="split the draws into ceil(nsamples/N) chunks of N draws "
                        "each, phi the mean of the chunk means (0 = one chunk)")
    p.add_argument("--sample-batch", type=int, default=0,
                   help="samples per group call (0 = auto: 2 for short clips under "
                        "small draw budgets, else 1)")
    p.add_argument("--async-writes", action="store_true",
                   help="write the store's float32 arrays on the native writer pool")
    p.add_argument("--method", choices=["grad", "deep", "kernel", "lime"], default="grad",
                   help="grad = expected gradients; deep = DeepSHAP rescale rules; "
                        "kernel = KernelSHAP over waveform segments; lime = LIME "
                        "linear surrogate over the same segments")
    p.add_argument("--kernel-segments", type=int, default=32,
                   help="coalition segments over the waveform (--method kernel/lime)")
    p.add_argument("--num-background", type=int, default=5,
                   help="background rows (zeros + sigma*noise)")
    p.add_argument("--kmeans", type=int, default=0,
                   help=">0: summarize the background to k centroids before explaining")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", action="store_true",
                   help="shard over the processes of a torchrun launch (draws for "
                        "one-sample groups, else samples)")
    p.add_argument("--no-resume", action="store_true")
    p.set_defaults(fn=cmd_run_shap)

    p = sub.add_parser("sweep", help="eta_raw-vs-WER sweep over data/")
    _add_model_args(p)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--segment-ms", type=float, default=0.0625)
    p.add_argument("--percentile", type=float, default=99.0)
    p.add_argument("--itm", choices=["strict", "half"], default="strict")
    p.add_argument("--batch", type=int, default=8,
                   help="samples per batched decode + eta_raw (length buckets)")
    p.add_argument("--plot", type=str, default="",
                   help="scatter plot path (default none: the reference's default "
                        "wer_vs_eta_raw_plot.png needs matplotlib)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("faithfulness",
                       help="deletion/insertion faithfulness curves over a stored "
                            "attribution set (occlusion AUC vs seeded random rankings)")
    _add_model_args(p)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--fractions", type=float, nargs="+",
                   default=[0.01, 0.02, 0.05, 0.1, 0.2])
    p.add_argument("--mode", choices=["deletion", "insertion"], default="deletion")
    p.add_argument("--fill", choices=["zero", "noise"], default="zero")
    p.add_argument("--n-random", type=int, default=3,
                   help="random-ranking control repetitions per fraction")
    p.add_argument("--limit", type=int, default=0, help="stop after N samples (0 = all)")
    p.add_argument("--out", type=str, default=None,
                   help="also write the records and the summary as JSONL here")
    p.add_argument("--plot", type=str, default=None,
                   help="write the mean WER-vs-fraction curves figure here")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_faithfulness)

    p = sub.add_parser("metric", help="single-sample eta_raw")
    p.add_argument("--audio", required=True)
    p.add_argument("--noise", required=True)
    p.add_argument("--shap", required=True)
    p.add_argument("--segment-ms", type=float, default=0.0625)
    p.add_argument("--percentile", type=float, default=99.0)
    p.add_argument("--itm", choices=["strict", "half"], default="half")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_metric)

    p = sub.add_parser("visualize", help="interactive attribution viewer")
    _add_model_args(p)
    p.add_argument("--data-dir", default="data")
    p.add_argument("--sample", type=int, default=0)
    p.add_argument("--save", type=str, default=None,
                   help="render headless to this png instead of showing")
    p.set_defaults(fn=cmd_visualize)

    p = sub.add_parser("compare", help="LIME-vs-SHAP comparison on one clip")
    _add_model_args(p)
    p.add_argument("--audio", type=str, default=None,
                   help=".npy waveform; default a seeded synthetic clip")
    p.add_argument("--clip-seconds", type=float, default=2.0)
    p.add_argument("--nsamples", type=int, default=200,
                   help="SHAP expected-gradients draws")
    p.add_argument("--lime-samples", type=int, default=500, help="LIME perturbations")
    p.add_argument("--lime-segments", type=int, default=64)
    p.add_argument("--lime-keep-prob", type=float, default=0.5)
    p.add_argument("--ridge-alpha", type=float, default=1.0)
    p.add_argument("--out-dir", type=str, default="artifacts",
                   help="figure, wavs and stats JSON here ('' = none)")
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("transcribe", help="greedy CTC transcription of wav/npy clips")
    _add_model_args(p)
    p.add_argument("inputs", nargs="+", help=".wav or .npy waveform files (npy at --sr)")
    p.add_argument("--sr", type=int, default=16_000,
                   help="sample rate of .npy inputs (resampled to 16 kHz when "
                        "different; .wav files carry their own rate)")
    p.set_defaults(fn=cmd_transcribe)

    p = sub.add_parser("train", help="CTC training on the text-conditional synthetic "
                                     "corpus until greedy decode works")
    _add_model_args(p)
    p.add_argument("--out", type=str, default="params_synthetic.npz",
                   help="output .npz params path (with the embedded config)")
    p.add_argument("--epochs", type=int, default=40)
    p.add_argument("--batches-per-epoch", type=int, default=100)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--clip-seconds", type=float, default=2.0)
    p.add_argument("--patience", type=int, default=5)
    p.add_argument("--train-snrs", type=float, nargs="*", default=[],
                   help="optional noise-augmentation SNRs (empty = clean)")
    p.add_argument("--target-wer", type=float, default=0.1)
    p.add_argument("--seed", type=int, default=0)
    p.set_defaults(fn=cmd_train)

    p = sub.add_parser("bench", help="runtime-vs-length sweep")
    p.add_argument("--lengths", type=int, nargs="+",
                   default=[2500, 5000, 10000, 20000, 40000, 80000])
    p.add_argument("--nsamples", type=int, default=16)
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--plot", type=str, default=None, help="runtime plot path")
    p.add_argument("--json", type=str, default=None)
    # the reference's throughput numerics by default; --dtype float32
    # --precision highest for the parity path's timing
    p.add_argument("--dtype", choices=["bfloat16", "float32"], default="bfloat16")
    p.add_argument("--precision", choices=["default", "highest"], default="default")
    p.add_argument("--attn", choices=["xla", "pallas", "auto"], default="xla")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench)
    return ap


def main(argv=None):
    logging.basicConfig(level=logging.INFO,
                        format="%(asctime)s - %(levelname)s - %(message)s")
    args = build_parser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
