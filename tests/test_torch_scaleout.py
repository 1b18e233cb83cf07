"""run-shap's scale-out and data-parallel training in the port on the CPU:
one 2-rank gloo group (two spawned processes, started once for the module)
runs every sharded scenario, tensor-parallel logits of both Wav2Vec2
families and the TP waveform gradient, the draw-sharded explainer, the
meshed pipeline, data-parallel train steps and the meshed epoch loop, and
the results are held here to the reference and to the port unsharded; then the
mesh's and TP's rules, the group-size policy, and the pipeline's fallbacks
(a failed group, a lost device, a failed re-staging) with the errors
injected through the group step. The reference's modules are imported
inside the tests that use them: the spawned ranks import this module."""

import dataclasses
import datetime
import multiprocessing
import traceback

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
import torch.distributed as dist

from asr_shap.core.config import ExplainerConfig as JaxExplainerConfig
from asr_shap_torch.core import config as pc
from asr_shap_torch.core.store import AttributionStore
from asr_shap_torch.explain.expected_gradients import expected_gradients_sharded, expected_phi
from asr_shap_torch.models.heads import make_explained_fn, model_logits_fn
from asr_shap_torch.models.wav2vec2 import init_wav2vec2_params
from asr_shap_torch.core.params_io import params_from_jax
from asr_shap_torch.parallel.mesh import make_mesh, replicate, shard_rows
from asr_shap_torch.parallel.tp import shard_params_tp, tp_specs
from asr_shap_torch.pipeline import run_shap as rs
from asr_shap_torch.pipeline import train as ptrain
from asr_shap_torch.pipeline.prefetch import prefetch_to_device
from asr_shap_torch.pipeline.testset import create_test_set
from torch_port_configs import (
    conformer_params,
    jax_draws,
    narrow_conformer_config,
    narrow_config,
    port_cfg,
    shared_params,
)

FAMILIES = ("wav2vec2", "relative", "rotary")
N = 800
EC = JaxExplainerConfig(nsamples=4, draw_chunk=2, output_chunk=0, num_background=3,
                        remat=False)
# data-parallel training: the narrow Wav2Vec2 with the kernel impls, a batch
# of 4 (2 per rank), the train tests' learning rate
LR = 1e-3
DP_STEPS = 2


def _model(family):
    """(reference config, port params, reference params) of a family at
    narrow widths: 2 layers, 2 heads, attention on its plain math."""
    if family == "wav2vec2":
        cfg = dataclasses.replace(narrow_config(), attention_impl="xla")
        params, ref = shared_params(cfg)
    else:
        cfg = narrow_conformer_config(attention_impl="xla", position_embeddings_type=family)
        params, ref = conformer_params(cfg, 0)
    return cfg, params, ref


def _numpy(tree):
    if isinstance(tree, dict):
        return {k: _numpy(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_numpy(v) for v in tree]
    return tree.numpy()


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_torch(v) for v in tree]
    return torch.from_numpy(tree)


def _pipeline_cfg(sample_batch, data_dir):
    return pc.PipelineConfig(
        model=port_cfg(narrow_config()),
        explainer=pc.ExplainerConfig(**dataclasses.asdict(EC)),
        testset=pc.TestSetConfig(num_samples=1, snrs_db=(5.0, 2.0), min_length=N,
                                 max_length=N),
        data_dir=data_dir, sample_batch=sample_batch)


def _scenarios(inputs):
    """One rank's share of every sharded scenario; rank-local results."""
    out = {}
    x = torch.from_numpy(inputs["x"])
    tp_mesh = make_mesh(pc.MeshConfig(data_parallel=1, model_parallel=2), device="cpu")
    for family in FAMILIES:
        cfg = inputs["cfgs"][family]
        local = shard_params_tp(_torch(inputs["params"][family]), tp_mesh)
        out[f"logits {family}"] = model_logits_fn(cfg)(
            local, cfg, x, lengths=torch.tensor([N, 550]), tp=tp_mesh).numpy()
    base = inputs["cfgs"]["wav2vec2"]
    ec = inputs["ec"]
    one = (torch.tensor([2]), torch.tensor([0.37]))
    local = shard_params_tp(_torch(inputs["params"]["wav2vec2"]), tp_mesh)
    out["phi tp"] = expected_phi(
        make_explained_fn(local, base, ec, tp=tp_mesh), x[0], torch.from_numpy(inputs["bg"]),
        config=dataclasses.replace(ec, nsamples=1, draw_chunk=1), draws=one).numpy()

    mesh = make_mesh(pc.MeshConfig(), device="cpu")
    params = _torch(inputs["params"]["wav2vec2"])
    f = make_explained_fn(params, base, ec)
    out["phi draw-sharded"] = expected_gradients_sharded(
        f, x[0], torch.from_numpy(inputs["bg"]), mesh, config=ec,
        draws=tuple(torch.from_numpy(d) for d in inputs["draws"])).values.numpy()
    out["shard_rows"] = shard_rows(mesh, torch.arange(8.0).reshape(2, 4), axis=1).numpy()
    out["replicate"] = replicate(mesh, torch.full((3,), float(dist.get_rank()))).numpy()
    for sb in (1, 2):
        res = rs.run_shap_pipeline(params, _pipeline_cfg(sb, inputs["dirs"][sb]),
                                   inputs["test_set"], mesh=mesh)
        out[f"pipeline {sb}"] = [(r["index"], r["shap_values"], r["transcription"])
                                 for r in res]
    out.update(_dp_scenarios(inputs, mesh))
    return out


def _dp_scenarios(inputs, mesh):
    """Data-parallel training on the (2, 1) mesh: DP_STEPS steps from
    replicated params on this rank's half of the batch; the epoch loop with
    validation and a checkpointer shared by both ranks; shard_batch and
    replicate_params on rank-dependent inputs."""
    out = {}
    cfg, tcfg, batch = inputs["dp_cfg"], inputs["dp_tcfg"], inputs["dp_batch"]
    opt = ptrain.make_optimizer(tcfg)
    p = ptrain.replicate_params(_torch(inputs["params"]["wav2vec2"]), mesh)
    state = ptrain.replicate_params(opt.init(ptrain.trainable_leaves(p, tcfg)), mesh)
    step = ptrain.make_train_step(cfg, tcfg, opt, mesh)
    losses = []
    for _ in range(DP_STEPS):
        p, state, loss = step(p, state, ptrain.shard_batch(batch, mesh))
        losses.append(float(loss))
    out["dp step"] = {"losses": losses, "params": _numpy(p), "count": state["count"],
                      "mu": {k: t.numpy() for k, t in state["mu"].items()},
                      "nu": {k: t.numpy() for k, t in state["nu"].items()}}

    ck = ptrain.Checkpointer(inputs["dirs"]["dp"], keep=1)
    _, _, history = ptrain.train(_torch(inputs["params"]["wav2vec2"]), cfg,
                                 dataclasses.replace(tcfg, num_epochs=1),
                                 [batch] * DP_STEPS, [batch], mesh=mesh, checkpointer=ck)
    out["dp train"] = {"history": history, "saved": sorted(ck._losses)}

    rank = dist.get_rank()
    ragged = {"a": np.arange(8).reshape(4, 2), "b": torch.arange(4.0), "_texts": list("wxyz")}
    out["shard_batch"] = {k: v.numpy() for k, v in ptrain.shard_batch(ragged, mesh).items()}
    out["prefetch"] = [{k: v.numpy() for k, v in b.items()}
                       for b in prefetch_to_device([ragged] * 2, mesh=mesh)]
    try:
        ptrain.shard_batch({"a": np.zeros(3)}, mesh)
    except ValueError as e:
        out["uneven"] = str(e)
    tree = {"count": rank + 3, "mu": {"a": torch.full((2,), float(rank))}}
    got = ptrain.replicate_params(tree, mesh)
    out["replicate_params"] = (got["count"], got["mu"]["a"].numpy())
    return out


def _rank_main(rank, init_file, inputs, queue):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}", rank=rank,
                            world_size=2, timeout=datetime.timedelta(seconds=120))
    try:
        queue.put((rank, _scenarios(inputs), None))
    except BaseException:
        queue.put((rank, None, traceback.format_exc()))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """Both ranks' results, and what they ran on."""
    rng = np.random.default_rng(5)
    tmp = tmp_path_factory.mktemp("scaleout")
    models = {family: _model(family) for family in FAMILIES}
    key = jax.random.key(11)
    draws = jax_draws(key, 4, 3)
    n_dp, dp_rng = 1600, np.random.default_rng(1)
    inputs = {
        "dp_cfg": port_cfg(narrow_config()),
        "dp_tcfg": pc.TrainConfig(learning_rate=LR, freeze_feature_encoder=False),
        "dp_batch": {"audio": dp_rng.standard_normal((4, n_dp)).astype(np.float32),
                     "audio_lengths": np.array([n_dp, n_dp - 200, n_dp - 400, n_dp], np.int32),
                     "labels": dp_rng.integers(5, 32, (4, 6)).astype(np.int32),
                     "label_lengths": np.array([6, 4, 0, 5], np.int32)},
        "x": rng.standard_normal((2, N)).astype(np.float32),
        "bg": (0.01 * rng.standard_normal((3, N))).astype(np.float32),
        "draws": tuple(d.numpy() for d in draws),
        "cfgs": {f: port_cfg(m[0]) for f, m in models.items()},
        "params": {f: _numpy(m[1]) for f, m in models.items()},
        "ec": pc.ExplainerConfig(**dataclasses.asdict(EC)),
        "test_set": create_test_set(pc.TestSetConfig(num_samples=1, snrs_db=(5.0, 2.0),
                                                     min_length=N, max_length=N)),
        "dirs": {**{sb: str(tmp / f"mesh{sb}") for sb in (1, 2)}, "dp": str(tmp / "dp_ck")},
    }
    ctx = multiprocessing.get_context("spawn")
    queue = ctx.Queue()
    procs = [ctx.Process(target=_rank_main, args=(r, str(tmp / "gloo_init"), inputs, queue))
             for r in range(2)]
    for p in procs:
        p.start()
    got = {}
    try:
        for _ in procs:
            rank, out, err = queue.get(timeout=300)
            got[rank] = (out, err)
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    errors = [err for _, err in got.values() if err]
    assert not errors, errors[0]
    return {"ranks": [got[0][0], got[1][0]], "inputs": inputs, "models": models,
            "key": key, "draws": draws}


@pytest.mark.parametrize("family", FAMILIES)
def test_tp_logits_match_reference(two_ranks, family):
    """model_parallel=2 (1 head per rank): both ranks' logits against the
    reference's unsharded forward (atol 1e-4 / rtol 1e-3, the model tests'
    float32 tolerance) and the port unsharded (1e-5 of max|logits|)."""
    from asr_shap.models.w2v2_conformer import w2v2_conformer_logits as jax_conformer_logits
    from asr_shap.models.wav2vec2 import wav2vec2_logits as jax_logits

    cfg, params, ref_params = two_ranks["models"][family]
    x = two_ranks["inputs"]["x"]
    lengths = np.array([N, 550])
    ref_fn = jax_logits if family == "wav2vec2" else jax_conformer_logits
    ref = np.asarray(jax.jit(lambda p, a, n: ref_fn(p, cfg, a, lengths=n))(
        ref_params, jnp.asarray(x), jnp.asarray(lengths)))
    plain = model_logits_fn(port_cfg(cfg))(params, port_cfg(cfg), torch.from_numpy(x),
                                           lengths=torch.from_numpy(lengths)).numpy()
    for rank in two_ranks["ranks"]:
        got = rank[f"logits {family}"]
        np.testing.assert_allclose(got, ref, atol=1e-4, rtol=1e-3)
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-5 * np.abs(plain).max())


def test_tp_waveform_gradient_matches_unsharded(two_ranks):
    """One draw's phi through the TP forward's batched VJP (the collectives'
    vmap rules): within 1e-4 of max|phi| of the port unsharded."""
    _, params, _ = two_ranks["models"]["wav2vec2"]
    inputs = two_ranks["inputs"]
    cfg, ec = inputs["cfgs"]["wav2vec2"], inputs["ec"]
    want = expected_phi(make_explained_fn(params, cfg, ec), torch.from_numpy(inputs["x"][0]),
                        torch.from_numpy(inputs["bg"]),
                        config=dataclasses.replace(ec, nsamples=1, draw_chunk=1),
                        draws=(torch.tensor([2]), torch.tensor([0.37]))).numpy()
    for rank in two_ranks["ranks"]:
        np.testing.assert_allclose(rank["phi tp"], want, rtol=0,
                                   atol=1e-4 * np.abs(want).max())


def test_draw_sharded_phi_matches_reference_sharded(two_ranks):
    """2 gloo ranks against the reference's expected_gradients_sharded on 2
    CPU devices, fed the same draw per id: 2e-3 of max|phi| (the port's
    phi tolerance); against the port unsharded over the same 4 draws, 1e-6
    of max|phi| (only the order of the sum differs)."""
    from jax.sharding import Mesh as JaxMesh

    from asr_shap.explain.expected_gradients import (
        expected_gradients_sharded as jax_eg_sharded,
    )
    from asr_shap.models.heads import make_explained_fn as jax_make_f

    cfg, params, ref_params = two_ranks["models"]["wav2vec2"]
    inputs = two_ranks["inputs"]
    x, bg = inputs["x"][0], inputs["bg"]
    mesh = JaxMesh(np.array(jax.devices()[:2]), ("data",))
    f_ref = jax_make_f(ref_params, cfg, EC)
    ref = np.asarray(jax.jit(lambda a, b, k: jax_eg_sharded(f_ref, a, b, k, mesh, EC).values)(
        jnp.asarray(x), jnp.asarray(bg), two_ranks["key"]))
    plain = expected_phi(make_explained_fn(params, port_cfg(cfg), inputs["ec"]),
                         torch.from_numpy(x), torch.from_numpy(bg), config=inputs["ec"],
                         draws=two_ranks["draws"]).numpy()
    scale = np.abs(ref).max()
    for rank in two_ranks["ranks"]:
        got = rank["phi draw-sharded"]
        assert got.shape == ref.shape == (N, cfg.frames_for_samples(N))
        np.testing.assert_allclose(got, ref, rtol=0, atol=2e-3 * scale)
        np.testing.assert_allclose(got, plain, rtol=0, atol=1e-6 * np.abs(plain).max())


@pytest.fixture(scope="module")
def unmeshed(two_ranks, tmp_path_factory):
    """The pipeline without a mesh, on one thread as the ranks run: the CPU
    kernels' sums take another order at another thread count."""
    d = str(tmp_path_factory.mktemp("flat"))
    _, params, _ = two_ranks["models"]["wav2vec2"]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        return rs.run_shap_pipeline(params, _pipeline_cfg(1, d),
                                    two_ranks["inputs"]["test_set"], device="cpu"), d
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize("sample_batch", [1, 2])
def test_meshed_pipeline_matches_unmeshed(two_ranks, unmeshed, sample_batch):
    """sample_batch=1 shards the draws (nsamples a multiple of draw_chunk x
    2, so the draw count is the unmeshed run's): within 1e-6 of max|phi|.
    sample_batch=2 shards the samples, 3 samples in groups of 2, the last
    padded: equal. Both ranks return every sample; rank 0 alone wrote the
    store, the unmeshed run's bytes when the phis are equal."""
    flat, flat_dir = unmeshed
    for rank in two_ranks["ranks"]:
        got = rank[f"pipeline {sample_batch}"]
        assert [g[0] for g in got] == [r["index"] for r in flat] == [0, 1, 2]
        for (_, phi, text), want in zip(got, flat):
            assert text == want["transcription"]
            if sample_batch == 1:
                np.testing.assert_allclose(phi, want["shap_values"], rtol=0,
                                           atol=1e-6 * np.abs(want["shap_values"]).max())
            else:
                np.testing.assert_array_equal(phi, want["shap_values"])
    store = AttributionStore(two_ranks["inputs"]["dirs"][sample_batch])
    assert len(store.keys()) == 3 and all(store.completed(k) for k in store.keys())
    if sample_batch == 2:
        from pathlib import Path

        files = {p.name: p.read_bytes() for p in Path(store.data_dir).glob("*.npy")}
        assert files == {p.name: p.read_bytes() for p in Path(flat_dir).glob("*.npy")}


def test_shard_rows_and_replicate(two_ranks):
    """The counterparts of data_sharding and replicated: each rank's block
    of the sharded axis, and rank 0's tensor on every rank."""
    whole = np.arange(8.0).reshape(2, 4)
    for rank, out in enumerate(two_ranks["ranks"]):
        np.testing.assert_array_equal(out["shard_rows"], whole[:, 2 * rank:2 * rank + 2])
        np.testing.assert_array_equal(out["replicate"], np.zeros(3))


def _port_leaves(tree):
    """{path: numpy array} of a port params tree of numpy arrays."""
    return {k: t.numpy() for k, t in ptrain.named_leaves(_torch(tree))}


def _reference_leaves(tree):
    """{path: numpy array} of a reference tree (layers stacked), in the
    port's paths."""
    return {k: t.numpy() for k, t in ptrain.named_leaves(
        params_from_jax(jax.tree.map(np.asarray, tree), device="cpu"))}


def test_dp_train_steps_match_reference_sharded(two_ranks):
    """DP_STEPS data-parallel steps on 2 gloo ranks (2 clips each) against
    the reference's replicate_params/shard_batch step on a 2-device CPU mesh,
    at test_torch_train.py's tolerances: losses rtol 2e-5, first moments
    within 1e-4 of the largest, params within 0.1 lr per step on all but
    0.1% of each leaf's elements and 2 lr per step everywhere; the two
    ranks' params and moments bit-equal."""
    from asr_shap.core.config import MeshConfig as JaxMeshConfig
    from asr_shap.core.config import TrainConfig as JaxTrainConfig
    from asr_shap.parallel.mesh import make_mesh as jax_make_mesh
    from asr_shap.pipeline import train as jtrain

    cfg, _, ref = two_ranks["models"]["wav2vec2"]
    xla = dataclasses.replace(cfg, attention_impl="xla", conv_impl="lax")
    mesh = jax_make_mesh(JaxMeshConfig(), jax.devices()[:2])
    jcfg = JaxTrainConfig(learning_rate=LR, freeze_feature_encoder=False)
    opt = jtrain.make_optimizer(jcfg)
    jp, js = jtrain.replicate_params(ref, mesh), jtrain.replicate_params(opt.init(ref), mesh)
    step = jax.jit(jtrain.make_train_step(xla, jcfg, opt))
    want = []
    for _ in range(DP_STEPS):
        jp, js, loss = step(jp, js, jtrain.shard_batch(two_ranks["inputs"]["dp_batch"], mesh))
        want.append(float(loss))

    ranks = [r["dp step"] for r in two_ranks["ranks"]]
    mu_ref = _reference_leaves(js[1][0].mu)
    p_ref = _reference_leaves(jp)
    scale = max(float(np.abs(m).max()) for m in mu_ref.values())
    step_lr = LR * DP_STEPS
    for got in ranks:
        np.testing.assert_allclose(got["losses"], want, rtol=2e-5)
        assert got["count"] == DP_STEPS and got["mu"].keys() == mu_ref.keys()
        for k, m in got["mu"].items():
            np.testing.assert_allclose(m, mu_ref[k], rtol=0, atol=1e-4 * scale, err_msg=k)
        params = _port_leaves(got["params"])
        assert params.keys() == p_ref.keys()
        for k, b in params.items():
            err = np.abs(b - p_ref[k])
            assert (err > 0.1 * step_lr).mean() <= 1e-3, k
            np.testing.assert_allclose(b, p_ref[k], rtol=0, atol=2 * step_lr, err_msg=k)
    a, b = ranks
    assert a["losses"] == b["losses"]
    for part in ("mu", "nu"):
        for k in a[part]:
            np.testing.assert_array_equal(a[part][k], b[part][k], err_msg=f"{part} {k}")
    pa, pb = _port_leaves(a["params"]), _port_leaves(b["params"])
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)


def test_dp_train_loop(two_ranks):
    """train(mesh=) on both ranks: the same history, its train loss the mean
    of the DP steps' losses (bit for bit: the same steps from the same
    params), a finite validation loss, and the epoch's checkpoint written by
    mesh rank 0 alone into the directory both ranks were given."""
    runs = [r["dp train"] for r in two_ranks["ranks"]]
    losses = two_ranks["ranks"][0]["dp step"]["losses"]
    assert runs[0]["history"] == runs[1]["history"]
    (epoch,) = runs[0]["history"]
    assert epoch["train_loss"] == float(np.mean(losses))
    assert np.isfinite(epoch["val_loss"])
    assert runs[0]["saved"] == [0] and runs[1]["saved"] == []
    ck = ptrain.Checkpointer(two_ranks["inputs"]["dirs"]["dp"], keep=1)
    assert ck.best_step == 0 and ck._losses == {0: epoch["val_loss"]}


def test_shard_batch_and_replicate_params(two_ranks):
    """shard_batch: each rank's rows of every leaf, the host-only "_" keys
    dropped, also through prefetch_to_device(mesh=); a batch of 3 rows over
    2 ranks raises ValueError. replicate_params: rank 0's tensors and step
    count on every rank."""
    for rank, out in enumerate(two_ranks["ranks"]):
        rows = slice(2 * rank, 2 * rank + 2)
        want = {"a": np.arange(8).reshape(4, 2)[rows], "b": np.arange(4.0)[rows]}
        for got in [out["shard_batch"]] + out["prefetch"]:
            assert got.keys() == want.keys()
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])
        assert "does not split over 2 data ranks" in out["uneven"]
        count, mu = out["replicate_params"]
        assert count == 3 and type(count) is int
        np.testing.assert_array_equal(mu, np.zeros(2))


@pytest.mark.parametrize("family", ["wav2vec2", "relative"])
def test_tp_specs_equal_reference_rule(family):
    """The port's partition of every leaf equals the reference's _spec_for
    on the same key path."""
    from asr_shap.parallel.tp import _spec_for as jax_spec_for

    _, params, _ = _model(family)
    ours = jax.tree_util.tree_flatten_with_path(
        tp_specs(params), is_leaf=lambda v: isinstance(v, tuple))[0]
    leaves = jax.tree_util.tree_flatten_with_path(_numpy(params))[0]
    assert len(ours) == len(leaves)
    sharded = 0
    for (path, spec), (lpath, leaf) in zip(ours, leaves):
        assert path == lpath
        assert spec == tuple(jax_spec_for(lpath, leaf, "model")), path
        sharded += bool(spec)
    assert sharded == 2 * (10 if family == "wav2vec2" else 15)


def test_make_mesh_errors(tmp_path):
    """No process group: RuntimeError. In a world of one, a mesh of 2 x 1 or
    1 x 2 needs more ranks: ValueError, as the reference's make_mesh."""
    with pytest.raises(RuntimeError, match="initialized"):
        make_mesh(pc.MeshConfig(), device="cpu")
    dist.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}", rank=0,
                            world_size=1)
    try:
        with pytest.raises(ValueError, match="needs 2 devices, have 1"):
            make_mesh(pc.MeshConfig(data_parallel=2), device="cpu")
        with pytest.raises(ValueError, match="mesh 0x2"):
            make_mesh(pc.MeshConfig(model_parallel=2), device="cpu")
        mesh = make_mesh(pc.MeshConfig(), device="cpu")
        assert (mesh.data_size, mesh.model_size, mesh.is_main) == (1, 1, True)
    finally:
        dist.destroy_process_group()


def test_group_size_policy():
    """The reference's policy (tests/test_pipeline.py::test_auto_group_size_policy),
    and under a mesh of 2 data ranks: the draws shard below the axis, the
    samples at or above it (rounded down), and the methods without a draw
    axis always shard samples (rounded up)."""
    assert [rs._auto_group_size(n, s) for n, s in (
        (48_000, 8), (99_999, 16), (48_000, 32), (48_000, 200), (100_000, 8),
        (118_400, 200))] == [2, 2, 1, 1, 1, 1]
    cfg = pc.PipelineConfig(explainer=pc.ExplainerConfig(nsamples=8))
    assert rs._group_size(cfg, None, 48_000) == 2
    assert rs._group_size(cfg, None, 120_000) == 1
    assert rs._group_size(pc.PipelineConfig(), None, 48_000) == 1
    assert rs._group_size(pc.PipelineConfig(sample_batch=4), None, 120_000) == 4

    class TwoRanks:
        data_size = 2

    mesh = TwoRanks()
    for sb, grad, deep in ((1, 1, 2), (2, 2, 2), (3, 2, 4), (5, 4, 6)):
        assert rs._group_size(pc.PipelineConfig(sample_batch=sb), mesh, 48_000) == grad
        deep_cfg = pc.PipelineConfig(sample_batch=sb,
                                     explainer=pc.ExplainerConfig(method="deep"))
        assert rs._group_size(deep_cfg, mesh, 48_000) == deep


def test_device_unavailable_classification():
    """Only a lost device or peer enters crash recovery: an AcceleratorError
    or a distributed backend/network error that says so. Out-of-memory,
    and other exceptions carrying the same words, do not."""
    assert rs._is_device_unavailable(torch.AcceleratorError("CUDA error: device unavailable"))
    assert rs._is_device_unavailable(dist.DistBackendError("NCCL error: peer lost"))
    assert rs._is_device_unavailable(dist.DistNetworkError("Connection reset by peer"))
    assert not rs._is_device_unavailable(torch.AcceleratorError("CUDA error: invalid argument"))
    assert not rs._is_device_unavailable(torch.OutOfMemoryError("device unavailable"))
    assert not rs._is_device_unavailable(RuntimeError("UNAVAILABLE: not the device's"))
    assert not rs._is_device_unavailable(ValueError("device lost"))


# The fallbacks run the tiny pipeline: 4 samples of one length (clean and
# three SNRs), 2 draws each, conv widths of 32.
TINY = pc.Wav2Vec2Config(hidden_size=64, num_hidden_layers=2, num_attention_heads=2,
                         intermediate_size=128, conv_dim=(32, 32), conv_stride=(5, 2),
                         conv_kernel=(10, 3), num_conv_pos_embeddings=16,
                         num_conv_pos_embedding_groups=4, feat_proj_dim=32)


@pytest.fixture(scope="module")
def tiny_run():
    params = init_wav2vec2_params(0, TINY, device="cpu")
    test_set = create_test_set(pc.TestSetConfig(num_samples=1, snrs_db=(5.0, 2.0, 1.0),
                                                min_length=800, max_length=800))
    return params, test_set


def _tiny_cfg(tmp_path, **kw):
    return pc.PipelineConfig(model=TINY, data_dir=str(tmp_path),
                             explainer=pc.ExplainerConfig(nsamples=2, draw_chunk=2,
                                                          num_background=2), **kw)


def _lost():
    return torch.AcceleratorError("CUDA error: device unavailable (simulated)")


def _check_complete(results, test_set, reference=None):
    assert [r["index"] for r in results] == list(range(len(test_set)))
    for r in results:
        assert np.isfinite(r["shap_values"]).all()
    if reference is not None:
        for r, want in zip(results, reference):
            np.testing.assert_array_equal(r["shap_values"], want["shap_values"])


@pytest.fixture(scope="module")
def tiny_serial(tiny_run, tmp_path_factory):
    params, test_set = tiny_run
    return rs.run_shap_pipeline(params, _tiny_cfg(tmp_path_factory.mktemp("serial"),
                                                  sample_batch=1), test_set, device="cpu")


def test_group_failure_falls_back_to_serial(tiny_run, tiny_serial, tmp_path, monkeypatch):
    """A grouped call that fails (here a plain RuntimeError) degrades the run
    to one sample per call, which completes every sample with the serial
    run's phi."""
    params, test_set = tiny_run
    real = rs._build_group_step
    calls = {"failed": 0}

    def flaky(cfg, mesh, g):
        if g > 1:
            def boom(*a):
                calls["failed"] += 1
                raise RuntimeError("group too large (simulated)")
            return boom
        return real(cfg, mesh, g)

    monkeypatch.setattr(rs, "_build_group_step", flaky)
    results = rs.run_shap_pipeline(params, _tiny_cfg(tmp_path, sample_batch=4), test_set,
                                   device="cpu")
    assert calls["failed"] == 1
    _check_complete(results, test_set, tiny_serial)


def test_crash_recovery_restages_and_completes(tiny_run, tiny_serial, tmp_path, monkeypatch):
    """A lost device in a group of 4: the run waits (backoff 0), re-stages
    the params from its host copy, goes on one sample per call and
    completes; the re-staged params are what the later calls get."""
    params, test_set = tiny_run
    real = rs._build_group_step
    state = {"crashed": 0, "params": []}

    def flaky(cfg, mesh, g):
        step = real(cfg, mesh, g)
        if g > 1 and not state["crashed"]:
            def crash(*a):
                state["crashed"] += 1
                raise _lost()
            return crash

        def wrapped(p, xs, idxs):
            state["params"].append(p)
            return step(p, xs, idxs)
        return wrapped

    monkeypatch.setattr(rs, "_build_group_step", flaky)
    restaged = []
    real_stage = rs._stage_params
    monkeypatch.setattr(rs, "_stage_params",
                        lambda host, dev: restaged.append(real_stage(host, dev)) or restaged[-1])
    results = rs.run_shap_pipeline(params, _tiny_cfg(tmp_path, sample_batch=4, crash_retries=2,
                                                     crash_backoff_s=0.0),
                                   test_set, device="cpu")
    assert state["crashed"] == 1 and len(restaged) == 1
    assert len(state["params"]) == 4 and all(p is restaged[0] for p in state["params"])
    _check_complete(results, test_set, tiny_serial)


def test_crash_recovery_disabled_raises(tiny_run, tmp_path, monkeypatch):
    """crash_retries=0: a lost device at one sample per call propagates."""
    params, test_set = tiny_run

    def builder(cfg, mesh, g):
        def crash(*a):
            raise _lost()
        return crash

    monkeypatch.setattr(rs, "_build_group_step", builder)
    with pytest.raises(torch.AcceleratorError, match="unavailable"):
        rs.run_shap_pipeline(params, _tiny_cfg(tmp_path, sample_batch=1, crash_retries=0),
                             test_set, device="cpu")


def test_crash_recovery_retries_failed_restaging(tiny_run, tmp_path, monkeypatch):
    """A device still lost at re-staging takes a further recovery attempt
    instead of ending the run."""
    params, test_set = tiny_run
    real = rs._build_group_step
    state = {"crashed": 0, "put_failures": 0}

    def flaky(cfg, mesh, g):
        step = real(cfg, mesh, g)
        if g > 1 and not state["crashed"]:
            def crash(*a):
                state["crashed"] += 1
                raise _lost()
            return crash
        return step

    real_stage = rs._stage_params

    def flaky_stage(host, device):
        if state["put_failures"] < 1:
            state["put_failures"] += 1
            raise _lost()
        return real_stage(host, device)

    monkeypatch.setattr(rs, "_build_group_step", flaky)
    monkeypatch.setattr(rs, "_stage_params", flaky_stage)
    results = rs.run_shap_pipeline(params, _tiny_cfg(tmp_path, sample_batch=4, crash_retries=3,
                                                     crash_backoff_s=0.0),
                                   test_set, device="cpu")
    assert state["crashed"] == 1 and state["put_failures"] == 1
    _check_complete(results, test_set)
