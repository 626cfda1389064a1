"""PyTorch port: data parallelism over `torch.distributed` against JAX's
data axis, on the CPU with ranks over gloo (`torch_port_ranks.launch`, a
free port, a timeout on every rank).

(1) `BatchIterator(host_shard=True)` against JAX's at 2 and 3 processes,
    with ``drop_last`` on and off: the same rows on every process, bit for
    bit; (2) the native loader's host sharding against JAX's native loader
    (the C API takes the local batch); (3) `cp_linear_attention` on 2
    ranks, each with half of T, against JAX's under `shard_map` on 2 CPU
    devices, forward, and the gradients of q, k and v against JAX's
    attention on the whole sequence (`lax.pmax` takes no gradient), with
    and without a key mask (atol 1e-5); (4) the data-parallel stage-2 step at D = 32, 2
    layers, B = 4 (2 a rank), T = 30: every metric (``grad_norm`` among
    them) within 1e-6 of the port's one-process step on the global batch
    and the summed gradients within 1e-6 of its largest one; against JAX's
    step on the global batch (JAX's random numbers handed over) at the
    step-parity tests' bounds (metrics rtol 1e-4, parameters atol 5e-5 /
    rtol 5e-3); the cases: the plain and the fused layers, the reference
    mask with unequal m_lens across the ranks, an elbow clamp between the
    global batch mean and one rank's mean, denoiser dropout, and the
    loss-second-moment sampler, whose state is the same on both ranks and
    JAX's `update_state` over the global t and losses; (5) the 2-rank
    evaluator against the one-process one on the same global waves and x_T;
    (6) a sharded evaluation wave of 8 on 4 ranks (2 clips a rank) on the
    fused paths' plain versions, bit for bit against one process of 8, with
    every GEMM's summation order following its row count.
"""

import dataclasses
import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh as JaxMesh
from jax.sharding import PartitionSpec as P

import torch_port_ranks as R
from conductor_tpu.config import Config as JConfig
from conductor_tpu.config import DatasetSpec as JSpec
from conductor_tpu.config import DenoiserConfig as JDenoiser
from conductor_tpu.config import DiffusionConfig as JDiffusion
from conductor_tpu.config import TrainConfig as JTrain
from conductor_tpu.data import dataset as jds
from conductor_tpu.data import native_loader as jnl
from conductor_tpu.diffusion import timestep_samplers as jts
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.ops import temporal_linear_attention
from conductor_tpu.parallel import cp_linear_attention as jax_cp_attention
from conductor_tpu.parallel import pad_to_multiple as jax_pad
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch.config import Config, DatasetSpec, DenoiserConfig, DiffusionConfig
from conductor_tpu_torch.config import TrainConfig
from conductor_tpu_torch.data import dataset as pds
from conductor_tpu_torch.data import native_loader as pnl
from conductor_tpu_torch.diffusion import timestep_samplers as pts
from conductor_tpu_torch.parallel import Mesh, init_from_env, pad_to_multiple

torch.set_num_threads(2)

SPEC, JSPEC = DatasetSpec(clip_seconds=6), JSpec(clip_seconds=6)
N_CLIPS = 5
B, T = 4, 30  # the global batch: 2 rows a rank
WORLD = 2
STEP_METRICS = ("loss", "loss_mot_rec", "loss_mot_feat", "loss_velocity", "loss_elbow",
                "loss_head", "loss_body", "grad_norm")
DP_TOL = 1e-6


# ------------------------------------------------------------ (1), (2) loaders


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cm_parallel"))
    pds.make_synthetic_dataset(r, "train", num_clips=N_CLIPS, spec=SPEC, seed=3)
    pds.make_synthetic_dataset(r, "test", num_clips=N_CLIPS, spec=SPEC, seed=4)
    return r


def _batches(it, epochs=2):
    out = []
    for _ in range(epochs):
        out += [tuple(np.asarray(a) for a in b) for b in it]
    return out


def _assert_same(a, b):
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.mark.parametrize("pcount", [2, 3])
@pytest.mark.parametrize("drop_last", [True, False])
def test_batch_iterator_host_shards_match_jax(root, pcount, drop_last):
    """Every process's rows of every global batch of 6, two shuffled
    epochs: JAX's bit for bit; together the processes' rows are the
    one-process batch (its tail padded with wrapped rows where kept)."""
    mk = lambda mod, spec, **kw: mod.BatchIterator(  # noqa: E731
        mod.ConductorMotionDataset(root, "train", 2, "random", spec=spec), 6, seed=7, times=3,
        drop_last=drop_last, **kw)
    whole = _batches(mk(pds, SPEC))
    shards = []
    for i in range(pcount):
        port = mk(pds, SPEC, host_shard=True, process_index=i, process_count=pcount)
        ref = mk(jds, JSPEC, host_shard=True, process_index=i, process_count=pcount)
        assert port.local_batch_size == ref.local_batch_size == 6 // pcount
        got = _batches(port)
        _assert_same(got, _batches(ref))
        shards.append(got)
    for k, full in enumerate(whole):
        joined = [np.concatenate([s[k][j] for s in shards]) for j in range(3)]
        n = full[0].shape[0]
        for a, b in zip(joined, full):
            np.testing.assert_array_equal(a[:n], b)
        assert joined[0].shape[0] == n + (-n) % pcount


def test_host_shard_refuses_a_batch_the_processes_do_not_divide(root):
    ds = pds.ConductorMotionDataset(root, "train", 2, "random", spec=SPEC)
    with pytest.raises(ValueError, match="must divide process_count 4"):
        pds.BatchIterator(ds, 6, host_shard=True, process_index=0, process_count=4)
    with pytest.raises(ValueError, match="must divide process_count 4"):
        pnl.make_batch_iterator(ds, 6, host_shard=True, process_index=0, process_count=4)


@pytest.mark.parametrize("pcount", [2, 3])
def test_native_loader_host_shards_match_jax(root, pcount):
    """The C loader under host sharding: each process's batches of the
    global 6 are JAX's native iterator's, bit for bit, at the local batch
    (6 / pcount rows); with ``drop_last`` off both fall back to the Python
    iterator (the C side shards with drop_last only)."""
    if not jnl.native_available(build=True):
        pytest.skip("the JAX package's native loader did not build")
    ds = pds.ConductorMotionDataset(root, "train", 2, "random", spec=SPEC)
    jds_ = jds.ConductorMotionDataset(root, "train", 2, "random", spec=JSPEC)
    seen = []
    for i in range(pcount):
        port = pnl.make_batch_iterator(ds, 6, seed=11, times=4, host_shard=True, process_index=i,
                                       process_count=pcount)
        ref = jnl.make_batch_iterator(jds_, 6, seed=11, times=4, host_shard=True,
                                      process_index=i, process_count=pcount)
        assert port.kind == "native" and port.batch_size == ref.batch_size == 6 // pcount
        assert len(port) == len(ref) == N_CLIPS * 4 // 6
        got = _batches(port)
        _assert_same(got, _batches(ref))
        seen.append(got)
        port.close()
        fallback = pnl.make_batch_iterator(ds, 6, drop_last=False, host_shard=True,
                                           process_index=i, process_count=pcount)
        assert fallback.kind == "python" and fallback.local_batch_size == 6 // pcount
    # the processes' windows of one global batch are disjoint draws of it
    assert all(s[0][1].shape[0] == 6 // pcount for s in seen)


# ----------------------------------------------------- (3)-(5) on the ranks


def _cfg(jax_side=False, *, impl="flax", feat_impl="flax", dropout=0.0, **train):
    mods = (JConfig, JDenoiser, JDiffusion, JTrain) if jax_side else (
        Config, DenoiserConfig, DiffusionConfig, TrainConfig)
    C, D, Df, Tr = mods
    return C(denoiser=D(num_frames=32, latent_dim=32, ff_size=16, num_layers=2, num_heads=4,
                        train_layer_impl=impl, dropout=dropout),
             diffusion=Df(steps=8, schedule="cosine"),
             train=Tr(cached_features=True, sample_length=1, batch_size=B, feat_impl=feat_impl,
                      **train))


def _batch():
    rng = np.random.RandomState(0)
    return (rng.normal(size=(B, T, 64)).astype(np.float32),
            rng.uniform(0, 1, size=(B, T, 13, 2)).astype(np.float32))


def _jax_step(cfg, feats, motion, m_lens=None):
    """One JAX step on the port's synthetic weights (seeds 1 and 2, as
    `torch_port_ranks.make_trainer`) and the global batch; its metrics,
    updated parameters and the random numbers it drew (t, noise, and the
    keep mask read through `cond_from_features` on ones)."""
    probe = R.make_trainer({"cfg": _cfg()})
    sd = {k: v.numpy() for k, v in probe.model.state_dict().items()}
    feat_sd = {k: v.numpy() for k, v in probe.feat_model.state_dict().items()}
    tr = JaxTrainer(cfg)
    rng = jax.random.PRNGKey(0)
    state = tr.init_state(rng)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        feat_variables=jax.tree.map(jnp.asarray, import_motion_encoder(feat_sd)),
        opt_state=tr.tx.init(variables["params"]))
    t_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t = jax.random.randint(t_rng, (B,), 0, tr.sched.num_timesteps)
    noise_rng, cond_rng = jax.random.split(loss_rng)
    noise = jax.random.normal(noise_rng, (B, T, 26))
    _, ones_out = tr.model.apply({"params": state.params, "batch_stats": state.batch_stats},
                                 jnp.ones((B, T, 64)), True, method=tr.model.cond_from_features,
                                 rngs={"cond": cond_rng})
    lens = jnp.full((B,), T, jnp.int32) if m_lens is None else jnp.asarray(m_lens, jnp.int32)
    state, metrics = tr.train_step(state, (jnp.asarray(feats), jnp.asarray(motion), lens), rng)
    drawn = {"t": torch.from_numpy(np.array(t)), "noise": torch.from_numpy(np.array(noise)),
             "cond_keep": torch.from_numpy(np.array(ones_out[..., 0]))}
    return {k: float(v) for k, v in metrics.items()}, state.params, drawn


def _half_elbows(drawn, feats, motion):
    """Each rank's own elbow term (its rows' batch mean), unclamped."""
    out = []
    for r in range(WORLD):
        sl = slice(r * B // WORLD, (r + 1) * B // WORLD)
        case = {"cfg": _cfg(elbow_clamp=1e9), "feats": feats[sl], "motion": motion[sl], "steps": 1,
                "drawn": [{k: v[sl] for k, v in drawn.items()}]}
        out.append(R.run_case(case)["metrics"][0]["loss_elbow"])
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory, root):
    """Runs every rank task once, in one launch of 2 ranks (started while
    the parent computes the one-process and JAX sides), and returns
    {"cases", "jax", "one", "ranks", "attention", "eval"}."""
    tmp = str(tmp_path_factory.mktemp("dp_ranks"))
    feats, motion = _batch()
    m_lens = np.array([30, 12, 5, 7], np.int32)  # rank 0 counts 42 frames, rank 1 12
    # JAX draws the step's numbers from its key alone, so the three JAX
    # steps below draw these
    jax_out = {"flax": _jax_step(_cfg(True), feats, motion)}
    drawn = jax_out["flax"][2]
    e0, e1 = _half_elbows(drawn, feats, motion)
    g, top = (e0 + e1) / 2, max(e0, e1)
    clamp = (g + top) / 2  # inside for the global mean, outside for one rank's own
    base = {"feats": feats, "motion": motion, "steps": 1}
    cases = {
        "flax": dict(base, cfg=_cfg(), drawn=[drawn]),
        "mask": dict(base, cfg=_cfg(replicate_reference_mask=True), m_lens=m_lens, drawn=[drawn]),
        "elbow": dict(base, cfg=_cfg(elbow_clamp=clamp), drawn=[drawn], elbows=(e0, e1, clamp)),
        "fused": dict(base, cfg=_cfg(impl="pallas_fused", feat_impl="pallas"), steps=2),
        "dropout": dict(base, cfg=_cfg(dropout=0.1), steps=2),
        "sampler": dict(base, cfg=_cfg(timestep_sampler="loss-second-moment"), steps=3),
    }
    rng = np.random.RandomState(5)
    att = {x: rng.normal(size=(2, 16, 32)).astype(np.float32) for x in ("q", "k", "v", "cot")}
    att["mask"] = (np.arange(16)[None, :, None] < np.array([16, 11])[:, None, None]).astype(
        np.float32)
    att["heads"] = 4
    ev_cfg = _cfg()
    ev_cfg = ev_cfg.replace(dataset=SPEC, denoiser=dataclasses.replace(ev_cfg.denoiser,
                                                                       num_frames=180))
    ev = {"cfg": ev_cfg, "root": root, "wave": 4, "num_steps": 3}
    torch.save({"cases": cases, "attention": att, "evaluate": ev}, os.path.join(tmp, "in.pt"))
    result = {}
    worker = threading.Thread(target=lambda: result.setdefault(
        "ranks", R.launch("all", WORLD, tmp, timeout=300)))
    worker.start()
    # JAX's other steps and the one-process sides, while the ranks run
    jax_out["mask"] = _jax_step(_cfg(True, replicate_reference_mask=True), feats, motion, m_lens)
    jax_out["elbow"] = _jax_step(_cfg(True, elbow_clamp=clamp), feats, motion)
    for name in ("mask", "elbow"):
        for k, v in jax_out[name][2].items():
            np.testing.assert_array_equal(v.numpy(), drawn[k].numpy(), err_msg=f"{name} {k}")
    recorded = []
    real_update = pts.update_state

    def record(state, t, losses):
        recorded.append((np.array(t), np.array(losses)))
        return real_update(state, t, losses)

    pts.update_state = record
    try:
        one = {name: R.run_case(case) for name, case in cases.items()}
    finally:
        pts.update_state = real_update
    one_eval = R.evaluate_rows(dict(ev, wave=4))
    worker.join(330)
    assert "ranks" in result, "the ranks did not finish"
    return {"cases": cases, "jax": jax_out, "one": one, "ranks": result["ranks"], "att": att,
            "one_eval": one_eval, "recorded": recorded}


def test_cp_linear_attention_matches_jax_shard_map(dp):
    """Two ranks, 8 frames each, against JAX's `cp_linear_attention` under
    `shard_map` on a 2-device 'seq' mesh: the output, and the gradients of
    sum(out * cot) for q, k and v against those of JAX's attention on the
    whole sequence (JAX's sharded function cannot be differentiated:
    `lax.pmax` has no rule), with a ragged key mask and without."""
    att = dp["att"]
    mesh = JaxMesh(np.array(jax.devices()[:WORLD]), ("seq",))
    spec = P(None, "seq", None)
    for name, mask in (("mask", att["mask"]), ("nomask", None)):
        fn = shard_map(
            lambda q, k, v, m: jax_cp_attention(q, k, v, att["heads"], m if mask is not None
                                                else None),
            mesh=mesh, in_specs=(spec,) * 4, out_specs=spec)
        m = jnp.asarray(att["mask"] if mask is not None else np.ones_like(att["mask"]))
        q, k, v, cot = (jnp.asarray(att[x]) for x in ("q", "k", "v", "cot"))
        y = fn(q, k, v, m)
        # JAX's `pmax` has no differentiation rule, so its sharded function
        # takes no gradient: the gradients are those of the attention on the
        # whole sequence, which it computes (`tests/test_seq_parallel.py`)
        whole = lambda q, k, v: temporal_linear_attention(  # noqa: E731
            q, k, v, att["heads"], m if mask is not None else None, impl="xla")
        np.testing.assert_allclose(np.asarray(y), np.asarray(whole(q, k, v)), atol=1e-5)
        grads = jax.grad(lambda q, k, v: jnp.sum(whole(q, k, v) * cot), argnums=(0, 1, 2))(q, k, v)
        want = {"y": np.asarray(y), **{f"d{x}": np.asarray(g) for x, g in zip("qkv", grads)}}
        for r, out in enumerate(dp["ranks"]):
            sl = slice(r * 8, (r + 1) * 8)
            for key, w in want.items():
                np.testing.assert_allclose(out["attention"][name][key], w[:, sl], atol=1e-5,
                                           err_msg=f"{name} rank {r} {key}")


def _flat(grads):
    return np.concatenate([g.reshape(-1) for g in grads])


@pytest.mark.parametrize("case", ["flax", "fused", "mask", "elbow", "dropout", "sampler"])
def test_data_parallel_step_matches_the_one_process_step(dp, case):
    """Every metric within 1e-6 (relative) and the summed gradients within
    1e-6 of the largest gradient, on both ranks and every step."""
    one = dp["one"][case]
    for r, out in enumerate(dp["ranks"]):
        got = out["cases"][case]
        assert len(got["metrics"]) == len(one["metrics"]) == dp["cases"][case]["steps"]
        for i, (a, b) in enumerate(zip(got["metrics"], one["metrics"])):
            for k in STEP_METRICS:
                if np.isnan(b[k]):
                    assert np.isnan(a[k]), (k, a[k])
                    continue
                assert abs(a[k] - b[k]) <= DP_TOL * abs(b[k]), (case, r, i, k, a[k], b[k])
        for i, (ga, gb) in enumerate(zip(got["grads"], one["grads"])):
            fa, fb = _flat(ga), _flat(gb)
            assert np.abs(fa - fb).max() <= DP_TOL * np.abs(fb).max(), (case, r, i)
    if case == "elbow":
        e0, e1, clamp = dp["cases"]["elbow"]["elbows"]
        # a clamp on each rank would cut one rank's elbow gradient
        assert (e0 + e1) / 2 < clamp < max(e0, e1)
    if case == "mask":
        lens = np.minimum(dp["cases"]["mask"]["m_lens"], T)
        assert lens[:2].sum() != lens[2:].sum()


@pytest.mark.parametrize("case", ["flax", "mask", "elbow"])
def test_data_parallel_step_matches_jax_global_step(dp, case):
    """Each rank's step against JAX's step on the global batch, JAX's
    random numbers handed over: metrics rtol 1e-4, every parameter atol
    5e-5 / rtol 5e-3 (the step-parity tests' bounds)."""
    jm, jparams, _ = dp["jax"][case]
    want = dict((jax.tree_util.keystr(k), v)
                for k, v in jax.tree_util.tree_leaves_with_path(jparams))
    for r, out in enumerate(dp["ranks"]):
        got = out["cases"][case]
        for k in STEP_METRICS:
            np.testing.assert_allclose(got["metrics"][0][k], jm[k], rtol=1e-4, err_msg=f"{r} {k}")
        params = import_motion_transformer(got["params"])["params"]
        leaves = jax.tree_util.tree_leaves_with_path(params)
        assert len(leaves) == len(want)
        for key, g in leaves:
            name = jax.tree_util.keystr(key)
            np.testing.assert_allclose(np.asarray(g), np.asarray(want[name]), atol=5e-5,
                                       rtol=5e-3, err_msg=f"rank {r} {name}")


def test_loss_second_moment_sampler_state_is_global(dp):
    """The sampler's ring after 3 steps: the same on both ranks, the
    one-process run's, and JAX's `update_state` over the global t and
    per-sample losses of each step."""
    states = [out["cases"]["sampler"]["sampler"] for out in dp["ranks"]]
    for k in states[0]:
        np.testing.assert_array_equal(states[0][k], states[1][k])
    one = dp["one"]["sampler"]["sampler"]
    np.testing.assert_array_equal(states[0]["loss_counts"], one["loss_counts"])
    np.testing.assert_allclose(states[0]["loss_history"], one["loss_history"], rtol=DP_TOL,
                               atol=1e-12)
    # the recorded calls: 3 from the "sampler" case (the only one with it)
    calls = dp["recorded"]
    assert len(calls) == 3 and all(t.shape == (B,) for t, _ in calls)
    js = jts.init_state(8)
    for t, losses in calls:
        js = jts.update_state(js, jnp.asarray(t), jnp.asarray(losses))
    np.testing.assert_array_equal(states[0]["loss_counts"], np.asarray(js.loss_counts))
    np.testing.assert_allclose(states[0]["loss_history"], np.asarray(js.loss_history), rtol=1e-5,
                               atol=1e-12)


def test_two_rank_evaluator_matches_one_process(dp):
    """5 test clips in waves of 4 (2 a rank; the last wave of 1 padded to
    2): rank 0's generated motion and report are the one-process
    evaluator's on the same global waves and x_T; rank 1 returns None."""
    got, want = dp["ranks"][0]["eval"], dp["one_eval"]
    assert dp["ranks"][1]["eval"]["report"] is None
    assert got["wave"] == want["wave"] == 4
    assert got["generated"].shape == want["generated"].shape == (N_CLIPS, 180, 13, 2)
    np.testing.assert_allclose(got["generated"], want["generated"], atol=1e-5)
    for k, v in want["report"].items():
        np.testing.assert_allclose(got["report"][k], v, rtol=1e-4, atol=1e-6, err_msg=k)


def test_four_rank_wave_is_one_process_wave(root, tmp_path):
    """4 ranks of 2 clips against one process of 8, on the same wave and
    x_T, the music encoder and the ladder on the fused paths (their plain
    versions here), bit for bit, while every ``torch.matmul`` sums in an
    order that follows its row count, as a GEMM library on the card picks
    its kernel by the shape.  The fused encoder's projection runs one GEMM
    a clip (its frames, never the batch's rows): one product over the
    batch made a clip's features, and so its motion, depend on the batch
    it was served in (3.4e-6 of the features, 3e-3 of a ddim50 motion on
    the card, the 4-rank `cli.evaluate` gap)."""
    cfg = _cfg().replace(dataset=SPEC)
    cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, num_frames=180,
                                                   layer_impl="pallas_fused",
                                                   music_encoder_impl="pallas"))
    ev = {"cfg": cfg, "root": root, "wave": 8, "num_steps": 3}
    torch.save({"evaluate": ev}, os.path.join(tmp_path, "in.pt"))
    result = {}
    worker = threading.Thread(target=lambda: result.setdefault(
        "ranks", R.launch("wave", 4, str(tmp_path), timeout=240)))
    worker.start()
    one = R.evaluate_wave(ev)
    worker.join(270)
    assert "ranks" in result, "the ranks did not finish"
    got = result["ranks"][0]["eval"]
    assert all(r["eval"]["report"] is None for r in result["ranks"][1:])
    assert got["wave"] == one["wave"] == 8
    assert got["generated"].shape == one["generated"].shape == (N_CLIPS, 180, 13, 2)
    np.testing.assert_array_equal(got["generated"], one["generated"])
    np.testing.assert_equal(got["report"], one["report"])  # NaN beats on both sides
    # the projection: one GEMM a clip of 180 frames, 5 in one process, 2 a
    # rank (the wave of 5 padded to 8 on the ranks)
    assert one["matmul_rows"] == [180] * N_CLIPS
    assert all(r["eval"]["matmul_rows"] == [180] * 2 for r in result["ranks"])


# ------------------------------------------------------------------ the mesh


def test_pad_to_multiple_matches_jax():
    for n, mult in ((5, 2), (3, 8), (4, 4), (1, 3)):
        x = np.arange(n * 2).reshape(n, 2)
        got, orig = pad_to_multiple(x, mult)
        want, orig_j = jax_pad(x, mult)
        np.testing.assert_array_equal(got, want)
        assert orig == orig_j == n
        t, _ = pad_to_multiple(torch.from_numpy(x), mult)
        np.testing.assert_array_equal(t.numpy(), want)


def test_mesh_rows_and_one_process_defaults(monkeypatch):
    """Without a torchrun environment `init_from_env` is one process on the
    asked device; a mesh's rows are contiguous, and a world that does not
    divide the batch is refused."""
    for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK"):
        monkeypatch.delenv(k, raising=False)
    mesh, device = init_from_env(None, "cpu")
    assert mesh == Mesh() and not mesh.distributed and mesh.is_main() and device.type == "cpu"
    x = torch.arange(6)
    assert mesh.local(x) is x and mesh.gather_rows(x) is x and mesh.any(True)
    m = Mesh(rank=1, size=3, backend="gloo")
    assert m.rows(6) == slice(2, 4) and not m.is_main()
    np.testing.assert_array_equal(m.local(np.arange(6)), [2, 3])
    with pytest.raises(ValueError, match="must divide the world size 3"):
        m.rows(4)


def test_a_world_that_cannot_join_raises(monkeypatch):
    """WORLD_SIZE 2 without the group's address, or with a backend the
    device cannot take: raises, never carries on as one process."""
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("LOCAL_RANK", "0")
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    with pytest.raises(RuntimeError, match="rank 0 of 2 could not join the gloo process group"):
        init_from_env("gloo", "cpu")
    with pytest.raises(ValueError, match="nccl backend needs CUDA"):
        init_from_env("nccl", "cpu")
    with pytest.raises(ValueError, match="unknown backend"):
        init_from_env("mpi", "cpu")
