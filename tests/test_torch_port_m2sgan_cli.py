"""PyTorch port: the M2SGAN CLI (`conductor_tpu_torch.cli.train_m2sgan`)
end to end on the CPU, tiny: 4 train and 2 test clips of 12 s, 6-s
windows, B = 4, 2 critic iterations, ``--device cpu``; matplotlib and
TensorBoard are blocked in `sys.modules`.

``--m2snet_ckpt <run>/ckpt`` from the port's M2SNet CLI (the SyncLoss
network and the generator's music encoder are that M2SNet's, and with
``--no_transfer_music_encoder`` only the SyncLoss network); the
evaluation's keys, all finite; ``--continue`` without ``--m2snet_ckpt``;
``--cached_sync_latents`` (every logged training metric equal to the
uncached run's) and ``--cached_features``, with their sidecar refusals;
the generator of a CLI checkpoint read by JAX's `import_generator`,
generating within 1e-5 of the largest value of the port's from the same
noise; and the sync-latent cache and `GANCachedDataset` against JAX's,
exactly, on a latent function with no reduction across frames (the
port batches windows across clips, JAX clip by clip).
"""

import json
import os
import shutil
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.data import feature_cache as jax_cache
from conductor_tpu.interop.torch_import import import_generator
from conductor_tpu.models.generator import Generator as FlaxG
from conductor_tpu_torch import M2SGANTrainer
from conductor_tpu_torch.cli import train_m2snet
from conductor_tpu_torch.cli.train_m2sgan import SYNC_LATENT_FILE, main
from conductor_tpu_torch.config import DatasetSpec
from conductor_tpu_torch.data.dataset import make_synthetic_dataset
from conductor_tpu_torch.data.feature_cache import GANCachedDataset, precompute_sync_latents
from conductor_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(2)

TINY = ["--batch_size", "4", "--sample_length", "6", "--critic_iters", "2", "--device", "cpu"]
BLOCKED = ("torch.utils.tensorboard", "matplotlib", "matplotlib.pyplot", "matplotlib.cm")
TRAIN_KEYS = {"w_distance", "gp", "loss_adv", "loss_sync", "loss_mse"}
EVAL_KEYS = {"SD_real", "SD_fake", "SDP", "wasserstein", "MSE", "RDE", "SCE", "MPE", "FGD",
             "Diversity"}


@pytest.fixture(scope="module", autouse=True)
def _blocked():
    with pytest.MonkeyPatch.context() as mp:
        for name in BLOCKED:
            mp.setitem(sys.modules, name, None)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cm100_m2sgan_cli"))
    make_synthetic_dataset(r, "train", num_clips=4, spec=DatasetSpec(clip_seconds=12))
    make_synthetic_dataset(r, "test", num_clips=2, spec=DatasetSpec(clip_seconds=12), seed=1)
    return r


@pytest.fixture(scope="module")
def m2snet(root, tmp_path_factory):
    """The port's M2SNet CLI, one epoch: its checkpoint root and model."""
    ckpts = str(tmp_path_factory.mktemp("m2snet"))
    train_m2snet.main(["--data_root", root, "--checkpoints_dir", ckpts, "--batch_size", "4",
                       "--sample_length", "6", "--clip_length", "2", "--epochs", "1",
                       "--evaluate_epoch", "5", "--device", "cpu"])
    ckpt = os.path.join(ckpts, "M2SNet", "M2SNet_hard", "ckpt")
    return ckpt, CheckpointManager(ckpt).restore()["model"]


def _train(root, ckpts, name, *extra):
    main(["--data_root", root, "--name", name, "--checkpoints_dir", str(ckpts), *TINY, *extra])
    return os.path.join(str(ckpts), "M2SGAN", name)


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _steps(run):
    return [r for r in _records(run) if "loss_sync" in r]


def _final(run):
    return CheckpointManager(os.path.join(run, "ckpt")).restore()


@pytest.fixture(scope="module")
def run(root, m2snet, tmp_path_factory):
    """2 epochs of 2 steps, the whole suite after each on one test batch."""
    return _train(root, tmp_path_factory.mktemp("m2sgan_runs"), "gan", "--m2snet_ckpt",
                  m2snet[0], "--epochs", "2", "--evaluate_epoch", "1", "--eval_batches", "1")


def test_m2snet_ckpt_and_evaluation(run, m2snet):
    records = _records(run)
    steps, evals = _steps(run), [r for r in records if "FGD" in r]
    assert [r["step"] for r in steps] == [1, 2, 3, 4]
    assert all(TRAIN_KEYS <= r.keys() and np.isfinite([r[k] for k in TRAIN_KEYS]).all()
               for r in steps)
    assert [(r["step"], r["epoch"]) for r in evals] == [(2, 0), (4, 1)]
    assert all(EVAL_KEYS | {"BC"} <= r.keys() and np.isfinite([r[k] for k in EVAL_KEYS | {"BC"}]).all()
               for r in evals)
    assert sorted(os.listdir(os.path.join(run, "images"))) == [
        "motion_traces_00000002.npy", "motion_traces_00000004.npy"]
    final = _final(run)
    assert set(final) == {"G", "D", "g_opt", "d_opt", "sync_encoder", "step"} and final["step"] == 4
    model = m2snet[1]
    for k, v in model.items():
        if k.startswith("music_encoder."):  # transferred, and frozen
            assert torch.equal(final["G"][k], v), k
        elif k.startswith("motion_encoder."):
            assert torch.equal(final["sync_encoder"][k.removeprefix("motion_encoder.")], v), k


def test_no_transfer_keeps_the_generators_encoder(root, m2snet, tmp_path):
    run = _train(root, tmp_path, "nt", "--m2snet_ckpt", m2snet[0], "--epochs", "1",
                 "--evaluate_epoch", "5", "--no_transfer_music_encoder")
    final = _final(run)
    w = "music_encoder.conv1.0.conv2d_layer.0.weight"
    assert not torch.equal(final["G"][w], m2snet[1][w])
    for k, v in final["sync_encoder"].items():
        assert torch.equal(m2snet[1]["motion_encoder." + k], v), k


def test_continue_needs_no_m2snet_ckpt(root, m2snet, tmp_path, capsys):
    run = _train(root, tmp_path, "c", "--m2snet_ckpt", m2snet[0], "--epochs", "1",
                 "--evaluate_epoch", "5")
    saved = _final(run)
    tr = M2SGANTrainer(sample_length=6, critic_iters=2, device="cpu")
    tr.load_state_dict(saved)
    again = tr.state_dict()
    for part in ("G", "D", "sync_encoder"):
        for k, v in saved[part].items():
            assert torch.equal(again[part][k], v), (part, k)
    for part in ("g_opt", "d_opt"):
        assert all(torch.equal(a, b) for a, b in zip(again[part]["nu"], saved[part]["nu"]))
    _train(root, tmp_path, "c", "--epochs", "1", "--evaluate_epoch", "5", "--continue")
    assert "resumed from step 2" in capsys.readouterr().out
    assert [r["step"] for r in _steps(run)] == [1, 2, 3, 4]
    final = _final(run)
    for k, v in saved["sync_encoder"].items():
        assert torch.equal(final["sync_encoder"][k], v), k


def test_caches_and_their_sidecars(root, m2snet, tmp_path, capsys):
    data = str(tmp_path / "data")
    shutil.copytree(root, data)
    common = ["--m2snet_ckpt", m2snet[0], "--epochs", "2", "--evaluate_epoch", "5"]
    plain = _train(data, tmp_path, "plain", *common)
    latents = _train(data, tmp_path, "latents", *common, "--cached_sync_latents")
    assert "sync-latent cache: 4 clips precomputed" in capsys.readouterr().out
    cache = np.load(os.path.join(data, "train", "0", SYNC_LATENT_FILE))
    assert cache.shape == (2, 180, 64) and cache.dtype == np.float32
    assert _steps(latents) == [r | {"t": s["t"]} for r, s in zip(_steps(plain), _steps(latents))]
    both = _steps(_train(data, tmp_path, "both", *common, "--cached_sync_latents",
                         "--cached_features"))
    assert "feature cache: 4 clips precomputed" in capsys.readouterr().out
    assert len(both) == 4 and all(np.isfinite([r[k] for k in TRAIN_KEYS]).all() for r in both)
    # latents of another dtype, features of another encoder: refused
    with pytest.raises(ValueError, match="sync_encoder_dtype"):
        _train(data, tmp_path, "x", *common, "--cached_sync_latents", "--sync_encoder_dtype",
               "bfloat16")
    with pytest.raises(ValueError, match="fingerprint"):
        _train(data, tmp_path, "y", *common, "--cached_features", "--no_transfer_music_encoder")
    _train(data, tmp_path, "y", *common, "--cached_features", "--no_transfer_music_encoder",
           "--overwrite_cache")


def test_generator_reads_into_jax(run):
    """JAX's `import_generator` reads G out of the CLI's checkpoint: the
    flax generator's motion equals the port's from the same noise within
    1e-5 of its largest value."""
    g_sd = _final(run)["G"]
    tr = M2SGANTrainer(sample_length=6, device="cpu")
    tr.load_reference_state_dict(g_sd)
    r = np.random.RandomState(1)
    mel = r.uniform(0, 1, size=(2, 540, 128)).astype(np.float32)
    noise = r.normal(size=(2, 6, 8)).astype(np.float32)
    g_vars = jax.tree.map(jnp.asarray, import_generator({k: v.numpy() for k, v in g_sd.items()}))
    want = np.asarray(FlaxG().apply(g_vars, jnp.asarray(mel), jnp.asarray(noise), False))
    got = tr.generate(torch.from_numpy(mel), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def _latents(motion):
    """A per-frame stand-in latent function: no sum across frames or clips."""
    m = np.asarray(motion, np.float64).reshape(*motion.shape[:2], 26)
    return (np.sin(m[..., :1] * 3 + m[..., 1:2]) * np.arange(1, 65) / 64).astype(np.float32)


def test_sync_latent_cache_and_dataset_match_jax(root, tmp_path):
    data = {side: str(tmp_path / side) for side in ("port", "jax")}
    for path in data.values():
        shutil.copytree(root, path)
    assert precompute_sync_latents(_latents, data["port"], sample_length=6, batch_size=3,
                                   filename=SYNC_LATENT_FILE) == 4
    jax_cache.precompute_sync_latents(_latents, data["jax"], sample_length=6,
                                      filename=SYNC_LATENT_FILE)
    for clip in range(4):
        got, want = (np.load(os.path.join(data[side], "train", str(clip), SYNC_LATENT_FILE))
                     for side in ("port", "jax"))
        np.testing.assert_array_equal(got, want)
    for feature_file in (None, "music_feat_m2sgan.npy"):
        if feature_file:
            for clip in range(4):
                feats = np.random.RandomState(clip).rand(360, 64).astype(np.float32)
                np.save(os.path.join(data["port"], "train", str(clip), feature_file), feats)
        port_ds = GANCachedDataset(data["port"], "train", 6, "sequential", feature_file=feature_file,
                                   sync_latent_file=SYNC_LATENT_FILE)
        jax_ds = jax_cache.GANCachedDataset(data["port"], "train", 6, "sequential",
                                            feature_file=feature_file,
                                            sync_latent_file=SYNC_LATENT_FILE)
        assert len(port_ds) == len(jax_ds) == 8
        for i in range(8):
            for got, want in zip(port_ds[i], jax_ds[i]):
                np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="sequential"):
        GANCachedDataset(data["port"], "train", 6, "random", sync_latent_file=SYNC_LATENT_FILE)
