"""PyTorch port: the stage-1 M2SNet CLI (`conductor_tpu_torch.cli.
train_m2snet`) end to end on the CPU, tiny: 4 train and 2 test clips of
6 s, 3-s windows, 1-s crops, B = 2, ``--device cpu``; matplotlib and
TensorBoard are blocked in `sys.modules`, so the image dumps land as
``.npy`` files and the logger writes JSONL only.

The artifacts (metrics, the evaluation sweep's ``{metric}_{strategy}``
keys, the feature maps, the checkpoints); ``hard_test`` reading the test
split; ``--continue``, which restores weights, BN statistics, Adam state
and step exactly and then runs ``--epochs`` epochs from epoch 0 (easy
again) as JAX's loop does, against those steps replayed in this process,
bit for bit; the checkpoint read by JAX's `import_m2snet`, whose eval
forward equals the port's within 1e-5; and the chain into the stage-2
CLI, ``--stage1_ckpt <run>/ckpt``.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop import import_m2snet
from conductor_tpu.models.m2snet import M2SNet as FlaxM2SNet
from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.cli import train as stage2_cli
from conductor_tpu_torch.cli.train_m2snet import main
from conductor_tpu_torch.config import DatasetSpec
from conductor_tpu_torch.data.dataset import (
    BatchIterator,
    ConductorMotionDataset,
    make_synthetic_dataset,
)
from conductor_tpu_torch.train.checkpoints import CheckpointManager, restore_raw
from conductor_tpu_torch.train.ddpm_trainer import step_generator

torch.set_num_threads(2)

SEED = 19990319  # the CLI's default --seed
TINY = ["--batch_size", "2", "--sample_length", "3", "--clip_length", "1", "--device", "cpu"]
BLOCKED = ("torch.utils.tensorboard", "matplotlib", "matplotlib.pyplot", "matplotlib.cm")


@pytest.fixture(scope="module", autouse=True)
def _blocked():
    with pytest.MonkeyPatch.context() as mp:
        for name in BLOCKED:
            mp.setitem(sys.modules, name, None)
        yield


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cm100_m2snet_cli"))
    make_synthetic_dataset(r, "train", num_clips=4, spec=DatasetSpec(clip_seconds=6))
    make_synthetic_dataset(r, "test", num_clips=2, spec=DatasetSpec(clip_seconds=6), seed=1)
    return r


def _train(root, ckpts, *extra):
    main(["--data_root", root, "--checkpoints_dir", str(ckpts), *TINY, *extra])


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


@pytest.fixture(scope="module")
def run(root, tmp_path_factory):
    """3 epochs of 4 steps, evaluations at epochs 0 and 2."""
    ckpts = tmp_path_factory.mktemp("m2snet_runs")
    _train(root, ckpts, "--epochs", "3", "--evaluate_epoch", "2")
    return os.path.join(str(ckpts), "M2SNet", "M2SNet_hard")


def test_artifacts(run):
    records = _records(run)
    steps = [r for r in records if "loss" in r]
    evals = [r for r in records if "accuracy_easy" in r]
    assert [r["step"] for r in steps] == list(range(1, 13))
    assert [r["epoch"] for r in steps] == [0] * 4 + [1] * 4 + [2] * 4
    assert all(np.isfinite([r["loss"], r["accuracy"], r["sync_prob"]]).all() for r in steps)
    keys = {f"{k}_{s}" for k in ("accuracy", "sync_prob", "non_sync_prob")
            for s in ("easy", "hard", "super_hard")}
    assert [(r["step"], r["epoch"]) for r in evals] == [(4, 0), (12, 2)]
    assert all(keys <= r.keys() and all(np.isfinite(r[k]) for k in keys) for r in evals)
    images = os.listdir(os.path.join(run, "images"))
    # 5 music maps and 7 of the 12 motion maps, at each evaluation
    assert len(images) == 2 * (5 + 7) and all(f.endswith(".npy") for f in images)
    mgr = CheckpointManager(os.path.join(run, "ckpt"))
    assert mgr.all_steps() == [4, 12]
    final = mgr.restore()
    assert set(final) == {"model", "optimizer", "step"} and final["step"] == 12


def test_hard_test_trains_on_the_test_split(root, tmp_path):
    _train(root, tmp_path, "--mode", "hard_test", "--epochs", "1")
    records = _records(os.path.join(str(tmp_path), "M2SNet", "M2SNet_hard_test"))
    assert [r["step"] for r in records if "loss" in r] == [1, 2]  # 4 test windows, B = 2


def test_continue_restores_and_replays_bit_for_bit(root, tmp_path):
    """``--epochs 2``, then ``--continue --epochs 1``: the restore is exact,
    and the 4 steps after it are epoch 0's again (easy, the loader's epoch
    0), drawn from the generators of steps 8-11, as this process replays
    them from the saved step 8."""
    _train(root, tmp_path, "--epochs", "2", "--evaluate_epoch", "5")
    run = os.path.join(str(tmp_path), "M2SNet", "M2SNet_hard")
    mgr = CheckpointManager(os.path.join(run, "ckpt"))
    saved = mgr.restore(8)
    replay = M2SNetTrainer(sample_length=3, clip_length=1, device="cpu")
    replay.load_state_dict(saved)
    again = replay.state_dict()
    assert again["step"] == 8
    for k, v in saved["model"].items():
        assert torch.equal(again["model"][k], v), k
    for i, st in saved["optimizer"]["state"].items():
        for key, v in st.items():
            assert torch.equal(again["optimizer"]["state"][i][key], v), (i, key)

    _train(root, tmp_path, "--epochs", "1", "--evaluate_epoch", "5", "--continue")
    resumed = [r for r in _records(run) if "loss" in r][8:]
    loader = BatchIterator(ConductorMotionDataset(root, "train", 3, "sequential"), 2, seed=SEED)
    replayed = []
    for mel, motion, _ in loader:  # epoch 0
        m = replay.train_step(mel, motion, "easy", generator=step_generator(SEED, replay.step))
        replayed.append({k: float(v) for k, v in m.items()})
    assert [r["step"] for r in resumed] == [9, 10, 11, 12]
    assert [{k: r[k] for k in m} for r, m in zip(resumed, replayed)] == replayed
    final = mgr.restore()
    assert final["step"] == replay.step == 12
    for k, v in replay.state_dict()["model"].items():
        assert torch.equal(final["model"][k], v), k


def test_checkpoint_reads_into_jax(run):
    """JAX's `import_m2snet` reads the model out of the CLI's checkpoint:
    the flax M2SNet's eval forward equals the port's within 1e-5."""
    sd = restore_raw(os.path.join(run, "ckpt"))
    tr = M2SNetTrainer(sample_length=3, clip_length=1, device="cpu")
    tr.load_reference_state_dict(sd)
    r = np.random.RandomState(0)
    mel = r.uniform(0, 1, size=(2, 270, 128)).astype(np.float32)
    motion = r.uniform(0, 1, size=(2, 90, 13, 2)).astype(np.float32)
    variables = jax.tree.map(jnp.asarray, import_m2snet({k: v.numpy() for k, v in sd.items()}))
    want = np.asarray(FlaxM2SNet().apply(variables, jnp.asarray(mel), jnp.asarray(motion), False))
    tr.model.eval()
    with torch.no_grad():
        got = tr.model(torch.from_numpy(mel), torch.from_numpy(motion)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_chain_into_the_stage2_cli(run, root, tmp_path):
    """The stage-2 CLI grafts both encoders from ``<run>/ckpt``."""
    stage2_cli.main(["--data_root", root, "--name", "graft", "--checkpoints_dir", str(tmp_path),
                     "--batch_size", "4", "--diffusion_steps", "8", "--schedule", "cosine",
                     "--sample_length", "2", "--latent_dim", "32", "--ff_size", "16",
                     "--num_layers", "2", "--num_heads", "4", "--device", "cpu", "--epochs", "1",
                     "--stage1_ckpt", os.path.join(run, "ckpt")])
    m2snet = CheckpointManager(os.path.join(run, "ckpt")).restore()["model"]
    final = CheckpointManager(os.path.join(str(tmp_path), "ConductorMotion100", "graft",
                                           "ckpt")).restore()
    for k, v in m2snet.items():
        if k.startswith("music_encoder."):
            assert torch.equal(final["encoder"][k], v), k
        elif k.startswith("motion_encoder."):
            assert torch.equal(final["feat_encoder"][k.removeprefix("motion_encoder.")], v), k
