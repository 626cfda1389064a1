"""PyTorch port: the stage-2 training CLI (`conductor_tpu_torch.cli.train`)
end to end on the CPU, tiny as tests/test_cli.py: 4 synthetic clips, B 4,
2-s windows, latent 32, 2 layers, 8 diffusion steps, ``--device cpu``;
the clips are 6 s long, so that the feature cache encodes short mel.

The artifacts (config.json that JAX's `Config.load` reads, metrics.jsonl,
the checkpoints, the native loader chosen); ``--epochs 1`` then
``--continue --epochs 2`` against a straight ``--epochs 2``, bit for bit;
``--cached_features`` and its sidecar refusal; ``--stage1_ckpt``;
``--timestep_sampler loss-second-moment``; and a SIGTERM to a CLI
subprocess, which leaves a checkpoint at the last logged step and exits 0.
TensorBoard is kept out (`torch.utils.tensorboard` imports TensorFlow
where it is installed, which takes ~20 s), so the logger writes JSONL only.
"""

import json
import os
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from conductor_tpu.config import Config as JaxConfig
from conductor_tpu_torch.cli.train import main
from conductor_tpu_torch.config import DatasetSpec
from conductor_tpu_torch.data.dataset import make_synthetic_dataset
from conductor_tpu_torch.data.feature_cache import FEATURE_FILE
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--batch_size", "4", "--diffusion_steps", "8", "--schedule", "cosine", "--sample_length",
        "2", "--latent_dim", "32", "--ff_size", "16", "--num_layers", "2", "--num_heads", "4",
        "--device", "cpu"]
NO_TENSORBOARD = "import sys; sys.modules['torch.utils.tensorboard'] = None; "


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cm100_port_cli"))
    make_synthetic_dataset(r, "train", num_clips=4, spec=DatasetSpec(clip_seconds=6))
    return r


def _train(root, ckpts, name, *extra):
    main(["--data_root", root, "--name", name, "--checkpoints_dir", str(ckpts), *TINY, *extra])
    return os.path.join(str(ckpts), "ConductorMotion100", name)


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _final(run):
    return CheckpointManager(os.path.join(run, "ckpt")).restore()


def test_artifacts(root, tmp_path, capsys):
    run = _train(root, tmp_path, "tiny", "--epochs", "2", "--save_latest", "2", "--profile_steps", "1")
    out = capsys.readouterr().out
    assert "loader: native" in out and "train_layer_impl flax" in out
    cfg = JaxConfig.load(os.path.join(run, "config.json"))
    assert (cfg.denoiser.latent_dim, cfg.diffusion.schedule) == (32, "cosine")
    assert (cfg.denoiser.train_layer_impl, cfg.train.feat_impl, cfg.denoiser.compute_dtype) == (
        "flax", "flax", "float32")  # resolved for the CPU, not "auto"
    records = _records(run)
    assert [r["step"] for r in records] == [1, 2] and [r["epoch"] for r in records] == [0, 1]
    assert all(np.isfinite(r["loss"]) and np.isfinite(r["grad_norm"]) for r in records)
    assert "mse_per_sample" not in records[0]
    assert CheckpointManager(os.path.join(run, "ckpt")).all_steps() == [1, 2]
    final = _final(run)
    assert (final["total_it"], final["ep"], final["sampler_state"]) == (2, 1, None)
    assert os.path.isfile(os.path.join(run, "profile", "trace.json"))


def test_resume_from_an_epoch_boundary_equals_the_straight_run(root, tmp_path):
    """``--times 2`` gives 2 steps an epoch: epoch 0, a resume at step 2,
    then epoch 1, against both epochs in one run: the final weights, Adam
    state and every logged number bit for bit."""
    common = ["--times", "2", "--save_latest", "100"]
    straight = _train(root, tmp_path / "a", "r", *common, "--epochs", "2")
    resumed = _train(root, tmp_path / "b", "r", *common, "--epochs", "1")
    assert _final(resumed)["total_it"] == 2
    _train(root, tmp_path / "b", "r", *common, "--epochs", "2", "--continue")
    a, b = _final(straight), _final(resumed)
    assert a["total_it"] == b["total_it"] == 4
    for k, v in a["encoder"].items():
        assert torch.equal(v, b["encoder"][k]), k
    for i, st in a["opt_encoder"]["state"].items():
        for key, v in st.items():
            assert torch.equal(v, b["opt_encoder"]["state"][i][key]), (i, key)
    strip = lambda rs: [{k: v for k, v in r.items() if k != "t"} for r in rs]  # noqa: E731
    assert strip(_records(straight)) == strip(_records(resumed))


def test_cached_features(root, tmp_path, capsys):
    import shutil

    data = str(tmp_path / "data")
    shutil.copytree(root, data)
    run = _train(data, tmp_path, "cached", "--epochs", "1", "--cached_features")
    assert "feature cache: 4 clips precomputed" in capsys.readouterr().out
    feats = np.load(os.path.join(data, "train", "0", FEATURE_FILE))
    assert feats.shape == (180, 64) and feats.dtype == np.float32 and feats.flags.c_contiguous
    assert all(np.isfinite(r["loss"]) for r in _records(run))
    # another seed initialises another frozen encoder: its features are not these
    with pytest.raises(ValueError, match="different settings"):
        _train(data, tmp_path, "cached2", "--epochs", "1", "--cached_features", "--seed", "5")
    _train(data, tmp_path, "cached2", "--epochs", "1", "--cached_features", "--seed", "5",
           "--overwrite_cache")
    assert not np.array_equal(np.load(os.path.join(data, "train", "0", FEATURE_FILE)), feats)
    # features computed in float32 are not those of a bfloat16 run
    with pytest.raises(ValueError, match="compute_dtype"):
        _train(data, tmp_path, "cached3", "--epochs", "1", "--cached_features", "--seed", "5",
               "--compute_dtype", "bfloat16")


def test_stage1_ckpt(root, tmp_path):
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=2)
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, tmp_path / "m2snet.pt")
    run = _train(root, tmp_path, "graft", "--epochs", "1", "--stage1_ckpt", str(tmp_path / "m2snet.pt"))
    final = _final(run)
    for k, v in sd.items():
        if k.startswith("music_encoder."):
            np.testing.assert_array_equal(final["encoder"][k].numpy(), v, err_msg=k)
        elif k.startswith("motion_encoder."):
            got = final["feat_encoder"][k.removeprefix("motion_encoder.")].numpy()
            np.testing.assert_array_equal(got, v, err_msg=k)


def test_loss_second_moment_sampler(root, tmp_path):
    run = _train(root, tmp_path, "lsm", "--epochs", "3", "--times", "2",
                 "--timestep_sampler", "loss-second-moment")
    state = _final(run)["sampler_state"]
    counts, hist = state["loss_counts"].numpy(), state["loss_history"].numpy()
    assert counts.shape == (8,) and counts.sum() == 6 * 4  # 6 steps of B = 4, no ring full
    assert (np.count_nonzero(hist, axis=1) == counts).all() and np.isfinite(hist).all()
    cfg = JaxConfig.load(os.path.join(run, "config.json"))
    assert cfg.train.timestep_sampler == "loss-second-moment"


def test_no_eff_is_not_ported(root, tmp_path):
    with pytest.raises(NotImplementedError, match="linear attention"):
        _train(root, tmp_path, "quad", "--epochs", "1", "--no_eff")


def test_sigterm_saves_the_logged_step_and_exits_0(root, tmp_path):
    """A SIGTERM to a CLI subprocess lands between steps: the run saves that
    step, says so, and exits 0; ``--continue`` resumes from it."""
    argv = ["--data_root", root, "--name", "sig", "--checkpoints_dir", str(tmp_path), *TINY,
            "--epochs", "1000", "--save_latest", "100000", "--save_every_e", "100000"]
    code = NO_TENSORBOARD + "from conductor_tpu_torch.cli.train import main; main(sys.argv[1:])"
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    proc = subprocess.Popen([sys.executable, "-c", code, *argv], stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True, env=env, cwd=str(tmp_path))
    run = os.path.join(str(tmp_path), "ConductorMotion100", "sig")
    jsonl = os.path.join(run, "metrics.jsonl")
    try:
        deadline = time.time() + 60
        while not (os.path.exists(jsonl) and os.path.getsize(jsonl) > 0):
            assert proc.poll() is None and time.time() < deadline, proc.communicate()[0]
            time.sleep(0.05)
        proc.send_signal(signal.SIGTERM)
        out, _ = proc.communicate(timeout=60)
    finally:
        proc.kill()
    assert proc.returncode == 0, out
    last = _records(run)[-1]["step"]
    assert CheckpointManager(os.path.join(run, "ckpt")).latest_step() == last
    assert f"stop requested (signal {int(signal.SIGTERM)}): saved step {last}" in out
    _train(root, tmp_path, "sig", "--epochs", str(last + 1), "--continue")
    assert _final(run)["total_it"] == last + 1 and _records(run)[-1]["step"] == last + 1
