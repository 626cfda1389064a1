"""PyTorch port, the evaluation CLIs end to end on the CPU, tiny: a stage-2
run of `cli.train` (D = 32, 2 layers, 8 cosine steps, one step on 2-s
windows) and an M2SNet checkpoint of `cli.train_m2snet` (one epoch, 1-s
crops), scored on a test split of three 60-s synthetic clips with beats in
the mel, ``--device cpu``.

`cli.evaluate` (2 DDIM steps, waves of 2) and `cli.evaluate_protocol`
(10-s windows, 2 batches, 2 replications, MultiModality) write the JAX CLIs'
artifacts under JAX's keys; ``--adaln_int8`` off the fused ladder exits
with JAX's message; `cli.serving_delta_ci.sweep` over 2 seeds writes the
JAX script's layout.  TensorBoard and matplotlib are kept out, as in the
other CLI tests."""

import dataclasses
import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

from conductor_tpu.cli.evaluate import main as jax_evaluate
from conductor_tpu.eval import EvalResult as JaxEvalResult
from conductor_tpu_torch.cli import evaluate, evaluate_protocol, serving_delta_ci
from conductor_tpu_torch.cli import train as stage2_cli
from conductor_tpu_torch.cli import train_m2snet
from conductor_tpu_torch.data.dataset import make_synthetic_dataset

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCKED = ("torch.utils.tensorboard", "matplotlib", "matplotlib.pyplot", "matplotlib.cm")
STAGE2 = ["--batch_size", "2", "--epochs", "1", "--diffusion_steps", "8", "--schedule", "cosine",
          "--sample_length", "2", "--latent_dim", "32", "--ff_size", "16", "--num_layers", "2",
          "--num_heads", "4", "--device", "cpu"]
METRIC_KEYS = ("MatchingScore", "R_precision", "FID", "Diversity", "MultiModality")


@pytest.fixture(scope="module", autouse=True)
def _blocked():
    with pytest.MonkeyPatch.context() as mp:
        for name in BLOCKED:
            mp.setitem(sys.modules, name, None)
        yield


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(data root, stage-2 run dir, M2SNet checkpoint root)."""
    root = str(tmp_path_factory.mktemp("cm100_eval_cli"))
    make_synthetic_dataset(root, "train", num_clips=2)
    make_synthetic_dataset(root, "test", num_clips=3, seed=1, correlated=True)
    ckpts = str(tmp_path_factory.mktemp("eval_cli_runs"))
    stage2_cli.main(["--data_root", root, "--name", "tiny", "--checkpoints_dir", ckpts, *STAGE2])
    train_m2snet.main(["--data_root", root, "--checkpoints_dir", ckpts, "--batch_size", "2",
                       "--sample_length", "3", "--clip_length", "1", "--epochs", "1",
                       "--eval_batches", "1", "--device", "cpu"])
    return (root, os.path.join(ckpts, "ConductorMotion100", "tiny"),
            os.path.join(ckpts, "M2SNet", "M2SNet_hard", "ckpt"))


def test_evaluate_writes_jax_keys(runs):
    root, run_dir, _ = runs
    report = evaluate.main(["--run_dir", run_dir, "--data_root", root, "--steps", "2",
                            "--batch_size", "2", "--single_device", "--out_suffix", "_tiny",
                            "--device", "cpu"])
    with open(os.path.join(run_dir, "eval_test_tiny.json")) as f:
        saved = json.load(f)
    assert saved == report
    assert list(saved) == [f.name for f in dataclasses.fields(JaxEvalResult)]
    assert all(np.isfinite(v) for v in saved.values()), saved


def test_adaln_int8_needs_the_fused_ladder(runs):
    """``--adaln_int8`` on the plain layers exits before any weight loads,
    with JAX's message (the JAX CLI reads the port's config.json)."""
    root, run_dir, _ = runs
    argv = ["--run_dir", run_dir, "--data_root", root, "--adaln_int8", "--layer_impl", "flax"]
    with pytest.raises(SystemExit) as want:
        jax_evaluate(argv)
    with pytest.raises(SystemExit) as got:
        evaluate.main(argv + ["--device", "cpu"])
    assert str(got.value) == str(want.value) and "--layer_impl pallas_fused" in str(got.value)
    cfg = evaluate.run_config(run_dir, torch.device("cpu"), "pallas_fused", adaln_int8=True)
    assert cfg.denoiser.sampler_adaln_int8 and cfg.denoiser.layer_impl == "pallas_fused"


def test_evaluate_protocol_writes_jax_layout(runs):
    root, run_dir, m2snet_ckpt = runs
    report = evaluate_protocol.main([
        "--run_dir", run_dir, "--data_root", root, "--m2snet_ckpt", m2snet_ckpt,
        "--sample_length", "10", "--batch_size", "4", "--max_batches", "2", "--steps", "2",
        "--top_k", "2", "--diversity_times", "4", "--replications", "2", "--mm_samples", "2",
        "--mm_repeats", "3", "--device", "cpu"])
    with open(os.path.join(run_dir, "protocol_test.json")) as f:
        saved = json.load(f)
    assert saved == report and set(saved) == set(METRIC_KEYS)
    assert set(saved["FID"]) == {"conductor_tpu"}
    assert set(saved["R_precision"]) == {"ground truth", "conductor_tpu"}
    assert set(saved["MultiModality"]) == {"model"}
    rp = saved["R_precision"]["conductor_tpu"]
    assert set(rp) == {"mean", "conf"} and len(rp["mean"]) == len(rp["conf"]) == 2
    assert np.isfinite(saved["FID"]["conductor_tpu"]["mean"])
    # fresh noise each call: the two replications differ, so the CI is real
    assert saved["MatchingScore"]["conductor_tpu"]["conf"] > 0


def _jax_sweep_module():
    spec = importlib.util.spec_from_file_location(
        "jax_serving_delta_ci", os.path.join(REPO, "scripts", "serving_delta_ci.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_serving_delta_sweep_writes_jax_layout(runs, capsys):
    """Two seeds, each an exact (plain float32) and a serving (fused, bf16,
    int8 AdaLN; the kernels' plain versions here) evaluation of one wave of
    2 clips of a split it writes: the JAX script's keys, each delta's
    per-seed list and CI."""
    root, run_dir, _ = runs
    jax_mod = _jax_sweep_module()
    out = serving_delta_ci.sweep(run_dir, root, clips=2, seeds=2, steps=2, device="cpu")
    assert os.path.isdir(os.path.join(root, "serving_ci"))
    assert set(out) == {"n_seeds", "clips_per_seed", "split", "ddim_steps", "device",
                        *jax_mod.METRICS}
    assert (out["n_seeds"], out["clips_per_seed"], out["ddim_steps"], out["device"]) == (
        2, 2, 2, "cpu")
    for key in jax_mod.METRICS:
        assert set(out[key]) == set(jax_mod._delta_ci([1.0, 2.0])), key
        assert len(out[key]["per_seed_pct"]) == 2 and np.isfinite(out[key]["mean_pct"]), key
    for seed in range(2):
        for kind in ("exact", "serving"):
            assert os.path.exists(os.path.join(run_dir, f"eval_serving_ci_{kind}_s{seed}.json"))
    # the exact and serving paths differ (bf16 and int8 against float32)
    assert any(d != 0 for d in out["mse_delta"]["per_seed_pct"])
    assert "[serving_delta_ci] seed 1" in capsys.readouterr().out
    again = serving_delta_ci.sweep(run_dir, root, clips=2, seeds=2, steps=2, device="cpu",
                                   reuse=True)
    assert again == out
