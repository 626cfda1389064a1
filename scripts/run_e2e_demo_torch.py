"""End-to-end quality pipeline on the PyTorch port, through its CLIs.

The port's counterpart of `scripts/run_e2e_demo.py`, with its flags,
defaults and stages, each run in-process through a port CLI's
``main(argv)`` with the arguments the JAX script passes (plus
``--device``): (1) the correlated synthetic ConductorMotion100 stand-in;
(2) `cli.train_m2snet`; (3) the stage-1 evaluation after precise-BN
recalibration on the train split; (4) `cli.train --stage1_ckpt` (the
encoder graft); (5) `cli.evaluate`, exact and in bench.py's serving
config, the serving-vs-exact sweep (`cli.serving_delta_ci`) and the
quality-vs-DDIM-steps sweep; (6) `cli.evaluate_protocol`; (7) the
checkpoint round trip: the run's newest checkpoint written as the
reference's state dicts (``latest.tar`` and the M2SNet's ``.pt``), loaded
into fresh trainers, every parameter equal.  Then ``run_meta.json`` with
the JAX script's keys, its ``backend`` the card's name and power limit as
nvidia-smi gives them, and its ``serving_*`` keys written by
`cli.serving_delta_ci.update_run_meta`.  Runs on the card unless
``--device cpu``; prints every stage's seconds.

    python scripts/run_e2e_demo_torch.py [--out docs/e2e_run_torch] [--work DIR] [--device cuda]

Writes <out>/m2snet_eval.json, eval_test.json, eval_test_serving.json,
serving_quality.json, quality_vs_steps.json, protocol_test.json and
run_meta.json.  ``--work`` defaults to a directory under the temporary
directory.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

import torch  # noqa: E402

QVS_KEYS = ("fgd", "diversity", "mse", "beat_consistency_generated", "beat_consistency_real")


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="docs/e2e_run_torch")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "e2e_demo_torch"))
    ap.add_argument("--train_clips", type=int, default=24)
    ap.add_argument("--test_clips", type=int, default=6)
    ap.add_argument("--stage1_epochs", type=int, default=16)
    ap.add_argument("--stage2_epochs", type=int, default=30)
    ap.add_argument("--serving_seeds", type=int, default=10,
                    help="generation seeds for the serving-vs-exact delta CI")
    ap.add_argument("--serving_clips", type=int, default=24,
                    help="clips in the dedicated serving-CI split (wider than the 6-clip test "
                         "split so per-seed BC noise stays small)")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    return ap


def stage1_args(data_root: str, ckpts: str, epochs: int) -> list[str]:
    """The demo's `cli.train_m2snet` flags (JAX's, `run_e2e_demo.py:70-75`)."""
    return ["--data_root", data_root, "--checkpoints_dir", ckpts, "--mode", "hard",
            "--epochs", str(epochs), "--batch_size", "4", "--sample_length", "30",
            "--clip_length", "10", "--evaluate_epoch", "4", "--eval_batches", "2"]


def stage2_args(data_root: str, ckpts: str, name: str, epochs: int, steps: int) -> list[str]:
    """The demo model's `cli.train` flags (JAX's, `run_e2e_demo.py:110-117`)."""
    return ["--data_root", data_root, "--name", name, "--checkpoints_dir", ckpts,
            "--batch_size", "8", "--epochs", str(epochs), "--diffusion_steps", str(steps),
            "--schedule", "cosine", "--sample_length", "10", "--latent_dim", "64",
            "--ff_size", "32", "--num_layers", "4", "--num_heads", "4", "--save_latest", "50"]


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    from conductor_tpu_torch.cli import evaluate, evaluate_protocol, serving_delta_ci, train
    from conductor_tpu_torch.cli import train_m2snet
    from conductor_tpu_torch.data.dataset import (
        BatchIterator,
        ConductorMotionDataset,
        make_synthetic_dataset,
    )

    dev = ["--device", args.device]
    os.makedirs(args.out, exist_ok=True)
    os.makedirs(args.work, exist_ok=True)
    t0 = time.time()
    seconds: dict[str, float] = {}
    mark = [time.perf_counter()]

    def stage(name: str, line: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - mark[0]
        mark[0] = now
        print(f"{line} ({seconds[name]:.1f} s)", flush=True)

    def save(name: str, obj) -> None:
        with open(os.path.join(args.out, name), "w") as f:
            json.dump(obj, f, indent=2)

    data_root = os.path.join(args.work, "cm100_synth")
    if not os.path.isdir(os.path.join(data_root, "train")):
        make_synthetic_dataset(data_root, "train", num_clips=args.train_clips, correlated=True)
        make_synthetic_dataset(data_root, "test", num_clips=args.test_clips, seed=1,
                               correlated=True)
    stage("dataset", f"[1/7] dataset: {args.train_clips} train / {args.test_clips} test clips")

    # ---- stage 1: M2SNet contrastive training -------------------------
    ckpts = os.path.join(args.work, "checkpoints")
    if os.path.isdir(ckpts):
        shutil.rmtree(ckpts)  # stale runs would pollute the appended metrics
    train_m2snet.main(stage1_args(data_root, ckpts, args.stage1_epochs) + dev)
    m2snet_dir = os.path.join(ckpts, "M2SNet", "M2SNet_hard")
    stage("stage1", f"[2/7] stage-1 trained -> {m2snet_dir}")

    # the stage-1 evaluation after precise-BN recalibration on the train
    # split: a run this short leaves the momentum-0.99 running statistics
    # far from the trained activations
    from conductor_tpu_torch import M2SNetTrainer
    from conductor_tpu_torch.eval.stage1 import M2SNetEvaluator
    from conductor_tpu_torch.train.checkpoints import CheckpointManager

    trainer1 = M2SNetTrainer(sample_length=30, clip_length=10, device=args.device)
    trainer1.load_state_dict(CheckpointManager(os.path.join(m2snet_dir, "ckpt")).restore())
    pairs = lambda split: [(b[0], b[1]) for b in BatchIterator(  # noqa: E731
        ConductorMotionDataset(data_root, split, sample_length=30, mode="sequential"), 4,
        shuffle=False, seed=0)]
    trainer1.recalibrate_batch_stats(pairs("train")[:6])
    s1_eval = M2SNetEvaluator(trainer1).evaluate(pairs("test")[:4])
    save("m2snet_eval.json", s1_eval)
    stage("stage1_eval", "[3/7] stage-1 eval (BN-recalibrated): "
          + " ".join(f"{s}={m['accuracy']:.3f}" for s, m in s1_eval.items()))

    # ---- stage 2: diffusion training with the encoder graft ------------
    train.main(stage2_args(data_root, ckpts, "e2e_demo", args.stage2_epochs, 50)
               + ["--stage1_ckpt", os.path.join(m2snet_dir, "ckpt"), *dev])
    run_dir = os.path.join(ckpts, "ConductorMotion100", "e2e_demo")
    stage("stage2", f"[4/7] stage-2 trained -> {run_dir}")

    # ---- the metric evaluation, exact and in the serving config --------
    common = ["--run_dir", run_dir, "--data_root", data_root, *dev]
    report = evaluate.main([*common, "--steps", "50", "--batch_size", str(args.test_clips)])
    save("eval_test.json", report)
    serving = evaluate.main([*common, "--steps", "50", "--batch_size", str(args.test_clips),
                             "--layer_impl", "pallas_fused", "--compute_dtype", "bfloat16",
                             "--adaln_int8", "--out_suffix", "_serving"])
    save("eval_test_serving.json", serving)
    quality = serving_delta_ci.sweep(run_dir, data_root, split="serving_ci",
                                     clips=args.serving_clips, seeds=args.serving_seeds,
                                     steps=50, device=args.device)
    save("serving_quality.json", quality)
    print("[5a/7] serving deltas (mean+-CI %): "
          f"FGD {quality['fgd_delta']['mean_pct']}+-{quality['fgd_delta']['ci95_pct']}  "
          f"BC {quality['bc_delta']['mean_pct']}+-{quality['bc_delta']['ci95_pct']}")
    # quality against DDIM steps on the same checkpoint, seed and clips:
    # the 50-step demo ladder respaced 10x..1x, as the 1000-step model is
    by_steps = {50: report}
    for steps in (5, 10, 25):
        by_steps[steps] = evaluate.main([*common, "--steps", str(steps), "--batch_size",
                                         str(args.test_clips), "--out_suffix", f"_ddim{steps}"])
    qvs = {str(s): {k: rep[k] for k in QVS_KEYS if k in rep} for s, rep in sorted(by_steps.items())}
    save("quality_vs_steps.json", qvs)
    stage("evaluate", "[5b/7] quality vs steps: " + json.dumps(qvs))

    # ---- the retrieval protocol ----------------------------------------
    protocol = evaluate_protocol.main([
        "--run_dir", run_dir, "--data_root", data_root,
        "--m2snet_ckpt", os.path.join(m2snet_dir, "ckpt"), "--sample_length", "10",
        "--batch_size", str(args.test_clips), "--steps", "50", "--replications", "2",
        "--top_k", "3", "--diversity_times", "10", "--mm_samples", "2", "--mm_repeats", "4",
        *dev])
    save("protocol_test.json", protocol)
    stage("protocol", f"[6/7] protocol: FID={protocol['FID']['conductor_tpu']['mean']:.3f} "
          f"R@1={protocol['R_precision']['conductor_tpu']['mean'][0]:.3f}")

    # ---- the checkpoint round trip --------------------------------------
    roundtrip = checkpoint_roundtrip(run_dir, m2snet_dir, args.work, args.device)
    stage("roundtrip", f"[7/7] checkpoint round trip: {roundtrip}")

    meta = write_run_meta(os.path.join(args.out, "run_meta.json"), run_dir, time.time() - t0,
                          roundtrip, quality, args.device)
    print(f"[done] eval: FGD={report['fgd']:.3f} div={report['diversity']:.3f} "
          f"BC_gen={report['beat_consistency_generated']:.3f} mse={report['mse']:.5f}; loss "
          f"{meta['stage2_loss_first10_mean']} -> {meta['stage2_loss_last10_mean']} "
          f"({meta['wall_clock_s']} s total); stage seconds "
          + json.dumps({k: round(v, 2) for k, v in seconds.items()}))
    return {"seconds": seconds, "run_dir": run_dir, "m2snet_dir": m2snet_dir, "meta": meta}


def write_run_meta(path: str, run_dir: str, wall_s: float, roundtrip: str, quality: dict,
                   device: str) -> dict:
    """``run_meta.json`` with the JAX demo's keys (`run_e2e_demo.py:
    262-281`): the stage-2 loss curve from the run's ``metrics.jsonl``, the
    backend (the card's name and power limit), the round trip, and the
    ``serving_*`` keys of `cli.serving_delta_ci.update_run_meta`."""
    from conductor_tpu_torch.cli import serving_delta_ci

    with open(os.path.join(run_dir, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    if not recs:
        raise SystemExit("stage-2 run logged no steps: batch_size exceeds the number of training "
                         "clips (the random-window dataset yields one entry per clip); lower the "
                         "--train_clips / --batch_size ratio")
    meta = {
        "wall_clock_s": round(wall_s, 1),
        "backend": f"{serving_delta_ci.card_label(device)} (synthetic data; no real "
                   "ConductorMotion100 in image)",
        "stage2_loss_first10_mean": round(float(np.mean([r["loss"] for r in recs[:10]])), 5),
        "stage2_loss_last10_mean": round(float(np.mean([r["loss"] for r in recs[-10:]])), 5),
        "stage2_steps": recs[-1]["step"],
        "torch_export_roundtrip": roundtrip,
        "commands": "see docs/E2E_RUN.md; scripts/run_e2e_demo_torch.py",
    }
    with open(path, "w") as f:
        json.dump(meta, f, indent=2)
    serving_delta_ci.update_run_meta(path, quality, device)
    with open(path) as f:
        return json.load(f)


def checkpoint_roundtrip(run_dir: str, m2snet_dir: str, work: str, device: str) -> str:
    """The stage-2 run's newest checkpoint written as the reference's
    ``latest.tar`` (``encoder``, ``opt_encoder``, ``ep``, ``total_it``) and
    the M2SNet's as the reference's state dict, each loaded into a fresh
    trainer on ``device``: every parameter equal, or AssertionError."""
    from conductor_tpu_torch import DDPMTrainer, M2SNetTrainer
    from conductor_tpu_torch.cli.evaluate import run_config
    from conductor_tpu_torch.train.checkpoints import CheckpointManager

    state = CheckpointManager(os.path.join(run_dir, "ckpt")).restore()
    tar = os.path.join(work, "e2e_export_latest.tar")
    torch.save({k: state[k] for k in ("encoder", "opt_encoder", "ep", "total_it")}, tar)
    fresh = DDPMTrainer(run_config(run_dir, torch.device(device)), device=device)
    fresh.load_state_dict(torch.load(tar, map_location="cpu", weights_only=True))
    bad = [k for k, v in fresh.model.state_dict().items()
           if not torch.equal(v.cpu(), state["encoder"][k])]
    m2s = CheckpointManager(os.path.join(m2snet_dir, "ckpt")).restore()["model"]
    pt = os.path.join(work, "e2e_export_m2snet.pt")
    torch.save(m2s, pt)
    trainer1 = M2SNetTrainer(sample_length=30, clip_length=10, device=device)
    trainer1.load_reference_state_dict(torch.load(pt, map_location="cpu", weights_only=True))
    bad += [f"m2snet.{k}" for k, v in trainer1.model.state_dict().items()
            if not torch.equal(v.cpu(), m2s[k])]
    assert not bad, f"round-trip mismatches: {bad[:5]}"
    return "exact (checkpoint -> latest.tar / .pt -> fresh trainers, all params equal)"


if __name__ == "__main__":
    main()
