"""Stage-1 contrastive training CLI (M2SNet), the port's
`conductor_tpu/cli/train_m2snet.py`.

Reference `Contrastive_Stage/M2SNet_train.py:119-180`: modes easy / hard /
super_hard / hard_test (the last trains on the *test* split with hard
negatives, to make the sync-error measuring network).  Epoch 0 always
uses easy negatives (`M2SNet_train.py:81-86`).  Every ``--evaluate_epoch``
epochs: accuracy and the sync / non-sync probabilities at the three
difficulties over the test split (`M2SNet_eval.py:34-121`), logged as
``{metric}_{strategy}``, the feature maps of the first test sample, and a
checkpoint ``<run>/ckpt/<step>.tar`` (`M2SNetTrainer.state_dict`); one
more checkpoint at the end.  ``--continue`` restores the latest
checkpoint, then runs ``--epochs`` epochs counting from 0 again, as JAX
does.  Each step draws its pairs from a generator seeded by ``(--seed,
step)``, and the batches come from the Python `BatchIterator` in JAX's
order (the native loader shuffles in an order of its own).  Every flag of
the JAX CLI keeps its name and default; the port adds ``--device``
(default ``cuda``).

    python -m conductor_tpu_torch.cli.train_m2snet --data_root /data/cm100 --mode hard
"""

from __future__ import annotations

import argparse
import os
import time

import torch

from . import training_device
from ..data.dataset import BatchIterator, ConductorMotionDataset
from ..eval.stage1 import M2SNetEvaluator
from ..train.checkpoints import CheckpointManager
from ..train.ddpm_trainer import step_generator
from ..train.m2snet_trainer import M2SNetTrainer
from ..utils.logging import MetricLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True)
    p.add_argument("--mode", default="hard", choices=["easy", "hard", "super_hard", "hard_test"])
    p.add_argument("--name", default=None)
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--batch_size", type=int, default=10)
    p.add_argument("--sample_length", type=int, default=30)
    p.add_argument("--clip_length", type=int, default=10)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--evaluate_epoch", type=int, default=5)
    p.add_argument("--eval_batches", type=int, default=None,
                   help="cap the test batches per evaluation sweep (default: the whole test "
                        "split, like the reference)")
    p.add_argument("--limit_hours", type=float, default=None)
    p.add_argument("--test_limit_hours", type=float, default=None,
                   help="reference --testing_set_limit (hours of test data)")
    p.add_argument("--seed", type=int, default=19990319)
    p.add_argument("--continue", dest="is_continue", action="store_true",
                   help="resume from the run dir's latest checkpoint (reference --M2SNet ckpt path)")
    p.add_argument("--music_conv_impl", default="auto", choices=["auto", "lax", "pallas_train"],
                   help="music-encoder conv stages: lax (cuDNN / the plain modules) or "
                        "pallas_train (the training kernels K4 / K9 / K10 / K11, in bf16 or "
                        "in their float32 modes with --compute_dtype float32); auto = "
                        "pallas_train on CUDA")
    p.add_argument("--compute_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="encoder compute dtype; auto = bf16 on CUDA, f32 elsewhere; either runs "
                        "with either --music_conv_impl")
    p.add_argument("--faithful", action="store_true",
                   help="reference-exact preset: lax convs + f32 on any device (the default is "
                        "the kernel path in bf16 on CUDA)")
    p.add_argument("--share_encodes", action="store_true",
                   help="encode each music/motion once per step and fuse pairs in latent space "
                        "(2x fewer encodes; BN stats see 2 updates/step instead of the "
                        "reference's 4)")
    p.add_argument("--remat", action="store_true",
                   help="recompute encoder activations in the backward pass (same math, more "
                        "FLOPs, lower peak memory)")
    p.add_argument("--microbatch", type=int, default=1,
                   help="split each step into k grad-accumulation chunks (exact full-batch "
                        "gradients; BN stats per chunk, like the reference's DataParallel "
                        "per-GPU BN)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cuda:0 when several cards)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    # hard_test trains on the test split with hard negatives (`M2SNet_train.py:119-124`)
    train_split = "test" if args.mode == "hard_test" else "train"
    strategy = "hard" if args.mode == "hard_test" else args.mode
    run_dir = os.path.join(args.checkpoints_dir, "M2SNet", args.name or f"M2SNet_{args.mode}")
    os.makedirs(run_dir, exist_ok=True)
    if args.faithful:
        args.compute_dtype, args.music_conv_impl = "float32", "lax"

    device = training_device(args.device)
    torch.manual_seed(args.seed)  # the initial weights
    trainer = M2SNetTrainer(
        sample_length=args.sample_length, clip_length=args.clip_length, lr=args.lr,
        compute_dtype=args.compute_dtype, share_encodes=args.share_encodes, remat=args.remat,
        microbatch=args.microbatch, music_conv_impl=args.music_conv_impl, device=device)
    print(f"device: {device}; compute_dtype {trainer.compute_dtype}, music_conv_impl "
          f"{trainer.music_conv_impl}")
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    if args.is_continue and ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore())
        print(f"resumed from step {trainer.step}")
    logger = MetricLogger(run_dir)

    ds_kw = dict(sample_length=args.sample_length, mode="sequential")
    train_ds = ConductorMotionDataset(args.data_root, train_split, limit_hours=args.limit_hours,
                                      **ds_kw)
    test_ds = ConductorMotionDataset(args.data_root, "test", limit_hours=args.test_limit_hours,
                                     **ds_kw)
    loader = BatchIterator(train_ds, args.batch_size, seed=args.seed)
    test_loader = BatchIterator(test_ds, args.batch_size, shuffle=False, seed=0)
    evaluator = M2SNetEvaluator(trainer)

    def eval_batches():
        for i, (mel, motion, _) in enumerate(test_loader):
            if args.eval_batches is not None and i >= args.eval_batches:
                return
            yield mel, motion

    if len(loader) == 0:
        raise SystemExit(f"no training batches: batch_size={args.batch_size} exceeds the "
                         "dataset length. Lower --batch_size or add data.")
    t0 = time.perf_counter()
    for epoch in range(args.epochs):
        # epoch 0 pre-trains with easy negatives (`M2SNet_train.py:81-86`)
        epoch_strategy = "easy" if epoch == 0 else strategy
        for mel, motion, _ in loader:
            metrics = trainer.train_step(mel, motion, epoch_strategy,
                                         generator=step_generator(args.seed, trainer.step))
            logger.log(trainer.step, metrics, epoch=epoch)
        if epoch % args.evaluate_epoch == 0:
            results = evaluator.evaluate(eval_batches(), seed=args.seed)
            evals = {f"{k}_{s}": v for s, ms in results.items() for k, v in ms.items()}
            if evals:
                logger.log(trainer.step, evals, epoch=epoch)
                print(f"eval@{epoch}: "
                      + " ".join(f"acc_{s}={ms['accuracy']:.5f}" for s, ms in results.items()))
            # the encoders' feature maps, the reference's per-eval dump
            # (`M2SNet_eval.py:110-116`)
            batch = next(iter(test_loader), None)
            if batch is not None:
                logger.log_feature_maps(trainer.step, *trainer.features(batch[0][:1], batch[1][:1]))
            ckpt.save(trainer.step, trainer.state_dict(), wait=True)
    ckpt.save(trainer.step, trainer.state_dict(), wait=True)
    ckpt.close()
    logger.close()
    print(f"done: {trainer.step} steps in {time.perf_counter() - t0:.1f} s; checkpoints in "
          f"{run_dir}/ckpt")


if __name__ == "__main__":
    main()
