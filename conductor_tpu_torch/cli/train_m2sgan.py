"""Stage-1 WGAN-GP training CLI (M2SGAN), the port's
`conductor_tpu/cli/train_m2sgan.py`.

Reference `Contrastive_Stage/M2SGAN_train.py:36-198`: the SyncLoss
network is a stage-1 M2SNet's motion encoder (``--m2snet_ckpt``: the
M2SNet CLI's ``<run>/ckpt``, or a reference M2SNet state-dict file or a
directory holding one), whose music encoder also goes into the generator
unless ``--no_transfer_music_encoder``; 5 critic iterations alternate
with one generator step.  Every ``--evaluate_epoch`` epochs: the M2SGAN
metric suite on the test split (`eval.stage1.M2SGANEvaluator`: realism,
consistency, MPE / FGD / Diversity on the SyncLoss network's float32
latents, and BC unless ``--no_eval_beats``), a real-against-generated
trace plot of the epoch's last batch, and a checkpoint
``<run>/ckpt/<step>.tar`` (`M2SGANTrainer.state_dict`, the SyncLoss
network included, so ``--continue`` needs no ``--m2snet_ckpt``).  With
``--cached_features`` / ``--cached_sync_latents`` the frozen music
encoder's features (``music_feat_m2sgan.npy``) and the SyncLoss latents of
the real motion (``sync_latent_m2sgan.npy``) are computed once, each
beside its clip with a sidecar keyed to the weights that made it.  The
features are encoded from whole clips, so near window borders they differ
from what the uncached step computes (ROADMAP F11); the latents are those
of each window.  Each step draws its noise and interpolation weights from
a generator seeded by ``(--seed, step)``, and the batches come from the
Python `BatchIterator` in JAX's order.  Every flag of the JAX CLI keeps
its name and default; the port adds ``--device`` (default ``cuda``), and
"on TPU" in JAX's "auto" rules reads "on CUDA".

    python -m conductor_tpu_torch.cli.train_m2sgan --data_root /data/cm100 \\
        --m2snet_ckpt checkpoints/M2SNet/M2SNet_hard/ckpt
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from . import training_device
from ..data.dataset import BatchIterator, ConductorMotionDataset
from ..data.feature_cache import (
    FeatureCachedDataset,
    GANCachedDataset,
    precompute_music_features,
    precompute_sync_latents,
    state_dict_fingerprint,
)
from ..eval.stage1 import M2SGANEvaluator
from ..models.precision import full_float32
from ..models.stgcn import MotionEncoderSTGCN
from ..train.checkpoints import CheckpointManager, restore_raw
from ..train.ddpm_trainer import step_generator
from ..train.m2sgan_trainer import M2SGANTrainer
from ..utils.logging import MetricLogger

FEATURE_FILE = "music_feat_m2sgan.npy"
SYNC_LATENT_FILE = "sync_latent_m2sgan.npy"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True)
    p.add_argument("--m2snet_ckpt", default=None,
                   help="stage-1 M2SNet checkpoint (the M2SNet CLI's <run>/ckpt, or a reference "
                        "state-dict file or a directory holding one): music-encoder transfer + "
                        "SyncLoss net")
    p.add_argument("--name", default="M2SGAN")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--batch_size", type=int, default=55)
    p.add_argument("--sample_length", type=int, default=30)
    p.add_argument("--lr", type=float, default=5e-4)
    p.add_argument("--critic_iters", type=int, default=5)
    p.add_argument("--w_adv", type=float, default=1.0)
    p.add_argument("--w_sync", type=float, default=0.05)
    p.add_argument("--w_mse", type=float, default=0.0)
    p.add_argument("--w_gp", type=float, default=10.0)
    p.add_argument("--evaluate_epoch", type=int, default=10)
    p.add_argument("--eval_batches", type=int, default=None,
                   help="cap the test batches per evaluation sweep (default: the whole test "
                        "split, like the reference)")
    p.add_argument("--no_eval_beats", action="store_true",
                   help="skip beat consistency in the periodic eval (host-side, slow)")
    p.add_argument("--limit_hours", type=float, default=None)
    p.add_argument("--test_limit_hours", type=float, default=None,
                   help="reference --testing_set_limit (hours of test data)")
    p.add_argument("--seed", type=int, default=19990319)
    p.add_argument("--continue", dest="is_continue", action="store_true",
                   help="resume from the run dir's latest checkpoint")
    p.add_argument("--train_music_encoder", action="store_true",
                   help="unfreeze the transferred music encoder (reference "
                        "--train_music_encoder, default frozen)")
    p.add_argument("--no_transfer_music_encoder", action="store_true",
                   help="keep the generator's random-init music encoder; the M2SNet checkpoint "
                        "still supplies the SyncLoss net (reference --transfer_music_encoder "
                        "False)")
    p.add_argument("--music_encoder_impl", default="auto", choices=["auto", "flax", "pallas"],
                   help="frozen music-encoder path: the plain f32 module or the fused bf16 "
                        "kernel K4; auto = pallas on CUDA (flax with --train_music_encoder)")
    p.add_argument("--music_conv_impl", default="auto", choices=["auto", "lax", "pallas_train"],
                   help="music-encoder conv impl inside the generator: pallas_train = the "
                        "training kernels (bf16, or their float32 modes with --compute_dtype "
                        "float32); auto = pallas_train on CUDA when --train_music_encoder is "
                        "set, lax otherwise")
    p.add_argument("--compute_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="generator compute dtype; auto = bf16 on CUDA when "
                        "--train_music_encoder is set, float32 otherwise (reference-exact)")
    p.add_argument("--sync_encoder_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="frozen SyncLoss ST-GCN compute dtype; auto = bf16 on CUDA")
    p.add_argument("--sync_encoder_impl", default="auto", choices=["auto", "flax", "pallas"],
                   help="frozen SyncLoss ST-GCN on the kernel K7; auto = pallas on CUDA")
    p.add_argument("--faithful", action="store_true",
                   help="reference-exact preset: the plain f32 modules everywhere (the default "
                        "is the kernel path on CUDA)")
    p.add_argument("--cached_features", action="store_true",
                   help="precompute the FROZEN music encoder's features once per dataset (whole "
                        "clips, then windows; near window borders they differ from the "
                        "uncached step's) and train from the cache; incompatible with "
                        "--train_music_encoder")
    p.add_argument("--cached_sync_latents", action="store_true",
                   help="precompute the frozen SyncLoss motion encoder's latents of REAL motion "
                        "once per dataset (per training window) and read them from the cache; "
                        "fake-side latents and their backward stay on the device")
    p.add_argument("--overwrite_cache", action="store_true",
                   help="recompute the on-disk feature/sync-latent caches even if present; "
                        "required when they were written under different frozen weights or "
                        "settings (the sidecar check refuses a silent mismatch)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cuda:0 when several cards)")
    return p


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.faithful:
        args.music_encoder_impl = args.sync_encoder_impl = "flax"
        args.music_conv_impl = "lax"
        args.compute_dtype = args.sync_encoder_dtype = "float32"
    run_dir = os.path.join(args.checkpoints_dir, "M2SGAN", args.name)
    os.makedirs(run_dir, exist_ok=True)

    device = training_device(args.device)
    torch.manual_seed(args.seed)  # the initial weights
    trainer = M2SGANTrainer(
        sample_length=args.sample_length, lr=args.lr, critic_iters=args.critic_iters,
        w_adv=args.w_adv, w_sync=args.w_sync, w_mse=args.w_mse, w_gp=args.w_gp,
        music_encoder_impl=args.music_encoder_impl, sync_encoder_dtype=args.sync_encoder_dtype,
        sync_encoder_impl=args.sync_encoder_impl, train_music_encoder=args.train_music_encoder,
        music_conv_impl=args.music_conv_impl, compute_dtype=args.compute_dtype,
        cached_features=args.cached_features, cached_sync_latents=args.cached_sync_latents,
        device=device)
    print(f"device: {device}; music_encoder_impl {trainer.music_encoder_impl}, sync_encoder "
          f"{trainer.sync_encoder_impl} {trainer.sync_encoder_dtype}, compute_dtype "
          f"{trainer.compute_dtype}, music_conv_impl {trainer.music_conv_impl}")
    if args.m2snet_ckpt:
        # the SyncLoss motion encoder always comes from the M2SNet checkpoint;
        # the music-encoder transfer is separately togglable (`M2SGAN_train.py:43-64`)
        m2snet = restore_raw(args.m2snet_ckpt)
        if args.no_transfer_music_encoder:
            trainer.load_reference_state_dict(sync_encoder=m2snet)
        else:
            trainer.load_reference_state_dict(m2snet=m2snet)
    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    if args.is_continue and ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore())  # then reset_caches()
        print(f"resumed from step {trainer.step}")

    if args.cached_features:
        # keyed to THIS stage's frozen encoder (a file of its own beside
        # stage 2's cache on the same root) and to the resolved path, whose
        # features differ (K4 in bf16, the plain module in float32)
        meta = {"fingerprint": state_dict_fingerprint(trainer.G.music_encoder.state_dict()),
                "music_encoder_impl": trainer.music_encoder_impl}
        n = precompute_music_features(trainer.music_features, args.data_root, "train",
                                      filename=FEATURE_FILE, overwrite=args.overwrite_cache,
                                      meta=meta)
        print(f"feature cache: {n} clips precomputed")
    if args.cached_sync_latents:
        @torch.no_grad()
        @full_float32()
        def real_latents(motion):
            return trainer.sync_latents(torch.as_tensor(motion, device=device))

        # keyed to the SyncLoss encoder's weights, the window grid and the
        # path; batched as the step is, so that each window's latents are
        # those the uncached step computes
        meta = {"fingerprint": state_dict_fingerprint(trainer.sync_encoder.state_dict()),
                "sample_length": args.sample_length,
                "sync_encoder_dtype": trainer.sync_encoder_dtype,
                "sync_encoder_impl": trainer.sync_encoder_impl}
        n = precompute_sync_latents(real_latents, args.data_root, "train",
                                    sample_length=args.sample_length, batch_size=args.batch_size,
                                    filename=SYNC_LATENT_FILE, overwrite=args.overwrite_cache,
                                    meta=meta)
        print(f"sync-latent cache: {n} clips precomputed")

    ds_kw = dict(sample_length=args.sample_length, mode="sequential", limit_hours=args.limit_hours)
    if args.cached_sync_latents:
        ds = GANCachedDataset(args.data_root, "train", sync_latent_file=SYNC_LATENT_FILE,
                              feature_file=FEATURE_FILE if args.cached_features else None, **ds_kw)
    elif args.cached_features:
        ds = FeatureCachedDataset(args.data_root, "train", feature_file=FEATURE_FILE, **ds_kw)
    else:
        ds = ConductorMotionDataset(args.data_root, "train", **ds_kw)
    loader = BatchIterator(ds, args.batch_size, seed=args.seed)
    test_ds = ConductorMotionDataset(args.data_root, "test", sample_length=args.sample_length,
                                     mode="sequential", limit_hours=args.test_limit_hours)
    test_loader = BatchIterator(test_ds, args.batch_size, shuffle=False, seed=0)
    logger = MetricLogger(run_dir)

    # the periodic full suite (`M2SGAN_train.py:128-141` ->
    # `M2SGAN_eval.py:62-191`), its latents from the SyncLoss network's
    # weights in float32, as JAX's `MotionEncoderSTGCN()` computes them
    feat_model = MotionEncoderSTGCN().to(device)
    feat_model.load_state_dict(trainer.sync_encoder.state_dict())
    feat_model.freeze()

    @torch.no_grad()
    @full_float32()
    def latents_fn(motion):
        return feat_model.features(torch.as_tensor(motion, device=device))[-1].float()

    evaluator = M2SGANEvaluator(lambda mel, g: trainer.generate(mel, generator=g),
                                latents_fn=latents_fn)

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
        for batch in loader:
            # (cond, motion, sync_latents) with --cached_sync_latents, else
            # (cond, motion, m_len): m_len is a stage-2 concern
            latents = batch[2] if args.cached_sync_latents else None
            metrics = trainer.train_step(batch[0], batch[1], latents,
                                         generator=step_generator(args.seed, trainer.step, device))
            logger.log(trainer.step, metrics, epoch=epoch)
        if epoch % args.evaluate_epoch == 0:
            scores = evaluator.evaluate(eval_batches(), seed=args.seed,
                                        with_beat=not args.no_eval_beats)
            logger.log(trainer.step, scores, epoch=epoch)
            print(f"eval@{epoch}: " + " ".join(f"{k}={v:.5f}" for k, v in sorted(scores.items())))
            # the reference's per-eval trace plot (`M2SGAN_eval.py:150-181`),
            # from the features under --cached_features
            fake = trainer.generate(batch[0][:1], generator=torch.Generator().manual_seed(args.seed),
                                    from_features=args.cached_features)
            logger.log_motion_plot(trainer.step, fake, np.asarray(batch[1][:1]))
            ckpt.save(trainer.step, trainer.state_dict(), wait=True)
    ckpt.save(trainer.step, trainer.state_dict(), wait=True)
    ckpt.close()
    logger.close()
    print(f"done: {trainer.step} steps in {time.perf_counter() - t0:.1f} s; checkpoints in "
          f"{run_dir}/ckpt")


if __name__ == "__main__":
    main()
