"""Stage-2 diffusion training CLI, the port's `conductor_tpu/cli/train.py`.

Trains the denoiser on one device (the card unless ``--device cpu``) from
a ConductorMotion100-shaped root: the data layer and the native loader
(`data`), the optional frozen-feature cache, a stage-1 graft
(``--stage1_ckpt``), step-versioned checkpoints under ``<run>/ckpt`` with
``--continue``, and a checkpoint at the next step boundary on SIGTERM /
SIGINT.  The resolved `Config` is saved as ``<run>/config.json``, which
the JAX package's `Config.load` reads.  Every flag of the JAX CLI keeps its
name and default, so a JAX command line runs unchanged; the port adds
``--device``.

    python -m conductor_tpu_torch.cli.train --data_root /data/cm100 \\
        --name my_run [--batch_size 32] [--epochs 100] [--times 25] [--continue]
"""

from __future__ import annotations

import argparse
import os
import signal
import time

import torch

from ..config import Config, DenoiserConfig, DiffusionConfig, TrainConfig, pin_faithful, resolve_auto
from ..data.dataset import ConductorMotionDataset
from ..data.feature_cache import (
    FeatureCachedDataset,
    precompute_music_features,
    state_dict_fingerprint,
)
from ..data.native_loader import make_batch_iterator
from ..train.checkpoints import CheckpointManager, restore_raw
from ..train.ddpm_trainer import DDPMTrainer
from ..utils.logging import MetricLogger


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--data_root", required=True, help="ConductorMotion100 root (train/ test/ splits)")
    p.add_argument("--name", default="diffusion", help="run name")
    p.add_argument("--checkpoints_dir", default="./checkpoints")
    p.add_argument("--batch_size", type=int, default=32, help="GLOBAL batch size")
    p.add_argument("--epochs", type=int, default=100)
    p.add_argument("--times", type=int, default=1, help="dataset repetitions per epoch")
    p.add_argument("--lr", type=float, default=2e-4)
    p.add_argument("--diffusion_steps", type=int, default=1000)
    p.add_argument("--sample_length", type=int, default=30, help="seconds per window")
    p.add_argument("--limit_hours", type=float, default=None)
    p.add_argument("--timestep_sampler", default="uniform",
                   choices=["uniform", "loss-second-moment"])
    p.add_argument("--stage1_ckpt", default=None,
                   help="reference-format M2SNet state-dict file, or a directory holding one, "
                        "to graft the music / motion encoders from")
    p.add_argument("--continue", dest="is_continue", action="store_true")
    p.add_argument("--log_every", type=int, default=5)
    p.add_argument("--save_latest", type=int, default=500)
    p.add_argument("--save_every_e", type=int, default=5)
    p.add_argument("--seed", type=int, default=19990319)
    p.add_argument("--replicate_reference_mask", action="store_true")
    # model overrides (reference defaults: latent 128, 8 layers; ff_size 64
    # and 8 heads from the constructor defaults)
    p.add_argument("--latent_dim", type=int, default=128)
    p.add_argument("--ff_size", type=int, default=64)
    p.add_argument("--num_layers", type=int, default=8)
    p.add_argument("--num_heads", type=int, default=8)
    p.add_argument("--no_eff", action="store_true", help="quadratic attention fallback")
    p.add_argument("--schedule", default="linear", choices=["linear", "cosine"])
    p.add_argument("--compute_dtype", default="auto", choices=["auto", "float32", "bfloat16"],
                   help="activation/matmul dtype (params stay f32); auto = bf16 on CUDA, "
                        "f32 elsewhere")
    p.add_argument("--feat_impl", default="auto", choices=["auto", "flax", "pallas"],
                   help="perceptual-loss ST-GCN: the frozen-encoder kernel (K7, "
                        "csrc/stgcn.cu; 'pallas') vs the plain module ('flax'); auto = the "
                        "kernel on CUDA with bf16")
    p.add_argument("--train_layer_impl", default="auto", choices=["auto", "flax", "pallas_fused"],
                   help="the decoder layers' training kernels (K5 forward, K6 backward; "
                        "'pallas_fused'), which need dropout 0, efficient attention and no "
                        "--replicate_reference_mask; auto = the kernels on CUDA when those hold")
    p.add_argument("--faithful", action="store_true",
                   help="reference-exact preset: pin every implementation knob to the plain "
                        "float32 modules (the default is the kernel path in bf16 on CUDA)")
    p.add_argument("--cached_features", action="store_true",
                   help="precompute the frozen music-encoder features once and train from "
                        "the cache (the same numbers)")
    p.add_argument("--overwrite_cache", action="store_true",
                   help="recompute the on-disk feature cache even if present; required when "
                        "it was written under other frozen weights (the sidecar check refuses "
                        "a silent mismatch)")
    p.add_argument("--debug_nans", action="store_true",
                   help="torch.autograd.set_detect_anomaly(True), the reference's always-on "
                        "check (`tools/train.py:38`)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="a torch.profiler trace of the first N steps in <run_dir>/profile "
                        "(chrome trace)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on (default cuda; cuda:0 when several cards)")
    return p


def config_from_args(args: argparse.Namespace, device: torch.device) -> Config:
    """The run's `Config`, its "auto" knobs resolved for ``device`` (or
    pinned by ``--faithful``), as `config.json` records it."""
    cfg = Config(
        denoiser=DenoiserConfig(
            latent_dim=args.latent_dim, ff_size=args.ff_size,
            num_layers=args.num_layers, num_heads=args.num_heads,
            efficient_attention=not args.no_eff,
            compute_dtype=args.compute_dtype,
            train_layer_impl=args.train_layer_impl,
        ),
        diffusion=DiffusionConfig(steps=args.diffusion_steps, schedule=args.schedule),
        train=TrainConfig(
            lr=args.lr, batch_size=args.batch_size, num_epochs=args.epochs,
            sample_length=args.sample_length, timestep_sampler=args.timestep_sampler,
            log_every=args.log_every, save_latest=args.save_latest,
            save_every_e=args.save_every_e, seed=args.seed,
            replicate_reference_mask=args.replicate_reference_mask,
            cached_features=args.cached_features,
            feat_impl=args.feat_impl,
        ),
    )
    return pin_faithful(cfg) if args.faithful else resolve_auto(cfg, device)


def main(argv: list[str] | None = None) -> None:
    args = build_argparser().parse_args(argv)
    if args.debug_nans:
        torch.autograd.set_detect_anomaly(True)

    # SIGTERM / SIGINT ask for a checkpoint at the next step boundary; the
    # handler restores the previous one, so a second signal force-exits
    stop_requested: list[int] = []

    def _request_stop(signum, frame):
        stop_requested.append(signum)
        signal.signal(signum, prev_handlers[signum])

    prev_handlers = {s: signal.signal(s, _request_stop) for s in (signal.SIGTERM, signal.SIGINT)}
    try:
        _train(args, stop_requested)
    finally:
        for s, h in prev_handlers.items():
            signal.signal(s, h)
        if args.debug_nans:
            torch.autograd.set_detect_anomaly(False)


def _train(args: argparse.Namespace, stop_requested: list[int]) -> None:
    device = torch.device(args.device)
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} CUDA devices: training on cuda:0 only "
              "(one device; no data parallelism)")
    cfg = config_from_args(args, device)
    run_dir = os.path.join(args.checkpoints_dir, cfg.dataset.name, args.name)
    os.makedirs(run_dir, exist_ok=True)
    cfg.save(os.path.join(run_dir, "config.json"))

    torch.manual_seed(cfg.train.seed)  # the initial weights
    trainer = DDPMTrainer(cfg, device=device)
    d = trainer.cfg.denoiser
    print(f"device: {device}; train_layer_impl {d.train_layer_impl}, feat_impl "
          f"{trainer.cfg.train.feat_impl}, compute_dtype {d.compute_dtype}")
    if args.stage1_ckpt:
        trainer.graft_stage1(restore_raw(args.stage1_ckpt))

    ckpt = CheckpointManager(os.path.join(run_dir, "ckpt"))
    if args.is_continue and ckpt.latest_step() is not None:
        trainer.load_state_dict(ckpt.restore())  # then reset_caches()
        print(f"resumed from step {trainer.step}")

    ds_kw = dict(sample_length=cfg.train.sample_length, mode="random",
                 limit_hours=args.limit_hours, spec=cfg.dataset)
    if args.cached_features:
        # the sidecar keys the cache to the exact frozen encoder weights and
        # the dtype it ran in: a cache from another --stage1_ckpt, seed or
        # --compute_dtype has the same shapes
        meta = {"fingerprint": state_dict_fingerprint(trainer.model.music_encoder.state_dict()),
                "compute_dtype": trainer.cfg.denoiser.compute_dtype}
        n = precompute_music_features(trainer.music_features, args.data_root, "train",
                                      overwrite=args.overwrite_cache, meta=meta)
        print(f"feature cache: {n} clips precomputed")
        ds = FeatureCachedDataset(args.data_root, "train", **ds_kw)
    else:
        ds = ConductorMotionDataset(args.data_root, "train", **ds_kw)
    loader = make_batch_iterator(ds, cfg.train.batch_size, times=args.times, seed=cfg.train.seed)
    why = getattr(loader, "fallback_reason", None)
    print(f"loader: {loader.kind}" + (f" (native unavailable: {why})" if why else ""))
    if len(loader) == 0:
        raise SystemExit(
            f"no training batches: batch_size={cfg.train.batch_size} exceeds the dataset "
            f"length ({len(loader.ds)} windows). Lower --batch_size or add data.")
    logger = MetricLogger(run_dir, console_every=cfg.train.log_every)

    profiler = None
    if args.profile_steps > 0:
        activities = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            activities.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=activities)
        profiler.start()

    def stop_profiler():
        nonlocal profiler
        if profiler is not None:
            profiler.stop()
            os.makedirs(os.path.join(run_dir, "profile"), exist_ok=True)
            profiler.export_chrome_trace(os.path.join(run_dir, "profile", "trace.json"))
            profiler = None
            print(f"profile written to {run_dir}/profile")

    it = trainer.step
    start_epoch = it // len(loader)  # an interrupted epoch restarts from its first batch
    t0 = time.perf_counter()
    for epoch in range(start_epoch, cfg.train.num_epochs):
        loader.epoch = epoch
        for mel, motion, m_lens in loader:
            metrics = trainer.train_step(mel, motion, m_lens)
            it += 1
            logger.log(it, metrics, epoch=epoch)
            if profiler is not None and it >= args.profile_steps:
                stop_profiler()
            if it % cfg.train.save_latest == 0:
                ckpt.save(it, trainer.state_dict(epoch))
            if stop_requested:
                break
        if stop_requested:
            stop_profiler()  # no truncated trace left open
            ckpt.save(it, trainer.state_dict(epoch), wait=True)
            print(f"stop requested (signal {stop_requested[0]}): saved step {it}; "
                  "resume with --continue")
            break
        if epoch % cfg.train.save_every_e == 0:
            ckpt.save(it, trainer.state_dict(epoch), wait=True)
    else:
        ckpt.save(it, trainer.state_dict(cfg.train.num_epochs - 1), wait=True)
    stop_profiler()
    ckpt.close()
    logger.close()
    getattr(loader, "close", lambda: None)()
    print(f"done: {it} steps in {time.perf_counter() - t0:.1f} s; checkpoints in {run_dir}/ckpt")


if __name__ == "__main__":
    main()
