#!/usr/bin/env python3
"""Where a step of the stage-2 training CLI (`conductor_tpu_torch.cli.train`)
spends its time on a CUDA card, part by part.

    python3 scripts/profile_torch_cli.py [--steps N] [--clips N] [--cached]

The CLI's loop at its defaults (the flagship denoiser on "auto", B = 32
random 30-s windows, 1000 steps) on a synthetic root of ``--clips`` 60-s
clips written to a temporary directory, each clip 4 times an epoch (the
CLI's ``--times 4``): the native loader's
batch, the step (`DDPMTrainer.train_step` from the host arrays, as the CLI
calls it), the logger's read of the metrics, the training state's copy to
the host (`DDPMTrainer.state_dict`) and its write (`CheckpointManager.save`
with ``wait``).  Each part is timed alone on the host clock up to a
`torch.cuda.synchronize()`; the step is also split into the copy of its
batch to the card (``torch.tensor(a).to("cuda")``, what `train_step` does
with a host array, and beside it the same bytes from pinned memory) and the
step on tensors already there.  Then the loop runs as the CLI runs it,
without the synchronizations and with ``--save_latest`` 2, and its wall a
step is printed with the saves and without them.  Medians over
``--steps`` (12) steps after 2 warm-up steps.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

from conductor_tpu_torch import DDPMTrainer  # noqa: E402
from conductor_tpu_torch.config import Config, TrainConfig  # noqa: E402
from conductor_tpu_torch.data.dataset import ConductorMotionDataset, make_synthetic_dataset  # noqa: E402
from conductor_tpu_torch.data.feature_cache import (  # noqa: E402
    FeatureCachedDataset,
    precompute_music_features,
)
from conductor_tpu_torch.data.native_loader import make_batch_iterator  # noqa: E402
from conductor_tpu_torch.train.checkpoints import CheckpointManager  # noqa: E402
from conductor_tpu_torch.utils.logging import MetricLogger  # noqa: E402


def batches(loader):
    """The loader's batches forever, epoch after epoch, as the CLI walks them."""
    while True:
        yield from loader


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--clips", type=int, default=16)
    ap.add_argument("--cached", action="store_true", help="train from the feature cache")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_cli: needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    work = tempfile.mkdtemp(prefix="profile_torch_cli_")
    root = os.path.join(work, "data")
    make_synthetic_dataset(root, "train", num_clips=args.clips)
    torch.manual_seed(0)
    trainer = DDPMTrainer(Config(train=TrainConfig(cached_features=args.cached)), device="cuda")
    ds_cls = ConductorMotionDataset
    if args.cached:
        precompute_music_features(trainer.music_features, root, "train")
        ds_cls = FeatureCachedDataset
    loader = make_batch_iterator(ds_cls(root, "train", 30, "random"), 32, seed=1, times=4)
    logger = MetricLogger(os.path.join(work, "run"), console_every=10**9)
    ckpt = CheckpointManager(os.path.join(work, "run", "ckpt"))
    it = batches(loader)
    parts: dict[str, list[float]] = {k: [] for k in (
        "loader", "step", "copy", "copy_pinned", "step_on_card", "log", "state_dict", "save")}
    for i in range(args.steps + 2):
        (mel, motion, m_lens), t_load = timed(lambda: next(it))
        metrics, t_step = timed(lambda: trainer.train_step(mel, motion, m_lens))
        _, t_log = timed(lambda: logger.log(trainer.step, metrics))
        state, t_state = timed(trainer.state_dict)
        _, t_save = timed(lambda: ckpt.save(trainer.step, state, wait=True))
        on_card, t_copy = timed(lambda: [torch.tensor(a).to("cuda") for a in (mel, motion)])
        pinned = [torch.from_numpy(a).pin_memory() for a in (mel, motion)]
        _, t_pinned = timed(lambda: [a.to("cuda", non_blocking=True) for a in pinned])
        _, t_card = timed(lambda: trainer.train_step(*on_card, m_lens))
        if i >= 2:
            for k, v in zip(parts, (t_load, t_step, t_copy, t_pinned, t_card, t_log, t_state, t_save)):
                parts[k].append(v)
    mb = (mel.nbytes + motion.nbytes) / 1e6

    def loop(save_every):
        """The CLI's loop: wall ms a step over ``--steps`` steps."""
        t0 = time.perf_counter()
        for _ in range(args.steps):
            m = trainer.train_step(*next(it))
            logger.log(trainer.step, m)
            if trainer.step % save_every == 0:
                ckpt.save(trainer.step, trainer.state_dict())
        ckpt.wait()
        return (time.perf_counter() - t0) * 1e3 / args.steps

    with_saves, without = loop(2), loop(10**9)
    med = {k: float(np.median(v)) for k, v in parts.items()}
    print(f"[cli-profile] {'cached features' if args.cached else 'from mel'}, B=32 T=900, loader "
          f"{loader.kind}, batch {mb:.1f} MB, medians of {args.steps} steps (ms): "
          + ", ".join(f"{k} {v:.2f}" for k, v in med.items()))
    print("[cli-profile] parts' ranges (ms): " + ", ".join(
        f"{k} {min(v):.2f}-{max(v):.2f}" for k, v in parts.items()))
    print(f"[cli-profile] the CLI's loop: {with_saves:.1f} ms a step saving every 2 steps, "
          f"{without:.1f} without saves; a checkpoint file "
          f"{os.path.getsize(ckpt.directory / f'{ckpt.latest_step()}.tar') / 1e6:.1f} MB on {smi}")
    loader.close()
    ckpt.close()
    logger.close()
    import shutil

    shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    main()
