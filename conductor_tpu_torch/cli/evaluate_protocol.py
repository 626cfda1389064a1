"""Replicated retrieval-protocol evaluation CLI, the port's
`conductor_tpu/cli/evaluate_protocol.py` (the reference's
`Diffusion_Stage/tools/evaluation.py:33-238`): R-precision,
MatchingScore, FID, Diversity and (optionally) MultiModality with
per-replication means and 95 % confidence intervals, in the co-embedding
space of a frozen stage-1 M2SNet (mean-pooled 64-d music and motion
latents, `eval.protocol.M2SNetCoEmbedding`).

Loads a `cli.train` run as `cli.evaluate` does and the M2SNet from
``--m2snet_ckpt`` (a checkpoint of `cli.train_m2snet`, its ``<run>/ckpt``
root, or a reference-format state-dict file: `train.checkpoints.
restore_raw`).  The co-embedding runs the plain M2SNet encoders in float32
(JAX's M2SNet music encoder defaults to its plain "lax" convolutions), so
the numpy reductions never accumulate in bf16; generation runs on the
run's layer path on the device (the card unless ``--device cpu``), each
call from a generator of its own, so that replications differ.  Writes
``<run_dir>/protocol_<split>.json`` in JAX's layout.  Every flag of the
JAX CLI keeps its name and default; the port adds ``--device``.

    python -m conductor_tpu_torch.cli.evaluate_protocol \\
        --run_dir checkpoints/ConductorMotion100/my_run \\
        --m2snet_ckpt checkpoints/M2SNet/M2SNet_hard/ckpt \\
        --data_root /data/cm100 [--steps 50] [--replications 20]
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

from ..data.dataset import BatchIterator, ConductorMotionDataset
from ..eval.protocol import EvaluationProtocol, M2SNetCoEmbedding, ProtocolConfig
from ..eval.stage1 import batch_generator
from ..interop.weights import load_m2snet_state_dict
from ..models.m2snet import M2SNet
from ..models.precision import full_float32
from ..train.checkpoints import restore_raw
from . import training_device
from .visualize import load_run

MODEL_NAME = "conductor_tpu"  # the JAX CLI's model key in the report


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (reference --which_epoch); default: latest")
    p.add_argument("--m2snet_ckpt", required=True,
                   help="stage-1 M2SNet checkpoint (the co-embedding nets)")
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--sample_length", type=int, default=60, help="seconds per evaluated window")
    p.add_argument("--batch_size", type=int, default=8)
    p.add_argument("--max_batches", type=int, default=None)
    p.add_argument("--steps", type=int, default=None, help="DDIM respacing (default: full ladder)")
    p.add_argument("--replications", type=int, default=1,
                   help="protocol replications (reference default 20, `evaluation.py:245`)")
    p.add_argument("--top_k", type=int, default=3)
    p.add_argument("--diversity_times", type=int, default=300)
    p.add_argument("--mm_samples", type=int, default=0,
                   help="conditions for MultiModality (0 = skip)")
    p.add_argument("--mm_repeats", type=int, default=10)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to evaluate on (default cuda)")
    return p


def make_generator(trainer, seed: int, *, num_steps, n_joints: int, joint_dim: int):
    """A fresh-noise ``generate(cond)`` for the protocol: call ``i`` draws
    its x_T from a generator seeded with ``(seed, i)``, so every batch of
    every replication draws its own noise (JAX folds a call counter into
    its key, `conductor_tpu/cli/evaluate_protocol.py:61-81`); one seed for
    every call would make the replications identical and their 95 % CIs
    zero."""
    counter = {"i": 0}

    def generate(cond):
        gen = batch_generator(seed, counter["i"])
        counter["i"] += 1
        out = trainer.generate(np.asarray(cond), num_steps=num_steps, generator=gen)
        out = out.cpu().numpy().astype(np.float32)
        return out.reshape(out.shape[0], -1, n_joints, joint_dim)

    return generate


def m2snet_co_embedding(path: str, device) -> M2SNetCoEmbedding:
    """The frozen stage-1 M2SNet restored from ``path``, its plain encoders
    in float32 and eval mode, as the protocol's co-embedding."""
    m2s = M2SNet().to(device)
    load_m2snet_state_dict(m2s, restore_raw(path))
    m2s.eval().requires_grad_(False)

    def encoder(module):
        @torch.no_grad()
        @full_float32()
        def fn(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            return module(x).float().cpu().numpy()
        return fn

    return M2SNetCoEmbedding(encoder(m2s.music_encoder), encoder(m2s.motion_encoder))


def main(argv=None) -> dict:
    args = build_argparser().parse_args(argv)
    device = training_device(args.device, "evaluating")
    trainer = load_run(args.run_dir, args.step, device)
    cfg = trainer.cfg
    wrapper = m2snet_co_embedding(args.m2snet_ckpt, device)

    ds = ConductorMotionDataset(args.data_root, args.split, sample_length=args.sample_length,
                                mode="sequential")
    loader = BatchIterator(ds, args.batch_size, shuffle=True, seed=args.seed)

    def batches_fn(rep: int = 0):
        # a new batch composition each replication (the reference's
        # epoch-seeded shuffling loader), so the ground truth's
        # MatchingScore and R-precision carry a real CI
        loader.epoch = rep
        for i, (mel, motion, _) in enumerate(loader):
            if args.max_batches is not None and i >= args.max_batches:
                return
            yield np.asarray(mel), np.asarray(motion)

    generate = make_generator(trainer, args.seed, num_steps=args.steps,
                              n_joints=cfg.dataset.n_joints, joint_dim=cfg.dataset.joint_dim)
    mm_generate = mm_conds = None
    if args.mm_samples > 0:
        picker = np.random.default_rng(args.seed)
        all_mels = [mel for mel, _ in batches_fn()]
        pool = np.concatenate(all_mels, axis=0) if all_mels else np.zeros((0,))
        idx = picker.choice(len(pool), min(args.mm_samples, len(pool)), replace=False)
        mm_conds = [pool[i] for i in idx]

        def mm_generate(cond):
            return generate(np.repeat(np.asarray(cond)[None], args.mm_repeats, axis=0))

    protocol = EvaluationProtocol(wrapper, ProtocolConfig(
        top_k=args.top_k, diversity_times=args.diversity_times, mm_num_times=args.mm_repeats,
        replication_times=args.replications, seed=args.seed))
    result = protocol.run(batches_fn, {MODEL_NAME: generate}, mm_generate=mm_generate,
                          mm_conds=mm_conds)
    print(result.format_report())

    def jsonable(x):
        mean, conf = x
        return {"mean": np.asarray(mean).tolist(), "conf": np.asarray(conf).tolist()}

    report = {metric: {model: jsonable(v) for model, v in models.items()}
              for metric, models in result.summary().items()}
    out = os.path.join(args.run_dir, f"protocol_{args.split}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    print(f"wrote {out}")
    return report


if __name__ == "__main__":
    main()
