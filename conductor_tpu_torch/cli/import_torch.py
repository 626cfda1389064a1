"""Reference PyTorch checkpoints into the port's run directories.

The port's counterpart of `conductor_tpu/cli/import_torch.py`, with its
three subcommands and flags, plus ``--device`` (default ``cuda``; ``cpu``
for a CPU run).  The port's modules carry the reference's key names, so
each import is a strict load into the module the run will hold (the
template check), then a checkpoint in the port's own layout:

    # stage 1: M2SNet_last.pt -> <out>/ckpt/0.tar, read by
    # cli.train --stage1_ckpt <out>/ckpt and cli.train_m2sgan --m2snet_ckpt
    python -m conductor_tpu_torch.cli.import_torch m2snet \\
        --input M2SNet_last.pt --output runs/m2snet_imported

    # M2SGAN: Generator .pt [+ Discriminator .pt] -> <out>/ckpt/0.tar, which
    # M2SGANTrainer.load_state_dict restores
    python -m conductor_tpu_torch.cli.import_torch m2sgan \\
        --input G.pt [--discriminator D.pt] --output runs/m2sgan_imported

    # stage 2: latest.tar, or a reference run directory (opt.txt +
    # model/latest.tar) -> config.json + ckpt/<total_it>.tar +
    # import_meta.json, which cli.visualize / cli.evaluate (--run_dir) and
    # cli.train --continue load
    python -m conductor_tpu_torch.cli.import_torch diffusion \\
        --input checkpoints/ConductorMotion100/ref_run --output runs/diffusion_imported \\
        [--which_epoch latest] [--stage1_pt M2SNet_last.pt] [--num_heads 8] [--skip_optimizer]

The stage-2 tar is the reference's ``{encoder, opt_encoder, ep,
total_it}`` (`Diffusion_Stage/trainers/ddpm_trainer.py:290-319`), with or
without the DataParallel ``module.`` prefix.  The denoiser's widths and
depth are read off its weights, and a run directory's ``opt.txt`` gives
the rest of the config, checked against the weights
(`interop.reference`).  The Adam moments of ``opt_encoder`` go into the
trainer's optimizer by the reference's registration order unless
``--skip_optimizer``; ``--stage1_pt`` loads an M2SNet's motion encoder as
the perceptual ST-GCN.  ``config.json`` holds the config before "auto" is
resolved, as JAX's does, so the run serves on whatever device loads it.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

from ..interop.opt_txt import resolve_run_dir
from ..interop.reference import config_from_reference, denoiser_config_from_state_dict
from ..interop.weights import (
    load_m2snet_state_dict,
    load_reference_state_dict,
    reference_state_dict,
)
from ..train.checkpoints import CheckpointManager, host_state_dict


def _save(out_dir: str, step: int, state: dict, meta: dict) -> None:
    os.makedirs(out_dir, exist_ok=True)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"))
    mgr.save(step, state, wait=True)
    with open(os.path.join(out_dir, "import_meta.json"), "w") as f:
        json.dump(meta, f, indent=2)


def import_m2snet_cmd(args) -> None:
    from ..models.m2snet import M2SNet
    from ..train.ddpm_trainer import require_device

    model = M2SNet().to(require_device(args.device))
    load_m2snet_state_dict(model, args.input)
    _save(args.output, 0, {"model": host_state_dict(model.state_dict()), "step": 0},
          {"source": os.path.abspath(args.input), "kind": "m2snet"})
    print(f"imported M2SNet -> {args.output} (use <output>/ckpt as --stage1_ckpt)")


def import_m2sgan_cmd(args) -> None:
    """Generator (and optionally Discriminator) state dicts -> a checkpoint
    in `M2SGANTrainer.state_dict`'s layout without optimizer states or
    SyncLoss network."""
    from ..models.generator import Discriminator1DCNN, Generator
    from ..train.ddpm_trainer import require_device

    device = require_device(args.device)
    g = Generator().to(device)
    load_reference_state_dict(g, args.input)
    state = {"G": host_state_dict(g.state_dict()), "step": 0}
    if args.discriminator:
        d = Discriminator1DCNN().to(device)
        load_reference_state_dict(d, args.discriminator)
        state["D"] = host_state_dict(d.state_dict())
    _save(args.output, 0, state, {"source": os.path.abspath(args.input), "kind": "m2sgan"})
    print(f"imported M2SGAN G{'+D' if args.discriminator else ''} -> {args.output}")


def import_diffusion_cmd(args) -> dict:
    """Writes the run directory; returns its import_meta.json."""
    from ..train.ddpm_trainer import DDPMTrainer

    opt, tar = None, args.input
    if os.path.isdir(args.input):
        opt, tar = resolve_run_dir(args.input, args.which_epoch)
        print(f"read {os.path.join(args.input, 'opt.txt')} -> {tar}")
    obj = torch.load(tar, map_location="cpu", weights_only=True)
    enc = reference_state_dict(obj)
    meta = {"ep": int(obj.get("ep", 0)), "total_it": int(obj.get("total_it", 0))}
    dcfg = denoiser_config_from_state_dict(enc, args.num_heads)
    cfg = config_from_reference(dcfg, opt)
    # the initial weights of what the tar does not hold (the perceptual
    # ST-GCN without --stage1_pt), seeded as cli.train seeds them
    torch.manual_seed(cfg.train.seed)
    trainer = DDPMTrainer(cfg, device=args.device)
    if args.stage1_pt:
        trainer.load_reference_state_dict(motion_encoder=args.stage1_pt)
    opt_encoder = None if args.skip_optimizer else obj.get("opt_encoder")
    trainer.load_state_dict({"encoder": enc, "opt_encoder": opt_encoder, **meta})
    moments = trainer.optimizer.adam.state_dict()["state"]
    if moments:
        count = max(int(st["step"]) for st in moments.values())
        print(f"imported Adam moments (count={count})")
    os.makedirs(args.output, exist_ok=True)
    cfg.save(os.path.join(args.output, "config.json"))
    info = {"source": os.path.abspath(args.input), "kind": "diffusion", **meta,
            "denoiser": dataclasses.asdict(cfg.denoiser),
            **({"opt_txt": opt} if opt is not None else {})}
    _save(args.output, meta["total_it"], trainer.state_dict(epoch=meta["ep"]), info)
    print(f"imported MotionTransformer (ep={meta['ep']}, it={meta['total_it']}) "
          f"-> {args.output} (use as --run_dir)")
    return info


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="kind", required=True)

    def parser(name, help_):
        sp = sub.add_parser(name, help=help_)
        sp.add_argument("--device", default="cuda",
                        help="the device of the strict load (cpu for a CPU run)")
        return sp

    pm = parser("m2snet", "stage-1 M2SNet .pt -> <output>/ckpt")
    pm.add_argument("--input", required=True)
    pm.add_argument("--output", required=True)
    pm.set_defaults(fn=import_m2snet_cmd)

    pg = parser("m2sgan", "M2SGAN Generator / Discriminator .pt -> <output>/ckpt")
    pg.add_argument("--input", required=True, help="Generator .pt")
    pg.add_argument("--discriminator", default=None, help="Discriminator .pt")
    pg.add_argument("--output", required=True)
    pg.set_defaults(fn=import_m2sgan_cmd)

    pd = parser("diffusion", "stage-2 latest.tar OR reference run dir (opt.txt) -> run dir")
    pd.add_argument("--input", required=True,
                    help="latest.tar, or a reference run dir containing opt.txt + "
                    "model/latest.tar")
    pd.add_argument("--which_epoch", default="latest",
                    help="'latest' or an epoch number (reference --which_epoch; only with a "
                    "run-dir --input)")
    pd.add_argument("--output", required=True)
    pd.add_argument("--stage1_pt", default=None,
                    help="M2SNet .pt for the perceptual ST-GCN graft")
    pd.add_argument("--num_heads", type=int, default=8)
    pd.add_argument("--skip_optimizer", action="store_true",
                    help="don't import Adam moments from opt_encoder")
    pd.set_defaults(fn=import_diffusion_cmd)
    return p


def main(argv=None):
    args = build_argparser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    main()
