"""The port's checkpoints back into the reference's PyTorch formats.

The port's counterpart of `conductor_tpu/cli/export_torch.py`, the inverse
of `cli.import_torch`:

    # stage 1: a stage-1 run's <run_dir>/ckpt -> M2SNet_*.pt
    python -m conductor_tpu_torch.cli.export_torch m2snet \\
        --run_dir checkpoints/M2SNet/M2SNet_hard --output M2SNet_export.pt

    # stage 2: a cli.train or cli.import_torch run -> latest.tar
    python -m conductor_tpu_torch.cli.export_torch diffusion \\
        --run_dir checkpoints/ConductorMotion100/my_run --output latest.tar

The reference's strict loads take both (`Contrastive_Stage/
M2SGAN_eval.py:48-53`; `Diffusion_Stage/trainers/ddpm_trainer.py:303-319`).
The state dicts are the checkpoints' own: the port's modules carry the
reference's key names, the ST-GCN adjacency and the BatchNorm counters
included.  The stage-2 tar's ``ep`` comes from the run's
``import_meta.json`` where there is one (0 otherwise), as in JAX.  Its
``opt_encoder`` is the checkpoint's own: the Adam moments over every
parameter in the reference's registration order, which the port's
`DDPMTrainer.state_dict` has held since the stage-2 CLI was ported (no new
feature here); JAX's exporter writes an empty Adam state instead
(`conductor_tpu/interop/torch_export.py:252-274`).  Nothing here needs a
card.
"""

from __future__ import annotations

import argparse
import json
import os

from ..interop.reference import save_diffusion_tar, save_torch_state_dict
from ..train.checkpoints import CheckpointManager, restore_raw


def export_m2snet_cmd(args) -> None:
    # a stage-1 CLI checkpoint gives its model, as does an imported one
    sd = restore_raw(os.path.join(args.run_dir, "ckpt"))
    save_torch_state_dict(args.output, sd)
    print(f"exported M2SNet -> {args.output} ({len(sd)} tensors)")


def export_diffusion_cmd(args) -> None:
    state = CheckpointManager(os.path.join(args.run_dir, "ckpt"), max_to_keep=None).restore()
    step = int(state["total_it"])
    ep = 0
    meta_path = os.path.join(args.run_dir, "import_meta.json")
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            ep = int(json.load(f).get("ep", 0))
    save_diffusion_tar(args.output, state["encoder"], state["opt_encoder"], ep=ep,
                       total_it=step)
    print(f"exported MotionTransformer (it={step}) -> {args.output} "
          f"({len(state['encoder'])} tensors)")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="kind", required=True)

    pm = sub.add_parser("m2snet", help="stage-1 run's ckpt -> .pt state dict")
    pm.add_argument("--run_dir", required=True, help="stage-1 run dir containing ckpt/")
    pm.add_argument("--output", required=True)
    pm.set_defaults(fn=export_m2snet_cmd)

    pd = sub.add_parser("diffusion", help="stage-2 run dir -> latest.tar")
    pd.add_argument("--run_dir", required=True, help="run dir containing config.json + ckpt/")
    pd.add_argument("--output", required=True)
    pd.set_defaults(fn=export_diffusion_cmd)
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
