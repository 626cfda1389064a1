"""Evaluation CLI: FGD / Diversity / Beat Consistency / MSE / SE / MPE / SDP
of a `cli.train` run on a split, the port's `conductor_tpu/cli/evaluate.py`
(the reference's `Diffusion_Stage/tools/eval_new_metrics.py:342-390`).

Loads the run's ``config.json`` and its checkpoint (the newest of
``<run_dir>/ckpt``, or ``--step``), generates the split's clips in waves on
the device (the card unless ``--device cpu``; the kernels where the
config, with the overrides below, names them) through
`eval.DiffusionEvaluator`, prints the report and writes it to
``<run_dir>/eval_<split><out_suffix>.json`` under JAX's keys.  Every flag
of the JAX CLI keeps its name and default; the port adds ``--device``.
``--layer_impl``, ``--compute_dtype`` and ``--adaln_int8`` change how
generation runs, not the model: they score a serving fast path against the
exact one on the same checkpoint (`cli.serving_delta_ci`).
Under ``torchrun`` (JAX's default mesh over every device) each wave holds
8 clips a rank and is sharded over the ranks (`eval.DiffusionEvaluator`'s
``mesh``); rank 0 writes the report.  ``--single_device`` is the
one-process run; under a torchrun world above 1 it is refused.

    python -m conductor_tpu_torch.cli.evaluate --run_dir checkpoints/ConductorMotion100/my_run \\
        --data_root /data/cm100 [--steps 50] [--max_clips 100] [--device cuda]
    torchrun --standalone --nproc_per_node 4 -m conductor_tpu_torch.cli.evaluate \\
        --run_dir checkpoints/ConductorMotion100/my_run --data_root /data/cm100
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

from ..config import Config, resolve_auto
from ..eval import DiffusionEvaluator
from . import run_mesh
from .visualize import load_run


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (reference --which_epoch); default: latest")
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="test")
    p.add_argument("--steps", type=int, default=None, help="DDIM respacing (default: full ladder)")
    p.add_argument("--batch_size", type=int, default=None,
                   help="clips per generation wave (default 8 a rank under torchrun, 8 on one "
                        "device)")
    p.add_argument("--max_clips", type=int, default=None)
    p.add_argument("--no_beats", action="store_true", help="skip beat-consistency (slow, host-side)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--single_device", action="store_true",
                   help="one process on one device (refused under a torchrun world above 1; "
                        "without torchrun the port evaluates on one device)")
    # how generation runs (default: the run's config.json), not the model
    p.add_argument("--layer_impl", default=None, choices=["flax", "pallas_fused"])
    p.add_argument("--compute_dtype", default=None, choices=["float32", "bfloat16"])
    p.add_argument("--adaln_int8", action="store_true",
                   help="int8 AdaLN projection on the fused ladder (requires --layer_impl "
                        "pallas_fused)")
    p.add_argument("--out_suffix", default="",
                   help="suffix for the eval_<split><suffix>.json artifact")
    p.add_argument("--device", default="cuda", help="torch device to evaluate on (default cuda)")
    p.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"],
                   help="torch.distributed backend under torchrun (default nccl on CUDA, gloo "
                        "on the CPU or for ranks sharing a card)")
    return p


def run_config(run_dir: str, device, layer_impl: str | None = None,
               compute_dtype: str | None = None, adaln_int8: bool = False) -> Config:
    """The run's config with the sampler overrides, "auto" resolved for
    ``device``; ``adaln_int8`` off the fused ladder exits, as JAX's CLI
    does (`conductor_tpu/cli/evaluate.py:77-87`): the plain layers never
    read it, so the "int8" artifact would silently come from the exact
    path."""
    cfg = Config.load(os.path.join(run_dir, "config.json"))
    overrides = {k: v for k, v in (("layer_impl", layer_impl), ("compute_dtype", compute_dtype),
                                   ("sampler_adaln_int8", adaln_int8 or None)) if v}
    if overrides:
        cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **overrides))
    cfg = resolve_auto(cfg, device)
    if adaln_int8 and cfg.denoiser.layer_impl != "pallas_fused":
        raise SystemExit(
            "--adaln_int8 requires the fused sampling path: pass --layer_impl pallas_fused "
            f"(run config has layer_impl={cfg.denoiser.layer_impl!r})")
    return cfg


def main(argv=None) -> dict | None:
    """Returns the report (None on every rank but rank 0 under torchrun)."""
    args = build_argparser().parse_args(argv)
    with run_mesh(args.device, args.dist_backend, "evaluating") as (mesh, device):
        if mesh.distributed and args.single_device:
            raise SystemExit("--single_device asks for one process; this is rank "
                             f"{mesh.rank} of {mesh.size} under torchrun")
        cfg = run_config(args.run_dir, device, args.layer_impl, args.compute_dtype,
                         args.adaln_int8)
        trainer = load_run(args.run_dir, args.step, device, cfg)
        evaluator = DiffusionEvaluator(trainer, batch_size=args.batch_size, mesh=mesh)
        if mesh.distributed and mesh.is_main():
            print(f"evaluating on {mesh.size} ranks ({mesh.backend}), waves of "
                  f"{evaluator.batch_size}")
        result = evaluator.evaluate(
            args.data_root, split=args.split, num_steps=args.steps, max_clips=args.max_clips,
            seed=args.seed, compute_beats=not args.no_beats,
        )
    if result is None:
        return None
    report = result.as_dict()
    print(json.dumps(report, indent=2))
    print("seconds: " + ", ".join(f"{k} {v:.2f}" for k, v in evaluator.seconds.items()))
    out = os.path.join(args.run_dir, f"eval_{args.split}{args.out_suffix}.json")
    with open(out, "w") as f:
        json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
