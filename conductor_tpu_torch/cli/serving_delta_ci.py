"""Serving-vs-exact quality delta with a 95 % CI, the port's counterpart of
`scripts/serving_delta_ci.py`.

The serving fast path (bench.py's config: the fused ladder, bf16, int8
AdaLN) must stay within the quality tolerance of the exact path (the
plain layers in float32).  One small sample cannot show that: beat
consistency on a few clips moves by percents on generation-seed noise
alone.  `sweep` runs `cli.evaluate` twice for each of ``seeds``
generation seeds on the same checkpoint and split, exact then serving,
and reports each metric's percentage delta as mean +- 95 % CI, in the JAX
script's JSON layout (``device`` is the torch device's name).  A split
that is missing is written first (``correlated`` synthetic clips).
``--run_meta`` refreshes the ``serving_*`` keys of a demo's
``run_meta.json`` (`update_run_meta`, JAX's `scripts/serving_delta_ci.py:
121-163`).

    python -m conductor_tpu_torch.cli.serving_delta_ci \\
        --run_dir checkpoints/ConductorMotion100/my_run --data_root /data/cm100_synth \\
        --seeds 10 --clips 24 [--out serving_quality.json] [--run_meta run_meta.json] \\
        [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess

import numpy as np
import torch

from ..data.dataset import make_synthetic_dataset
from .evaluate import main as eval_main

METRICS = {
    "fgd_delta": "fgd",
    "bc_delta": "beat_consistency_generated",
    "mse_delta": "mse",
}
EXACT = ["--layer_impl", "flax", "--compute_dtype", "float32"]
SERVING = ["--layer_impl", "pallas_fused", "--compute_dtype", "bfloat16", "--adaln_int8"]


def _delta_ci(deltas_pct: list[float]) -> dict:
    ds = np.asarray(deltas_pct)
    return {
        "per_seed_pct": [round(float(d), 3) for d in ds],
        "mean_pct": round(float(ds.mean()), 3),
        "abs_mean_pct": round(float(np.abs(ds).mean()), 3),
        "ci95_pct": round(float(1.96 * ds.std() / np.sqrt(len(ds))), 3),
    }


def _delta_pct(serving: float, exact: float) -> float:
    return 100.0 * (serving - exact) / max(abs(exact), 1e-9)


def sweep(
    run_dir: str,
    data_root: str,
    *,
    split: str = "serving_ci",
    clips: int = 24,
    seeds: int = 10,
    steps: int = 50,
    split_seed: int = 2,
    reuse: bool = False,
    device: str = "cuda",
) -> dict:
    """Exact-vs-serving evaluation over ``seeds`` generation seeds on
    ``split`` (written if absent), each seed's two runs on one wave of
    ``clips`` clips; returns the serving-quality dict.  ``reuse`` reads a
    seed's ``eval_<split>_<kind>_s<seed>.json`` where it exists (each is
    fixed by the checkpoint, split, seed and path), so that an interrupted
    sweep resumes."""
    if not os.path.isdir(os.path.join(data_root, split)):
        make_synthetic_dataset(data_root, split, num_clips=clips, seed=split_seed, correlated=True)
    reps = []
    for seed in range(seeds):
        pair = {}
        for kind, flags in (("exact", EXACT), ("serving", SERVING)):
            sfx = f"_{kind}_s{seed}"
            out_json = os.path.join(run_dir, f"eval_{split}{sfx}.json")
            if not (reuse and os.path.exists(out_json)):
                eval_main(["--run_dir", run_dir, "--data_root", data_root, "--split", split,
                           "--steps", str(steps), "--batch_size", str(clips), "--seed", str(seed),
                           "--out_suffix", sfx, "--device", device, *flags])
            with open(out_json) as f:
                pair[kind] = json.load(f)
        reps.append(pair)
        print(f"[serving_delta_ci] seed {seed}: " + "  ".join(
            f"{k} {_delta_pct(pair['serving'][m], pair['exact'][m]):+.3f}%"
            for k, m in METRICS.items()))
    dev = torch.device(device)
    out = {
        "n_seeds": seeds,
        "clips_per_seed": clips,
        "split": split,
        "ddim_steps": steps,
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else str(dev),
    }
    for key, metric in METRICS.items():
        out[key] = _delta_ci([_delta_pct(r["serving"][metric], r["exact"][metric]) for r in reps])
    return out


def card_label(device: str | torch.device) -> str:
    """The card as ``nvidia-smi --query-gpu=name,power.limit`` names it
    (its name and power limit), or "cpu"; the torch device's name where
    nvidia-smi does not answer."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                "--format=csv,noheader"], capture_output=True, text=True,
                               check=True, timeout=60).stdout.strip().splitlines()
        return lines[index].strip()
    except (OSError, subprocess.SubprocessError, IndexError):
        return torch.cuda.get_device_name(dev)


def update_run_meta(run_meta_path: str, quality: dict, device: str | torch.device = "cuda") -> None:
    """Refresh the ``serving_*`` keys of ``run_meta_path`` from a `sweep`
    (JAX's `update_run_meta`): the FGD and BC deltas' means and 95 % CIs
    and ``serving_ci_provenance``, which names the card (`card_label`)."""
    with open(run_meta_path) as f:
        meta = json.load(f)
    meta["serving_fgd_delta_pct"] = quality["fgd_delta"]["mean_pct"]
    meta["serving_fgd_delta_ci95_pct"] = quality["fgd_delta"]["ci95_pct"]
    meta["serving_bc_delta_pct"] = quality["bc_delta"]["mean_pct"]
    meta["serving_bc_delta_ci95_pct"] = quality["bc_delta"]["ci95_pct"]
    meta["serving_ci_provenance"] = (
        f"{quality['n_seeds']} seeds x {quality['clips_per_seed']} clips ({quality['split']} "
        f"split) on {card_label(device)} (conductor_tpu_torch.cli.serving_delta_ci)")
    with open(run_meta_path, "w") as f:
        json.dump(meta, f, indent=2)


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--data_root", required=True)
    p.add_argument("--split", default="serving_ci")
    p.add_argument("--clips", type=int, default=24)
    p.add_argument("--seeds", type=int, default=10)
    p.add_argument("--steps", type=int, default=50)
    p.add_argument("--out", default=None)
    p.add_argument("--reuse", action="store_true",
                   help="reuse existing per-seed eval_<split>_*.json files (resume an "
                        "interrupted sweep)")
    p.add_argument("--run_meta", default=None,
                   help="run_meta.json whose serving_* keys to refresh")
    p.add_argument("--device", default="cuda", help="torch device to evaluate on (default cuda)")
    args = p.parse_args(argv)
    quality = sweep(args.run_dir, args.data_root, split=args.split, clips=args.clips,
                    seeds=args.seeds, steps=args.steps, reuse=args.reuse, device=args.device)
    print(json.dumps(quality, indent=2))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(quality, f, indent=2)
    if args.run_meta:
        update_run_meta(args.run_meta, quality, args.device)
    return quality


if __name__ == "__main__":
    main()
