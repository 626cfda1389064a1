"""Quality against DDIM respacing on a real 1000-step ladder, on the port.

The port's counterpart of `scripts/run_1000ladder.py`: train the e2e
demo's model (`run_e2e_demo_torch.stage2_args`) with ``--diffusion_steps
1000`` (a step costs what it costs on a 50-step ladder: one t a clip),
then sweep ``--steps`` (ddim 50 / 100 / 250 / 1000) through
`cli.evaluate` on the demo's test split, and write
``quality_vs_steps_1000.json`` in the JAX script's schema.  Everything
runs in-process on the card unless ``--device cpu``.  The demo's synthetic
dataset under ``--work`` is reused where present, and written otherwise.

    python scripts/run_1000ladder_torch.py [--out docs/e2e_run_torch] [--work DIR] \\
        [--steps 50 100 250 1000] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.abspath(os.path.dirname(__file__)))
sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))

from run_e2e_demo_torch import QVS_KEYS, stage2_args  # noqa: E402


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--out", default="docs/e2e_run_torch")
    ap.add_argument("--work", default=os.path.join(tempfile.gettempdir(), "e2e_demo_torch"))
    ap.add_argument("--train_clips", type=int, default=24)
    ap.add_argument("--test_clips", type=int, default=6)
    ap.add_argument("--stage2_epochs", type=int, default=30)
    ap.add_argument("--steps", type=int, nargs="+", default=[50, 100, 250, 1000],
                    help="the DDIM respacings to sweep")
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from conductor_tpu_torch.cli import evaluate, train
    from conductor_tpu_torch.data.dataset import make_synthetic_dataset

    t0 = time.time()
    os.makedirs(args.out, exist_ok=True)
    data_root = os.path.join(args.work, "cm100_synth")
    if not os.path.isdir(os.path.join(data_root, "train")):
        make_synthetic_dataset(data_root, "train", num_clips=args.train_clips, correlated=True)
        make_synthetic_dataset(data_root, "test", num_clips=args.test_clips, seed=1,
                               correlated=True)
    print(f"[1/3] dataset at {data_root}")

    ckpts = os.path.join(args.work, "checkpoints_1000")
    run_dir = os.path.join(ckpts, "ConductorMotion100", "ladder1000")
    if not os.path.isdir(os.path.join(run_dir, "ckpt")):
        train.main(stage2_args(data_root, ckpts, "ladder1000", args.stage2_epochs, 1000)
                   + ["--device", args.device])
    train_s = time.time() - t0
    print(f"[2/3] trained 1000-step ladder -> {run_dir} ({train_s:.1f} s)")

    ladder, seconds = {}, {}
    for steps in args.steps:
        t1 = time.time()
        rep = evaluate.main(["--run_dir", run_dir, "--data_root", data_root, "--steps",
                             str(steps), "--batch_size", str(args.test_clips), "--out_suffix",
                             f"_ladder{steps}", "--device", args.device])
        seconds[str(steps)] = round(time.time() - t1, 2)
        ladder[str(steps)] = {k: rep[k] for k in QVS_KEYS if k in rep}
        print(f"  ddim{steps}: fgd={ladder[str(steps)]['fgd']:.3f} "
              f"bc={ladder[str(steps)]['beat_consistency_generated']:.4f} ({seconds[str(steps)]} s)")

    payload = {
        "ladder_steps": 1000,
        "model": "e2e demo config (latent 64, 4 layers), 1000-step cosine ladder",
        "sweep": ladder,
        "wall_clock_s": round(time.time() - t0, 1),
    }
    with open(os.path.join(args.out, "quality_vs_steps_1000.json"), "w") as f:
        json.dump(payload, f, indent=2)
    print(f"[3/3] wrote {args.out}/quality_vs_steps_1000.json ({payload['wall_clock_s']} s; "
          f"evaluation seconds by respacing {seconds})")
    return payload


if __name__ == "__main__":
    main()
