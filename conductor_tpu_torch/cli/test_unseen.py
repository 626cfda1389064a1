"""Unseen-music CLI: a directory of tracks of any length -> conducting-motion
videos, the port's `conductor_tpu/cli/test_unseen.py`.

Loads a run of `cli.train` as `cli.visualize` does, then for each file of
``--music_dir``: the mel (cached as ``mel_<file>.npy`` under
``--cache_dir``), the motion in 60-s windows
(`prospective.unseen.generate_long`) on the device (the card unless
``--device cpu``), a skeleton video with the audio muxed in (without cv2:
a line saying that no video was rendered).  Every flag of the JAX CLI keeps
its name and default; the port adds ``--device``.

    python -m conductor_tpu_torch.cli.test_unseen --run_dir checkpoints/.../my_run \\
        --music_dir test/test_samples [--steps 50] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import time

from ..prospective.unseen import cached_mel, generate_long
from .visualize import load_run, render, window_generator


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True)
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (reference --which_epoch); default: latest")
    p.add_argument("--music_dir", required=True, help="directory of audio files")
    p.add_argument("--out_dir", default=None, help="default: <run_dir>/unseen")
    p.add_argument("--cache_dir", default=None, help="mel cache (default: <music_dir>/cache)")
    p.add_argument("--steps", type=int, default=None, help="DDIM respacing")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device to serve on (default cuda)")
    return p


def main(argv=None) -> None:
    args = build_argparser().parse_args(argv)
    trainer = load_run(args.run_dir, args.step, args.device)
    out_dir = args.out_dir or os.path.join(args.run_dir, "unseen")
    cache_dir = args.cache_dir or os.path.join(args.music_dir, "cache")
    names = sorted(
        f for f in os.listdir(args.music_dir)
        if os.path.isfile(os.path.join(args.music_dir, f)) and not f.startswith(".")
    )
    print(f"found {len(names)} test samples: {names}")
    generate = window_generator(trainer, args.seed, num_steps=args.steps)
    for i, name in enumerate(names):
        path = os.path.join(args.music_dir, name)
        print(f"[{i + 1}/{len(names)}] {name}")
        t0 = time.time()
        mel = cached_mel(path, cache_dir)
        print(f"  mel {mel.shape} in {time.time() - t0:.2f}s")
        t0 = time.time()
        motion = generate_long(generate, mel)
        print(f"  motion generated in {time.time() - t0:.2f}s")
        final = render(motion, out_dir, os.path.splitext(name)[0], path)
        if final is not None:
            print(f"  wrote {final}")
    print("test finished")


if __name__ == "__main__":
    main()
