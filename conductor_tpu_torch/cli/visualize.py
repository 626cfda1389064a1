"""Serving CLI: audio -> mel -> motion -> skeleton video, the port's
`conductor_tpu/cli/visualize.py`.

Loads a run of `cli.train` (its ``config.json`` and the newest checkpoint
of ``ckpt/``, or ``--step``), extracts the first 60 s of a music file as a
90-fps mel (``--max_seconds 0``: the whole track, in 60-s windows,
`prospective.unseen.generate_long`), generates the conducting motion on
the device (the card unless ``--device cpu``; the kernels where the run's
config names them), and renders an OpenCV skeleton video with the audio
muxed back in.  Every flag of the JAX CLI keeps its name and default; the
port adds ``--device``.  ``--seed`` seeds a `torch.Generator` anew for each
window, as JAX hands each window the same key.  Without cv2 no video is
rendered: the CLI says so (``--save_npy`` keeps the motion).

    python -m conductor_tpu_torch.cli.visualize --run_dir checkpoints/ConductorMotion100/my_run \\
        --music path/to/music.wav [--steps 50] [--guidance 1.0] [--device cuda]
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from ..config import Config
from ..data.mel import extract_mel_feature
from ..train.checkpoints import CheckpointManager
from ..train.ddpm_trainer import DDPMTrainer
from ..viz import motion as viz


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--run_dir", required=True, help="training run dir (contains config.json, ckpt/)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to load (reference --which_epoch); default: latest")
    p.add_argument("--music", required=True, help="audio file (wav natively; others need soundfile)")
    p.add_argument("--out_dir", default=None, help="default: <run_dir>/viz")
    p.add_argument("--steps", type=int, default=None, help="DDIM respacing (default: full ladder)")
    p.add_argument("--guidance", type=float, default=1.0)
    p.add_argument(
        "--max_seconds", type=float, default=60.0,
        help="truncate the audio (reference behavior: first 60 s only); 0 = no cap: chunk the "
             "full track into 60-s windows (prospective.unseen.generate_long) and concatenate",
    )
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--save_npy", action="store_true", help="also save the raw (T,13,2) motion")
    p.add_argument("--device", default="cuda", help="torch device to serve on (default cuda)")
    return p


def load_run(run_dir: str, step: int | None, device: str, cfg: Config | None = None) -> DDPMTrainer:
    """A trainer on ``device`` with the run's config (or ``cfg``, the run's
    with overrides) and its checkpoint ``step`` (the newest by default)
    loaded, as ``cli.train --continue`` loads it."""
    if cfg is None:
        cfg = Config.load(os.path.join(run_dir, "config.json"))
    trainer = DDPMTrainer(cfg, device=device)
    trainer.load_state_dict(CheckpointManager(os.path.join(run_dir, "ckpt")).restore(step))
    d = trainer.cfg.denoiser
    print(f"device: {trainer.device}; step {trainer.step}; layer_impl {d.layer_impl}, "
          f"music_encoder_impl {d.music_encoder_impl}, compute_dtype {d.compute_dtype}")
    return trainer


def window_generator(trainer: DDPMTrainer, seed: int, **kwargs):
    """``mel (1, t90, 128)`` numpy -> motion (1, t30, 26) numpy, each call
    from a generator seeded with ``seed``."""
    def generate(mel):
        gen = torch.Generator(device=trainer.device).manual_seed(seed)
        return trainer.generate(np.asarray(mel), generator=gen, **kwargs).cpu().numpy()

    return generate


def render(motion: np.ndarray, out_dir: str, name: str, music: str) -> str | None:
    """The skeleton video with the audio muxed in, or None (and a line
    saying so) without cv2."""
    try:
        video = viz.render_motion_video([motion], out_dir, name=name)
    except ImportError as e:
        print(f"no video rendered for {name}: {e} (cv2 is not installed)")
        return None
    return viz.mux_audio(video, music)


def main(argv=None) -> None:
    from ..prospective.unseen import generate_long

    args = build_argparser().parse_args(argv)
    trainer = load_run(args.run_dir, args.step, args.device)
    ds = trainer.cfg.dataset
    mel = extract_mel_feature(args.music, max_seconds=args.max_seconds if args.max_seconds > 0 else None)
    print(f"mel: {mel.shape} ({mel.shape[0] / 90:.1f} s)")
    generate = window_generator(trainer, args.seed, num_steps=args.steps,
                                guidance_scale=args.guidance)
    if mel.shape[0] > ds.clip_seconds * ds.mel_hz:
        # longer than the sequence embedding's horizon: 60-s windows,
        # generated one by one and concatenated (the unseen-music contract)
        motion = generate_long(generate, mel, chunk_seconds=ds.clip_seconds, mel_hz=ds.mel_hz,
                               motion_hz=ds.motion_hz, n_joints=ds.n_joints,
                               joint_dim=ds.joint_dim)
    else:
        motion = generate(mel[None])[0].reshape(-1, ds.n_joints, ds.joint_dim)

    out_dir = args.out_dir or os.path.join(args.run_dir, "viz")
    name = os.path.splitext(os.path.basename(args.music))[0]
    if args.save_npy:
        os.makedirs(out_dir, exist_ok=True)
        np.save(os.path.join(out_dir, f"{name}.npy"), motion)
    final = render(motion, out_dir, name, args.music)
    if final is not None:
        print(f"wrote {final}")


if __name__ == "__main__":
    main()
