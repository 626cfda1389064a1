"""Time the data-parallel stage-2 step under torchrun, against one process.

    torchrun --standalone --nproc_per_node 4 scripts/dp_step_torch.py \\
        [--batch_size 32] [--steps 6] [--mask] [--dist_backend nccl]
    torchrun --standalone --nproc_per_node 4 scripts/dp_step_torch.py --tiny --device cpu

Every rank builds the flagship trainer (D = 128, 8 layers, 8 heads, 1000
linear steps; "auto": K5 / K6 / K7 on the card, with ``--mask`` the
reference mask, m_lens 60, on the plain bf16 layers with K8) from the
port's synthetic weights of seed 0, takes a global batch of
``--batch_size`` 30-s windows (T = 900) made from a numpy seed, and runs
``--steps`` data-parallel steps on its rows, each step's t, noise and
condition mask drawn for the global batch from a numpy seed.  Before them
rank 0 runs the same steps in one process on the whole batch on its card.
Each step is timed on the host clock to the readback of its loss, after a
barrier.  Rank 0 prints one JSON line: the card (nvidia-smi's name and
power limit), the world, the batch, each rank's median ms a step and the
one process's, the steps' per-rank and global throughput, the largest
relative gap of loss and ``grad_norm`` to the one process's, and the
launches a rank and step.  ``--tiny`` (D = 32, 2 layers, T = 30) is the
CPU rehearsal.  It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.abspath(os.path.join(os.path.dirname(__file__), "..")))


def make_cfg(tiny: bool, mask: bool):
    from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig

    if tiny:
        cfg = Config(denoiser=DenoiserConfig(num_frames=30, latent_dim=32, ff_size=16,
                                             num_layers=2, num_heads=4),
                     diffusion=DiffusionConfig(steps=8, schedule="cosine"),
                     train=TrainConfig(sample_length=1))
    else:
        cfg = Config()
    if mask:
        import dataclasses

        cfg = cfg.replace(train=dataclasses.replace(cfg.train, replicate_reference_mask=True))
    return cfg


def timed_steps(tr, batch, drawn, barrier) -> tuple[list[float], list[float], list[float], list]:
    """Each step's loss, grad_norm, seconds and launches."""
    from conductor_tpu_torch.ops import launch_counts, reset_launch_counts

    mel, motion, m_lens = batch
    losses, norms, seconds, launches = [], [], [], []
    for d in drawn:
        barrier()
        reset_launch_counts()
        t0 = time.perf_counter()
        m = tr.train_step(mel, motion, m_lens, **d)
        losses.append(float(m["loss"]))  # the host readback ends the step
        seconds.append(time.perf_counter() - t0)
        norms.append(float(m["grad_norm"]))
        launches.append({k: n for k, n in launch_counts().items() if n})
    return losses, norms, seconds, launches


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--batch_size", type=int, default=32, help="the global batch")
    ap.add_argument("--steps", type=int, default=6)
    ap.add_argument("--mask", action="store_true", help="the reference mask (m_lens 60)")
    ap.add_argument("--tiny", action="store_true", help="D = 32, 2 layers, T = 30 (the CPU)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    args = ap.parse_args()

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
    from conductor_tpu_torch.parallel import Mesh, init_from_env, shutdown

    mesh, dev = init_from_env(args.dist_backend, args.device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    cfg = make_cfg(args.tiny, args.mask)
    b, t = args.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(b, 3 * t, 128)).astype(np.float32))
    motion = torch.from_numpy(rng.uniform(0, 1, size=(b, t, 13, 2)).astype(np.float32))
    m_lens = torch.full((b,), 60) if args.mask else None
    drawn = [{"t": rng.randint(0, cfg.diffusion.steps, size=b),
              "noise": rng.normal(size=(b, t, 26)).astype(np.float32),
              "cond_keep": (rng.uniform(size=(b, t)) >= 0.1).astype(np.float32)}
             for _ in range(args.steps)]

    def trainer(m):
        tr = DDPMTrainer(cfg, device=dev, mesh=m)
        tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                     motion_encoder=synthetic_motion_encoder_state_dict(
                                         tr.feat_model, seed=0))
        return tr

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    one = None
    if mesh.is_main():  # one process on the whole batch, before the ranks step
        tr = trainer(Mesh())
        one = timed_steps(tr, (mel.to(dev), motion.to(dev), m_lens), drawn, sync)
        del tr
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    def barrier():
        sync()
        mesh.barrier()

    barrier()
    tr = trainer(mesh)
    rows = (mesh.local(mel).to(dev), mesh.local(motion).to(dev),
            None if m_lens is None else mesh.local(m_lens))
    losses, norms, seconds, launches = timed_steps(tr, rows, drawn, barrier)
    medians = mesh.gather_rows(torch.tensor([float(np.median(seconds[1:] or seconds))]))
    if mesh.is_main():
        smi = "cpu"
        if dev.type == "cuda":
            smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                  "--format=csv,noheader"], capture_output=True,
                                 text=True).stdout.splitlines()[0].strip()
        one_ms = float(np.median(one[2][1:] or one[2])) * 1e3
        ms = [round(float(x) * 1e3, 2) for x in medians]
        print(json.dumps({
            "card": smi, "world": mesh.size, "backend": mesh.backend, "global_batch": b,
            "rows_a_rank": b // mesh.size, "frames": t, "mask": args.mask, "steps": args.steps,
            "ms_a_step_by_rank": ms, "ms_a_step_one_process": round(one_ms, 2),
            "windows_per_s": round(b / (max(ms) / 1e3), 1),
            "windows_per_s_one_process": round(b / (one_ms / 1e3), 1),
            "largest_rel_gap": {
                "loss": max(abs(x - y) / abs(y) for x, y in zip(losses, one[0])),
                "grad_norm": max(abs(x - y) / abs(y) for x, y in zip(norms, one[1]))},
            "losses": losses, "losses_one_process": one[0],
            "launches_a_rank_step": launches[-1],
            "note": "medians over steps 2 on; the first step is the warm-up",
        }), flush=True)
    shutdown(mesh)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
