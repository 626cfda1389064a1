"""Two-process loss parity of the port's data-parallel stage-2 step.

The port's counterpart of `scripts/multiprocess_check.py`: one stage-2
step (D = 32, 2 layers, 8 cosine steps, a global batch of 4 sequential
2-s windows of a synthetic root, the port's synthetic weights of seed 0)
run as 2 processes over gloo, each loading its rows through
`BatchIterator(host_shard=True)`, and as 1 process on the global batch:
the two ranks' loss and ``grad_norm`` agree with each other and with the
one process's within 1e-6 (relative).  ``--reference FILE`` (an ``.npz``
of JAX's step on the same global batch and weights: ``loss``,
``grad_norm``, and the ``t``, ``noise`` and ``cond_keep`` it drew, which
every run here then takes) adds the third comparison, within 1e-4, the
step-parity tests' bound; `tests/test_torch_port_e2e.py` writes one.

    python scripts/multiprocess_check_torch.py [--reference jax_step.npz] [--device cpu]

Ranks on one card share it over gloo (``--device cuda``).  Exits 0 on
parity, printing "multiprocess parity ok".
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.abspath(os.path.join(HERE, ".."))
GLOBAL_BATCH = 4
SECONDS = 2  # a window
WORLD = 2
RTOL, JAX_RTOL = 1e-6, 1e-4
TIMEOUT = 600


def make_cfg():
    from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig

    return Config(
        denoiser=DenoiserConfig(num_frames=30 * SECONDS, latent_dim=32, ff_size=16, num_layers=2,
                                num_heads=4),
        diffusion=DiffusionConfig(steps=8, schedule="cosine"),
        train=TrainConfig(batch_size=GLOBAL_BATCH, sample_length=SECONDS),
    )


def global_batch(data_root: str, **shard):
    """The first batch (this process's rows of it with ``host_shard``) of
    the sequential windows, unshuffled, as JAX's check loads its own."""
    from conductor_tpu_torch.data.dataset import BatchIterator, ConductorMotionDataset

    ds = ConductorMotionDataset(data_root, "train", sample_length=SECONDS, mode="sequential")
    return next(iter(BatchIterator(ds, GLOBAL_BATCH, shuffle=False, **shard)))


def run_step(data_root: str, device: str, reference: str | None) -> dict:
    """One step on this process's rows; {loss, grad_norm, rank, world}."""
    import torch

    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
    from conductor_tpu_torch.parallel import init_from_env, shutdown

    mesh, dev = init_from_env("gloo", device)
    tr = DDPMTrainer(make_cfg(), device=dev, mesh=mesh)
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                 motion_encoder=synthetic_motion_encoder_state_dict(tr.feat_model,
                                                                                    seed=0))
    mel, motion, m_lens = global_batch(data_root, host_shard=mesh.distributed,
                                       process_index=mesh.rank, process_count=mesh.size)
    drawn = {}
    if reference:
        ref = np.load(reference)
        drawn = {k: torch.from_numpy(ref[k]) for k in ("t", "noise", "cond_keep")}
    m = tr.train_step(mel, motion, m_lens, **drawn)
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]), "rank": mesh.rank,
           "world": mesh.size, "rows": int(mel.shape[0])}
    shutdown(mesh)
    return out


def parent(args) -> int:
    sys.path.insert(0, REPO)
    from conductor_tpu_torch.data.dataset import make_synthetic_dataset

    root = args.data_root
    if root is None:
        root = os.path.join(tempfile.mkdtemp(prefix="conductor_mp_torch_"), "cm100")
        make_synthetic_dataset(root, "train", num_clips=GLOBAL_BATCH)

    def spawn(world: int, rank: int, port: int) -> subprocess.Popen:
        env = dict(os.environ, RANK=str(rank), WORLD_SIZE=str(world), LOCAL_RANK=str(rank),
                   MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port), OMP_NUM_THREADS="2",
                   PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
        cmd = [sys.executable, os.path.abspath(__file__), "--child", "--data_root", root,
               "--device", args.device]
        if args.reference:
            cmd += ["--reference", args.reference]
        return subprocess.Popen(cmd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True, cwd=REPO)

    def collect(procs, tag):
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=TIMEOUT)[0])
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
        results = []
        for p, out in zip(procs, outs):
            lines = [ln for ln in out.splitlines() if ln.startswith("RESULT ")]
            if p.returncode != 0 or not lines:
                print(f"--- {tag} output ---\n{out}")
                raise SystemExit(f"{tag} failed (rc={p.returncode})")
            results.append(json.loads(lines[0][len("RESULT "):]))
        return results

    from conductor_tpu_torch.parallel.mesh import free_port

    port = free_port()
    alone = [spawn(1, 0, free_port())]  # all three processes at once
    ranks = [spawn(WORLD, r, port) for r in range(WORLD)]
    try:
        single = collect(alone, "single process")[0]
        dist = collect(ranks, f"{WORLD} processes")
    finally:
        for p in alone + ranks:
            if p.poll() is None:
                p.kill()
    print("single :", single)
    for r in dist:
        print(f"rank {r['rank']}:", r)
    assert [r["world"] for r in dist] == [WORLD] * WORLD
    assert [r["rows"] for r in dist] == [GLOBAL_BATCH // WORLD] * WORLD
    assert single["rows"] == GLOBAL_BATCH
    ref = np.load(args.reference) if args.reference else None
    for key in ("loss", "grad_norm"):
        for r in dist:
            np.testing.assert_allclose(r[key], dist[0][key], rtol=RTOL, err_msg=key)
            np.testing.assert_allclose(r[key], single[key], rtol=RTOL, err_msg=key)
        if ref is not None:
            np.testing.assert_allclose(dist[0][key], float(ref[key]), rtol=JAX_RTOL, err_msg=key)
            print(f"{key}: JAX {float(ref[key]):.8g}, {WORLD} ranks {dist[0][key]:.8g}, "
                  f"1 process {single[key]:.8g}")
    print("multiprocess parity ok" + (" (and with JAX's step)" if ref is not None else ""))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--child", action="store_true")
    ap.add_argument("--data_root")
    ap.add_argument("--reference", default=None,
                    help=".npz of JAX's step on the same batch: loss, grad_norm, t, noise, "
                         "cond_keep")
    ap.add_argument("--device", default="cpu", help="torch device of every rank (default cpu)")
    args = ap.parse_args()
    if args.child:
        sys.path.insert(0, REPO)
        print("RESULT " + json.dumps(run_step(args.data_root, args.device, args.reference)),
              flush=True)
        return 0
    return parent(args)


if __name__ == "__main__":
    raise SystemExit(main())
