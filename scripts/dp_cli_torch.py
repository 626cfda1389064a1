"""`cli.train` and `cli.evaluate` under torchrun on N ranks against one
process, on a synthetic root.

    python scripts/dp_cli_torch.py [--nproc 4] [--dist_backend nccl] [--device cuda]
    python scripts/dp_cli_torch.py --nproc 2 --device cpu --tiny

Writes a root of 16 synthetic 60-s train clips and 8 test clips in a
temporary directory, trains ``--times 4 --epochs 1`` (2 steps of the global
batch of 32, the CLI's other defaults; with ``--tiny`` D = 32, 2 layers,
2-s windows, a batch of 4) on N ranks and on one process, then scores the
N-rank run at ddim50 with `cli.evaluate` on N ranks (waves of 8 a rank)
and on one process on the same waves.  Prints one JSON line: the card, each
call's wall seconds (process start-up included), the steps' losses on both
sides and their largest relative gap, and the two reports' largest gap.
It imports no JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

REPO = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
TINY = ["--batch_size", "4", "--sample_length", "2", "--latent_dim", "32", "--ff_size", "16",
        "--num_layers", "2", "--num_heads", "4", "--diffusion_steps", "8", "--schedule",
        "cosine"]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nproc", type=int, default=4)
    ap.add_argument("--dist_backend", default=None, choices=["nccl", "gloo"])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--tiny", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, REPO)
    from conductor_tpu_torch.data.dataset import make_synthetic_dataset

    env = dict(os.environ, PYTHONUNBUFFERED="1",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    backend = ["--dist_backend", args.dist_backend] if args.dist_backend else []
    work = tempfile.mkdtemp(prefix="dp_cli_")
    seconds: dict[str, float] = {}

    def run(tag: str, nproc: int, module: str, *argv: str) -> str:
        cmd = [sys.executable, "-m", module, *argv, "--device", args.device]
        if nproc:
            cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                   "--nproc_per_node", str(nproc), "-m", module, *argv, "--device", args.device,
                   *backend]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, env=env, cwd=REPO, capture_output=True, text=True, timeout=900)
        seconds[tag] = round(time.perf_counter() - t0, 1)
        if proc.returncode:
            raise SystemExit(f"{tag} failed:\n{(proc.stdout + proc.stderr)[-4000:]}")
        return proc.stdout

    try:
        root = os.path.join(work, "data")
        make_synthetic_dataset(root, "train", num_clips=16)
        make_synthetic_dataset(root, "test", num_clips=8, seed=18, correlated=True)
        train = ["--data_root", root, "--checkpoints_dir", work, "--times", "4", "--epochs", "1",
                 "--log_every", "1", *(TINY if args.tiny else [])]
        out = run("train_ranks", args.nproc, "conductor_tpu_torch.cli.train", *train,
                  "--name", "ranks")
        run("train_one", 0, "conductor_tpu_torch.cli.train", *train, "--name", "one")

        def losses(name):
            with open(os.path.join(work, "ConductorMotion100", name, "metrics.jsonl")) as f:
                return [json.loads(line)["loss"] for line in f]

        got, want = losses("ranks"), losses("one")
        run_dir = os.path.join(work, "ConductorMotion100", "ranks")
        score = ["--run_dir", run_dir, "--data_root", root, "--steps", "50"]
        run("evaluate_ranks", args.nproc, "conductor_tpu_torch.cli.evaluate", *score,
            "--out_suffix", "_ranks")
        run("evaluate_one", 0, "conductor_tpu_torch.cli.evaluate", *score, "--batch_size",
            str(8 * args.nproc), "--out_suffix", "_one")
        reports = []
        for sfx in ("_ranks", "_one"):
            with open(os.path.join(run_dir, f"eval_test{sfx}.json")) as f:
                reports.append(json.load(f))
        card = "cpu"
        if args.device.startswith("cuda"):
            card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                                   "--format=csv,noheader"], capture_output=True,
                                  text=True).stdout.splitlines()[0].strip()
        result = {
            "card": card, "nproc": args.nproc, "backend": args.dist_backend or "default",
            "seconds": seconds, "losses_ranks": got, "losses_one_process": want,
            "largest_rel_loss_gap": max(abs(a - b) / abs(b) for a, b in zip(got, want)),
            "largest_report_gap": max(abs(reports[0][k] - v) for k, v in reports[1].items()),
            "rank_lines": [ln for ln in out.splitlines() if ln.startswith("rank ")],
        }
        print(json.dumps(result), flush=True)
        ok = len(got) == len(want) > 0 and result["largest_rel_loss_gap"] <= 1e-3
        return 0 if ok else 1
    finally:
        shutil.rmtree(work, ignore_errors=True)


if __name__ == "__main__":
    raise SystemExit(main())
