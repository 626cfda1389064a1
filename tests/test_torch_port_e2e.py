"""PyTorch port: the stage-2 CLI under a torchrun environment, E's tail and
the multiprocess check, on the CPU.

(6) `cli.train` on 2 ranks over gloo (torchrun's environment, a free port,
    a timeout on every rank): rank 0 alone writes (one metrics line a step,
    the feature cache that rank 1 checks), ``--epochs 1`` then
    ``--continue --epochs 2`` equals the one-process ``--epochs 2`` on the
    global batch (losses and weights within 1e-5), a SIGTERM to rank 1
    stops both ranks at one step boundary where rank 0 saves, and a global
    batch the ranks do not divide is refused; (7) ``--run_meta``'s keys
    and values against JAX's `update_run_meta` on the same sweep output;
    `scripts/multiprocess_check_torch.py` with JAX's step on the same
    global batch as its reference (the script itself imports no JAX); the
    demo's parts (its CLI flags against JAX's demo's, the checkpoint round
    trip, ``run_meta.json``'s keys against JAX's committed one) and the
    1000-step ladder sweep at ddim 5 on a tiny run.  The whole demo takes
    minutes on the CPU; it runs whole on the card (`chip_smoke.py` phase 19).
"""

import ast
import json
import os
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_port_ranks as R
from conductor_tpu.config import Config as JConfig
from conductor_tpu.config import DenoiserConfig as JDenoiser
from conductor_tpu.config import DiffusionConfig as JDiffusion
from conductor_tpu.config import TrainConfig as JTrain
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch import DDPMTrainer, M2SNetTrainer
from conductor_tpu_torch.cli import serving_delta_ci
from conductor_tpu_torch.cli import train as train_cli
from conductor_tpu_torch.config import DatasetSpec
from conductor_tpu_torch.data.dataset import make_synthetic_dataset
from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
from conductor_tpu_torch.parallel import Mesh
from conductor_tpu_torch.parallel.mesh import free_port
from conductor_tpu_torch.train.checkpoints import CheckpointManager

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
sys.path.insert(0, SCRIPTS)
import multiprocess_check_torch as mpc  # noqa: E402
import run_1000ladder_torch as ladder  # noqa: E402
import run_e2e_demo_torch as demo  # noqa: E402

TINY = ["--batch_size", "4", "--diffusion_steps", "8", "--schedule", "cosine", "--sample_length",
        "2", "--latent_dim", "32", "--ff_size", "16", "--num_layers", "2", "--num_heads", "4",
        "--device", "cpu", "--times", "2", "--cached_features", "--log_every", "1"]
NO_TENSORBOARD = "import sys; sys.modules['torch.utils.tensorboard'] = None; "
CLI = NO_TENSORBOARD + "from conductor_tpu_torch.cli.train import main; main(sys.argv[1:])"


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    r = str(tmp_path_factory.mktemp("cm100_e2e"))
    make_synthetic_dataset(r, "train", num_clips=4, spec=DatasetSpec(clip_seconds=6))
    return r


def _spawn(argv, world=2, port=None):
    port = port or free_port()
    return [subprocess.Popen([sys.executable, "-c", CLI, *argv],
                             env=dict(R.rank_env(r, world, port), PYTHONUNBUFFERED="1"),
                             stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                             cwd=REPO) for r in range(world)]


def _records(run):
    with open(os.path.join(run, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def _final(run):
    return CheckpointManager(os.path.join(run, "ckpt")).restore()


def test_train_cli_on_two_ranks_equals_one_process(root, tmp_path):
    """``--epochs 1`` then ``--continue --epochs 2`` on 2 ranks (2 rows a
    rank of each global batch of 4, the feature cache written by rank 0)
    against one process's ``--epochs 2``: one metrics line a step, only
    from rank 0; the losses and the final weights within 1e-5."""
    args = ["--data_root", root, "--name", "dp", "--checkpoints_dir", str(tmp_path / "dp"), *TINY]
    outs = R.wait_all(_spawn(args + ["--epochs", "1"]), 240)
    assert "rank 0 of 2 (gloo)" in outs[0] and "rank 1 of 2 (gloo)" in outs[1]
    assert "step: 2" in outs[0] and "step:" not in outs[1]  # rank 0 alone logs
    assert "feature cache: 4 clips precomputed" in outs[0] and "feature cache" not in outs[1]
    run = os.path.join(str(tmp_path / "dp"), "ConductorMotion100", "dp")
    assert [r["step"] for r in _records(run)] == [1, 2]
    outs = R.wait_all(_spawn(args + ["--epochs", "2", "--continue"]), 240)
    assert "resumed from step 2" in outs[0] and "resumed" not in outs[1]
    train_cli.main(["--data_root", root, "--name", "one", "--checkpoints_dir",
                    str(tmp_path / "one"), *TINY, "--epochs", "2"])
    one = os.path.join(str(tmp_path / "one"), "ConductorMotion100", "one")
    got, want = _records(run), _records(one)
    assert [r["step"] for r in got] == [r["step"] for r in want] == [1, 2, 3, 4]
    for a, b in zip(got, want):
        for k in ("loss", "loss_mot_rec", "grad_norm"):
            np.testing.assert_allclose(a[k], b[k], rtol=1e-5, err_msg=k)
    a, b = _final(run), _final(one)
    assert a["total_it"] == b["total_it"] == 4
    for k, v in b["encoder"].items():
        np.testing.assert_allclose(a["encoder"][k].numpy(), v.numpy(), atol=1e-5, err_msg=k)


def test_sigterm_on_one_rank_stops_both_at_one_boundary(root, tmp_path):
    """A SIGTERM to rank 1: both ranks stop after the same step, rank 0
    saves it and says the signal came from another rank, both exit 0."""
    ckpts = str(tmp_path / "sig")
    procs = _spawn(["--data_root", root, "--name", "sig", "--checkpoints_dir", ckpts, *TINY,
                    "--epochs", "1000", "--save_latest", "100000", "--save_every_e", "100000"])
    run = os.path.join(ckpts, "ConductorMotion100", "sig")
    jsonl = os.path.join(run, "metrics.jsonl")
    try:
        deadline = time.time() + 120
        while not (os.path.exists(jsonl) and os.path.getsize(jsonl) > 0):
            assert all(p.poll() is None for p in procs) and time.time() < deadline
            time.sleep(0.05)
        procs[1].send_signal(signal.SIGTERM)
    finally:
        outs = R.wait_all(procs, 120)
    last = _records(run)[-1]["step"]
    assert CheckpointManager(os.path.join(run, "ckpt")).latest_step() == last
    assert f"stop requested (signal on another rank): saved step {last}" in outs[0]
    assert f"stop requested (signal {int(signal.SIGTERM)}): stopped at step {last}" in outs[1]


def test_train_cli_refuses_a_batch_the_ranks_do_not_divide(root, tmp_path, monkeypatch):
    from contextlib import contextmanager

    @contextmanager
    def two_ranks(name, backend=None, task="training"):
        yield Mesh(rank=0, size=2, backend="gloo"), torch.device("cpu")

    monkeypatch.setattr(train_cli, "run_mesh", two_ranks)
    with pytest.raises(SystemExit, match="--batch_size 3 .* must divide the world size 2"):
        train_cli.main(["--data_root", root, "--checkpoints_dir", str(tmp_path), "--batch_size",
                        "3", "--device", "cpu"])
    assert not os.listdir(tmp_path)


def _quality():
    return {"n_seeds": 3, "clips_per_seed": 16, "split": "serving_ci", "ddim_steps": 50,
            "device": "cpu",
            **{k: {"per_seed_pct": [0.1, -0.2, 0.3], "mean_pct": m, "abs_mean_pct": abs(m),
                   "ci95_pct": c}
               for k, m, c in (("fgd_delta", 0.073, 0.003), ("bc_delta", -0.463, 0.071),
                               ("mse_delta", 0.045, 0.001))}}


def test_run_meta_matches_jax_update_run_meta(tmp_path, monkeypatch):
    """``--run_meta`` on a sweep's output: the keys and values JAX's
    `update_run_meta` writes, the provenance naming the device ("cpu")."""
    import serving_delta_ci as jax_sdc  # scripts/serving_delta_ci.py

    base = {"wall_clock_s": 1.0, "backend": "x", "serving_fgd_delta_pct": 9.0}
    paths = {}
    for side in ("jax", "port"):
        paths[side] = str(tmp_path / f"{side}.json")
        with open(paths[side], "w") as f:
            json.dump(base, f)
    jax_sdc.update_run_meta(paths["jax"], _quality())
    monkeypatch.setattr(serving_delta_ci, "sweep", lambda *a, **k: _quality())
    serving_delta_ci.main(["--run_dir", str(tmp_path), "--data_root", str(tmp_path),
                           "--run_meta", paths["port"], "--device", "cpu"])
    jm, pm = (json.load(open(paths[s])) for s in ("jax", "port"))
    assert list(jm) == list(pm)
    for k, v in jm.items():
        if k != "serving_ci_provenance":
            assert pm[k] == v, k
    head = "3 seeds x 16 clips (serving_ci split) on "
    assert jm["serving_ci_provenance"] == head + "cpu (scripts/serving_delta_ci.py)"
    assert pm["serving_ci_provenance"] == head + "cpu (conductor_tpu_torch.cli.serving_delta_ci)"
    assert serving_delta_ci.card_label("cpu") == "cpu"


def test_multiprocess_check_agrees_with_jax(tmp_path):
    """The script's 2 ranks and 1 process against JAX's step on the same
    global batch of 4 (mel path, the port's seed-0 weights), JAX's random
    numbers handed over through ``--reference``."""
    root = str(tmp_path / "cm100")
    make_synthetic_dataset(root, "train", num_clips=mpc.GLOBAL_BATCH)
    mel, motion, m_lens = mpc.global_batch(root)
    probe = DDPMTrainer(mpc.make_cfg(), device="cpu")
    sd = synthetic_state_dict(probe.model, seed=0)
    feat_sd = synthetic_motion_encoder_state_dict(probe.feat_model, seed=0)
    cfg = JConfig(denoiser=JDenoiser(num_frames=30 * mpc.SECONDS, latent_dim=32, ff_size=16,
                                     num_layers=2, num_heads=4),
                  diffusion=JDiffusion(steps=8, schedule="cosine"),
                  train=JTrain(batch_size=mpc.GLOBAL_BATCH, sample_length=mpc.SECONDS))
    tr = JaxTrainer(cfg)
    rng = jax.random.PRNGKey(0)
    state = tr.init_state(rng)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = state.replace(params=variables["params"], batch_stats=variables["batch_stats"],
                          feat_variables=jax.tree.map(jnp.asarray, import_motion_encoder(feat_sd)),
                          opt_state=tr.tx.init(variables["params"]))
    b, t = motion.shape[:2]
    t_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    ts = jax.random.randint(t_rng, (b,), 0, tr.sched.num_timesteps)
    noise_rng, cond_rng = jax.random.split(loss_rng)
    noise = jax.random.normal(noise_rng, (b, t, 26))
    _, ones_out = tr.model.apply({"params": state.params, "batch_stats": state.batch_stats},
                                 jnp.ones((b, t, 64)), True, method=tr.model.cond_from_features,
                                 rngs={"cond": cond_rng})
    _, metrics = tr.train_step(state, (jnp.asarray(mel), jnp.asarray(motion),
                                       jnp.asarray(m_lens)), rng)
    ref = str(tmp_path / "jax_step.npz")
    np.savez(ref, t=np.array(ts), noise=np.array(noise), cond_keep=np.array(ones_out[..., 0]),
             loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]))
    proc = subprocess.run([sys.executable, os.path.join(SCRIPTS, "multiprocess_check_torch.py"),
                           "--data_root", root, "--reference", ref], capture_output=True,
                          text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "multiprocess parity ok (and with JAX's step)" in proc.stdout


def _jax_call_flags(name: str) -> dict:
    """The literal flag values of JAX's demo's ``name([...])`` call."""
    tree = ast.parse(open(os.path.join(SCRIPTS, "run_e2e_demo.py")).read())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == name)
    items = call.args[0].elts
    flags = {}
    for k, v in zip(items, items[1:]):
        if isinstance(k, ast.Constant) and str(k.value).startswith("--"):
            flags[k.value] = v.value if isinstance(v, ast.Constant) else None
    return flags


def _flags(argv: list[str]) -> dict:
    return {k: v for k, v in zip(argv, argv[1:]) if k.startswith("--")}


def test_demo_passes_jax_demos_flags_and_round_trips(root, tmp_path):
    """The demo's stage-1 and stage-2 flags are JAX's demo's (the
    non-literal values aside); the round trip of a tiny CLI run and an
    M2SNet checkpoint is exact; ``run_meta.json`` has the keys of JAX's
    committed ``docs/e2e_run/run_meta.json``."""
    for name, ours in (("m2snet_main", demo.stage1_args("R", "C", 16)),
                       ("train_main", demo.stage2_args("R", "C", "e2e_demo", 30, 50))):
        want = _jax_call_flags(name)
        got = _flags(ours)
        assert set(got) == set(want) - {"--stage1_ckpt"}, name
        for k, v in want.items():
            if v is not None and k in got:
                assert got[k] == v, (name, k)
    train_cli.main(["--data_root", root, "--name", "rt", "--checkpoints_dir", str(tmp_path),
                    *TINY, "--epochs", "1"])
    run_dir = os.path.join(str(tmp_path), "ConductorMotion100", "rt")
    m2s_dir = str(tmp_path / "m2s")
    CheckpointManager(os.path.join(m2s_dir, "ckpt")).save(
        0, M2SNetTrainer(sample_length=30, clip_length=10, device="cpu").state_dict(), wait=True)
    roundtrip = demo.checkpoint_roundtrip(run_dir, m2s_dir, str(tmp_path), "cpu")
    assert roundtrip.startswith("exact")
    meta = demo.write_run_meta(str(tmp_path / "run_meta.json"), run_dir, 12.3, roundtrip,
                               _quality(), "cpu")
    with open(os.path.join(REPO, "docs", "e2e_run", "run_meta.json")) as f:
        assert set(meta) == set(json.load(f))
    assert meta["backend"].startswith("cpu (synthetic data") and meta["stage2_steps"] == 2


def test_1000_ladder_sweep_writes_jax_schema(tmp_path):
    """The ladder on a tiny run (8 clips, one epoch, ddim 5 of the
    1000-step ladder, the CPU): JAX's schema, finite metrics."""
    out = ladder.main(["--out", str(tmp_path / "out"), "--work", str(tmp_path / "work"),
                       "--train_clips", "8", "--test_clips", "2", "--stage2_epochs", "1",
                       "--steps", "5", "--device", "cpu"])
    with open(os.path.join(REPO, "docs", "e2e_run", "quality_vs_steps_1000.json")) as f:
        jax_payload = json.load(f)
    with open(tmp_path / "out" / "quality_vs_steps_1000.json") as f:
        assert json.load(f) == out
    assert list(out) == list(jax_payload) and out["ladder_steps"] == 1000
    assert list(out["sweep"]) == ["5"]
    assert set(out["sweep"]["5"]) == set(jax_payload["sweep"]["50"])
    assert all(np.isfinite(v) for v in out["sweep"]["5"].values())
