"""PyTorch port: reference checkpoints in and out (`interop.opt_txt`,
`interop.reference`, `cli.import_torch`, `cli.export_torch`) against the
JAX package's (`conductor_tpu/interop/`, `conductor_tpu/cli/import_torch.py`,
`export_torch.py`).

- `read_opt_txt` gives JAX's dict on the same file (bools, ``None``,
  ``2e-05``, negative ints, a value holding ``": "``);
  `denoiser_config_from_state_dict` gives JAX's config;
- ``import_torch diffusion`` in both packages on synthetic reference run
  directories (``opt.txt`` + ``model/latest.tar``): one tar from JAX's
  `save_diffusion_tar` (an empty Adam state), one with the full Adam
  moments of a port run two steps in.  Both give the same config.json
  field for field, the same step and ``import_meta.json``; the port's
  imported Adam moments are the tar's as JAX's `load_diffusion_optimizer`
  reads them (what JAX's `graft_adam_state` grafts); the ddim motion of
  the two imported runs agrees within 1e-5 of the largest value on JAX's
  x_T; an ``opt.txt`` whose depth the weights contradict is refused in both;
- ``export_torch diffusion`` / ``m2snet`` from the port read in JAX's
  importer give parameters (and Adam moments) exactly equal to the
  originals'; export -> import round-trips bit for bit;
- ``import_torch m2sgan`` of the `torch_m2sgan.npz` weights restores into
  `M2SGANTrainer`, whose generator meets JAX's imported generator's output
  within 1e-5; ``import_torch m2snet`` gives a checkpoint the graft reads.

Tiny denoiser: D = 32, 2 layers, 4 heads, ff 16, 60 frames, 1000 linear
steps served as ddim4.  JAX's `init_state` is jitted here (eager flax init
takes ~18 s)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.cli import import_torch as jax_import_cli
from conductor_tpu.config import Config as JaxConfig
from conductor_tpu.interop import opt_txt as jax_opt_txt
from conductor_tpu.interop.torch_export import save_diffusion_tar as jax_save_diffusion_tar
from conductor_tpu.interop.torch_import import (
    import_adam_state,
    import_generator,
    import_m2snet,
    import_motion_transformer,
    load_diffusion_optimizer,
    load_diffusion_tar,
)
from conductor_tpu.models.generator import Generator as FlaxG
from conductor_tpu.train.checkpoints import restore_raw as jax_restore_raw
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu.train.ddpm_trainer import TrainState
from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer
from conductor_tpu_torch.cli import export_torch, import_torch
from conductor_tpu_torch.cli.visualize import load_run
from conductor_tpu_torch.config import Config, DenoiserConfig, TrainConfig
from conductor_tpu_torch.interop import synth_state_dict, synthetic_m2snet_state_dict
from conductor_tpu_torch.interop.opt_txt import read_opt_txt, write_opt_txt
from conductor_tpu_torch.interop.reference import denoiser_config_from_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.train.checkpoints import CheckpointManager, restore_raw

torch.set_num_threads(2)

TINY = dict(latent_dim=32, ff_size=16, num_layers=2, num_heads=4, num_frames=60)
OPT = {"name": "ref: run", "dataset_name": "ConductorMotion100", "num_layers": 2,
       "latent_dim": 32, "diffusion_steps": 1000, "lr": 2e-05, "batch_size": 4, "num_epochs": 5,
       "no_eff": False, "log_every": 7, "save_latest": 100, "save_every_e": 2,
       "which_epoch": "latest", "seed": -3, "data_root": None, "is_train": True}
STEPS, B, T = 4, 2, 60


def _np(sd):
    return {k: v.detach().numpy().copy() for k, v in sd.items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two reference run directories on one set of weights: "empty" (JAX's
    `save_diffusion_tar`) and "adam" (a port run's state two steps in)."""
    root = tmp_path_factory.mktemp("ref_runs")
    cfg = Config(denoiser=DenoiserConfig(**TINY), train=TrainConfig(sample_length=2, batch_size=B))
    tr = DDPMTrainer(cfg, device="cpu")
    from conductor_tpu_torch.interop import synthetic_state_dict

    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=1))
    rng = np.random.RandomState(0)
    for _ in range(2):
        tr.train_step(rng.uniform(0, 1, (B, 3 * T, 128)).astype(np.float32),
                      rng.uniform(0, 1, (B, T, 13, 2)).astype(np.float32))
    state = tr.state_dict(epoch=3)
    out = {}
    for name in ("empty", "adam"):
        run = root / name
        (run / "model").mkdir(parents=True)
        write_opt_txt(str(run / "opt.txt"), OPT)
        tar = str(run / "model" / "latest.tar")
        if name == "empty":
            jax_save_diffusion_tar(tar, _np(state["encoder"]), ep=3, total_it=2)
        else:
            torch.save({k: state[k] for k in ("encoder", "opt_encoder", "ep", "total_it")}, tar)
        out[name] = str(run)
    return out, _np(state["encoder"])


@pytest.fixture()
def fast_jax_init(monkeypatch):
    orig = JaxTrainer.init_state

    def init_state(self, rng, **kw):
        return jax.jit(lambda r, k: orig(self, r, **k))(rng, kw)

    monkeypatch.setattr(JaxTrainer, "init_state", init_state)


def test_read_opt_txt_matches_jax(tmp_path):
    path = str(tmp_path / "opt.txt")
    write_opt_txt(path, OPT)
    with open(path, "a") as f:
        f.write("no separator here\n\nlambda_feat: 1e-06\nscale: 0.5\n")
    got = read_opt_txt(path)
    assert got == jax_opt_txt.read_opt_txt(path)
    assert got["name"] == "ref: run" and got["lr"] == 2e-05 and got["data_root"] is None
    assert got["seed"] == -3 and got["no_eff"] is False and got["lambda_feat"] == 1e-06
    assert {k: got[k] for k in OPT} == OPT


def test_denoiser_config_from_state_dict_matches_jax(runs):
    _, sd = runs
    for heads in (8, 4):
        for keys in (sd, {f"module.{k}": v for k, v in sd.items()}):
            got = denoiser_config_from_state_dict(keys, heads)
            want = jax_import_cli.denoiser_config_from_state_dict(keys, heads)
            assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert (got.latent_dim, got.num_layers, got.ff_size, got.num_frames) == (32, 2, 16, 60)


def _jax_motion(out_dir, mel, rng):
    cfg = JaxConfig.load(os.path.join(out_dir, "config.json"))
    raw = jax_restore_raw(os.path.join(out_dir, "ckpt"))
    state = TrainState(step=jnp.asarray(raw["step"]), params=raw["params"],
                       batch_stats=raw["batch_stats"], feat_variables=None, opt_state=None)
    return np.asarray(JaxTrainer(cfg).generate(state, jnp.asarray(mel), rng, num_steps=STEPS))


@pytest.mark.parametrize("name", ["empty", "adam"])
def test_import_diffusion_matches_jax(runs, name, tmp_path, fast_jax_init):
    dirs, sd = runs
    out_p, out_j = str(tmp_path / "port"), str(tmp_path / "jax")
    meta = import_torch.main(["diffusion", "--input", dirs[name], "--output", out_p,
                              "--device", "cpu"])
    jax_import_cli.main(["diffusion", "--input", dirs[name], "--output", out_j])
    with open(os.path.join(out_p, "config.json")) as f, open(
            os.path.join(out_j, "config.json")) as g:
        assert json.load(f) == json.load(g)
    with open(os.path.join(out_j, "import_meta.json")) as f:
        want_meta = json.load(f)
    assert json.loads(json.dumps(meta)) == want_meta
    cfg = Config.load(os.path.join(out_p, "config.json"))
    assert (cfg.diffusion.steps, cfg.train.lr, cfg.train.sample_length, cfg.train.log_every) == (
        1000, 2e-05, 2, 7)
    step = CheckpointManager(os.path.join(out_p, "ckpt")).latest_step()
    assert step == int(jax_restore_raw(os.path.join(out_j, "ckpt"))["step"]) == 2
    state = CheckpointManager(os.path.join(out_p, "ckpt")).restore()
    for k, v in sd.items():
        np.testing.assert_array_equal(state["encoder"][k].numpy(), v, err_msg=k)
    # the Adam moments: the tar's, as JAX reads and grafts them
    want_opt = load_diffusion_optimizer(os.path.join(dirs[name], "model", "latest.tar"))
    if want_opt is None:
        assert name == "empty" and not state["opt_encoder"]["state"]
    else:
        opt_np = {"state": {k: {kk: np.asarray(vv) for kk, vv in v.items()}
                            for k, v in state["opt_encoder"]["state"].items()},
                  "param_groups": state["opt_encoder"]["param_groups"]}
        got_opt = import_adam_state(opt_np, _np(state["encoder"]))
        assert got_opt[2] == want_opt[2] == 2
        for got_t, want_t in zip(got_opt[:2], want_opt[:2]):
            for (path, w), (_, g) in zip(jax.tree_util.tree_leaves_with_path(want_t),
                                         jax.tree_util.tree_leaves_with_path(got_t)):
                np.testing.assert_array_equal(np.asarray(g), np.asarray(w),
                                              err_msg=jax.tree_util.keystr(path))
    # ddim motion of the two imported runs on JAX's x_T
    mel = np.random.RandomState(3).uniform(0, 1, (1, 3 * T, 128)).astype(np.float32)
    rng = jax.random.PRNGKey(4)
    want = _jax_motion(out_j, mel, rng)
    x_t = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], (1, T, 26))))
    got = load_run(out_p, None, "cpu").generate(mel, num_steps=STEPS, noise=x_t).numpy()
    assert got.shape == want.shape == (1, T, 26)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


def test_opt_txt_mismatch_is_refused_in_both(runs, tmp_path):
    dirs, _ = runs
    bad = tmp_path / "bad"
    (bad / "model").mkdir(parents=True)
    os.link(os.path.join(dirs["empty"], "model", "latest.tar"), bad / "model" / "latest.tar")
    write_opt_txt(str(bad / "opt.txt"), dict(OPT, num_layers=3))
    for main in (import_torch.main, jax_import_cli.main):
        with pytest.raises(ValueError, match="num_layers=3"):
            main(["diffusion", "--input", str(bad), "--output", str(tmp_path / "out")])
    with pytest.raises(FileNotFoundError, match="ckpt_e007"):
        import_torch.main(["diffusion", "--input", dirs["empty"], "--which_epoch", "7",
                           "--output", str(tmp_path / "out"), "--device", "cpu"])


def test_export_is_read_by_jax_and_round_trips(runs, tmp_path):
    """The exported tar's parameters and Adam moments in JAX's importer
    equal the original tar's exactly; importing it again gives the first
    import's checkpoint bit for bit."""
    dirs, sd = runs
    first, second = str(tmp_path / "first"), str(tmp_path / "second")
    import_torch.main(["diffusion", "--input", dirs["adam"], "--output", first, "--device", "cpu"])
    tar = str(tmp_path / "export" / "latest.tar")
    os.makedirs(os.path.dirname(tar))
    export_torch.main(["diffusion", "--run_dir", first, "--output", tar])
    enc, meta = load_diffusion_tar(tar)
    assert meta == {"ep": 3, "total_it": 2} and list(enc) == list(sd)
    got = jax.tree_util.tree_leaves_with_path(import_motion_transformer(enc))
    want = dict(jax.tree_util.tree_leaves_with_path(import_motion_transformer(sd)))
    for key, v in got:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[key]))
    orig = load_diffusion_optimizer(os.path.join(dirs["adam"], "model", "latest.tar"))
    for a, b in zip(jax.tree_util.tree_leaves(load_diffusion_optimizer(tar)[:2]),
                    jax.tree_util.tree_leaves(orig[:2])):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    import_torch.main(["diffusion", "--input", tar, "--output", second, "--device", "cpu"])
    a = CheckpointManager(os.path.join(first, "ckpt")).restore()
    b = CheckpointManager(os.path.join(second, "ckpt")).restore()

    def flat(state):
        return jax.tree_util.tree_leaves_with_path(
            jax.tree.map(lambda v: v.numpy() if torch.is_tensor(v) else v, state))

    assert [p for p, _ in flat(a)] == [p for p, _ in flat(b)]
    for (path, x), (_, y) in zip(flat(a), flat(b)):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y),
                                      err_msg=jax.tree_util.keystr(path))


def test_m2snet_import_export(tmp_path):
    """A reference M2SNet .pt -> ``import_torch m2snet`` -> a checkpoint the
    graft reads (`restore_raw` of ``<out>/ckpt``) -> ``export_torch
    m2snet`` -> JAX's `import_m2snet` exactly as on the original."""
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=2)
    pt = str(tmp_path / "M2SNet_last.pt")
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()}, pt)
    out = str(tmp_path / "m2snet")
    import_torch.main(["m2snet", "--input", pt, "--output", out, "--device", "cpu"])
    raw = restore_raw(os.path.join(out, "ckpt"))
    assert set(raw) == set(sd)
    tr = DDPMTrainer(Config(denoiser=DenoiserConfig(**TINY)), device="cpu")
    tr.graft_stage1(raw)
    exported = str(tmp_path / "export.pt")
    export_torch.main(["m2snet", "--run_dir", out, "--output", exported])
    got = torch.load(exported, weights_only=True)
    want = dict(jax.tree_util.tree_leaves_with_path(import_m2snet(sd)))
    for key, v in jax.tree_util.tree_leaves_with_path(import_m2snet(_np(got))):
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[key]))


def test_m2sgan_import_restores_into_the_trainer(tmp_path):
    fx = np.load(os.path.join(os.path.dirname(__file__), "fixtures", "torch_m2sgan.npz"))

    def manifest(key):
        return {k: tuple(v) for k, v in json.loads(bytes(fx[key]).decode()).items()}

    from conductor_tpu_torch.models.generator import Discriminator1DCNN, Generator

    g, d = Generator(), Discriminator1DCNN()
    g.load_state_dict({k: torch.from_numpy(v) for k, v in
                       synth_state_dict(manifest("g_manifest"), seed=0).items()})
    d.load_state_dict({k: torch.from_numpy(v) for k, v in
                       synth_state_dict(manifest("d_manifest"), seed=1).items()})
    # the generator's state dict after a load: the TCN's two names of one
    # module hold one value, as JAX's importer needs (ROADMAP F10)
    g_sd, d_sd = _np(g.state_dict()), _np(d.state_dict())
    torch.save(g.state_dict(), tmp_path / "G.pt")
    torch.save(d.state_dict(), tmp_path / "D.pt")
    for with_d in (False, True):
        out = str(tmp_path / f"gan{int(with_d)}")
        argv = ["m2sgan", "--input", str(tmp_path / "G.pt"), "--output", out, "--device", "cpu"]
        import_torch.main(argv + (["--discriminator", str(tmp_path / "D.pt")] if with_d else []))
        trainer = M2SGANTrainer(device="cpu")
        trainer.load_state_dict(CheckpointManager(os.path.join(out, "ckpt")).restore())
        assert trainer.step == 0
        d_equal = all(np.array_equal(v.numpy(), d_sd[k])
                      for k, v in trainer.D.state_dict().items())
        assert d_equal == with_d  # without --discriminator the critic stays as it was
    mel, noise = fx["mel"][:, :540], fx["noise"][:, :6]
    want = FlaxG().apply(jax.tree.map(jnp.asarray, import_generator(g_sd)), jnp.asarray(mel),
                         jnp.asarray(noise))
    got = trainer.generate(torch.from_numpy(mel), noise=torch.from_numpy(noise)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5 * np.abs(np.asarray(want)).max())
