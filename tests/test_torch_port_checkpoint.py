"""PyTorch port: stage-2 checkpoints, the stage-1 graft and config.json
against the JAX package.

A port checkpoint (`DDPMTrainer.state_dict` through `CheckpointManager`)
is a reference ``latest.tar``: JAX's `load_diffusion_tar` +
`import_motion_transformer` read the port's parameters exactly, and
`load_diffusion_optimizer` its Adam moments and count exactly (the port
writes ``opt_encoder`` in the reference's parameter order, which is its
own registration order).  `graft_stage1` from a synthetic reference M2SNet
against JAX's `init_state` fed by `music_encoder_from_m2snet` /
`motion_encoder_from_m2snet`: music features and ST-GCN latents at 1e-5
of the largest value.  The CLI's config.json loads in JAX's `Config.load`
field for field.  Tiny float32 config: 2 layers, latent 32, 8 steps.
"""

import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config as JaxConfig
from conductor_tpu.config import DenoiserConfig as JaxDenoiserConfig
from conductor_tpu.config import DiffusionConfig as JaxDiffusionConfig
from conductor_tpu.config import TrainConfig as JaxTrainConfig
from conductor_tpu.interop.torch_export import save_diffusion_tar
from conductor_tpu.interop.torch_import import (
    import_motion_transformer,
    load_diffusion_optimizer,
    load_diffusion_tar,
    motion_encoder_from_m2snet,
    music_encoder_from_m2snet,
    parameter_names,
)
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.cli.train import build_argparser, config_from_args
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict, synthetic_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.train.checkpoints import CheckpointManager, restore_raw

torch.set_num_threads(2)

TINY = dict(latent_dim=32, ff_size=16, num_layers=2, num_heads=4, num_frames=60)
B, T = 2, 60


def _cfg(**train):
    return Config(denoiser=DenoiserConfig(**TINY), diffusion=DiffusionConfig(steps=8, schedule="cosine"),
                  train=TrainConfig(sample_length=2, batch_size=B, cached_features=True, **train))


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    return (rng.normal(size=(B, T, 64)).astype(np.float32),
            rng.uniform(0, 1, size=(B, T, 13, 2)).astype(np.float32))


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """A trainer three steps in (the loss-second-moment sampler on), and
    its checkpoint file."""
    tr = DDPMTrainer(_cfg(timestep_sampler="loss-second-moment"), device="cpu")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=1))
    for s in range(3):
        tr.train_step(*_batch(s))
    mgr = CheckpointManager(tmp_path_factory.mktemp("ckpt"))
    mgr.save(tr.step, tr.state_dict(epoch=1))
    mgr.close()
    return tr, os.path.join(mgr.directory, f"{tr.step}.tar")


def test_parameter_order_is_the_reference_state_dict_order(trained):
    """`opt_encoder` positions are `parameter_names` of the state dict, the
    reference module's registration order, which is the port's."""
    tr, _ = trained
    names = [n for n, _ in tr.model.named_parameters()]
    assert names == parameter_names(tr.model.state_dict())
    assert names[0] == "sequence_embedding" and names[1].startswith("music_encoder.")


def test_jax_reads_the_port_checkpoint_exactly(trained):
    tr, path = trained
    enc, meta = load_diffusion_tar(path)
    assert meta == {"ep": 1, "total_it": 3}
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    assert list(enc) == list(sd)
    for k in sd:
        np.testing.assert_array_equal(enc[k], sd[k], err_msg=k)
    got = jax.tree_util.tree_leaves_with_path(import_motion_transformer(enc)["params"])
    want = dict(jax.tree_util.tree_leaves_with_path(import_motion_transformer(sd)["params"]))
    for key, v in got:
        np.testing.assert_array_equal(np.asarray(v), np.asarray(want[key]))


def test_jax_reads_the_port_adam_state_exactly(trained):
    """`load_diffusion_optimizer`'s (mu, nu, count) are the port's Adam
    moments, under the right names; the frozen music encoder has none."""
    tr, path = trained
    mu, nu, count = load_diffusion_optimizer(path)
    assert count == 3
    adam = tr.optimizer.adam
    sd = {k: v.numpy() for k, v in tr.model.state_dict().items()}
    moments = {}
    for name, p in tr.model.named_parameters():
        st = adam.state.get(p)
        assert (st is None) == name.startswith("music_encoder."), name
        moments[name] = st
    for key, tree in (("exp_avg", mu), ("exp_avg_sq", nu)):
        msd = {k: (moments[k][key].numpy() if moments.get(k) is not None else
                   np.zeros_like(v) if k in moments else v) for k, v in sd.items()}
        want = dict(jax.tree_util.tree_leaves_with_path(import_motion_transformer(msd)["params"]))
        leaves = jax.tree_util.tree_leaves_with_path(tree)
        assert len(leaves) == len(want)
        for k, v in leaves:
            np.testing.assert_array_equal(np.asarray(v), np.asarray(want[k]),
                                          err_msg=jax.tree_util.keystr(k))


def test_state_dict_round_trip_continues_bit_for_bit(trained):
    """A trainer restored from the file takes the next step as the original
    does: parameters, Adam state, step count and sampler state restored."""
    tr, path = trained
    restored = DDPMTrainer(_cfg(timestep_sampler="loss-second-moment"), device="cpu")
    restored.load_state_dict(CheckpointManager(os.path.dirname(path)).restore())
    assert restored.step == 3
    np.testing.assert_array_equal(restored.sampler_state.loss_history, tr.sampler_state.loss_history)
    twin = DDPMTrainer(_cfg(timestep_sampler="loss-second-moment"), device="cpu")
    twin.load_state_dict(tr.state_dict())
    batch = _batch(7)
    m_a, m_b = restored.train_step(*batch), twin.train_step(*batch)
    assert all(torch.equal(m_a[k], m_b[k]) for k in m_a)
    for (k, a), b in zip(restored.model.state_dict().items(), twin.model.state_dict().values()):
        assert torch.equal(a, b), k
    for k, v in restored.feat_model.state_dict().items():
        assert torch.equal(v, tr.feat_model.state_dict()[k]), k


def test_reference_tar_without_port_keys_loads(tmp_path):
    """A tar JAX's exporter writes (an empty optimizer state, no ST-GCN)
    resumes the denoiser only."""
    tr = DDPMTrainer(_cfg(), device="cpu")
    sd = synthetic_state_dict(tr.model, seed=5)
    save_diffusion_tar(str(tmp_path / "latest.tar"), sd, ep=4, total_it=40)
    feat_before = {k: v.clone() for k, v in tr.feat_model.state_dict().items()}
    tr.load_state_dict(torch.load(tmp_path / "latest.tar", weights_only=True))
    assert tr.step == 40 and not tr.optimizer.adam.state
    for k, v in tr.model.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    assert all(torch.equal(v, feat_before[k]) for k, v in tr.feat_model.state_dict().items())


def test_graft_stage1_matches_jax_init_state(tmp_path):
    m2snet_sd = synthetic_m2snet_state_dict(M2SNet(), seed=3)
    torch.save({k: torch.from_numpy(v) for k, v in m2snet_sd.items()}, tmp_path / "M2SNet_7.pt")
    port = DDPMTrainer(_cfg(), device="cpu")
    port.graft_stage1(restore_raw(tmp_path))  # a directory holding one state-dict file

    jtr = JaxTrainer(JaxConfig(denoiser=JaxDenoiserConfig(**TINY),
                               diffusion=JaxDiffusionConfig(steps=8, schedule="cosine"),
                               train=JaxTrainConfig(sample_length=2, batch_size=B)))
    music = music_encoder_from_m2snet(m2snet_sd)
    init = jax.jit(lambda key, mp, ms, mv: jtr.init_state(  # jitted: eager flax init takes ~18 s
        key, stage1_music_params=mp, stage1_music_stats=ms, stage1_motion_variables=mv))
    state = init(jax.random.PRNGKey(0), music["params"], music["batch_stats"],
                 motion_encoder_from_m2snet(m2snet_sd))
    rng = np.random.RandomState(2)
    mel = rng.uniform(0, 1, size=(B, 3 * T, 128)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(B, T, 13, 2)).astype(np.float32)
    encode = jax.jit(lambda v, m: jtr.model.apply(v, m, method=jtr.model.encode_music)[1])
    want_feats = np.asarray(encode({"params": state.params, "batch_stats": state.batch_stats},
                                   jnp.asarray(mel)))
    want_lat = np.asarray(jax.jit(jtr.feat_model.apply)(state.feat_variables, jnp.asarray(motion)))
    got_feats = port.music_features(mel).numpy()
    with torch.no_grad():
        got_lat = port.feat_model(torch.from_numpy(motion)).numpy()
    for got, want in ((got_feats, want_feats), (got_lat, want_lat)):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())
    # the grafted encoder stays frozen
    assert not any(p.requires_grad for p in port.model.music_encoder.parameters())


def test_restore_raw_refuses_an_ambiguous_directory(tmp_path):
    for name in ("a.pt", "b.pth"):
        torch.save({"x": torch.zeros(1)}, tmp_path / name)
    with pytest.raises(ValueError, match="exactly one"):
        restore_raw(tmp_path)
    assert torch.equal(restore_raw(tmp_path / "a.pt")["x"], torch.zeros(1))


def test_checkpoint_manager_keeps_the_newest(tmp_path):
    mgr = CheckpointManager(tmp_path / "ckpt", max_to_keep=2)
    assert mgr.latest_step() is None
    for step in (1, 5, 9):
        mgr.save(step, {"total_it": step, "w": torch.full((3,), float(step))})
    mgr.wait()
    assert mgr.all_steps() == [5, 9] and mgr.latest_step() == 9
    assert mgr.restore()["total_it"] == 9 and mgr.restore(5)["w"][0] == 5.0
    assert sorted(os.listdir(tmp_path / "ckpt")) == ["5.tar", "9.tar"]  # no temporary left
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore()


def test_config_json_loads_in_jax_field_for_field(tmp_path):
    """The CLI's resolved config, saved, is JAX's `Config.load` field for
    field, for the CPU and CUDA resolutions and --faithful."""
    argv = ["--data_root", "x", "--latent_dim", "32", "--timestep_sampler", "loss-second-moment",
            "--cached_features", "--schedule", "cosine"]
    for extra, device in (([], "cpu"), ([], "cuda"), (["--faithful"], "cuda")):
        args: argparse.Namespace = build_argparser().parse_args(argv + extra)
        cfg = config_from_args(args, torch.device(device))
        cfg.save(str(tmp_path / "config.json"))
        jcfg = JaxConfig.load(str(tmp_path / "config.json"))
        assert dataclasses.asdict(jcfg) == dataclasses.asdict(cfg)
    assert (cfg.denoiser.train_layer_impl, cfg.train.feat_impl) == ("flax", "flax")
    cuda = config_from_args(build_argparser().parse_args(argv), torch.device("cuda"))
    assert (cuda.denoiser.train_layer_impl, cuda.train.feat_impl) == ("pallas_fused", "pallas")
