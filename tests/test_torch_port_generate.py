"""PyTorch port, the serving slice as a whole: `DDPMTrainer.generate` from
mel to motion against the recorded reference-torch DDIM trajectory and
against the JAX package's fused serving path (Pallas in interpret mode)."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.synth import manifest_from_json, synth_state_dict
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxDDPMTrainer
from conductor_tpu.train.ddpm_trainer import TrainState
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.diffusion import ddim_sample_loop, make_schedule
from conductor_tpu_torch.interop import manifest

torch.set_num_threads(2)

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")


def test_generate_matches_reference_trajectory():
    """The plain path over 50 linear DDIM steps from the recorded x_T, against
    the reference-torch trajectory (bounds of tests/test_torch_import.py)."""
    fx = np.load(os.path.join(FIXTURES, "torch_ddim_trajectory.npz"))
    sd = synth_state_dict(manifest_from_json(bytes(fx["manifest"]).decode()), seed=0)
    steps = int(fx["steps"])
    cfg = Config(
        denoiser=DenoiserConfig(num_frames=30, latent_dim=128, ff_size=64, num_layers=2,
                                num_heads=8),
        diffusion=DiffusionConfig(steps=steps, schedule="linear"),
    )
    trainer = DDPMTrainer(cfg, device="cpu")
    assert trainer.fused is None  # "auto" on the CPU: the plain modules
    trainer.load_reference_state_dict(sd)
    mel, noise = torch.from_numpy(fx["mel"]), torch.from_numpy(fx["noise"])
    want = fx["trajectory"]  # (steps, 2, 30, 26), t = steps-1 .. 0

    final = trainer.generate(mel, noise=noise)
    np.testing.assert_allclose(final.numpy(), want[-1], atol=1e-3, rtol=1e-3)

    with torch.no_grad():
        xf = trainer.model.encode_music(mel)
        _, traj = ddim_sample_loop(
            make_schedule("linear", steps), lambda x, t: trainer.model(x, t, *xf), noise,
            return_trajectory=True,
        )
    assert traj.shape == want.shape
    np.testing.assert_allclose(traj[:10].numpy(), want[:10], atol=2e-4, rtol=1e-3)
    for s in range(steps):
        scale = max(float(np.abs(want[s]).max()), 1.0)
        assert float(np.abs(traj[s].numpy() - want[s]).max()) < 2e-3 * scale, s


@pytest.fixture(scope="module")
def serving_pair():
    """A JAX trainer on the fused Pallas serving path (float32) and the
    port's trainer on its fused path (plain versions on the CPU), both on one
    synthetic weight set made from the port model's key/shape manifest."""
    base = Config(
        denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2,
                                num_heads=4, layer_impl="pallas_fused",
                                music_encoder_impl="pallas", compute_dtype="float32"),
        diffusion=DiffusionConfig(steps=8, schedule="cosine"),
        train=TrainConfig(sample_length=1),
    )
    port = DDPMTrainer(base, device="cpu")
    sd = synth_state_dict(manifest(port.model), seed=2)
    port.load_reference_state_dict(sd)
    assert port.fused is not None and port.fused_encoder is not None

    jtr = JaxDDPMTrainer(base)
    rng = jax.random.PRNGKey(0)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    # generate reads only the params and the encoder's BN statistics
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], feat_variables=None,
                       opt_state=None)
    mel = np.random.RandomState(4).uniform(0, 1, size=(1, 96, 128)).astype(np.float32)
    # JAX's x_T, drawn as its samplers draw it, handed to the port
    x_t = np.array(jax.random.normal(jax.random.split(rng)[0], (1, 32, 26)))
    return jtr, state, rng, port, mel, x_t


@pytest.mark.parametrize("num_steps", [None, 4])
def test_fused_generate_matches_jax_serving_path(serving_pair, num_steps):
    """Full 8-step ladder and a 4-step respaced ladder; atol 5e-4."""
    jtr, state, rng, port, mel, x_t = serving_pair
    want = np.asarray(jtr.generate(state, jnp.asarray(mel), rng, num_steps=num_steps))
    got = port.generate(torch.from_numpy(mel), num_steps=num_steps, noise=torch.from_numpy(x_t))
    assert got.shape == want.shape == (1, 32, 26)
    assert float(np.abs(want).max()) > 1e-2
    np.testing.assert_allclose(got.numpy(), want, atol=5e-4)


def test_plain_and_fused_paths_agree(serving_pair):
    """The port's own two serving paths on one weight set and one x_T."""
    _, _, _, port, mel, x_t = serving_pair
    plain = DDPMTrainer(port.cfg.replace(denoiser=dataclasses.replace(
        port.cfg.denoiser, layer_impl="flax", music_encoder_impl="flax")), device="cpu")
    plain.load_reference_state_dict(port.model.state_dict())
    args = dict(num_steps=4, noise=torch.from_numpy(x_t))
    np.testing.assert_allclose(plain.generate(torch.from_numpy(mel), **args).numpy(),
                               port.generate(torch.from_numpy(mel), **args).numpy(), atol=5e-4)
