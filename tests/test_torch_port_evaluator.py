"""PyTorch port, the stage-2 evaluator (`eval.DiffusionEvaluator`) against
the JAX package's on one synthetic weight set (D = 32, 2 layers, 4 heads,
ff 16, 8 cosine steps, float32, the plain layers) and a 3-clip synthetic
test split of 60-s clips (beats in the mel), in waves of 2 (two waves, the
second short), 4 DDIM steps, beats included.  JAX draws wave ``i0``'s x_T
from ``fold_in(rng, i0)``; those draws are handed to the port through
``wave_noise``.  Every field within 1e-4 relative, FGD within 1e-3 (a sqrtm
of 64 x 64 covariances amplifies small latent differences).  The latents
run in float32 whatever the trainer's compute dtype."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu import config as jax_config
from conductor_tpu.eval import DiffusionEvaluator as JaxEvaluator
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxDDPMTrainer
from conductor_tpu.train.ddpm_trainer import TrainState
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch import config as port_config
from conductor_tpu_torch.data.dataset import make_synthetic_dataset
from conductor_tpu_torch.eval import DiffusionEvaluator, EvalResult
from conductor_tpu_torch.interop import (
    manifest,
    synth_state_dict,
    synthetic_motion_encoder_state_dict,
)

torch.set_num_threads(2)

STEPS, WAVE = 4, 2


def make_cfg(compute_dtype="float32", module=port_config):
    return module.Config(
        denoiser=module.DenoiserConfig(latent_dim=32, ff_size=16, num_layers=2, num_heads=4,
                                       layer_impl="flax", music_encoder_impl="flax",
                                       compute_dtype=compute_dtype),
        diffusion=module.DiffusionConfig(steps=8, schedule="cosine"),
    )


@pytest.fixture(scope="module")
def case(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("eval_root"))
    make_synthetic_dataset(root, "test", num_clips=3, seed=1, correlated=True)
    port = DDPMTrainer(make_cfg(), device="cpu")
    sd = synth_state_dict(manifest(port.model), seed=2)
    feat_sd = synthetic_motion_encoder_state_dict(port.feat_model, seed=3)
    port.load_reference_state_dict(sd, motion_encoder=feat_sd)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"],
                       feat_variables=jax.tree.map(jnp.asarray, import_motion_encoder(feat_sd)),
                       opt_state=None)
    return root, port, sd, feat_sd, state


def jax_wave_noise(rng):
    """JAX's x_T of wave ``i0``: ``normal(split(fold_in(rng, i0))[0])``, as
    `ddim_sample_loop` draws it from the wave's key."""
    def noise(i0, shape):
        init_rng, _ = jax.random.split(jax.random.fold_in(rng, i0))
        return torch.from_numpy(np.array(jax.random.normal(init_rng, shape)))
    return noise


def test_evaluate_matches_jax(case):
    root, port, _, _, state = case
    rng = jax.random.PRNGKey(7)
    jtr = JaxDDPMTrainer(make_cfg(module=jax_config))
    want = JaxEvaluator(jtr, batch_size=WAVE).evaluate(state, root, num_steps=STEPS, rng=rng)
    ev = DiffusionEvaluator(port, batch_size=WAVE)
    got = ev.evaluate(root, num_steps=STEPS, wave_noise=jax_wave_noise(rng))
    assert isinstance(got, EvalResult) and list(got.as_dict()) == list(want.as_dict())
    for key, w in want.as_dict().items():
        g = got.as_dict()[key]
        assert np.isfinite(w) and np.isfinite(g), key
        np.testing.assert_allclose(g, w, rtol=1e-3 if key == "fgd" else 1e-4, err_msg=key)
    assert set(ev.seconds) == {"generate", "latents", "beats"}
    assert all(v > 0 for v in ev.seconds.values())


def test_seeded_waves_repeat_and_latents_stay_float32(case):
    """Waves drawn from ``(seed, i0)`` repeat with the seed and move with it;
    a bf16 trainer's evaluator takes its latents from a float32 copy of the
    frozen ST-GCN (FGD on the same motion would collapse in bf16)."""
    root, port, sd, feat_sd, _ = case
    ev = DiffusionEvaluator(port, batch_size=WAVE)
    kw = dict(num_steps=2, max_clips=2, compute_beats=False)
    a, b = ev.evaluate(root, **kw), ev.evaluate(root, **kw)
    assert np.isnan(a.beat_consistency_real) and np.isnan(a.beat_consistency_generated)
    assert all(v == b.as_dict()[k] for k, v in a.as_dict().items() if "beat" not in k)
    assert ev.evaluate(root, seed=1, **kw).mse != a.mse
    bf16 = DDPMTrainer(make_cfg("bfloat16"), device="cpu")
    bf16.load_reference_state_dict(sd, motion_encoder=feat_sd)
    ev16 = DiffusionEvaluator(bf16, batch_size=WAVE)
    motion = np.random.RandomState(0).uniform(0, 1, (1, 1800, 13, 2)).astype(np.float32)
    ev16.evaluate(root, num_steps=2, max_clips=1, compute_beats=False)  # loads the ST-GCN
    lat = ev16._latents(motion)
    assert lat.dtype == np.float32 and ev16._feat_model.dtype == torch.float32
    with torch.no_grad():
        want = port.feat_model(torch.from_numpy(motion)).numpy()
    np.testing.assert_allclose(lat, want, rtol=0, atol=1e-6 * np.abs(want).max())

