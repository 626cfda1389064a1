"""PyTorch port: the M2SGAN generator and critic (`models.generator`,
`models.tcn`) on the CPU.

- against the reference torch outputs of `torch_m2sgan.npz` (``fake``,
  ``hidden``, ``score`` on its `synth_state_dict` weights), within 1e-5
  of the largest value;
- against the flax modules through `import_generator` /
  `import_discriminator` on the same weights, in float32 (1e-5) and bf16
  (3e-2 of the largest value);
- each of the four noise up-convolutions gives L · stride frames, equal
  to flax's ``ConvTranspose(padding="SAME")`` on the imported kernel;
- the TCN's and the noise BatchNorm's running statistics after one
  train-mode pass against flax's ``batch_stats``.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from test_torch_port_m2s_parity import as_reference, close_trees, tree

from conductor_tpu.interop.torch_import import (
    _convtranspose1d,
    import_discriminator,
    import_generator,
)
from conductor_tpu.models.generator import Discriminator1DCNN as FlaxD
from conductor_tpu.models.generator import Generator as FlaxG
from conductor_tpu_torch.interop import (
    load_discriminator_state_dict,
    load_generator_state_dict,
    synth_state_dict,
)
from conductor_tpu_torch.models.generator import NOISE_UPSAMPLER, Discriminator1DCNN, Generator

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_m2sgan.npz")


@pytest.fixture(scope="module")
def fx():
    return np.load(FIXTURE)


def _manifest(fx, key):
    return {k: tuple(v) for k, v in json.loads(bytes(fx[key]).decode()).items()}


def models(fx, dtype=torch.float32):
    g, d = Generator(dtype=dtype), Discriminator1DCNN(dtype=dtype)
    load_generator_state_dict(g, synth_state_dict(_manifest(fx, "g_manifest"), seed=0))
    load_discriminator_state_dict(d, synth_state_dict(_manifest(fx, "d_manifest"), seed=1))
    return g, d


def flax_vars(g, d):
    """G's and D's variables in flax's layout, copied (the arrays would
    otherwise share the parameters' and statistics' memory)."""
    return tree(jax.tree.map(np.array, (import_generator(as_reference(g, g.state_dict())),
                                        import_discriminator(as_reference(d, d.state_dict())))))


def close(got, want, rel):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               atol=rel * float(np.abs(np.asarray(want, np.float32)).max()))


def test_generator_and_critic_match_the_reference_fixture(fx):
    """The reference state dicts load strictly (the TCN's ``net.*`` keys,
    loaded last, win as in torch) and reproduce the reference outputs."""
    g, d = models(fx)
    mel, noise = torch.from_numpy(fx["mel"]), torch.from_numpy(fx["noise"])
    with torch.no_grad():
        fake = g(mel, noise)
        hidden = g.features(mel, noise)
        score = d(torch.from_numpy(fx["motion"]))
    assert fake.shape == fx["fake"].shape and score.shape == fx["score"].shape
    for got, key in ((fake, "fake"), (hidden, "hidden"), (score, "score")):
        close(got.numpy(), fx[key], 1e-5)


def test_the_tcns_net_keys_load_last_as_in_torch(fx):
    """The reference registers each TemporalBlock's convolutions and
    BatchNorms twice (``conv1`` ... and ``net.{0,2,5,7}``); torch loads
    ``net.*`` last, and `synth_state_dict` draws the two apart.  The port,
    loading as torch does, meets the fixture within 1e-5; JAX's
    `import_generator`, which reads ``conv1`` / ``bn1`` (ROADMAP F10),
    lands more than 1e-4 of the largest value from it."""
    sd = synth_state_dict(_manifest(fx, "g_manifest"), seed=0)
    key = "tcn.TCN.tcn.tcn.network.0"
    assert not np.array_equal(sd[f"{key}.conv1.weight_v"], sd[f"{key}.net.0.weight_v"])
    g, _ = models(fx)
    assert torch.equal(g.tcn.TCN["tcn"].tcn["network"][0].conv1.weight_v,
                       torch.from_numpy(sd[f"{key}.net.0.weight_v"]))
    G = FlaxG()
    want = jax.jit(lambda m, z: G.apply(tree(import_generator(sd)), m, z))(
        jnp.asarray(fx["mel"]), jnp.asarray(fx["noise"]))
    scale = float(np.abs(fx["fake"]).max())
    assert float(np.abs(np.asarray(want) - fx["fake"]).max()) > 1e-4 * scale


@pytest.mark.parametrize("dtype,rel", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_generator_and_critic_match_flax(fx, dtype, rel):
    g, d = models(fx, dtype)
    g_vars, d_vars = flax_vars(g, d)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    G, D = FlaxG(dtype=jdt), FlaxD(dtype=jdt)
    mel, noise, motion = fx["mel"][:, :540], fx["noise"][:, :6], fx["motion"]
    want_fake, want_hidden = jax.jit(lambda m, z: (G.apply(g_vars, m, z),
                                                   G.apply(g_vars, m, z, method=G.features)))(
        jnp.asarray(mel), jnp.asarray(noise))
    want_score = jax.jit(lambda x: D.apply(d_vars, x))(jnp.asarray(motion))
    with torch.no_grad():
        fake = g(torch.from_numpy(mel), torch.from_numpy(noise))
        hidden = g.features(torch.from_numpy(mel), torch.from_numpy(noise))
        score = d(torch.from_numpy(motion))
    assert fake.dtype == dtype and score.dtype == dtype
    close(fake.float().numpy(), want_fake, rel)
    close(hidden.float().numpy(), want_hidden, rel)
    close(score.float().numpy(), want_score, rel)


@pytest.mark.parametrize("config", NOISE_UPSAMPLER, ids=lambda c: f"k{c[2]}s{c[3]}")
def test_noise_upconvolution_is_flax_same(config):
    """torch ConvTranspose1d with the port's padding, on the torch weight as
    it is, against flax's SAME ConvTranspose on the imported (flipped)
    kernel: L · stride frames, equal within float32 rounding."""
    cin, cout, k, s, p = config
    up = torch.nn.ConvTranspose1d(cin, cout, k, s, p)
    x = np.random.RandomState(k).normal(size=(2, 10, cin)).astype(np.float32)
    with torch.no_grad():
        got = up(torch.from_numpy(x).transpose(1, 2)).transpose(1, 2).numpy()
    assert got.shape == (2, 10 * s, cout)
    params = _convtranspose1d({"u.weight": up.weight.detach().numpy(),
                               "u.bias": up.bias.detach().numpy()}, "u")
    want = fnn.ConvTranspose(cout, (k,), strides=(s,), padding="SAME").apply(
        {"params": tree(params)}, jnp.asarray(x))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)


def test_train_mode_batch_statistics_match_flax(fx):
    """One train-mode pass moves the TCN's and the noise BatchNorm's running
    statistics (flax's rule: momentum 0.99, biased variance) as flax's
    ``mutable=["batch_stats"]`` does; the music encoder, frozen, keeps its
    own."""
    g, _ = models(fx)
    g_vars, _ = flax_vars(g, Discriminator1DCNN())
    stats0 = jax.device_get(g_vars["batch_stats"])
    mel, noise = fx["mel"][:, :540], fx["noise"][:, :6]
    G = FlaxG()
    _, mut = jax.jit(lambda m, z: G.apply(g_vars, m, z, True, mutable=["batch_stats"]))(
        jnp.asarray(mel), jnp.asarray(noise))
    with torch.no_grad():
        g(torch.from_numpy(mel), torch.from_numpy(noise), train=True)
    got = import_generator(as_reference(g, g.state_dict()))["batch_stats"]
    close_trees(got, jax.device_get(mut["batch_stats"]), atol=1e-5)
    close_trees(got["music_encoder"], stats0["music_encoder"], atol=0)
    assert not np.allclose(got["noise_bn"]["mean"], stats0["noise_bn"]["mean"])
