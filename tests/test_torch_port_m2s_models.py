"""PyTorch port: stage 1's modules in train mode against the flax modules
on the same reference-format weights, float32 on the CPU.

- `models.bn.BatchNorm`: flax's running-statistics rule (momentum 0.99,
  the BIASED batch variance), which torch's own BatchNorm misses by 0.8 %
  at the ST-GCN's ``data_bn`` over B * T = 120 frames; running statistics
  within 1e-5;
- `MusicEncoder` in train mode on both of its paths, "lax" (plain modules)
  and "pallas_train" (NHWC, the kernels' plain versions through their
  autograd Functions), against each other and against the flax module:
  forward, BN statistics and every parameter's gradient, at the bounds of
  tests/test_conv_train.py:183-242 (forward 2e-4, statistics 1e-5, loss
  rtol 1e-5, gradients 0.002 of the largest)
  (tests/test_torch_port_m2snet.py has the ST-GCN and the whole M2SNet).

Gradients and statistics are compared in flax's layout: the port's are put
into a reference-format dict and read by the JAX package's importer.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import as_reference, close_trees, grads, tree

from conductor_tpu.interop.torch_import import import_music_encoder
from conductor_tpu.models.music_encoder import MusicEncoder as FlaxMusicEncoder
from conductor_tpu_torch.interop import synthetic_state_dict
from conductor_tpu_torch.models.bn import BatchNorm
from conductor_tpu_torch.models.music_encoder import MusicEncoder

torch.set_num_threads(2)


@pytest.mark.parametrize("channel_dim", [1, -1])
def test_batchnorm_running_stats_follow_flax(channel_dim):
    rng = np.random.RandomState(0)
    x = rng.normal(1.0, 2.0, size=(2, 26, 60) if channel_dim == 1 else (2, 60, 26)).astype(np.float32)
    bn = BatchNorm(26)
    with torch.no_grad():
        bn.weight.uniform_(0.5, 1.5)
        bn.bias.normal_()
    y = bn(torch.from_numpy(x), channel_dim=channel_dim)
    xf = np.moveaxis(x, 1, -1) if channel_dim == 1 else x
    params = {"scale": jnp.asarray(bn.weight.detach().numpy()),
              "bias": jnp.asarray(bn.bias.detach().numpy())}
    stats = {"mean": jnp.zeros(26), "var": jnp.ones(26)}
    want, mut = fnn.BatchNorm(use_running_average=False).apply(
        {"params": params, "batch_stats": stats}, jnp.asarray(xf), mutable=["batch_stats"])
    got = y.detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1) if channel_dim == 1 else got,
                               np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), mut["batch_stats"]["mean"], atol=1e-5)
    np.testing.assert_allclose(bn.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-5)
    assert int(bn.num_batches_tracked) == 1
    # torch's own rule (unbiased variance) is off by 1 / (B * T - 1) of the
    # variance's update: visible at this size
    ref = torch.nn.BatchNorm1d(26, momentum=0.01)
    ref(torch.from_numpy(x if channel_dim == 1 else np.moveaxis(x, -1, 1).copy()))
    assert not np.allclose(ref.running_var.numpy(), mut["batch_stats"]["var"], atol=1e-5)
    bn.eval()  # eval normalises with the running statistics
    want_eval = fnn.BatchNorm(use_running_average=True).apply(
        {"params": params, "batch_stats": mut["batch_stats"]}, jnp.asarray(xf))
    got = bn(torch.from_numpy(x), channel_dim=channel_dim).detach().numpy()
    np.testing.assert_allclose(np.moveaxis(got, 1, -1) if channel_dim == 1 else got,
                               np.asarray(want_eval), atol=1e-5)


@pytest.fixture(scope="module")
def music_case():
    """Synthetic music-encoder weights, a seeded mel (B = 2, 18 frames) and
    target, and the flax module's train-mode loss, statistics and
    gradients on them."""
    sd = synthetic_state_dict(MusicEncoder(), seed=1)
    rng = np.random.RandomState(7)
    mel = rng.normal(size=(2, 18, 128)).astype(np.float32)
    tgt = rng.normal(size=(2, 6, 64)).astype(np.float32)
    variables = tree(import_music_encoder(sd))
    enc = FlaxMusicEncoder()

    def loss(params):
        y, mut = enc.apply({"params": params, "batch_stats": variables["batch_stats"]},
                           jnp.asarray(mel), True, mutable=["batch_stats"])
        return jnp.mean((y - tgt) ** 2), (y, mut["batch_stats"])

    (value, (y, stats)), dparams = jax.value_and_grad(loss, has_aux=True)(variables["params"])
    return sd, mel, tgt, float(value), np.asarray(y), stats, dparams


def _port_music(sd, conv_impl, mel, tgt):
    enc = MusicEncoder(conv_impl=conv_impl)
    enc.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    enc.train()
    y = enc(torch.from_numpy(mel))
    loss = ((y - torch.from_numpy(tgt)) ** 2).mean()
    loss.backward()
    return enc, float(loss.detach()), y.detach().numpy()


def test_music_encoder_packed_matches_lax(music_case):
    sd, mel, tgt = music_case[:3]
    lax, loss_a, ya = _port_music(sd, "lax", mel, tgt)
    packed, loss_b, yb = _port_music(sd, "pallas_train", mel, tgt)
    np.testing.assert_allclose(yb, ya, atol=2e-4)
    np.testing.assert_allclose(loss_b, loss_a, rtol=1e-5)
    for (k, a), b in zip(lax.state_dict().items(), packed.state_dict().values()):
        if "running" in k:
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5, err_msg=k)
    ga, gb = dict(lax.named_parameters()), dict(packed.named_parameters())
    gmax = max(float(p.grad.abs().max()) for p in ga.values())
    for k, p in ga.items():
        np.testing.assert_allclose(gb[k].grad.numpy(), p.grad.numpy(), atol=0.002 * gmax,
                                   err_msg=k)


@pytest.mark.parametrize("conv_impl", ["lax", "pallas_train"])
def test_music_encoder_train_matches_flax(music_case, conv_impl):
    sd, mel, tgt, loss_want, y_want, stats_want, grads_want = music_case
    enc, loss, y = _port_music(sd, conv_impl, mel, tgt)
    np.testing.assert_allclose(y, y_want, atol=2e-4)
    np.testing.assert_allclose(loss, loss_want, rtol=1e-5)
    close_trees(import_music_encoder(as_reference(enc, enc.state_dict()))["batch_stats"],
                stats_want, atol=1e-5)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads_want))
    close_trees(import_music_encoder(grads(enc))["params"], grads_want, atol=0.002 * gmax)
