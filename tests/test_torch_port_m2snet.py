"""PyTorch port: the stage-1 ST-GCN in train mode and the whole M2SNet,
against the flax modules on the same reference-format weights, float32 on
the CPU.

- `MotionEncoderSTGCN` in train mode (stage 1 trains it, plain, as the
  JAX package does) at B * T = 120 frames: forward, running statistics
  within 1e-5 and `jax.grad` of every parameter;
- `M2SNet` in eval mode against the reference activations of
  `torch_m2snet.npz` (``hx``, ``hy``, ``out``, at the bounds of
  tests/test_torch_import.py) on `synth_state_dict` weights, and against
  the flax `M2SNet`; its `features` stacks end in the same latents.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import torch
from test_torch_port_m2s_parity import as_reference, close_trees, grads, tree

from conductor_tpu.interop.synth import manifest_from_json
from conductor_tpu.interop.torch_import import import_m2snet, import_motion_encoder
from conductor_tpu.models.m2snet import M2SNet as FlaxM2SNet
from conductor_tpu.models.stgcn import MotionEncoderSTGCN as FlaxMotionEncoder
from conductor_tpu_torch.interop import (
    load_m2snet_state_dict,
    synth_state_dict,
    synthetic_motion_encoder_state_dict,
)
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_m2snet.npz")


def test_stgcn_train_matches_flax():
    model = MotionEncoderSTGCN()
    sd = synthetic_motion_encoder_state_dict(model, seed=2)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in sd.items()})
    rng = np.random.RandomState(3)
    motion = rng.uniform(0, 1, size=(2, 60, 13, 2)).astype(np.float32)
    w = rng.normal(size=(2, 60, 64)).astype(np.float32)
    variables = tree(import_motion_encoder(sd))
    flax_model = FlaxMotionEncoder()

    def loss(params):
        y, mut = flax_model.apply({"params": params, "batch_stats": variables["batch_stats"]},
                                  jnp.asarray(motion), True, mutable=["batch_stats"])
        return (y * w).sum(), (y, mut["batch_stats"])

    (_, (y_want, stats_want)), grads_want = jax.value_and_grad(loss, has_aux=True)(
        variables["params"])
    model.train()
    y = model(torch.from_numpy(motion))
    (y * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(y_want), atol=1e-4)
    close_trees(import_motion_encoder(as_reference(model, model.state_dict()))["batch_stats"],
                stats_want, atol=1e-5)
    gmax = max(float(np.abs(np.asarray(g)).max()) for g in jax.tree.leaves(grads_want))
    close_trees(import_motion_encoder(grads(model))["params"], grads_want, atol=1e-4 * gmax)


def test_m2snet_eval_matches_reference_and_flax():
    fx = np.load(FIXTURE)
    sd = synth_state_dict(manifest_from_json(bytes(fx["manifest"]).decode()), seed=0)
    model = M2SNet()
    load_m2snet_state_dict(model, sd)
    model.eval()
    mel, motion = torch.from_numpy(fx["mel"]), torch.from_numpy(fx["motion"])
    with torch.no_grad():
        hx, hy = model.encode(mel, motion)
        out = model(mel, motion)
    np.testing.assert_allclose(hx.numpy(), fx["hx"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(hy.numpy(), fx["hy"], atol=2e-4, rtol=1e-3)
    np.testing.assert_allclose(out.numpy(), fx["out"], atol=1e-5, rtol=1e-4)
    want = FlaxM2SNet().apply(tree(import_m2snet(sd)), jnp.asarray(fx["mel"]),
                              jnp.asarray(fx["motion"]))
    np.testing.assert_allclose(out.numpy(), np.asarray(want), atol=1e-5)
    # the feature stacks end in the same latents (their maps are held
    # against flax in tests/test_torch_port_gan_losses.py)
    with torch.no_grad():
        music_feats, motion_feats = model.features(mel, motion)
    assert (len(music_feats), len(motion_feats)) == (5, 12)
    np.testing.assert_array_equal(music_feats[-1].numpy(), hx.numpy())
    np.testing.assert_array_equal(motion_feats[-1].numpy(), hy.numpy())
