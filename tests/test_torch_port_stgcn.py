"""PyTorch port: the frozen ST-GCN motion encoder of the perceptual loss,
against the flax module on the same reference-format weights, against the
reference torch activations recorded in `torch_m2snet.npz`, and its
d(input) against `jax.grad` of the flax module."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop.synth import manifest_from_json, synth_state_dict
from conductor_tpu.interop.torch_import import import_motion_encoder, motion_encoder_from_m2snet
from conductor_tpu.models.graph import build_adjacency as jax_build_adjacency
from conductor_tpu.models.stgcn import MotionEncoderSTGCN as FlaxMotionEncoder
from conductor_tpu_torch.interop import load_motion_encoder_state_dict, synthetic_state_dict
from conductor_tpu_torch.models.graph import build_adjacency
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN

torch.set_num_threads(2)

FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures", "torch_m2snet.npz")


@pytest.fixture(scope="module")
def m2snet():
    fx = np.load(FIXTURE)
    sd = synth_state_dict(manifest_from_json(bytes(fx["manifest"]).decode()), seed=0)
    return fx, sd


def _port(sd):
    model = MotionEncoderSTGCN()
    load_motion_encoder_state_dict(model, sd)
    return model.freeze()


@pytest.mark.parametrize("layout,strategy", [("ConductorMotionX", "uniform"),
                                             ("ConductorMotionX", "spatial"),
                                             ("openpose", "distance")])
def test_graph_copy_matches_jax(layout, strategy):
    np.testing.assert_array_equal(build_adjacency(layout, strategy),
                                  jax_build_adjacency(layout, strategy))


def test_matches_reference_activations(m2snet):
    """`hy` of the reference MotionEncoder_STGCN, at the bounds of
    tests/test_torch_import.py (atol 2e-4, rtol 1e-3)."""
    fx, sd = m2snet
    with torch.no_grad():
        hy = _port(sd)(torch.from_numpy(fx["motion"]))
    np.testing.assert_allclose(hy.numpy(), fx["hy"], atol=2e-4, rtol=1e-3)


def test_matches_flax_and_input_gradient(m2snet):
    """Forward within atol 1e-5 of the flax module on the same weights, and
    d(input) of a weighted sum within 1e-5 of `jax.grad` (relative to the
    gradient's scale)."""
    fx, sd = m2snet
    variables = jax.tree.map(jnp.asarray, motion_encoder_from_m2snet(sd))
    flax_model = FlaxMotionEncoder()
    rng = np.random.RandomState(0)
    motion = rng.uniform(0, 1, size=(2, 37, 13, 2)).astype(np.float32)
    w = rng.normal(size=(2, 37, 64)).astype(np.float32)

    def loss(m):
        return (flax_model.apply(variables, m) * w).sum()

    want = flax_model.apply(variables, jnp.asarray(motion))
    want_grad = jax.grad(loss)(jnp.asarray(motion))

    model = _port(sd)
    x = torch.from_numpy(motion).requires_grad_(True)
    got = model(x)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5)
    (got * torch.from_numpy(w)).sum().backward()
    scale = float(np.abs(np.asarray(want_grad)).max())
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(want_grad), atol=1e-5 * max(scale, 1.0))
    assert all(p.grad is None for p in model.parameters())


def test_frozen_and_strict(m2snet):
    """Frozen: eval BatchNorm and no parameter takes a gradient; a bare
    subtree loads like the M2SNet dict, and a missing key or a foreign
    adjacency raises."""
    _, sd = m2snet
    model = _port(sd)
    assert not model.training and not any(p.requires_grad for p in model.parameters())
    bare = {k[len("motion_encoder."):]: v for k, v in sd.items() if k.startswith("motion_encoder.")}
    other = MotionEncoderSTGCN()
    load_motion_encoder_state_dict(other, bare)
    for (k, a), b in zip(model.state_dict().items(), other.state_dict().values()):
        assert torch.equal(a, b), k
    with pytest.raises(RuntimeError):
        load_motion_encoder_state_dict(other, {k: v for k, v in bare.items() if k != "fc.0.bias"})
    with pytest.raises(ValueError, match="adjacency"):
        load_motion_encoder_state_dict(other, dict(bare, **{"st_gcn.A": bare["st_gcn.A"] * 2}))
    # synthetic weights keep the module's own graph and load into flax too
    synth = synthetic_state_dict(other, seed=1)
    np.testing.assert_array_equal(synth["st_gcn.A"], build_adjacency())
    import_motion_encoder(synth)
