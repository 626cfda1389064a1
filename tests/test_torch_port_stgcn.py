"""PyTorch port: the frozen ST-GCN motion encoder of the perceptual loss,
against the flax module on the same reference-format weights, against the
reference torch activations recorded in `torch_m2snet.npz`, and its
d(input) against `jax.grad` of the flax module."""

import copy
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


def _ae():
    from conductor_tpu_torch.interop import manifest, synth_state_dict
    from conductor_tpu_torch.interop.weights import _see_the_motion
    from conductor_tpu_torch.models.stgcn import STGCN

    net = STGCN(mode="AE")
    # under the ``st_gcn.`` prefix of a motion encoder's keys: the synthesis
    # gives ``st_gcn.A`` the true adjacency, and the adjustment moves BN
    # scales and edge importances near 1, so that the input reaches the
    # output through the eight blocks
    sd = synth_state_dict({f"st_gcn.{k}": v for k, v in manifest(net).items()}, seed=4)
    sd = _see_the_motion(sd, "st_gcn.")
    net.load_state_dict({k.removeprefix("st_gcn."): torch.from_numpy(np.array(v))
                         for k, v in sd.items()}, strict=True)
    return net


def test_ae_mode_blocks_and_keys():
    """The "AE" mode: eight blocks of 16, temporal strides 3 and 2; where
    the stride changes, a strided 1x1 conv and BN residual under the
    reference's ``residual.{0,1}`` (blocks 2 and 5), the identity
    elsewhere but block 0, which has none."""
    net = _ae()
    assert [b.res_mode for b in net.st_gcn_networks] == (
        ["none", "identity", "conv", "identity", "identity", "conv", "identity", "identity"])
    keys = net.state_dict().keys()
    assert "st_gcn_networks.2.residual.0.weight" in keys
    assert "st_gcn_networks.5.residual.1.running_var" in keys
    assert not any(k.startswith("st_gcn_networks.1.residual") for k in keys)
    with pytest.raises(ValueError, match="mode"):
        type(net)(mode="bogus")


@pytest.mark.parametrize("t", [30, 31])
def test_ae_mode_matches_flax_eval_and_train(t):
    """Against flax `STGCN(mode="AE")` on the same weights (JAX's
    `import_motion_encoder` on the port's keys): eval mode, and train mode
    (batch statistics, the running ones moved as flax's); T = 30 and a
    ragged 31 (strided to 5 / 6 frames).  Float32 within 1e-5 of the
    largest value (train mode: of the float64 forward, and 2e-5 of
    flax's)."""
    import torch_port_flax as TF

    from conductor_tpu.models.stgcn import STGCN as FlaxSTGCN

    net = _ae()
    variables = TF.stgcn(TF.as_numpy(net.state_dict()))
    motion = np.random.RandomState(t).uniform(0, 1, size=(2, t, 13, 2)).astype(np.float32)
    flax_net = FlaxSTGCN(mode="AE")
    want = np.asarray(flax_net.apply(variables, jnp.asarray(motion)))
    net.eval()
    with torch.no_grad():
        got = net(torch.from_numpy(motion)).permute(0, 2, 3, 1).numpy()  # (B, T', V, C)
    assert got.shape == want.shape == (2, -(-t // 6), 13, 16)
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())
    want_t, state = flax_net.apply(variables, jnp.asarray(motion), train=True,
                                   mutable=["batch_stats"])
    exact = copy.deepcopy(net).double().train()
    net.train()
    with torch.no_grad():
        got_t = net(torch.from_numpy(motion)).permute(0, 2, 3, 1).numpy()
        ref = exact(torch.from_numpy(motion).double(), dtype=torch.float64).permute(0, 2, 3, 1)
    # train mode through eight BatchNorms on batch statistics: the port
    # within 1e-5 of the float64 forward (measured 6.6e-7 at T = 31), and
    # within 2e-5 of flax's, whose one-pass variance puts it 1.6e-5 of the
    # largest value from float64 at T = 31
    scale = np.abs(ref.numpy()).max()
    np.testing.assert_allclose(got_t, ref.numpy(), atol=1e-5 * scale)
    np.testing.assert_allclose(got_t, np.asarray(want_t), atol=2e-5 * scale)
    moved = TF.stgcn(TF.as_numpy(net.state_dict()))["batch_stats"]
    for (path, w), (_, v) in zip(jax.tree_util.tree_leaves_with_path(state["batch_stats"]),
                                 jax.tree_util.tree_leaves_with_path(moved)):
        np.testing.assert_allclose(v, np.asarray(w), rtol=1e-5, atol=1e-6,
                                   err_msg=jax.tree_util.keystr(path))
