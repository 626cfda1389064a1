"""PyTorch port: its own copies of the JAX package's jax-free pieces.

The port imports nothing of `conductor_tpu`, so it keeps copies of the
config dataclasses (`conductor_tpu_torch/config.py`) and of the weight
synthesis (`conductor_tpu_torch/interop/synth.py`).  These tests hold the
copies to the originals: every dataclass's fields and defaults, the JSON
of a config (equal strings, and each package loads the other's), and
`synth_state_dict`'s arrays bit for bit on the manifests of the committed
fixtures, which were synthesised by the JAX function.
"""

import dataclasses
import os

import numpy as np
import pytest

import conductor_tpu.config as jax_config
import conductor_tpu_torch.config as port_config
from conductor_tpu.interop.synth import manifest_from_json
from conductor_tpu.interop.synth import synth_state_dict as jax_synth
from conductor_tpu_torch.interop import synth_state_dict

FIXTURES = os.path.join(os.path.dirname(__file__), "fixtures")
CLASSES = ("Config", "DatasetSpec", "DenoiserConfig", "DiffusionConfig", "TrainConfig",
           "MeshConfig")


@pytest.mark.parametrize("name", CLASSES)
def test_dataclass_fields_and_defaults_match(name):
    ours, theirs = getattr(port_config, name), getattr(jax_config, name)
    assert ours is not theirs
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(theirs)]
    assert dataclasses.asdict(ours()) == dataclasses.asdict(theirs())


def test_json_is_the_same_string_and_loads_across():
    assert port_config.Config().to_json() == jax_config.Config().to_json()
    changes = dict(denoiser=dict(num_layers=2, compute_dtype="bfloat16"),
                   train=dict(lr=1e-3, feat_impl="pallas"), diffusion=dict(steps=8))
    port = port_config.Config().replace(**{
        k: dataclasses.replace(getattr(port_config.Config(), k), **v) for k, v in changes.items()})
    jax_cfg = jax_config.Config().replace(**{
        k: dataclasses.replace(getattr(jax_config.Config(), k), **v) for k, v in changes.items()})
    assert jax_config.Config.from_json(port.to_json()) == jax_cfg
    assert port_config.Config.from_json(jax_cfg.to_json()) == port
    assert (port_config.Config.faithful().to_json()
            == jax_config.pin_faithful(jax_config.Config()).to_json())


@pytest.mark.parametrize("fixture,key", [("torch_transformer", "manifest"),
                                         ("torch_m2snet", "manifest"),
                                         ("torch_m2sgan", "g_manifest"),
                                         ("torch_m2sgan", "d_manifest")])
def test_synth_state_dict_is_bit_identical(fixture, key):
    manifest = manifest_from_json(bytes(np.load(os.path.join(FIXTURES, f"{fixture}.npz"))[key]))
    for seed in (0, 3):
        got, want = synth_state_dict(manifest, seed=seed), jax_synth(manifest, seed=seed)
        assert got.keys() == want.keys()
        for k, v in want.items():
            assert got[k].dtype == v.dtype, k
            np.testing.assert_array_equal(got[k], v, err_msg=k)


# each knob all "auto", all on the kernels, or all on the plain modules
KNOBS = {
    "auto": dict(attention_impl="auto", layer_impl="auto", train_layer_impl="auto",
                 music_encoder_impl="auto", feat_impl="auto"),
    "kernels": dict(attention_impl="pallas", layer_impl="pallas_fused",
                    train_layer_impl="pallas_fused", music_encoder_impl="pallas",
                    feat_impl="pallas"),
    "plain": dict(attention_impl="xla", layer_impl="flax", train_layer_impl="flax",
                  music_encoder_impl="flax", feat_impl="flax"),
    "mixed": dict(attention_impl="auto", layer_impl="flax", train_layer_impl="auto",
                  music_encoder_impl="pallas", feat_impl="auto"),
}


def _both(module, efficient, dropout, ref_mask, dtype, knobs):
    kw = dict(KNOBS[knobs])
    feat = kw.pop("feat_impl")
    return module.Config(
        denoiser=module.DenoiserConfig(efficient_attention=efficient, dropout=dropout,
                                       compute_dtype=dtype, **kw),
        train=module.TrainConfig(replicate_reference_mask=ref_mask, feat_impl=feat))


@pytest.mark.parametrize("efficient", [True, False])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
@pytest.mark.parametrize("ref_mask", [False, True])
def test_resolve_auto_matches_jax(efficient, dropout, ref_mask):
    """The port's "auto" rule is JAX's, field by field: on CUDA as JAX's on
    the TPU, on the CPU as JAX's on the CPU, over the compute dtypes and
    explicit or "auto" knobs, ``feat_impl`` included (K7 on CUDA at either
    compute dtype, as JAX's kernel on the TPU)."""
    for dtype in ("auto", "float32", "bfloat16"):
        for knobs in KNOBS:
            args = (efficient, dropout, ref_mask, dtype, knobs)
            for device, backend in (("cuda", "tpu"), ("cpu", "cpu")):
                got = dataclasses.asdict(port_config.resolve_auto(_both(port_config, *args), device))
                want = dataclasses.asdict(jax_config.resolve_auto(_both(jax_config, *args), backend))
                assert got == want, (args, device)
