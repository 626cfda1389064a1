"""PyTorch port: the M2SGAN BiLSTM decoders (`models.generator`:
`PoseDecoderBiLSTM`, `GeneratorCVPRLSTM`, `Generator(decoder_kind=
"bilstm")`) against the flax modules (`conductor_tpu/models/generator.py:
110-156`) on the same weights (the port's synthetic reference-format
weights, mapped to flax's cells by `torch_port_flax`), in eval mode and in
train mode with flax's dropout masks handed over (read off its Dropout
output, which is zero exactly where it dropped).  Float32 within 1e-5 of
the largest value.  Sizes: B = 2, 1 s (T30 = 30) for the generator, T = 24
for the decoders; the LSTMs at their published width (128 a direction)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_flax as TF
from flax import linen as fnn

from conductor_tpu.models.generator import Generator as FlaxG
from conductor_tpu.models.generator import GeneratorCVPRLSTM as FlaxCVPR
from conductor_tpu.models.generator import PoseDecoderBiLSTM as FlaxDecoder
from conductor_tpu_torch.interop import (
    load_reference_state_dict,
    synthetic_generator_state_dict,
    synthetic_state_dict,
)
from conductor_tpu_torch.models.generator import (
    Generator,
    GeneratorCVPRLSTM,
    PoseDecoderBiLSTM,
    bilstm_plain,
    lstm_plain,
)

torch.set_num_threads(2)


def close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * float(np.abs(want).max()))


def flax_train(module, variables, *args, seed=0):
    """flax's train-mode output, its updated statistics (if any) and the
    keep masks of its Dropout modules (by module path)."""
    out, state = module.apply(
        variables, *args, train=True, rngs={"dropout": jax.random.PRNGKey(seed)},
        mutable=["batch_stats", "intermediates"],
        capture_intermediates=lambda mdl, _: isinstance(mdl, fnn.Dropout))
    drops = jax.tree_util.tree_leaves_with_path(state["intermediates"])
    masks = [np.asarray(v) != 0 for _, v in drops]
    return np.asarray(out), state.get("batch_stats"), masks


def _x(shape, seed=1):
    return np.random.RandomState(seed).normal(size=shape).astype(np.float32)


def _module(make, seed=0, generator=False):
    m = make()
    sd = (synthetic_generator_state_dict if generator else synthetic_state_dict)(m, seed=seed)
    load_reference_state_dict(m, sd)
    return m, TF.as_numpy(m.state_dict())


def test_decoder_matches_flax_eval_and_train():
    dec, sd = _module(lambda: PoseDecoderBiLSTM(128, 26))
    params = {"params": TF.bilstm_decoder(sd)}
    x = _x((2, 24, 128))
    want = FlaxDecoder(26).apply(params, jnp.asarray(x))
    with torch.no_grad():
        close(dec(torch.from_numpy(x)).numpy(), want)
        # the plain recurrence the card's cuDNN LSTM is held against
        close(bilstm_plain(dec, torch.from_numpy(x)).numpy(), want)
    want_t, _, masks = flax_train(FlaxDecoder(26), params, jnp.asarray(x))
    assert len(masks) == 1 and 0.3 < masks[0].mean() < 0.7  # rate 0.5
    with torch.no_grad():
        got = dec(torch.from_numpy(x), lambda site, shape: torch.from_numpy(masks[0]))
    close(got.numpy(), want_t)
    assert float(np.abs(want_t - np.asarray(want)).max()) > 1e-3  # the masks did drop


def test_lstm_gates_and_direction_order():
    """torch's gate rows (i, f, g, o) and output halves (forward, then the
    backward direction in time order) against `lstm_plain`, which writes
    them out, and against flax's cells on one bidirectional layer."""
    layer = torch.nn.LSTM(20, 16, batch_first=True, bidirectional=True)
    x = torch.from_numpy(_x((3, 7, 20), seed=4))
    with torch.no_grad():
        np.testing.assert_allclose(layer(x)[0].numpy(), lstm_plain(layer, x).numpy(), atol=1e-6)
    sd = {f"lstm.0.{k}": v for k, v in TF.as_numpy(layer.state_dict()).items()}
    bidir = fnn.Bidirectional(fnn.RNN(fnn.OptimizedLSTMCell(16)),
                              fnn.RNN(fnn.OptimizedLSTMCell(16)))
    cells = TF.bilstm_decoder(sd | {f"fc.{i}.{p}": np.zeros((1, 1), np.float32)
                                    for i in (0, 2, 4) for p in ("weight", "bias")}, num_layers=1)
    want = bidir.apply({"params": {"forward_rnn": {"cell": cells["OptimizedLSTMCell_0"]},
                                   "backward_rnn": {"cell": cells["OptimizedLSTMCell_1"]}}},
                       jnp.asarray(x.numpy()))
    with torch.no_grad():
        close(layer(x)[0].numpy(), want)


def test_cvpr_lstm_matches_flax_eval_and_train():
    g, sd = _module(GeneratorCVPRLSTM)
    variables = TF.cvpr_lstm(sd)
    x = _x((2, 24, 20), seed=2)
    want = FlaxCVPR().apply(variables, jnp.asarray(x))
    with torch.no_grad():
        got = g(torch.from_numpy(x))
    assert got.shape == (2, 24, 13, 2)
    close(got.numpy(), want)
    want_t, _, masks = flax_train(FlaxCVPR(), variables, jnp.asarray(x), None, seed=3)
    assert g.dropout_sites() == ["lstm.dropout.0"]
    with torch.no_grad():
        got = g(torch.from_numpy(x), train=True,
                dropout_keep={"lstm.dropout.0": torch.from_numpy(masks[0])})
    close(got.numpy(), want_t)


def test_generator_bilstm_end_to_end():
    """`Generator(decoder_kind="bilstm")`: mel and noise to poses against
    flax's, in eval mode and in train mode (the noise path's BatchNorm on
    batch statistics, the running ones moved as flax's, flax's dropout
    masks); its own draws drop about half."""
    g, sd = _module(lambda: Generator(decoder_kind="bilstm"), generator=True)
    assert not hasattr(g, "tcn") and g.dropout_sites() == ["lstm.dropout.0"]
    variables = TF.generator_bilstm(sd)
    rng = np.random.RandomState(5)
    mel = rng.uniform(0, 1, size=(2, 90, 128)).astype(np.float32)
    noise = rng.normal(size=(2, 1, 8)).astype(np.float32)
    G = FlaxG(decoder_kind="bilstm")
    want = G.apply(variables, jnp.asarray(mel), jnp.asarray(noise))
    with torch.no_grad():
        got = g(torch.from_numpy(mel), torch.from_numpy(noise))
    assert got.shape == (2, 30, 13, 2)
    close(got.numpy(), want)
    want_t, stats, masks = flax_train(G, variables, jnp.asarray(mel), jnp.asarray(noise), seed=6)
    with torch.no_grad():
        got = g(torch.from_numpy(mel), torch.from_numpy(noise), train=True,
                dropout_keep={"lstm.dropout.0": torch.from_numpy(masks[0])})
    close(got.numpy(), want_t)
    close(g.noise_BN.running_mean.numpy(), stats["noise_bn"]["mean"])
    close(g.noise_BN.running_var.numpy(), stats["noise_bn"]["var"])
    with torch.no_grad():
        drawn = g(torch.from_numpy(mel), torch.from_numpy(noise), train=True,
                  generator=torch.Generator().manual_seed(0))
    assert bool(torch.isfinite(drawn).all()) and not torch.equal(drawn, got)


def test_decoder_kind_is_checked():
    with pytest.raises(ValueError, match="decoder_kind"):
        Generator(decoder_kind="gru")
