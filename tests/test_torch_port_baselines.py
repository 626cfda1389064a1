"""PyTorch port: the Prospective Cup starter models (`prospective.baselines`)
against the flax modules (`conductor_tpu/prospective/baselines.py:19-50`)
on the same weights (the port's synthetic reference-format weights, the
LSTM mapped to flax's cell by `torch_port_flax`): the zero stub, and the
CNN-LSTM in eval mode and in train mode (its music encoder's BatchNorms on
batch statistics, the running ones moved as flax's).  Float32 within 1e-5
of the largest value; B = 2, 1-s and 2-s mel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_port_flax as TF

from conductor_tpu.prospective.baselines import CNNLSTMGenerator as FlaxCNNLSTM
from conductor_tpu.prospective.baselines import PlainGenerator as FlaxPlain
from conductor_tpu_torch.interop import load_reference_state_dict, synthetic_state_dict
from conductor_tpu_torch.models.generator import lstm_plain
from conductor_tpu_torch.prospective import CNNLSTMGenerator, PlainGenerator

torch.set_num_threads(2)


def close(got, want, rel=1e-5):
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    np.testing.assert_allclose(np.asarray(got, np.float32), want,
                               atol=rel * float(np.abs(want).max()))


def _mel(seconds, seed=0):
    return np.random.RandomState(seed).uniform(0, 1, size=(2, 90 * seconds, 128)).astype(
        np.float32)


@pytest.mark.parametrize("seconds", [1, 2])
def test_plain_generator_is_zeros_like_flax(seconds):
    mel = _mel(seconds)
    want = np.asarray(FlaxPlain().apply({}, jnp.asarray(mel)))
    got = PlainGenerator()(torch.from_numpy(mel))
    assert got.shape == want.shape == (2, 30 * seconds, 13, 2)
    assert not got.any() and got.dtype == torch.float32


@pytest.fixture(scope="module")
def cnn_lstm():
    g = CNNLSTMGenerator()
    load_reference_state_dict(g, synthetic_state_dict(g, seed=3))
    return g, TF.cnn_lstm(TF.as_numpy(g.state_dict()))


def test_cnn_lstm_matches_flax_eval(cnn_lstm):
    g, variables = cnn_lstm
    mel = _mel(2, seed=1)
    want = FlaxCNNLSTM().apply(variables, jnp.asarray(mel))
    with torch.no_grad():
        got = g(torch.from_numpy(mel))
        plain = g.fc(lstm_plain(g.lstm, g.music_encoder(torch.from_numpy(mel)))).reshape(got.shape)
    assert got.shape == (2, 60, 13, 2)
    close(got.numpy(), want)
    close(plain.numpy(), want)  # the plain recurrence beside nn.LSTM


def test_cnn_lstm_matches_flax_train(cnn_lstm):
    g, variables = cnn_lstm
    mel = _mel(1, seed=2)
    want, state = FlaxCNNLSTM().apply(variables, jnp.asarray(mel), train=True,
                                      mutable=["batch_stats"])
    before = {k: v.clone() for k, v in g.state_dict().items()}
    try:
        with torch.no_grad():
            got = g(torch.from_numpy(mel), train=True)
        close(got.numpy(), want)
        moved = TF.cnn_lstm(TF.as_numpy(g.state_dict()))["batch_stats"]
        for (path, w), (_, v) in zip(jax.tree_util.tree_leaves_with_path(state["batch_stats"]),
                                     jax.tree_util.tree_leaves_with_path(moved)):
            close(np.asarray(v), w, 1e-5)
    finally:
        g.load_state_dict(before)
