"""The M2SGAN generator and WGAN critic (the stage-1 adversarial baseline).

Port of `conductor_tpu/models/generator.py` with the reference's module
trees and key names (`Contrastive_Stage/models/Generator.py`,
`Discriminator.py`), so its state dicts load strictly
(`interop.load_generator_state_dict`):

- `Generator`: the music encoder (``music_encoder.*``, B, T30, 64) beside a
  noise path, (B, S, 8) one vector a second upsampled x30 by four
  ConvTranspose1d (``noise_convTranspose.{0,2,4,6}``, strides 1, 5, 3, 2,
  ReLU after each) to (B, T30, 64) and ``noise_BN``, concatenated to (B,
  T30, 128) and decoded by `PoseDecoderTCN` (``tcn.TCN.tcn.*``, then
  ``tcn.fc.{0,2,4}``, sigmoid) into (B, T30, 13, 2) poses, or with
  ``decoder_kind="bilstm"`` by `PoseDecoderBiLSTM` (``lstm.*``);
- `PoseDecoderBiLSTM`: two bidirectional LSTM layers of 128 a direction,
  flax's dropout between them (0.5), then Linear-ReLU-Linear-ReLU-Linear
  and a sigmoid; `GeneratorCVPRLSTM`, the CVPR'22 baseline: that decoder
  alone over precomputed 20-d features;
- `Discriminator1DCNN`: three Conv1d(k 5, pad 2) + ReLU + VALID
  MaxPool1d(5, stride 3, 2, 2) over the 26 channels of a frame
  (``motion_encoder.{0,3,6}``), a per-frame MLP to a scalar (``fc.{0,2,4}``),
  the mean over time: (B, T, 13, 2) -> (B, 1).

Each ConvTranspose1d's padding gives exactly L · stride frames with flax's
``padding="SAME"`` alignment (pad (k - 1 - p) a side of the dilated
input: 1, 7, 3, 3 frames); the torch weight (in, out, k) is used as it is
(the JAX import flips its taps).  ``dtype`` rounds where flax's ``dtype=``
does (`models.precision`); the critic of the trainer is float32.

The ``train`` flags follow the flax modules: `Generator.__call__`,
`decode` and `features` put the noise BatchNorm and the decoder's in
train mode (batch statistics, running ones moved) or eval mode; the music
encoder trains only when it is not frozen.

The BiLSTM (`conductor_tpu/models/generator.py:110-156`) runs each
bidirectional layer as a one-layer ``nn.LSTM(bidirectional=True)``
(cuDNN on the card; JAX scans flax's ``OptimizedLSTMCell`` outside any
Pallas kernel), in float32 whatever ``dtype``, as flax's cells, which take
no ``dtype``, promote to their float32 parameters; the head rounds where
flax's ``Dense(dtype=)`` does.  torch's gates (i, f, g, o) are flax's,
and the forward and backward halves of a layer's output come in
``nn.Bidirectional``'s order; flax's cell has a hidden bias and no input
bias, torch both, so a flax cell's weights map to ``bias_ih = 0``.  The
dropout between the layers is `transformer.Dropout` (flax's rule): with
``train`` it drops by ``dropout_keep`` (a mapping from `dropout_sites` to
masks, or a callable ``(site, shape) -> mask``, so that tests hand flax's
masks over) or by masks drawn from ``generator``.  The reference's key
names for this decoder are not in the repository (JAX's `import_generator`
takes only the TCN), so ``lstm.{i}.weight_ih_l0[_reverse]`` ... and
``fc.{0,2,4}`` follow JAX's docstring and are unchecked against a
reference ``.pt``.  `lstm_plain` is a plain float32 recurrence of an
``nn.LSTM`` layer, the version the card's cuDNN LSTM is held against.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bn import BatchNorm
from .music_encoder import MusicEncoder
from .precision import conv, linear
from .tcn import DilatedTCN
from .transformer import Dropout, dropout_sites, keep_mask_source, name_dropout_sites

# (in, out, kernel, stride, padding) of the noise upsampler (`Generator.py:59-64`)
NOISE_UPSAMPLER = ((8, 16, 3, 1, 1), (16, 16, 11, 5, 3), (16, 32, 5, 3, 1), (32, 64, 6, 2, 2))
CRITIC_POOL_STRIDES = (3, 2, 2)


class PoseDecoderTCN(nn.Module):
    """(B, T, 128) -> (B, T, output_size) in (0, 1): the TCN, then
    Linear-ReLU-Linear-ReLU-Linear and a sigmoid (`Generator.py:34-49`)."""

    def __init__(self, output_size: int = 26, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        self.TCN = nn.ModuleDict({"tcn": DilatedTCN(128, 64, n_layers=6, n_channel=64,
                                                    kernel_size=5, dtype=dtype)})
        self.fc = nn.Sequential(nn.Linear(64, 64), nn.ReLU(), nn.Linear(64, 64), nn.ReLU(),
                                nn.Linear(64, output_size), nn.Sigmoid())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        first, _, second, _, third, _ = self.fc
        y = self.TCN["tcn"](x)
        y = torch.relu(linear(second, torch.relu(linear(first, y, self.dtype)), self.dtype))
        return torch.sigmoid(linear(third, y, self.dtype))


class Generator(nn.Module):
    """(mel (B, S*90, 128), noise (B, S, 8)) -> motion (B, S*30, 13, 2)."""

    def __init__(self, n_joints: int = 13, freeze_music_encoder: bool = True,
                 decoder_kind: str = "tcn", dtype: torch.dtype = torch.float32,
                 music_conv_impl: str = "lax"):
        super().__init__()
        if decoder_kind not in ("tcn", "bilstm"):
            raise ValueError(f"decoder_kind is 'tcn' or 'bilstm', got {decoder_kind!r}")
        self.n_joints, self.freeze_music_encoder, self.dtype = n_joints, freeze_music_encoder, dtype
        self.decoder_kind = decoder_kind
        self.music_encoder = MusicEncoder(64, conv_impl=music_conv_impl, dtype=dtype)
        layers = []
        for cin, cout, k, s, p in NOISE_UPSAMPLER:
            layers += [nn.ConvTranspose1d(cin, cout, k, s, p), nn.ReLU()]
        self.noise_convTranspose = nn.Sequential(*layers)
        self.noise_BN = BatchNorm(64)
        if decoder_kind == "tcn":
            self.tcn = PoseDecoderTCN(n_joints * 2, dtype)
        else:
            self.lstm = PoseDecoderBiLSTM(128, n_joints * 2, dtype=dtype)
            name_dropout_sites(self)

    def _mode(self, train: bool) -> None:
        self.train(train)
        self.music_encoder.train(train and not self.freeze_music_encoder)

    def encode_music(self, mel: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The music branch alone, (B, T30, 64); detached when frozen."""
        self._mode(train)
        hx = self.music_encoder(mel)
        return hx.detach() if self.freeze_music_encoder else hx

    def _noise(self, noise: torch.Tensor) -> torch.Tensor:
        h = noise.transpose(1, 2)
        for up in self.noise_convTranspose[::2]:
            if self.dtype == torch.float32:
                h = up(h.float())
            else:
                h = F.conv_transpose1d(h.to(self.dtype), up.weight.to(self.dtype), None,
                                       up.stride, up.padding) + up.bias.to(self.dtype)[:, None]
            h = torch.relu(h)
        return self.noise_BN(h, dtype=self.dtype).transpose(1, 2)  # (B, T30, 64)

    def _hidden(self, hx: torch.Tensor, noise: torch.Tensor) -> torch.Tensor:
        h = self._noise(noise)
        dtype = torch.promote_types(hx.dtype, h.dtype)
        return torch.cat([hx.to(dtype), h.to(dtype)], dim=-1)  # (B, T30, 128)

    def _poses(self, h: torch.Tensor, drop=None) -> torch.Tensor:
        y = self.tcn(h) if self.decoder_kind == "tcn" else self.lstm(h, drop)
        return y.reshape(y.shape[0], y.shape[1], self.n_joints, 2)

    def dropout_sites(self) -> list[str]:
        """The names of the decoder's dropout modules (the BiLSTM's), in the
        order a forward reaches them, e.g. ``lstm.dropout.0``."""
        return dropout_sites(self)

    def decode(self, hx: torch.Tensor, noise: torch.Tensor, train: bool = False, *,
               dropout_keep=None, generator: torch.Generator | None = None) -> torch.Tensor:
        """The noise path and the decoder on precomputed music features
        (B, T30, 64); with ``train`` a BiLSTM decoder drops by
        ``dropout_keep`` or by masks drawn from ``generator``."""
        self._mode(train)
        return self._poses(self._hidden(hx, noise), self._dropper(train, dropout_keep, generator))

    def _dropper(self, train, dropout_keep, generator):
        if self.decoder_kind != "bilstm":
            return None
        return keep_mask_source(self.lstm.p, train, dropout_keep, generator,
                                self.noise_BN.weight.device)

    def features(self, mel: torch.Tensor, noise: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The concatenated conditioning features (B, T30, 128)
        (`Generator.py:79-86`)."""
        hx = self.encode_music(mel, train)
        return self._hidden(hx, noise)

    def forward(self, mel: torch.Tensor, noise: torch.Tensor, train: bool = False, *,
                dropout_keep=None, generator: torch.Generator | None = None) -> torch.Tensor:
        return self._poses(self.features(mel, noise, train),
                           self._dropper(train, dropout_keep, generator))


class Discriminator1DCNN(nn.Module):
    """WGAN critic: motion (B, T, 13, 2) -> (B, 1)."""

    def __init__(self, n_joints: int = 13, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype = dtype
        layers, cin = [], n_joints * 2
        for stride in CRITIC_POOL_STRIDES:
            layers += [nn.Conv1d(cin, 64, 5, padding=2), nn.ReLU(), nn.MaxPool1d(5, stride)]
            cin = 64
        self.motion_encoder = nn.Sequential(*layers)
        self.fc = nn.Sequential(nn.Linear(64, 32), nn.ReLU(), nn.Linear(32, 32), nn.ReLU(),
                                nn.Linear(32, 1))

    def forward(self, motion: torch.Tensor) -> torch.Tensor:
        b, t = motion.shape[0], motion.shape[1]
        x = motion.reshape(b, t, -1).transpose(1, 2)  # (B, 26, T), joint-major
        for i in range(0, len(self.motion_encoder), 3):
            c, _, pool = self.motion_encoder[i:i + 3]
            x = F.max_pool1d(torch.relu(conv(c, x, self.dtype)), pool.kernel_size, pool.stride)
        first, _, second, _, third = self.fc
        h = x.transpose(1, 2)
        h = torch.relu(linear(second, torch.relu(linear(first, h, self.dtype)), self.dtype))
        return linear(third, h, self.dtype).mean(dim=1)


class GeneratorCVPRLSTM(nn.Module):
    """The CVPR'22 VirtualConductor LSTM baseline (`conductor_tpu/models/
    generator.py:141-156`): `PoseDecoderBiLSTM` over precomputed features
    (B, T, ``input_size``, 20 in the reference) -> (B, T, 13, 2); ``noise``
    is taken and ignored, as in JAX, to keep the generator's call."""

    def __init__(self, n_joints: int = 13, input_size: int = 20,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n_joints = n_joints
        self.lstm = PoseDecoderBiLSTM(input_size, n_joints * 2, dtype=dtype)
        name_dropout_sites(self)

    def dropout_sites(self) -> list[str]:
        return dropout_sites(self)

    def forward(self, x: torch.Tensor, noise: torch.Tensor | None = None, train: bool = False, *,
                dropout_keep=None, generator: torch.Generator | None = None) -> torch.Tensor:
        self.train(train)
        y = self.lstm(x, keep_mask_source(self.lstm.p, train, dropout_keep, generator, x.device))
        return y.reshape(y.shape[0], y.shape[1], self.n_joints, 2)


class PoseDecoderBiLSTM(nn.Module):
    """(B, T, input_size) -> (B, T, output_size) in (0, 1): ``num_layers``
    bidirectional LSTM layers of ``hidden`` a direction (``lstm.{i}``),
    flax's dropout between them (``dropout.{i}``), then
    Linear-ReLU-Linear-ReLU-Linear (``fc.{0,2,4}``) and a sigmoid
    (`Generator.py:7-31`)."""

    def __init__(self, input_size: int = 128, output_size: int = 26, hidden: int = 128,
                 num_layers: int = 2, dropout: float = 0.5, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.dtype, self.p = dtype, float(dropout)
        self.lstm = nn.ModuleList(
            nn.LSTM(input_size if i == 0 else 2 * hidden, hidden, batch_first=True,
                    bidirectional=True) for i in range(num_layers))
        self.dropout = nn.ModuleList(Dropout(dropout) for _ in range(num_layers - 1))
        name_dropout_sites(self)
        self.fc = nn.Sequential(nn.Linear(2 * hidden, 64), nn.ReLU(), nn.Linear(64, 64), nn.ReLU(),
                                nn.Linear(64, output_size), nn.Sigmoid())

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        """``drop(site, shape) -> keep mask`` (None: nothing drops)."""
        y = x.float()
        for i, layer in enumerate(self.lstm):
            y = layer(y)[0]
            if i < len(self.dropout):
                y = self.dropout[i](y, drop)
        first, _, second, _, third, _ = self.fc
        y = torch.relu(linear(second, torch.relu(linear(first, y, self.dtype)), self.dtype))
        return torch.sigmoid(linear(third, y, self.dtype))


def lstm_plain(layer: nn.LSTM, x: torch.Tensor) -> torch.Tensor:
    """A one-layer batch-first ``nn.LSTM`` (one or two directions) as a
    plain float32 recurrence over time, from zero states: gates
    ``x W_ih^T + b_ih + h W_hh^T + b_hh`` split (i, f, g, o), ``c = f c +
    i g``, ``h = o tanh(c)``; the backward direction runs from the last
    frame and its outputs stay in time order, concatenated after the
    forward ones."""
    outs = []
    for sfx in ("", "_reverse")[:1 + int(layer.bidirectional)]:
        w_ih, w_hh = getattr(layer, "weight_ih_l0" + sfx), getattr(layer, "weight_hh_l0" + sfx)
        b = getattr(layer, "bias_ih_l0" + sfx) + getattr(layer, "bias_hh_l0" + sfx)
        xw = x.float() @ w_ih.t() + b
        h = c = x.new_zeros((x.shape[0], layer.hidden_size), dtype=torch.float32)
        steps = range(x.shape[1] - 1, -1, -1) if sfx else range(x.shape[1])
        ys = [None] * x.shape[1]
        for t in steps:
            i, f, g, o = (xw[:, t] + h @ w_hh.t()).chunk(4, dim=-1)
            c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
            h = torch.sigmoid(o) * torch.tanh(c)
            ys[t] = h
        outs.append(torch.stack(ys, dim=1))
    return torch.cat(outs, dim=-1)


def gru_plain(layer: nn.GRU, x: torch.Tensor, lengths: torch.Tensor | None = None,
              h0: torch.Tensor | None = None) -> torch.Tensor:
    """A one-layer batch-first ``nn.GRU`` (one or two directions) as a
    plain float32 recurrence over time, returning its last states
    (directions, B, H) as ``nn.GRU``'s ``h_n``: gates ``x W_ih^T + b_ih``
    and ``h W_hh^T + b_hh`` split (r, z, n), ``n = tanh(x_n + r h_n)``,
    ``h = (1 - z) n + z h``, from ``h0`` (zeros if None).  With ``lengths``
    a clip's state stops at its last valid frame and its backward
    direction starts there, as over a packed sequence."""
    B, T = x.shape[:2]
    lengths = torch.full((B,), T) if lengths is None else torch.as_tensor(lengths)
    valid = torch.arange(T, device=x.device) < lengths.to(x.device)[:, None]
    last = []
    for d, sfx in enumerate(("", "_reverse")[:1 + int(layer.bidirectional)]):
        w_ih, w_hh = getattr(layer, "weight_ih_l0" + sfx), getattr(layer, "weight_hh_l0" + sfx)
        b_ih, b_hh = getattr(layer, "bias_ih_l0" + sfx), getattr(layer, "bias_hh_l0" + sfx)
        xw = x.float() @ w_ih.t() + b_ih
        h = (x.new_zeros((B, layer.hidden_size), dtype=torch.float32) if h0 is None
             else h0[d].float())
        for t in (range(T - 1, -1, -1) if sfx else range(T)):
            xr, xz, xn = xw[:, t].chunk(3, dim=-1)
            hr, hz, hn = (h @ w_hh.t() + b_hh).chunk(3, dim=-1)
            r, z = torch.sigmoid(xr + hr), torch.sigmoid(xz + hz)
            h_new = (1 - z) * torch.tanh(xn + r * hn) + z * h
            h = torch.where(valid[:, t, None], h_new, h)
        last.append(h)
    return torch.stack(last)


def bilstm_plain(dec: PoseDecoderBiLSTM, x: torch.Tensor, drop=None) -> torch.Tensor:
    """`PoseDecoderBiLSTM` in float32 with `lstm_plain` in place of each
    ``nn.LSTM``: the version its cuDNN layers are held against."""
    y = x.float()
    for i, layer in enumerate(dec.lstm):
        y = lstm_plain(layer, y)
        if i < len(dec.dropout):
            y = dec.dropout[i](y, drop)
    return dec.fc(y)
