"""The M2SGAN generator and WGAN critic (the stage-1 adversarial baseline).

Port of `conductor_tpu/models/generator.py:25-107, 159-175` with the
reference's module trees and key names (`Contrastive_Stage/models/
Generator.py`, `Discriminator.py`), so its state dicts load strictly
(`interop.load_generator_state_dict`):

- `Generator`: the music encoder (``music_encoder.*``, B, T30, 64) beside a
  noise path, (B, S, 8) one vector a second upsampled x30 by four
  ConvTranspose1d (``noise_convTranspose.{0,2,4,6}``, strides 1, 5, 3, 2,
  ReLU after each) to (B, T30, 64) and ``noise_BN``, concatenated to (B,
  T30, 128) and decoded by `PoseDecoderTCN` (``tcn.TCN.tcn.*``, then
  ``tcn.fc.{0,2,4}``, sigmoid) into (B, T30, 13, 2) poses;
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
encoder trains only when it is not frozen.  ``decoder_kind="bilstm"`` and
`GeneratorCVPRLSTM` raise NotImplementedError (ROADMAP G).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from .bn import BatchNorm
from .music_encoder import MusicEncoder
from .precision import conv, linear
from .tcn import DilatedTCN

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
        if decoder_kind == "bilstm":
            raise NotImplementedError("the BiLSTM decoder is not ported yet (ROADMAP G)")
        if decoder_kind != "tcn":
            raise ValueError(f"decoder_kind is 'tcn' or 'bilstm', got {decoder_kind!r}")
        self.n_joints, self.freeze_music_encoder, self.dtype = n_joints, freeze_music_encoder, dtype
        self.music_encoder = MusicEncoder(64, conv_impl=music_conv_impl, dtype=dtype)
        layers = []
        for cin, cout, k, s, p in NOISE_UPSAMPLER:
            layers += [nn.ConvTranspose1d(cin, cout, k, s, p), nn.ReLU()]
        self.noise_convTranspose = nn.Sequential(*layers)
        self.noise_BN = BatchNorm(64)
        self.tcn = PoseDecoderTCN(n_joints * 2, dtype)

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

    def _poses(self, h: torch.Tensor) -> torch.Tensor:
        y = self.tcn(h)
        return y.reshape(y.shape[0], y.shape[1], self.n_joints, 2)

    def decode(self, hx: torch.Tensor, noise: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The noise path and the decoder on precomputed music features
        (B, T30, 64)."""
        self._mode(train)
        return self._poses(self._hidden(hx, noise))

    def features(self, mel: torch.Tensor, noise: torch.Tensor, train: bool = False) -> torch.Tensor:
        """The concatenated conditioning features (B, T30, 128)
        (`Generator.py:79-86`)."""
        hx = self.encode_music(mel, train)
        return self._hidden(hx, noise)

    def forward(self, mel: torch.Tensor, noise: torch.Tensor, train: bool = False) -> torch.Tensor:
        return self._poses(self.features(mel, noise, train))


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
    """The CVPR'22 BiLSTM baseline (`conductor_tpu/models/generator.py:141`):
    not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("GeneratorCVPRLSTM is not ported yet (ROADMAP G)")
