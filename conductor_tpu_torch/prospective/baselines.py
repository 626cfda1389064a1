"""The Prospective Cup starter models, with the kit's contract
``generator(mel (B, 90*s, 128)) -> motion (B, 30*s, 13, 2)``.

Port of `conductor_tpu/prospective/baselines.py:19-50` (the reference kit
ships a constant stub, `ProspectiveCup/models/plain_model.py:5-20`, and
reports a CNN-LSTM baseline in its README, `ProspectiveCup/README.md:
88-94`, without its source):

- `PlainGenerator`: zeros (SDP 0 %);
- `CNNLSTMGenerator`: the shared `MusicEncoder` front end (90 Hz mel ->
  30 Hz 64-d tokens, "lax": the plain convolutions, as JAX's, in train
  mode on batch statistics) feeding a one-direction LSTM of 128
  (``lstm``, float32, cuDNN on the card), Linear-ReLU-Linear and a sigmoid
  pose head (``fc.{0,2}``).  Neither has reference weights; the key names
  are the port's.
"""

from __future__ import annotations

import torch
from torch import nn

from ..models.music_encoder import MusicEncoder


class PlainGenerator(nn.Module):
    """The constant stub (`plain_model.py:5-20`): zero motion."""

    def __init__(self, n_joints: int = 13, joint_dim: int = 2):
        super().__init__()
        self.n_joints, self.joint_dim = n_joints, joint_dim

    def forward(self, mel: torch.Tensor, train: bool = False) -> torch.Tensor:
        b, t90 = mel.shape[0], mel.shape[1]
        return mel.new_zeros((b, t90 // 3, self.n_joints, self.joint_dim))


class CNNLSTMGenerator(nn.Module):
    """The README's CNN-LSTM baseline: mel -> `MusicEncoder` -> LSTM ->
    Linear-ReLU-Linear-sigmoid -> (B, T30, 13, 2)."""

    def __init__(self, n_joints: int = 13, joint_dim: int = 2, hidden: int = 128):
        super().__init__()
        self.n_joints, self.joint_dim = n_joints, joint_dim
        self.music_encoder = MusicEncoder(64)
        self.lstm = nn.LSTM(64, hidden, batch_first=True)
        self.fc = nn.Sequential(nn.Linear(hidden, hidden), nn.ReLU(),
                                nn.Linear(hidden, n_joints * joint_dim), nn.Sigmoid())

    def forward(self, mel: torch.Tensor, train: bool = False) -> torch.Tensor:
        """With ``train`` the encoder's BatchNorms normalise by the batch
        and move their running statistics (flax's rule)."""
        self.train(train)
        b, t90 = mel.shape[0], mel.shape[1]
        feats = self.music_encoder(mel.float())  # (B, T30, 64)
        pose = self.fc(self.lstm(feats)[0])
        return pose.reshape(b, t90 // 3, self.n_joints, self.joint_dim)
