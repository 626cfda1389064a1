"""M2SNet: the stage-1 music-motion synchronization network.

Port of `conductor_tpu/models/m2snet.py:17-55`: the music encoder and the
ST-GCN motion encoder, fused by pointwise layers into a per-frame sync
probability.  The fusion head keeps the reference's Conv1d form and keys
(`fuse_layer.{0,2,4}`: Conv1d(128 -> 64, 1), ReLU, Conv1d(64 -> 64, 1),
ReLU, Conv1d(64 -> 1, 1), Sigmoid), so a reference M2SNet state dict loads
strictly (`interop.load_m2snet_state_dict`).  ``compute_dtype`` rounds the
three parts where the flax modules' ``dtype=`` does (`models.precision`).
"""

from __future__ import annotations

import torch
from torch import nn

from .music_encoder import MusicEncoder
from .precision import conv
from .stgcn import MotionEncoderSTGCN


class M2SNet(nn.Module):
    """(mel (B, T90, 128), motion (B, T30, 13, 2)) -> sync prob (B, T30, 1)."""

    def __init__(self, latent_dim: int = 64, music_conv_impl: str = "lax",
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.music_encoder = MusicEncoder(latent_dim, conv_impl=music_conv_impl,
                                          dtype=compute_dtype)
        self.dtype = compute_dtype
        self.motion_encoder = MotionEncoderSTGCN(latent_dim, dtype=compute_dtype)
        self.fuse_layer = nn.Sequential(
            nn.Conv1d(2 * latent_dim, latent_dim, 1), nn.ReLU(),
            nn.Conv1d(latent_dim, latent_dim, 1), nn.ReLU(),
            nn.Conv1d(latent_dim, 1, 1), nn.Sigmoid(),
        )

    def encode(self, mel: torch.Tensor, motion: torch.Tensor):
        """Both latent streams, (B, T30, 64) each."""
        return self.music_encoder(mel), self.motion_encoder(motion)

    def fuse(self, hx: torch.Tensor, hy: torch.Tensor) -> torch.Tensor:
        """Sync probability (B, T30, 1) from the two latents."""
        first, _, second, _, third, _ = self.fuse_layer
        h = torch.cat([hx, hy], dim=-1).transpose(1, 2)
        h = torch.relu(conv(second, torch.relu(conv(first, h, self.dtype)), self.dtype))
        return torch.sigmoid(conv(third, h, self.dtype)).transpose(1, 2)

    def forward(self, mel: torch.Tensor, motion: torch.Tensor) -> torch.Tensor:
        return self.fuse(*self.encode(mel, motion))

    def features(self, mel: torch.Tensor, motion: torch.Tensor):
        """Every intermediate map of both encoders (`M2SNet.py:38-41`):
        (`MusicEncoder.features`, `MotionEncoderSTGCN.features`)."""
        return self.music_encoder.features(mel), self.motion_encoder.features(motion)
