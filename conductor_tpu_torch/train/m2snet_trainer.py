"""The stage-1 trainer: one M2SNet contrastive step.

Port of `M2SNetTrainer` (`conductor_tpu/train/m2snet_trainer.py:37-280`).
`train_step` cuts the pairs (`data.pairs`), runs four M2SNet forwards in
train mode, (m1, p1), (m1, p2), (m2, p2), (m2, p1), with the BatchNorm
running statistics chained in that order (with ``share_encodes``: two
encodes and four fusions, `:132-169`), takes the loss, four BCEs of the
per-sample mean probability clipped to [1e-7, 1 - 1e-7] (`:171-202`),
and one `torch.optim.Adam` step (optax's `adam`, no clipping).

"auto" resolves per device: on CUDA to ``compute_dtype="bfloat16"`` and
``music_conv_impl="pallas_train"``, the music encoder on the kernels (K4 in
its training modes, K9, K10, K11); elsewhere to "float32" and "lax", the
plain modules.  Either dtype runs with either music path on the CPU (the
kernels' plain versions); in bf16 every module rounds where the flax
module's ``dtype=bfloat16`` does (`models.precision`: float32 parameters
and BN statistics).  The kernels take bf16 operands, so an explicit
"pallas_train" with "float32" on CUDA raises ValueError.  The step runs
with TF32 off (`models.precision.full_float32`): float32 is float32 on the
card too.

Not ported yet, raising NotImplementedError: ``remat``, ``microbatch > 1``,
`recalibrate_batch_stats`, `M2SNetEvaluator` and the ``train_m2snet`` CLI
(`cli/train_m2snet.py`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..data.pairs import build_pairs
from ..interop.weights import load_m2snet_state_dict
from ..models.m2snet import M2SNet
from ..models.precision import full_float32
from .ddpm_trainer import require_device


def _bce(pred: torch.Tensor, target: float) -> torch.Tensor:
    p = pred.float().mean(dim=1).clamp(1e-7, 1 - 1e-7)  # per-sample mean probability
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def resolve_impls(compute_dtype: str, music_conv_impl: str,
                  device: torch.device) -> tuple[str, str]:
    """(compute_dtype, music_conv_impl) with "auto" resolved for
    ``device``; raises on a pair the port does not run there."""
    cuda = device.type == "cuda"
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if cuda else "float32"
    if music_conv_impl == "auto":
        music_conv_impl = "pallas_train" if cuda else "lax"
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype: {compute_dtype}")
    if music_conv_impl not in ("lax", "pallas_train"):
        raise ValueError(f"unknown music_conv_impl: {music_conv_impl}")
    if cuda and music_conv_impl == "pallas_train" and compute_dtype != "bfloat16":
        raise ValueError("music_conv_impl='pallas_train' on CUDA runs the kernels, which take "
                         f"bf16 operands; compute_dtype is {compute_dtype}")
    return compute_dtype, music_conv_impl


class M2SNetTrainer:
    """Owns the M2SNet and its optimizer on ``device`` (the card unless the
    caller asks for the CPU; raises without one)."""

    def __init__(self, sample_length: int = 30, clip_length: int = 10, lr: float = 1e-3,
                 latent_dim: int = 64, compute_dtype: str = "auto", share_encodes: bool = False,
                 remat: bool = False, microbatch: int = 1, music_conv_impl: str = "auto",
                 device: torch.device | str = "cuda"):
        device = require_device(device)
        if remat:
            raise NotImplementedError("remat is not ported yet")
        if microbatch != 1:
            raise NotImplementedError("microbatch > 1 is not ported yet")
        compute_dtype, music_conv_impl = resolve_impls(compute_dtype, music_conv_impl, device)
        self.device = device
        self.sample_length, self.clip_length = sample_length, clip_length
        self.share_encodes = share_encodes
        self.compute_dtype, self.music_conv_impl = compute_dtype, music_conv_impl
        self.lr = lr
        self.model = M2SNet(latent_dim, music_conv_impl, getattr(torch, compute_dtype)).to(device)
        self._new_optimizer()

    def _new_optimizer(self) -> None:
        self.optimizer = torch.optim.Adam(self.model.parameters(), lr=self.lr)

    def load_reference_state_dict(self, sd) -> None:
        """Load a reference M2SNet state dict strictly (``module.`` stripped,
        the adjacency checked; see `interop.weights`) and start a fresh
        optimizer."""
        load_m2snet_state_dict(self.model, sd)
        self._new_optimizer()

    def _forward4(self, pairs):
        m1, m2, p1, p2 = pairs
        model = self.model
        if self.share_encodes:
            x1, y1 = model.encode(m1, p1)
            x2, y2 = model.encode(m2, p2)
            return [model.fuse(a, b) for a, b in ((x1, y1), (x1, y2), (x2, y2), (x2, y1))]
        return [model(mel, mot) for mel, mot in ((m1, p1), (m1, p2), (m2, p2), (m2, p1))]

    def _pairs(self, music, motion, strategy, starts, generator):
        def on_device(a):  # a copy of host arrays, which may be read-only
            return (a if torch.is_tensor(a) else torch.tensor(np.asarray(a))).to(
                self.device, torch.float32)

        return build_pairs(on_device(music), on_device(motion), strategy, self.sample_length,
                           self.clip_length, starts=starts, generator=generator)

    def _metrics(self, p11, p12) -> dict[str, torch.Tensor]:
        b = p11.shape[0]
        hits = (p11 > 0.5).sum() + (p12 < 0.5).sum()
        return {"accuracy": hits / (b * self.clip_length * 2 * 30),
                "sync_prob": p11.float().mean(), "non_sync_prob": p12.float().mean()}

    @full_float32()
    def train_step(self, music, motion, strategy: str = "hard", *, starts=None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step on music (B, S*90, 128) and motion
        (B, S*30, 13, 2).  The pair starts (30 Hz frames) are ``starts`` if
        given, else drawn from ``generator``.  Returns the JAX metrics as
        0-d tensors (no host sync)."""
        pairs = self._pairs(music, motion, strategy, starts, generator)
        self.model.train()
        p11, p12, p22, p21 = self._forward4(pairs)
        loss = _bce(p11, 1.0) + _bce(p12, 0.0) + _bce(p22, 1.0) + _bce(p21, 0.0)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in self._metrics(p11, p12).items()}}

    @torch.no_grad()
    @full_float32()
    def evaluate(self, music, motion, strategy: str, *, starts=None,
                 generator: torch.Generator | None = None) -> dict[str, float]:
        """The four forwards in eval mode on one batch at a difficulty
        (`:263-280`): accuracy, sync_prob and non_sync_prob."""
        pairs = self._pairs(music, motion, strategy, starts, generator)
        self.model.eval()
        p11, p12, _, _ = self._forward4(pairs)
        return {k: float(v) for k, v in self._metrics(p11, p12).items()}

    def recalibrate_batch_stats(self, batches):
        raise NotImplementedError("recalibrate_batch_stats is not ported yet")


class M2SNetEvaluator:
    """Not ported yet (`conductor_tpu/eval/stage1.py::M2SNetEvaluator`);
    `M2SNetTrainer.evaluate` scores one batch."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError("M2SNetEvaluator is not ported yet")
