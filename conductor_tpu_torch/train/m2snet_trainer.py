"""The stage-1 trainer: one M2SNet contrastive step.

Port of `M2SNetTrainer` (`conductor_tpu/train/m2snet_trainer.py:37-332`).
`train_step` cuts the pairs (`data.pairs`), runs four M2SNet forwards in
train mode, (m1, p1), (m1, p2), (m2, p2), (m2, p1), with the BatchNorm
running statistics chained in that order (with ``share_encodes``: two
encodes and four fusions, `:132-169`), takes the loss, four BCEs of the
per-sample mean probability clipped to [1e-7, 1 - 1e-7] (`:171-202`),
and one `torch.optim.Adam` step (optax's `adam`, no clipping).

- ``remat`` (`:67-110`): each of the four forwards (each encode under
  ``share_encodes``) runs under `torch.utils.checkpoint`, so the backward
  recomputes its activations instead of keeping them.  The recomputation
  runs inside `models.bn.batch_statistics_only`, so that the running
  statistics move once a forward, as without ``remat``; the kernels'
  autograd Functions run their forward again, which their launch counts
  show.
- ``microbatch = k`` (`:204-245`): the pairs are cut over the whole batch,
  then split into k chunks along it; each chunk takes its four forwards
  (BatchNorm batch statistics per chunk, the running ones chained chunk
  after chunk) and its own gradient, and the gradients and metrics are
  the mean over the chunks.
- `recalibrate_batch_stats` (`:284-332`): precise-BN over a list of
  batches.
- ``step`` counts the steps taken; `state_dict` / `load_state_dict` carry
  the model (the reference's M2SNet keys), Adam's state and the step.

"auto" resolves per device: on CUDA to ``compute_dtype="bfloat16"`` and
``music_conv_impl="pallas_train"``, the music encoder on the kernels (K4 in
its training modes, K9, K10, K11); elsewhere to "float32" and "lax", the
plain modules, as JAX's rule (`conductor_tpu/train/m2snet_trainer.py:
65-66`).  Either dtype runs with either music path, on the CPU through the
kernels' plain versions and on CUDA through the kernels, which take bf16
operands (tensor cores) or float32 operands with float32 products (their
float32 modes, CUDA cores); in bf16 every module rounds where the flax
module's ``dtype=bfloat16`` does (`models.precision`: float32 parameters
and BN statistics).  The step runs with TF32 off
(`models.precision.full_float32`): float32 is float32 on the card too.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..data.pairs import build_pairs
from ..interop.weights import load_m2snet_state_dict
from ..models.bn import batch_statistics_only
from ..models.m2snet import M2SNet
from ..models.precision import full_float32
from .checkpoints import host_state_dict
from .ddpm_trainer import require_device


def _recomputation():
    """`torch.utils.checkpoint`'s contexts: the forward as it is, the
    recomputation leaving the BatchNorm running statistics alone."""
    return contextlib.nullcontext(), batch_statistics_only()


def _bce(pred: torch.Tensor, target: float) -> torch.Tensor:
    p = pred.float().mean(dim=1).clamp(1e-7, 1 - 1e-7)  # per-sample mean probability
    return -(target * torch.log(p) + (1 - target) * torch.log(1 - p)).mean()


def resolve_impls(compute_dtype: str, music_conv_impl: str,
                  device: torch.device) -> tuple[str, str]:
    """(compute_dtype, music_conv_impl) with "auto" resolved for
    ``device``; raises on an unknown value."""
    cuda = device.type == "cuda"
    if compute_dtype == "auto":
        compute_dtype = "bfloat16" if cuda else "float32"
    if music_conv_impl == "auto":
        music_conv_impl = "pallas_train" if cuda else "lax"
    if compute_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown compute_dtype: {compute_dtype}")
    if music_conv_impl not in ("lax", "pallas_train"):
        raise ValueError(f"unknown music_conv_impl: {music_conv_impl}")
    return compute_dtype, music_conv_impl


class M2SNetTrainer:
    """Owns the M2SNet and its optimizer on ``device`` (the card unless the
    caller asks for the CPU; raises without one)."""

    def __init__(self, sample_length: int = 30, clip_length: int = 10, lr: float = 1e-3,
                 latent_dim: int = 64, compute_dtype: str = "auto", share_encodes: bool = False,
                 remat: bool = False, microbatch: int = 1, music_conv_impl: str = "auto",
                 device: torch.device | str = "cuda"):
        device = require_device(device)
        if microbatch < 1:
            raise ValueError(f"microbatch must be a positive number of chunks, got {microbatch}")
        compute_dtype, music_conv_impl = resolve_impls(compute_dtype, music_conv_impl, device)
        self.device = device
        self.sample_length, self.clip_length = sample_length, clip_length
        self.share_encodes, self.remat, self.microbatch = share_encodes, remat, microbatch
        self.step = 0
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

    def state_dict(self) -> dict:
        """The training state on the host: ``model`` (the M2SNet under the
        reference's keys, which `load_m2snet_state_dict` and JAX's
        `import_m2snet` read), ``optimizer`` (Adam's state) and ``step``."""
        opt = self.optimizer.state_dict()
        return {"model": host_state_dict(self.model.state_dict()),
                "optimizer": {"state": {i: host_state_dict(st) for i, st in opt["state"].items()},
                              "param_groups": opt["param_groups"]},
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict`'s output."""
        load_m2snet_state_dict(self.model, state["model"])
        self._new_optimizer()
        self.optimizer.load_state_dict(state["optimizer"])
        self.step = int(state["step"])

    def _forward4(self, pairs, remat: bool = False):
        m1, m2, p1, p2 = pairs
        model = self.model

        def run(fn, *args):
            if not remat:
                return fn(*args)
            return checkpoint(fn, *args, use_reentrant=False, preserve_rng_state=False,
                              context_fn=_recomputation)

        if self.share_encodes:
            x1, y1 = run(model.encode, m1, p1)
            x2, y2 = run(model.encode, m2, p2)
            return [model.fuse(a, b) for a, b in ((x1, y1), (x1, y2), (x2, y2), (x2, y1))]
        return [run(model, mel, mot) for mel, mot in ((m1, p1), (m1, p2), (m2, p2), (m2, p1))]

    def _on_device(self, a) -> torch.Tensor:
        """A float32 copy on the device (host arrays may be read-only)."""
        return (a if torch.is_tensor(a) else torch.tensor(np.asarray(a))).to(
            self.device, torch.float32)

    def _pairs(self, music, motion, strategy, starts, generator):
        return build_pairs(self._on_device(music), self._on_device(motion), strategy,
                           self.sample_length, self.clip_length, starts=starts,
                           generator=generator)

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
        0-d tensors (no host sync); the step's gradients stay in the
        parameters' ``.grad``."""
        pairs = self._pairs(music, motion, strategy, starts, generator)
        k, b = self.microbatch, pairs[0].shape[0]
        if b % k:
            raise ValueError(f"batch {b} not divisible by microbatch {k}")
        self.model.train()
        params = list(self.model.parameters())
        grads = metrics = None
        for chunk in zip(*(t.chunk(k) for t in pairs)):
            p11, p12, p22, p21 = self._forward4(chunk, self.remat)
            loss = _bce(p11, 1.0) + _bce(p12, 0.0) + _bce(p22, 1.0) + _bce(p21, 0.0)
            g = torch.autograd.grad(loss, params, allow_unused=True)
            m = {"loss": loss.detach(), **{n: v.detach() for n, v in self._metrics(p11, p12).items()}}
            if grads is None:
                grads, metrics = list(g), m
            else:  # the chunks' sums, in chunk order, as JAX's scan adds them
                grads = [a if c is None else a + c for a, c in zip(grads, g)]
                metrics = {n: v + m[n] for n, v in metrics.items()}
        if k > 1:  # equal chunks: the mean of the chunk means is the batch mean
            grads = [None if g is None else g / k for g in grads]
            metrics = {n: v / k for n, v in metrics.items()}
        for p, g in zip(params, grads):
            p.grad = g
        self.optimizer.step()
        self.step += 1
        return metrics

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

    @torch.no_grad()
    @full_float32()
    def features(self, music, motion):
        """`M2SNet.features` in eval mode: every map of both encoders."""
        self.model.eval()
        return self.model.features(self._on_device(music), self._on_device(motion))

    @torch.no_grad()
    @full_float32()
    def recalibrate_batch_stats(self, batches) -> None:
        """Precise-BN (`:284-332`): replace every BatchNorm's running mean
        and variance by the aggregate of its batch statistics over
        ``batches``, (music, motion) pairs of whole windows: one train-mode
        forward of the M2SNet a batch, each normalising by its own batch
        statistics, which are read directly (JAX recovers them from its
        running-statistics update, (new - 0.99 old) / 0.01, with 100 times
        the float32 rounding).  The mean is the mean of the batch means,
        the variance max(E[var_i + mean_i²] - mean², 0): the statistics of
        one batch holding the whole set.  The weights, the optimizer and
        ``num_batches_tracked`` are left as they are (flax keeps no such
        count).  Raises ValueError on an empty list."""
        self.model.train()
        records = []
        for music, motion in batches:
            record: dict = {}
            with batch_statistics_only(record):
                self.model(self._on_device(music), self._on_device(motion))
            records.append(record)
        if not records:
            raise ValueError("recalibrate_batch_stats needs at least one batch")
        n = len(records)
        for bn in records[0]:
            means = [r[bn][0] for r in records]
            mean = sum(means) / n
            e2 = sum(r[bn][1] + m ** 2 for r, m in zip(records, means)) / n
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(torch.clamp_min(e2 - mean ** 2, 0.0))
