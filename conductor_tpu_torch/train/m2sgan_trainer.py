"""The M2SGAN stage-1 trainer: WGAN-GP with SyncLoss.

Port of `M2SGANTrainer` (`conductor_tpu/train/m2sgan_trainer.py:49-397`;
reference `Contrastive_Stage/M2SGAN_train.py:36-147`).  `train_step`
follows `_train_step_impl` (`:225-318`):

- one fake from the music features and the step's noise, the generator in
  eval mode, without gradient;
- ``critic_iters`` critic updates on that same fake: loss = -E[D(real)] +
  E[D(fake)] + w_gp · GP (`train.losses.gradient_penalty`, each
  iteration's interpolation weights its own);
- one generator step against the UPDATED critic, the generator's
  BatchNorms in train mode (their running statistics moved, as flax's
  ``mutable=["batch_stats"]``): w_adv · -E[D(G)] + w_sync · SyncLoss +
  w_mse · MSE, SyncLoss the L1 between the frozen ST-GCN's latents of
  the fake and of the real motion;
- RMSprop by optax's rule for both (`train.optim.RMSprop`).

Metrics, as JAX's: ``w_distance`` and ``gp`` of the last critic
iteration, ``loss_adv``, ``loss_sync`` and ``loss_mse`` of the generator
step.

The knobs and their "auto" rule are JAX's (`:50-153`), "on TPU" read as
"on CUDA":

- ``music_encoder_impl``: "pallas" (the frozen encoder on K4,
  `FusedMusicEncoder`, built once from the generator's encoder) unless
  the encoder trains, then "flax" (the plain module); "flax" off CUDA;
- ``sync_encoder_impl`` "pallas" with ``sync_encoder_dtype`` bf16 (the
  frozen ST-GCN on K7, `ops.stgcn.fused_frozen_stgcn`: the fake forward
  keeping its ReLU masks and backward, the real forward only; the pack
  built once and dropped by `reset_caches`; an explicit float32 runs K7's
  float32 mode); "flax" and float32 off CUDA.  K7 takes float32 motion, so a bf16 generator's output is cast
  to float32 before it;
- with ``train_music_encoder``, ``compute_dtype`` bf16 and
  ``music_conv_impl`` "pallas_train" (K4's training modes, K9, K10, K11,
  `m2snet_trainer.resolve_impls`), also on the kernels' float32 modes
  with an explicit ``compute_dtype="float32"``; with the encoder frozen,
  float32 and "lax".

As in JAX, ``train_music_encoder`` refuses ``music_encoder_impl="pallas"``
and ``cached_features`` (a trainable encoder's output cannot be
precomputed).  With ``cached_features`` the step's ``cond`` is the
frozen encoder's features (B, S*30, 64) (`music_features` makes them);
with ``cached_sync_latents`` it takes the real motion's SyncLoss latents
(B, S*30, 64) (`sync_latents` makes them): the same functions the
uncached step runs, so the numbers are the same.

The noise (B, S, noise_dim) and the interpolation weights (``gp_alpha``:
each interpolating term's weights with a leading critic-iteration axis)
are handed over or drawn from ``generator``.  Both entry points run with
TF32 off (`models.precision.full_float32`).

``step`` counts the steps taken; `state_dict` / `load_state_dict` carry
G and D under the reference's keys, both RMSprop states, the frozen
SyncLoss network (JAX's ``GANState.sync_variables``) and the step.  Not
ported yet: the BiLSTM decoder (ROADMAP G).
"""

from __future__ import annotations

import numpy as np
import torch

from ..interop.weights import (
    load_motion_encoder_state_dict,
    load_music_encoder_from_m2snet,
    load_reference_state_dict,
)
from ..models.generator import Discriminator1DCNN, Generator
from ..models.music_encoder import FusedMusicEncoder
from ..models.precision import full_float32
from ..models.stgcn import MotionEncoderSTGCN
from ..ops.stgcn import fused_frozen_stgcn, pack_frozen_stgcn
from .checkpoints import host_state_dict
from .ddpm_trainer import require_device
from .losses import alpha_shape, draw_gp_alpha, gradient_penalty, sync_loss
from .m2snet_trainer import resolve_impls
from .optim import RMSprop


def resolve_gan_impls(music_encoder_impl: str, sync_encoder_dtype: str, sync_encoder_impl: str,
                      music_conv_impl: str, compute_dtype: str, train_music_encoder: bool,
                      device: torch.device) -> dict[str, str]:
    """The trainer's implementation knobs with "auto" resolved for
    ``device``; raises on a value the port does not run there."""
    cuda = device.type == "cuda"

    def auto(value, cuda_value, other_value):
        return value if value != "auto" else (cuda_value if cuda else other_value)

    out = {
        "music_encoder_impl": auto(music_encoder_impl,
                                   "flax" if train_music_encoder else "pallas", "flax"),
        "sync_encoder_dtype": auto(sync_encoder_dtype, "bfloat16", "float32"),
        "sync_encoder_impl": auto(sync_encoder_impl, "pallas", "flax"),
    }
    if not train_music_encoder:  # JAX's frozen-encoder "auto": the reference's numerics
        compute_dtype = "float32" if compute_dtype == "auto" else compute_dtype
        music_conv_impl = "lax" if music_conv_impl == "auto" else music_conv_impl
    out["compute_dtype"], out["music_conv_impl"] = resolve_impls(compute_dtype, music_conv_impl,
                                                                 device)
    for key, allowed in (("music_encoder_impl", ("flax", "pallas")),
                         ("sync_encoder_impl", ("flax", "pallas")),
                         ("sync_encoder_dtype", ("float32", "bfloat16"))):
        if out[key] not in allowed:
            raise ValueError(f"unknown {key}: {out[key]}")
    return out


class M2SGANTrainer:
    """Owns the generator, the critic, their RMSprop states and the frozen
    SyncLoss ST-GCN on ``device`` (the card unless the caller asks for the
    CPU; raises without one)."""

    def __init__(self, sample_length: int = 30, lr: float = 5e-4, critic_iters: int = 5,
                 w_adv: float = 1.0, w_sync: float = 0.05, w_mse: float = 0.0,
                 w_gp: float = 10.0, noise_dim: int = 8, gp_terms: tuple[str, ...] = ("real_fake",),
                 music_encoder_impl: str = "auto", sync_encoder_dtype: str = "auto",
                 sync_encoder_impl: str = "auto", train_music_encoder: bool = False,
                 music_conv_impl: str = "auto", compute_dtype: str = "auto",
                 cached_features: bool = False, cached_sync_latents: bool = False,
                 device: torch.device | str = "cuda"):
        device = require_device(device)
        impls = resolve_gan_impls(music_encoder_impl, sync_encoder_dtype, sync_encoder_impl,
                                  music_conv_impl, compute_dtype, train_music_encoder, device)
        if train_music_encoder and impls["music_encoder_impl"] != "flax":
            raise ValueError("music_encoder_impl='pallas' is an inference-only fast path for the "
                             "FROZEN encoder; with train_music_encoder use "
                             "music_conv_impl='pallas_train' (trainable packed kernels)")
        if cached_features and train_music_encoder:
            raise ValueError("cached_features requires the frozen music encoder "
                             "(train_music_encoder=False): a trainable encoder's output changes "
                             "every update and cannot be precomputed")
        self.device = device
        self.music_encoder_impl, self.sync_encoder_impl = (impls["music_encoder_impl"],
                                                           impls["sync_encoder_impl"])
        self.sync_encoder_dtype, self.compute_dtype = (impls["sync_encoder_dtype"],
                                                       impls["compute_dtype"])
        self.music_conv_impl = impls["music_conv_impl"]
        self.sample_length, self.lr, self.critic_iters = sample_length, lr, critic_iters
        self.w_adv, self.w_sync, self.w_mse, self.w_gp = w_adv, w_sync, w_mse, w_gp
        self.noise_dim, self.gp_terms = noise_dim, tuple(gp_terms)
        self.train_music_encoder = train_music_encoder
        self.cached_features, self.cached_sync_latents = cached_features, cached_sync_latents
        self.G = Generator(freeze_music_encoder=not train_music_encoder,
                           dtype=getattr(torch, self.compute_dtype),
                           music_conv_impl=self.music_conv_impl).to(device)
        self.G.music_encoder.requires_grad_(train_music_encoder)
        self.D = Discriminator1DCNN().to(device)
        self.sync_dtype = getattr(torch, self.sync_encoder_dtype)
        self.sync_encoder = MotionEncoderSTGCN(dtype=self.sync_dtype).to(device).freeze()
        self.step = 0
        self._new_optimizers()
        self.reset_caches()

    def _new_optimizers(self) -> None:
        self.g_opt = RMSprop(self.G.parameters(), self.lr)
        self.d_opt = RMSprop(self.D.parameters(), self.lr)

    def reset_caches(self) -> None:
        """Drop the weights derived from the frozen networks (K4's encoder
        and K7's pack); the next use rebuilds them.  Loading calls it."""
        self._fused_encoder = self._sync_pack = None

    def load_reference_state_dict(self, generator=None, discriminator=None, *, m2snet=None,
                                  sync_encoder=None) -> None:
        """Load reference-format weights (`interop.weights`): ``generator``
        and ``discriminator`` state dicts; ``m2snet``, a stage-1 M2SNet
        whose music encoder goes into the generator and whose motion
        encoder becomes the SyncLoss network (`M2SGAN_train.py:55-64`);
        ``sync_encoder``, that network alone (a MotionEncoder_STGCN
        subtree or an M2SNet).  Starts fresh optimizer states."""
        if generator is not None:
            load_reference_state_dict(self.G, generator)
        if discriminator is not None:
            load_reference_state_dict(self.D, discriminator)
        if m2snet is not None:
            load_music_encoder_from_m2snet(self.G, m2snet)
            load_motion_encoder_state_dict(self.sync_encoder, m2snet)
        if sync_encoder is not None:
            load_motion_encoder_state_dict(self.sync_encoder, sync_encoder)
        self._new_optimizers()
        self.reset_caches()

    def state_dict(self) -> dict:
        """The training state on the host: ``G`` and ``D`` under the
        reference's keys (JAX's `import_generator` / `import_discriminator`
        read them; the TCN's two names of one module hold one value),
        ``g_opt`` / ``d_opt`` (RMSprop's second moments), ``sync_encoder``
        (the frozen SyncLoss ST-GCN) and ``step``."""
        def host(module):
            return host_state_dict(module.state_dict())

        return {"G": host(self.G), "D": host(self.D), "g_opt": self.g_opt.state_dict(),
                "d_opt": self.d_opt.state_dict(), "sync_encoder": host(self.sync_encoder),
                "step": self.step}

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict`'s output, or a `cli.import_torch m2sgan`
        checkpoint (``G``, ``D`` if it was given, ``step``: what it lacks
        stays as it is, the optimizer states start fresh); then
        `reset_caches`."""
        load_reference_state_dict(self.G, state["G"])
        if "D" in state:
            load_reference_state_dict(self.D, state["D"])
        if "sync_encoder" in state:
            load_motion_encoder_state_dict(self.sync_encoder, state["sync_encoder"])
        self._new_optimizers()
        if "g_opt" in state:
            self.g_opt.load_state_dict(state["g_opt"])
            self.d_opt.load_state_dict(state["d_opt"])
        self.step = int(state["step"])
        self.reset_caches()

    def _on_device(self, a) -> torch.Tensor:
        return (a if torch.is_tensor(a) else torch.tensor(np.asarray(a))).to(self.device,
                                                                             torch.float32)

    def _draw_noise(self, batch: int, generator: torch.Generator | None) -> torch.Tensor:
        where = generator.device if generator is not None else self.device
        return torch.randn((batch, self.sample_length, self.noise_dim), generator=generator,
                           device=where).to(self.device)

    @torch.no_grad()
    @full_float32()
    def music_features(self, mel) -> torch.Tensor:
        """The frozen music encoder's features (B, S*30, 64) of mel (B,
        S*90, 128): what the step computes from mel, and what a
        ``cached_features`` step takes instead."""
        if self.train_music_encoder:
            raise ValueError("the music encoder trains: its features cannot be precomputed")
        mel = self._on_device(mel)
        if self.music_encoder_impl == "pallas":
            return self.fused_encoder()(mel)
        return self.G.encode_music(mel)

    def fused_encoder(self) -> FusedMusicEncoder:
        """K4's frozen music encoder, built from the generator's at first
        use after a load (`reset_caches`)."""
        if self._fused_encoder is None:
            self._fused_encoder = FusedMusicEncoder(self.G.music_encoder)
        return self._fused_encoder

    def sync_latents(self, motion: torch.Tensor) -> torch.Tensor:
        """Motion (B, T, 13, 2) -> the frozen SyncLoss latents (B, T, 64),
        differentiable with respect to the motion: what the step runs on
        the fake and on the real, and what a ``cached_sync_latents`` step
        takes for the real."""
        if self.sync_encoder_impl == "pallas":
            return fused_frozen_stgcn(motion.float(), self.sync_pack(), self.sync_dtype)
        return self.sync_encoder(motion)

    def sync_pack(self) -> dict[str, torch.Tensor]:
        """K7's packed weights of the SyncLoss network, built at first use
        after a load (`reset_caches`)."""
        if self._sync_pack is None:
            self._sync_pack = pack_frozen_stgcn(self.sync_encoder, self.sync_dtype)
        return self._sync_pack

    def _gp_alpha(self, gp_alpha, batch: int, generator) -> dict[str, torch.Tensor]:
        if gp_alpha is None:
            return draw_gp_alpha(self.gp_terms, batch, self.critic_iters, generator, self.device)
        return {k: self._on_device(v).reshape(self.critic_iters, *alpha_shape(k, batch))
                for k, v in gp_alpha.items()}

    @full_float32()
    def train_step(self, cond, real, real_latents=None, *, noise=None, gp_alpha=None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One step on cond, mel (B, S*90, 128) or with ``cached_features``
        the encoder's features (B, S*30, 64), and real motion (B, S*30, 13,
        2); ``real_latents`` (B, S*30, 64) is required with, and only with,
        ``cached_sync_latents``.  Returns the JAX metrics as 0-d tensors
        (no host sync)."""
        if (real_latents is None) == self.cached_sync_latents:
            raise ValueError("real_latents is required with cached_sync_latents, and only then")
        cond, real = self._on_device(cond), self._on_device(real)
        batch = real.shape[0]
        noise = self._draw_noise(batch, generator) if noise is None else self._on_device(noise)
        alpha = self._gp_alpha(gp_alpha, batch, generator)
        if real_latents is not None:
            real_latents = self._on_device(real_latents)

        # one fake, reused by every critic iteration
        with torch.no_grad():
            if self.train_music_encoder:
                hx = None
                fake = self.G(cond, noise, train=False)
            else:
                hx = cond if self.cached_features else self.music_features(cond)
                fake = self.G.decode(hx, noise, train=False)

        d_params = self.d_opt.params
        real_m = fake_m = gp = real.new_zeros(())
        for i in range(self.critic_iters):
            real_m, fake_m = self.D(real).mean(), self.D(fake).mean()
            gp = gradient_penalty(self.D, real, fake, self.gp_terms,
                                  {k: v[i] for k, v in alpha.items()})
            loss = -real_m + fake_m + self.w_gp * gp
            for p, g in zip(d_params, torch.autograd.grad(loss, d_params)):
                p.grad = g
            self.d_opt.step()

        loss, terms = self.generator_loss(cond, hx, noise, real, real_latents)
        g_params = self.g_opt.params
        for p, g in zip(g_params, torch.autograd.grad(loss, g_params)):
            p.grad = g
        self.g_opt.step()
        self.step += 1
        metrics = {"w_distance": real_m - fake_m, "gp": gp, **terms}
        return {k: v.detach() for k, v in metrics.items()}

    def generator_loss(self, cond, hx, noise, real, real_latents=None):
        """The generator step's loss and its terms (``loss_adv``,
        ``loss_sync``, ``loss_mse``) against the current critic, the
        generator in train mode (its BatchNorm statistics move): the fake
        from mel ``cond`` through the training encoder, or with the encoder
        frozen from its features ``hx``."""
        out = (self.G(cond, noise, train=True) if self.train_music_encoder
               else self.G.decode(hx, noise, train=True))
        adv = -self.D(out).mean()
        sync = sync_loss(self.sync_latents, out, real, real_latents)
        mse = ((out - real) ** 2).mean()
        loss = self.w_adv * adv + self.w_sync * sync + self.w_mse * mse
        return loss, {"loss_adv": adv, "loss_sync": sync, "loss_mse": mse}

    @torch.no_grad()
    @full_float32()
    def generate(self, cond, *, noise=None, generator: torch.Generator | None = None,
                 from_features: bool = False) -> torch.Tensor:
        """Motion (B, S*30, 13, 2) from mel (B, S*90, 128), or from the
        frozen encoder's features (B, S*30, 64) with ``from_features``; the
        generator in eval mode, the encoder its plain module (`:387-397`)."""
        cond = self._on_device(cond)
        noise = (self._draw_noise(cond.shape[0], generator) if noise is None
                 else self._on_device(noise))
        if from_features:
            return self.G.decode(cond, noise, train=False)
        return self.G(cond, noise, train=False)
