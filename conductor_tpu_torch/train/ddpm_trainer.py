"""The stage-2 trainer: one optimizer step, and serving (mel -> motion).

Port of `DDPMTrainer` (`conductor_tpu/train/ddpm_trainer.py`).

`train_step` is one step of `_train_step_impl` / `_losses` (`:190-330`):
the 5-term objective ``1 * masked MSE + 1e-6 * L1(frozen ST-GCN latents) +
0.1 * velocity - 0.1 * clamp(elbow, +-2e-4) + 0.1 * head``, uniform
timesteps, condition dropout, then optax's global-norm clip and Adam
(`train/optim.py`).  The MSE's mask is the full window, or with
``replicate_reference_mask`` the reference's ``min(T, m_lens)`` frames,
which the plain layers also take as the self-attention's key mask.  With
``train_layer_impl == "pallas_fused"`` (the port's "auto" on CUDA, gated
off by the reference mask or dropout) the denoiser's layers run through
`fused_train_denoise`: K5 forward, K6 backward; otherwise the plain
modules in the compute dtype (flax's ``dtype=`` rule, `models.precision`)
and autograd, their self-attention on K8 with ``attention_impl ==
"pallas"`` (`ops.attention`).  The perceptual term runs the frozen ST-GCN:
with ``feat_impl == "pallas"`` (the port's "auto" on CUDA with bf16
operands) on `ops.stgcn.fused_frozen_stgcn`, K7 forward on pred and target
and K7 backward to pred, over weights packed once outside the step;
otherwise the plain `MotionEncoderSTGCN` and autograd.  From mel the frozen
music encoder runs in the compute dtype, as the JAX trainer's
`MotionTransformer(dtype=compute_dtype)` runs it.

`generate` (`:401-531`) encodes the music once, precomputes the
step-invariant condition and the time-embedding table, then runs the
(optionally respaced) eta=0 DDIM ladder.  With ``layer_impl ==
"pallas_fused"`` the ladder runs on the sampler and decoder-stack kernels
(`FusedDenoiser.ddim_sample`), in the int8-AdaLN mode with
``sampler_adaln_int8`` (bench.py's serving config) and the bf16-VPU mode
with ``sampler_vpu_dtype="bfloat16"``; otherwise the plain modules in the
compute dtype run through the generic `ddim_sample_loop`, which ignores
those two flags, as JAX's plain-layer path does.  With
``music_encoder_impl == "pallas"`` the encoder runs on the conv-block
kernel.

Both entry points run with TF32 off (`models.precision.full_float32`), so
a float32 path is float32 on the card too.

Around the step, as JAX's `TrainState` and `init_state` carry it: the step
count, from which each step's random numbers are drawn (a generator seeded
from ``(cfg.train.seed, step)``, as JAX folds the step into its key), so a
resumed run draws what the uninterrupted one drew; the loss-second-moment
sampler's state (``timestep_sampler="loss-second-moment"``, updated from
each step's per-sample MSE); `graft_stage1`, which takes a stage-1
M2SNet's music encoder into the denoiser and its motion encoder into the
perceptual net; and `state_dict` / `load_state_dict` of the whole training
state in the reference's stage-2 ``latest.tar`` layout
(`train.checkpoints`).

Not ported yet, raising NotImplementedError: denoiser dropout,
classifier-free guidance, and the ancestral sampler.
"""

from __future__ import annotations

import numpy as np
import torch

from ..config import Config, resolve_auto
from ..diffusion import (
    ddim_sample_loop,
    make_schedule,
    respaced_schedule,
    space_timesteps,
    training_losses,
    uniform_sample,
)
from ..diffusion import timestep_samplers as ts
from ..interop.weights import (
    load_motion_encoder_state_dict,
    load_music_encoder_from_m2snet,
    load_reference_state_dict,
)
from ..models.music_encoder import FusedMusicEncoder
from ..models.precision import full_float32
from ..models.stgcn import MotionEncoderSTGCN
from ..models.transformer import MotionTransformer
from ..ops.stgcn import fused_frozen_stgcn, pack_frozen_stgcn
from .fused_denoiser import FusedDenoiser, fused_train_denoise
from .optim import ClippedAdam


class DDPMTrainer:
    """Owns the denoiser, the frozen perceptual ST-GCN and the optimizer on
    ``device`` (the card unless the caller asks for the CPU; raises without
    one); serves `train_step` and `generate`."""

    def __init__(self, cfg: Config, device: torch.device | str = "cuda"):
        device = require_device(device)
        cfg = resolve_auto(cfg, device)
        d = cfg.denoiser
        if (d.layer_impl not in ("flax", "pallas_fused")
                or d.music_encoder_impl not in ("flax", "pallas")
                or d.attention_impl not in ("xla", "pallas")
                or d.compute_dtype not in ("float32", "bfloat16")):
            raise ValueError(f"unknown layer_impl / music_encoder_impl / attention_impl / "
                             f"compute_dtype: {d.layer_impl}, {d.music_encoder_impl}, "
                             f"{d.attention_impl}, {d.compute_dtype}")
        if (cfg.diffusion.mean_type, cfg.diffusion.var_type) != ("start_x", "fixed_small"):
            raise NotImplementedError("the port serves START_X / FIXED_SMALL only")
        _check_training_config(cfg, device)
        self.cfg = cfg
        self.device = device
        self.model = MotionTransformer.from_config(d).to(device).eval()
        self.model.music_encoder.requires_grad_(False)  # frozen, as in the JAX package
        self.feat_model = MotionEncoderSTGCN(n_joints=cfg.dataset.n_joints,
                                             dtype=getattr(torch, d.compute_dtype)).to(device).freeze()
        self._build_feat_pack()
        self.sched = make_schedule(cfg.diffusion.schedule, cfg.diffusion.steps)
        self.train_sched = self.sched.to(device)
        self.step = 0
        self.sampler_state = (ts.init_state(self.sched.num_timesteps)
                              if cfg.train.timestep_sampler == "loss-second-moment" else None)
        self._new_optimizer()
        self._build_sampling_pack()

    def _new_optimizer(self) -> None:
        tc = self.cfg.train
        self.optimizer = ClippedAdam(self.model.parameters(), lr=tc.lr, max_norm=tc.grad_clip)

    def load_reference_state_dict(self, sd=None, *, motion_encoder=None) -> None:
        """Load reference-format weights (see `interop.weights`): ``sd``
        into the denoiser, ``motion_encoder`` (a MotionEncoder_STGCN subtree
        or a whole M2SNet state dict) into the frozen perceptual ST-GCN.
        Rebuilds the sampling pack and starts a fresh optimizer, or
        rebuilds the ST-GCN's packed weights."""
        if sd is not None:
            load_reference_state_dict(self.model, sd)
            self._new_optimizer()
            self._build_sampling_pack()
        if motion_encoder is not None:
            load_motion_encoder_state_dict(self.feat_model, motion_encoder)
            self._build_feat_pack()

    def graft_stage1(self, m2snet_sd) -> None:
        """The hand-off from stage 1 (JAX `init_state(stage1_music_params=,
        stage1_music_stats=, stage1_motion_variables=)`,
        `conductor_tpu/train/ddpm_trainer.py:135-186`): a reference-format
        M2SNet state dict's music encoder, parameters and BatchNorm
        statistics, into the frozen ``model.music_encoder``, and its motion
        encoder into the perceptual ST-GCN; then `reset_caches`."""
        load_music_encoder_from_m2snet(self.model, m2snet_sd)
        load_motion_encoder_state_dict(self.feat_model, m2snet_sd)
        self.reset_caches()

    def reset_caches(self) -> None:
        """Rebuild what is derived from the weights (the ST-GCN's pack, the
        sampling pack, the fused encoder) after a graft or a restore (JAX
        `reset_caches`, called by `cli/train.py:167`)."""
        self._build_feat_pack()
        self._build_sampling_pack()

    def _step_generator(self) -> torch.Generator:
        """The generator of this step's random numbers, on the trainer's
        device, seeded from ``(cfg.train.seed, step)``: JAX draws them from
        ``fold_in(rng, state.step)`` (`conductor_tpu/train/ddpm_trainer.py:302`)."""
        seed = np.random.SeedSequence((self.cfg.train.seed, self.step)).generate_state(1, np.uint64)
        return torch.Generator(device=self.device).manual_seed(int(seed[0]) >> 1)

    # ---------------------------------------------------------- checkpoints

    def state_dict(self, epoch: int = 0) -> dict:
        """The whole training state, on the host, in the reference's stage-2
        ``latest.tar`` layout (`Diffusion_Stage/trainers/ddpm_trainer.py:
        290-319`): ``encoder`` (the denoiser under the reference's key
        names), ``opt_encoder`` (the Adam state over every parameter in
        the reference's registration order, the frozen music encoder's
        without state), ``ep`` and ``total_it`` (the step); beside them the
        frozen perceptual ST-GCN (``feat_encoder``, which JAX's
        `TrainState` carries as ``feat_variables``) and the
        loss-second-moment sampler's state (``sampler_state``, or None)."""
        def host(sd):
            return {k: v.detach().to("cpu", copy=True) for k, v in sd.items()}

        sampler = None
        if self.sampler_state is not None:
            sampler = {k: torch.from_numpy(v.copy()) for k, v in self.sampler_state._asdict().items()}
        return {
            "encoder": host(self.model.state_dict()),
            "opt_encoder": self._reference_adam_state(host),
            "ep": int(epoch),
            "total_it": self.step,
            "feat_encoder": host(self.feat_model.state_dict()),
            "sampler_state": sampler,
        }

    def load_state_dict(self, state: dict) -> None:
        """Restore `state_dict`'s output, or a reference ``latest.tar`` dict
        (without the port's own keys, which then stay as they are); then
        `reset_caches`."""
        load_reference_state_dict(self.model, state["encoder"])
        if state.get("feat_encoder") is not None:
            self.feat_model.load_state_dict(state["feat_encoder"], strict=True)
        opt = state.get("opt_encoder")
        if opt and opt.get("state"):
            self.optimizer.adam.load_state_dict(self._port_adam_state(opt))
        self.step = int(state.get("total_it", 0))
        if state.get("sampler_state") is not None and self.sampler_state is not None:
            self.sampler_state = ts.SamplerState(
                **{k: v.numpy().copy() for k, v in state["sampler_state"].items()})
        self.reset_caches()

    def _trainable_positions(self) -> list[int]:
        """The positions, among every parameter in registration order (the
        reference's ``param_groups[0]["params"]``), of the parameters the
        optimizer owns (`ClippedAdam` keeps them in that order)."""
        return [i for i, p in enumerate(self.model.parameters()) if p.requires_grad]

    def _reference_adam_state(self, host) -> dict:
        sd = self.optimizer.adam.state_dict()
        pos = self._trainable_positions()
        n = sum(1 for _ in self.model.parameters())
        return {
            "state": {pos[i]: host(st) for i, st in sd["state"].items()},
            "param_groups": [dict(g, params=list(range(n))) for g in sd["param_groups"]],
        }

    def _port_adam_state(self, opt: dict) -> dict:
        index = {p: i for i, p in enumerate(self._trainable_positions())}
        state = {index[int(p)]: st for p, st in opt["state"].items() if int(p) in index}
        groups = [dict(g, params=list(range(len(index)))) for g in opt["param_groups"]]
        return {"state": state, "param_groups": groups}

    @torch.no_grad()
    def _build_feat_pack(self) -> None:
        """The frozen ST-GCN's packed weights for K7, built outside the step
        as JAX `_feat_pack` does, and again when new ST-GCN weights load
        (JAX `reset_caches`); None on the plain path."""
        tc = self.cfg.train
        self.feat_pack = (
            pack_frozen_stgcn(self.feat_model, getattr(torch, self.cfg.denoiser.compute_dtype))
            if tc.feat_impl == "pallas" and tc.lambda_feat != 0.0 else None
        )

    @torch.no_grad()
    def _build_sampling_pack(self) -> None:
        """Weight-only constants of a serving call: the full time-embedding
        ladder, the fused denoiser's banks and the folded encoder."""
        d = self.cfg.denoiser
        self.temb_table = self.model.time_embed_table(self.cfg.diffusion.steps)
        self.fused = FusedDenoiser(self.model, self.cfg) if d.layer_impl == "pallas_fused" else None
        self.fused_encoder = (
            FusedMusicEncoder(self.model.music_encoder, getattr(torch, d.compute_dtype))
            if d.music_encoder_impl == "pallas" else None
        )
        self._pack_stale = False

    @torch.no_grad()
    @full_float32()
    def generate(
        self,
        mel,
        *,
        num_steps: int | None = None,
        noise: torch.Tensor | None = None,
        generator: torch.Generator | None = None,
        guidance_scale: float = 1.0,
        sampler: str = "ddim",
    ) -> torch.Tensor:
        """mel (B, T90, 128) -> motion (B, T30, 26).  x_T is ``noise`` if
        given, else drawn from ``generator``."""
        if guidance_scale != 1.0:
            raise NotImplementedError("classifier-free guidance is not ported yet")
        if self._pack_stale:  # the weights moved since the pack was built
            self._build_sampling_pack()
        if sampler != "ddim":
            raise NotImplementedError(f"sampler {sampler!r} is not ported yet (ddim only)")
        ds = self.cfg.dataset
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        if mel.ndim != 3 or mel.shape[-1] != ds.mel_bins:
            raise ValueError(
                f"mel must be (B, T90, {ds.mel_bins}) — got {tuple(mel.shape)}. "
                "Extract features with conductor_tpu.data.mel.extract_mel_feature "
                f"(n_mels={ds.mel_bins})."
            )
        steps = self.cfg.diffusion.steps
        if num_steps is not None and num_steps < steps:
            sched = respaced_schedule(
                self.cfg.diffusion.schedule, steps, space_timesteps(steps, f"ddim{num_steps}")
            )
        else:
            sched = self.sched

        if self.fused_encoder is not None:
            xf_proj, xf_out = self.model.cond_from_features(self.fused_encoder(mel))
        else:
            xf_proj, xf_out = self.model.encode_music(mel)
        cond = dict(self.model.precompute_cond(xf_proj, xf_out), temb_table=self.temb_table)
        shape = (xf_proj.shape[0], xf_proj.shape[1], self.cfg.denoiser.input_feats)
        if noise is None:
            gen_device = generator.device if generator is not None else self.device
            noise = torch.randn(shape, generator=generator, device=gen_device)
        elif tuple(noise.shape) != shape:
            raise ValueError(f"noise must have shape {shape}, got {tuple(noise.shape)}")
        noise = noise.to(self.device, torch.float32)

        if self.fused is not None:
            return self.fused.ddim_sample(self.fused.prepare_cond(cond), sched, noise)

        def model_fn(x, t):
            return self.model.denoise(x, t, cond)

        return ddim_sample_loop(sched, model_fn, noise)

    @torch.no_grad()
    @full_float32()
    def music_features(self, mel) -> torch.Tensor:
        """The frozen encoder's features (B, T30, 64) of mel (B, T90, 128),
        as a step from mel computes them: the plain `MusicEncoder` in the
        compute dtype (what the feature cache holds, as JAX's CLI encodes
        with `encode_music`, `conductor_tpu/cli/train.py:184-189`)."""
        mel = torch.as_tensor(mel, dtype=torch.float32, device=self.device)
        return self.model.encode_music(mel)[1]

    # ------------------------------------------------------------ training

    def training_terms(self, xf_proj, xf_out, motion, t, noise,
                       src_mask: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
        """`training_losses` of the denoiser on this trainer's layer path,
        given the music condition: the loss terms and the flat ``pred`` /
        ``target`` (B, T, 26) that the perceptual term takes.  ``src_mask``
        (B, T, 1) float32 is the plain layers' key mask (all ones by
        default); the fused layers take the full window only."""
        if self.cfg.denoiser.train_layer_impl == "pallas_fused":
            def model_fn(x, tt):
                return fused_train_denoise(self.model, self.cfg, x, tt, xf_proj, xf_out)
        else:
            def model_fn(x, tt):
                return self.model(x, tt, xf_proj, xf_out, src_mask)
        d = self.cfg.diffusion
        return training_losses(self.train_sched, model_fn, motion, t, noise.reshape(motion.shape),
                               mean_type=d.mean_type, var_type=d.var_type, loss_type=d.loss_type)

    def perceptual_loss(self, pred, target) -> torch.Tensor:
        """Mean |ST-GCN(pred) - ST-GCN(target)| over the frozen encoder's
        latents, for motion (B, T, J, 2): on K7 with ``feat_impl ==
        "pallas"`` (the target takes no gradient, as in JAX), else on the
        plain module."""
        if self.cfg.train.feat_impl == "pallas":
            mxu = getattr(torch, self.cfg.denoiser.compute_dtype)
            feat_fake = fused_frozen_stgcn(pred, self.feat_pack, mxu)
            feat_real = fused_frozen_stgcn(target.detach(), self.feat_pack, mxu)
        else:
            feat_fake, feat_real = self.feat_model(pred), self.feat_model(target)
        return (feat_fake - feat_real).abs().mean()

    def _losses(self, cond, motion, m_lens, t, noise, cond_keep, generator):
        """The 5-term objective (`conductor_tpu/train/ddpm_trainer.py:
        190-298`) and its metrics."""
        b, n = motion.shape[0], motion.shape[1]
        tc = self.cfg.train
        encode = self.model.cond_from_features if tc.cached_features else self.model.encode_music
        xf_proj, xf_out = encode(cond, True, keep=cond_keep, generator=generator)
        # the reference's mask (`:206-210`): the first min(T, m_lens) frames
        cur_len = torch.clamp(m_lens, max=n) if tc.replicate_reference_mask else torch.full_like(m_lens, n)
        src_mask = (torch.arange(n, device=motion.device)[None] < cur_len[:, None]).float()[..., None]
        terms = self.training_terms(xf_proj, xf_out, motion, t, noise, src_mask)
        target, pred = terms["target"], terms["pred"]
        mask2d = src_mask[..., 0]
        loss_rec = (((pred - target) ** 2).mean(dim=-1) * mask2d).sum() / mask2d.sum()
        if tc.lambda_feat == 0.0:
            loss_feat = torch.zeros((), device=pred.device)
        else:
            j = self.cfg.dataset.n_joints
            loss_feat = self.perceptual_loss(pred.reshape(b, n, j, -1), target.reshape(b, n, j, -1))
        loss_elbow = terms["velocity_elbow"].clamp(-tc.elbow_clamp, tc.elbow_clamp)
        loss = (tc.lambda_rec * loss_rec + tc.lambda_feat * loss_feat
                + tc.lambda_velocity * terms["velocity"] - tc.lambda_elbow * loss_elbow
                + tc.lambda_head * terms["velocity_head"])
        metrics = {
            "loss": loss,
            "loss_mot_rec": loss_rec,
            # NaN, not a fake 0, when the term is skipped (as in JAX)
            "loss_mot_feat": torch.full((), float("nan")) if tc.lambda_feat == 0.0 else loss_feat,
            "loss_velocity": terms["velocity"],
            "loss_elbow": loss_elbow,
            "loss_head": terms["velocity_head"],
            "loss_body": terms["velocity_body"],
            "mse_per_sample": terms["mse"],  # the sampler's input, not a metric
        }
        return loss, metrics

    @full_float32()
    def train_step(self, mel_or_feats, motion, m_lens=None, *, t=None, noise=None, cond_keep=None,
                   generator: torch.Generator | None = None) -> dict[str, torch.Tensor]:
        """One optimizer step on a batch: ``mel_or_feats`` is mel (B, T90,
        128), or frozen-encoder features (B, T30, 64) with
        ``cached_features``; ``motion`` (B, T30, J, 2).  ``m_lens`` (B,),
        the clips' lengths, is needed with ``replicate_reference_mask`` and
        ignored without (the full window).  The timesteps ``t`` (B,), the
        noise (B, T30, J * 2) and the (B, T30) condition keep mask are drawn
        unless given, from ``generator`` or else from `_step_generator`; t
        by the timestep sampler.  Returns the JAX metrics as 0-d tensors (no
        host sync but the loss-second-moment sampler's update)."""
        dev = self.device
        if generator is None:
            generator = self._step_generator()

        def on_device(a, dtype):  # a copy of host arrays, which may be read-only
            return (a if torch.is_tensor(a) else torch.tensor(np.asarray(a))).to(dev, dtype)

        motion = on_device(motion, torch.float32)
        cond = on_device(mel_or_feats, torch.float32)
        b, n = motion.shape[0], motion.shape[1]
        if m_lens is None:
            if self.cfg.train.replicate_reference_mask:
                raise ValueError("replicate_reference_mask needs m_lens, the clips' lengths")
            m_lens = torch.full((b,), n)
        m_lens = on_device(m_lens, torch.long)
        if t is None and self.sampler_state is not None:
            t, _ = ts.loss_aware_sample(self.sampler_state, b, generator=generator)
        elif t is None:
            t, _ = uniform_sample(self.sched.num_timesteps, b, generator=generator)
        if noise is None:
            noise = torch.randn((b, n, motion[0, 0].numel()), generator=generator,
                                device=generator.device)
        t = on_device(t, torch.long)
        noise = on_device(noise, torch.float32)
        if cond_keep is not None:
            cond_keep = on_device(cond_keep, torch.float32)
        loss, metrics = self._losses(cond, motion, m_lens, t, noise, cond_keep, generator)
        loss.backward()
        metrics["grad_norm"] = self.optimizer.step()
        self._pack_stale = True
        self.step += 1
        mse = metrics.pop("mse_per_sample")
        if self.sampler_state is not None:
            self.sampler_state = ts.update_state(self.sampler_state, t.cpu().numpy(),
                                                 mse.detach().cpu().numpy())
        return {k: v.detach() for k, v in metrics.items()}


def require_device(device: torch.device | str) -> torch.device:
    """``device`` as a `torch.device`; raises for CUDA without a card (no
    silent fallback to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA device was asked for but torch.cuda.is_available() is False")
    return device


def _check_training_config(cfg: Config, device: torch.device | str) -> None:
    """Raise on the training options the port does not run on ``device``:
    the gating of the fused layers (`conductor_tpu/train/ddpm_trainer.py:
    119-125`), the ST-GCN kernel's bf16 operands on CUDA, and the modes not
    ported yet (denoiser dropout among them)."""
    d, tc = cfg.denoiser, cfg.train
    if d.train_layer_impl not in ("flax", "pallas_fused"):
        raise ValueError(f"unknown train_layer_impl: {d.train_layer_impl}")
    if d.train_layer_impl == "pallas_fused" and (
        not d.efficient_attention or d.dropout != 0.0 or tc.replicate_reference_mask
    ):
        raise ValueError("train_layer_impl='pallas_fused' needs linear attention, dropout 0 and "
                         "the full src_mask (replicate_reference_mask off)")
    if tc.feat_impl not in ("flax", "pallas"):
        raise ValueError(f"unknown feat_impl: {tc.feat_impl}")
    if (tc.feat_impl == "pallas" and torch.device(device).type == "cuda"
            and d.compute_dtype != "bfloat16"):
        raise ValueError("feat_impl='pallas' on CUDA runs the ST-GCN kernel, which takes bf16 "
                         f"operands; compute_dtype is {d.compute_dtype}")
    if tc.timestep_sampler not in ("uniform", "loss-second-moment"):
        raise ValueError(f"unknown timestep sampler: {tc.timestep_sampler}")
    if d.dropout != 0.0:
        raise NotImplementedError("denoiser dropout is not ported (the default is 0)")
    if cfg.diffusion.loss_type not in ("mse", "rescaled_mse"):
        raise NotImplementedError(f"loss_type {cfg.diffusion.loss_type!r} is not ported")
