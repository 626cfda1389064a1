"""What a reference run needs beyond loading weights: its architecture and
config, and the reference's file formats on the way out.

The port's modules carry the reference's key names, so weights load as
they are (`interop.weights`).  What remains of JAX's
`conductor_tpu/interop/torch_import.py` / `torch_export.py` and its
`cli/import_torch.py` is here, in the port's own copy:

- `denoiser_config_from_state_dict`: the MotionTransformer's widths and
  depth read off its weights (`conductor_tpu/cli/import_torch.py:115-133`);
- `config_from_reference`: a `Config` from those widths and a run's
  ``opt.txt`` (`interop.opt_txt`), the recorded depth and width checked
  against the weights', then the training window clamped to the model's
  frames (`:135-188`);
- `save_torch_state_dict` / `save_diffusion_tar`: a ``.pt`` state dict and
  a stage-2 ``latest.tar`` (`conductor_tpu/interop/torch_export.py:
  240-284`).  The tar's ``opt_encoder`` is the caller's: the port's
  `DDPMTrainer.state_dict` already holds the Adam moments in the
  reference's registration order (since the stage-2 CLI was ported), so its
  export carries them, where JAX's exporter writes an empty Adam state.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

from ..config import Config, DenoiserConfig
from ..train.checkpoints import host_state_dict
from .weights import reference_state_dict


def denoiser_config_from_state_dict(sd, num_heads: int = 8) -> DenoiserConfig:
    """The architecture a MotionTransformer state dict implies (the head
    count leaves no trace in the shapes: pass the training value, 8 by
    default as in the reference, `transformer.py:367`)."""
    sd = reference_state_dict(sd)
    n_layers = 0
    while f"temporal_decoder_blocks.{n_layers}.sa_block.query.weight" in sd:
        n_layers += 1
    return DenoiserConfig(
        input_feats=sd["out.weight"].shape[0],
        num_frames=sd["sequence_embedding"].shape[0],
        latent_dim=sd["joint_embed.weight"].shape[0],
        ff_size=sd["temporal_decoder_blocks.0.ffn.linear1.weight"].shape[0],
        num_layers=n_layers,
        num_heads=num_heads,
    )


def config_from_reference(dcfg: DenoiserConfig, opt: Mapping | None = None) -> Config:
    """The run's `Config`: the weights' architecture ``dcfg``, then, with a
    run's ``opt.txt`` options, its attention kind, diffusion steps and
    training hyperparameters; raises ValueError where opt.txt's depth or
    width disagrees with the weights.  The training window is clamped to
    the model's frames (it matters only for checkpoints shorter than the
    reference's 1800 frames)."""
    cfg = Config(denoiser=dcfg)
    if opt is not None:
        for key, got in (("num_layers", dcfg.num_layers), ("latent_dim", dcfg.latent_dim)):
            want = opt.get(key)
            if want is not None and int(want) != got:
                raise ValueError(f"opt.txt says {key}={want} but the weights imply {got} — "
                                 "wrong checkpoint for this run dir?")
        tc = cfg.train
        cfg = cfg.replace(
            denoiser=dataclasses.replace(dcfg,
                                         efficient_attention=not bool(opt.get("no_eff", False))),
            diffusion=dataclasses.replace(cfg.diffusion,
                                          steps=int(opt.get("diffusion_steps", 1000))),
            train=dataclasses.replace(
                tc,
                lr=float(opt.get("lr", tc.lr)),
                batch_size=int(opt.get("batch_size", tc.batch_size)),
                num_epochs=int(opt.get("num_epochs", tc.num_epochs)),
                log_every=int(opt.get("log_every", tc.log_every)),
                save_latest=int(opt.get("save_latest", tc.save_latest)),
                save_every_e=int(opt.get("save_every_e", tc.save_every_e)),
            ),
        )
    max_seconds = cfg.denoiser.num_frames // cfg.dataset.motion_hz
    if cfg.train.sample_length > max_seconds:
        cfg = cfg.replace(train=dataclasses.replace(cfg.train, sample_length=max_seconds))
    return cfg


def save_torch_state_dict(path: str, sd: Mapping) -> None:
    """A ``.pt`` state-dict file of host tensors."""
    torch.save(host_state_dict(sd), path)


def save_diffusion_tar(path: str, encoder_sd: Mapping, opt_encoder: dict, ep: int = 0,
                       total_it: int = 0) -> None:
    """A stage-2 ``latest.tar`` that the reference's `DDPMTrainer.load`
    (`ddpm_trainer.py:303-319`) takes for evaluation (``encoder``) and to
    resume (``opt_encoder``, the port's Adam state in the reference's
    registration order)."""
    torch.save({
        "encoder": host_state_dict(encoder_sd),
        "opt_encoder": opt_encoder,
        "ep": int(ep),
        "total_it": int(total_it),
    }, path)
