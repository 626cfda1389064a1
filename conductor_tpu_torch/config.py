"""Configuration for the PyTorch port.

The dataclasses and their JSON format are a copy of the JAX package's
(`conductor_tpu/config.py:20-160, 223-284`), field for field and default for
default, so a config saved by either package loads in the other
(`tests/test_torch_port_config.py`).  The port keeps its own copy: it
imports nothing of the JAX package.  Only the resolution of the "auto"
implementation knobs is the port's: on a CUDA device "auto" selects the
hand-written kernels and bf16 matmul operands, anywhere else the plain
PyTorch modules in float32.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any

import torch


@dataclass(frozen=True)
class DatasetSpec:
    """ConductorMotion100 constants (reference `README.md:53-84`)."""

    name: str = "ConductorMotion100"
    n_joints: int = 13          # MOCO upper-body keypoints
    joint_dim: int = 2          # 2-D keypoints in [0, 1]
    mel_bins: int = 128         # mel-spectrogram frequency bins
    mel_hz: int = 90            # mel frames per second
    motion_hz: int = 30         # motion frames per second
    clip_seconds: int = 60      # each dataset folder holds one 60-s clip
    max_motion_length: int = 1800  # 60 s * 30 Hz; denoiser sequence capacity

    @property
    def pose_dim(self) -> int:
        return self.n_joints * self.joint_dim  # 26

    @property
    def mel_per_motion(self) -> int:
        return self.mel_hz // self.motion_hz  # 3: 90 Hz mel -> 30 Hz motion


@dataclass(frozen=True)
class DenoiserConfig:
    """MotionTransformer hyperparameters.

    Defaults reproduce the reference training configuration
    (`Diffusion_Stage/options/train_options.py:7-8` latent 128 / 8 layers;
    `models/transformer.py:360-374` ff_size=64 and num_heads=8 are the
    constructor defaults, never overridden by `tools/train.py:20-29`).
    """

    input_feats: int = 26
    num_frames: int = 1800
    latent_dim: int = 128
    ff_size: int = 64
    num_layers: int = 8
    num_heads: int = 8
    dropout: float = 0.0
    cond_mask_prob: float = 0.1     # training-time condition dropout (`transformer.py:389`)
    music_latent_dim: int = 64      # MusicEncoder output width
    music_width: int = 512          # xf_proj / xf_out width after `linear` (`transformer.py:404`)
    efficient_attention: bool = True  # linear attention; False = quadratic (`--no_eff`)
    # Implementation knobs default to "auto": the TPU-first fast path on TPU
    # hardware, the portable XLA/flax path elsewhere (CPU tests, debugging).
    # `resolve_auto` maps them at trainer/CLI construction;
    # `Config.faithful()` pins every one to the reference-exact value.
    attention_impl: str = "auto"      # "auto" | "xla" | "pallas" (fused TPU kernel, ops/pallas_attention.py)
    compute_dtype: str = "auto"       # "auto" | "float32" | "bfloat16" — activation/matmul
                                      # dtype (params stay float32; MXU is 2x at bf16)
    adaln_mode: str = "sliced"        # "sliced" | "batched" AdaLN application (perf knob)
    layer_impl: str = "auto"          # "auto" | "flax" | "pallas_fused" — sampling-path layer
                                      # impl (fused whole-layer kernel, ops/pallas_layer.py)
    train_layer_impl: str = "auto"    # "auto" | "flax" | "pallas_fused" — training-path layer
                                      # impl (fused fwd + custom_vjp bwd kernels,
                                      # ops/pallas_layer_bwd.py; requires dropout=0,
                                      # efficient attention, full src_mask — "auto" falls
                                      # back to flax when those don't hold)
    music_encoder_impl: str = "auto"  # "auto" | "flax" | "pallas" — frozen-encoder impl for
                                      # generation/eval (fused conv kernels,
                                      # ops/pallas_conv.py; <2% feature drift at bf16)
    sampler_vpu_dtype: str = "float32"  # "float32" | "bfloat16" — elementwise/
                                      # transcendental dtype inside the fused
                                      # sampling kernels (softmax exps, silu,
                                      # gelu; LN stats + time softmax stay f32).
                                      # bf16 = opt-in serving fast path; see
                                      # tests/test_fused_denoiser.py bound
    sampler_adaln_int8: bool = False  # int8 MXU path for the AdaLN projection
                                      # inside the fused sampling kernels: the
                                      # (T,512)@(512,768) modulation matmul is
                                      # ~68% of the step FLOPs and v5e does
                                      # int8 at 2x bf16.  Weights quantized
                                      # per-column, activations per-row (once
                                      # per step, in the prologue kernel).
                                      # Opt-in serving fast path; drift bound
                                      # in tests/test_fused_denoiser.py

    @property
    def time_embed_dim(self) -> int:
        return self.latent_dim * 4  # `transformer.py:385`


@dataclass(frozen=True)
class DiffusionConfig:
    """Diffusion process settings (`trainers/ddpm_trainer.py:87-97`)."""

    steps: int = 1000
    schedule: str = "linear"         # "linear" | "cosine"
    mean_type: str = "start_x"       # "start_x" | "epsilon" | "previous_x"
    var_type: str = "fixed_small"    # "fixed_small" | "fixed_large" | "learned" | "learned_range"
    loss_type: str = "mse"           # "mse" | "rescaled_mse" | "kl" | "rescaled_kl"
    rescale_timesteps: bool = False


@dataclass(frozen=True)
class TrainConfig:
    """Stage-2 DDPM training recipe (`ddpm_trainer.py:223-277,324`,
    `options/train_options.py:14-17`)."""

    lr: float = 2e-4
    batch_size: int = 32
    num_epochs: int = 100
    grad_clip: float = 0.5
    sample_length: int = 30          # seconds per training window
    # Loss weights (`ddpm_trainer.py:252-258`)
    lambda_rec: float = 1.0
    lambda_feat: float = 1e-6
    lambda_velocity: float = 0.1
    lambda_elbow: float = 0.1
    lambda_head: float = 0.1
    elbow_clamp: float = 2e-4
    # The reference masks the reconstruction loss with m_lens=60 (seconds of the
    # *full* file), so for 30-s (900-frame) windows only the first 60 frames are
    # supervised (`datasets/dataset.py:448`, `ddpm_trainer.py:143,161-163`).
    # We treat that as a bug; default supervises the full window.  Set True to
    # replicate the reference byte-for-byte.
    replicate_reference_mask: bool = False
    timestep_sampler: str = "uniform"  # "uniform" | "loss-second-moment"
    # Train from precomputed frozen-encoder features (data/feature_cache.py):
    # the batch's conditioning slot carries (B, T30, 64) features instead of
    # raw mel.  Numerically identical; skips the HBM-bound CNN every step.
    cached_features: bool = False
    # Perceptual-loss ST-GCN implementation: "pallas" runs the frozen
    # encoder as single fused kernels fwd+bwd (ops/pallas_stgcn.py) instead
    # of ~60 composable-XLA HBM passes; same math (BN stats folded).
    # "auto": pallas on TPU, flax elsewhere (`resolve_auto`).
    feat_impl: str = "auto"          # "auto" | "flax" | "pallas"
    log_every: int = 5
    save_latest: int = 500
    save_every_e: int = 5
    seed: int = 19990319             # reference global seed (`M2SNet_train.py:21-23`)


@dataclass(frozen=True)
class MeshConfig:
    """Device-mesh layout for pjit/shard_map SPMD."""

    data_axis: str = "data"
    seq_axis: str = "seq"            # optional T-sharding escape hatch
    data_parallel: int = -1          # -1 = all devices
    seq_parallel: int = 1


def pin_faithful(cfg: "Config") -> "Config":
    """Pin an existing Config's implementation knobs to the reference-exact
    set (see `Config.faithful`), leaving model/training hyperparameters as
    given."""
    return cfg.replace(
        denoiser=dataclasses.replace(
            cfg.denoiser,
            attention_impl="xla",
            compute_dtype="float32",
            layer_impl="flax",
            train_layer_impl="flax",
            music_encoder_impl="flax",
            sampler_vpu_dtype="float32",
            sampler_adaln_int8=False,
        ),
        train=dataclasses.replace(cfg.train, feat_impl="flax"),
    )


@dataclass(frozen=True)
class Config:
    dataset: DatasetSpec = field(default_factory=DatasetSpec)
    denoiser: DenoiserConfig = field(default_factory=DenoiserConfig)
    diffusion: DiffusionConfig = field(default_factory=DiffusionConfig)
    train: TrainConfig = field(default_factory=TrainConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)

    @classmethod
    def faithful(cls, **sections: Any) -> "Config":
        """The reference-exact preset: every implementation knob pinned to
        the path that reproduces the reference's numerics bit-for-bit on any
        backend — flax/XLA modules, f32 activations, no fused kernels.  The
        "auto" defaults are the TPU-first fast configuration instead
        (parity-pinned, but bf16); use this preset (CLI: `--faithful`) for
        cross-framework comparisons and checkpoint-exact reproductions."""
        return pin_faithful(cls(**sections))

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_json(cls, text: str) -> "Config":
        raw = json.loads(text)
        return cls(
            dataset=DatasetSpec(**raw.get("dataset", {})),
            denoiser=DenoiserConfig(**raw.get("denoiser", {})),
            diffusion=DiffusionConfig(**raw.get("diffusion", {})),
            train=TrainConfig(**raw.get("train", {})),
            mesh=MeshConfig(**raw.get("mesh", {})),
        )

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            f.write(self.to_json())

    @classmethod
    def load(cls, path: str) -> "Config":
        with open(path) as f:
            return cls.from_json(f.read())

    def replace(self, **sections: Any) -> "Config":
        return dataclasses.replace(self, **sections)


# (denoiser field) -> (value on a CUDA device, value elsewhere), for the
# "auto" knobs the port reads.  The names are the shared config's:
# "pallas_fused" / "pallas" mean "the kernel path", which in this package is
# CUDA C++ (`conductor_tpu_torch/csrc/`).
_AUTO_FIELDS = {
    "attention_impl": ("pallas", "xla"),
    "compute_dtype": ("bfloat16", "float32"),
    "layer_impl": ("pallas_fused", "flax"),
    "train_layer_impl": ("pallas_fused", "flax"),
    "music_encoder_impl": ("pallas", "flax"),
}


def resolve_auto(cfg: Config, device: torch.device | str) -> Config:
    """Resolve the "auto" implementation knobs for ``device``.  Explicit
    values are kept as given.  As in the JAX package
    (`conductor_tpu/config.py:192-220`), "auto" falls back to the plain
    modules without linear attention (the kernels compute linear attention
    only: ``attention_impl`` "xla", the layers "flax"), and "auto" training
    layers fall back to the plain modules when dropout is on or the
    reference mask is replicated.  ``feat_impl`` "auto" is the ST-GCN
    kernel (K7, "pallas", in bf16 or float32, the compute dtype) on a CUDA
    device and the plain module ("flax") elsewhere.  Idempotent."""
    cuda = torch.device(device).type == "cuda"
    d = cfg.denoiser
    resolved = {
        k: (cuda_v if cuda else plain_v) if getattr(d, k) == "auto" else getattr(d, k)
        for k, (cuda_v, plain_v) in _AUTO_FIELDS.items()
    }
    if not d.efficient_attention:
        for k in ("attention_impl", "layer_impl", "train_layer_impl"):
            if getattr(d, k) == "auto":
                resolved[k] = "xla" if k == "attention_impl" else "flax"
    if d.train_layer_impl == "auto" and (d.dropout != 0.0 or cfg.train.replicate_reference_mask):
        resolved["train_layer_impl"] = "flax"
    feat = cfg.train.feat_impl
    if feat == "auto":
        feat = "pallas" if cuda else "flax"
    return cfg.replace(denoiser=dataclasses.replace(d, **resolved),
                       train=dataclasses.replace(cfg.train, feat_impl=feat))
