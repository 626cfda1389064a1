"""Analytic FLOP counts of the hot surfaces, for MFU on the H100.

The port's counterpart of `conductor_tpu/utils/flops.py`, with the same
counts: one denoiser forward (one sampling step) is, per layer, the AdaLN
modulation product (T, E) @ (E, 6D) (int8 in bench.py's config), twelve
(T, D) @ (D, D) products (self q / k / v, the two segment-softmax
normalizers, the KV contraction, q_sm @ kv, cross q, qc_sm @ kvc and the
three stylization output projections) and the FFN pair; the per-ladder
one-offs (music encoding, the prologue / epilogue, the joint embed and the
output head) are under 1 % of a 1000-step ladder and not counted, so MFU
is a slight underestimate.

The peaks are one H100's (`kernel_checks`: 989 TFLOP/s bf16, 1,979 TOP/s
int8, 67 TFLOP/s float32 outside the tensor cores; the data sheet's, at
700 W), not JAX's TPU peaks.  MFU is ``ideal_seconds / measured_seconds``,
each product priced at the peak of the precision it runs at: the AdaLN
product at the int8 peak in the int8 mode, the rest at the compute
dtype's (bf16, or float32 for a float32 config, which JAX's counts do not
have).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..kernel_checks import BF16_FLOPS, F32_FLOPS, INT8_OPS


@dataclass(frozen=True)
class StepFlops:
    adaln: float  # the AdaLN modulation products' FLOPs (int8-eligible)
    other: float  # everything else

    @property
    def total(self) -> float:
        return self.adaln + self.other

    def ideal_seconds(self, *, adaln_int8: bool, float32: bool = False) -> float:
        peak = F32_FLOPS if float32 else BF16_FLOPS
        return self.adaln / (INT8_OPS if adaln_int8 else peak) + self.other / peak


def denoiser_forward_flops(cfg, batch: int, t30: int) -> StepFlops:
    """Matmul FLOPs of one denoiser forward (one sampling step) at
    ``batch`` x ``t30`` motion frames, from the config's widths."""
    d = cfg.denoiser.latent_dim
    e = cfg.denoiser.time_embed_dim
    f = cfg.denoiser.ff_size
    layers = cfg.denoiser.num_layers
    per_layer_adaln = 2.0 * t30 * e * (6 * d)
    per_layer_other = 2.0 * t30 * (12 * d * d + 2 * d * f)
    return StepFlops(adaln=batch * layers * per_layer_adaln,
                     other=batch * layers * per_layer_other)


def sampling_mfu(cfg, batch: int, t30: int, steps: int, seconds: float, *,
                 adaln_int8: bool | None = None) -> dict:
    """{'achieved_tflops', 'mfu_pct'} of a measured ladder: TFLOP/s a card,
    and the MFU with the int8 AdaLN priced at the int8 peak, so that the
    quantization cannot inflate it."""
    if adaln_int8 is None:
        adaln_int8 = bool(getattr(cfg.denoiser, "sampler_adaln_int8", False))
    per_step = denoiser_forward_flops(cfg, batch, t30)
    total = per_step.total * steps
    f32 = cfg.denoiser.compute_dtype == "float32"
    ideal = per_step.ideal_seconds(adaln_int8=adaln_int8, float32=f32) * steps
    return {
        "achieved_tflops": round(total / seconds / 1e12, 1),
        "mfu_pct": round(100.0 * ideal / seconds, 1),
    }


def train_step_mfu(cfg, batch: int, t30: int, seconds: float) -> dict:
    """MFU of a stage-2 training step: forward + backward = 3x the
    denoiser's forward FLOPs (the frozen perceptual ST-GCN and the loss
    terms are left out, so the estimate errs low)."""
    fwd = denoiser_forward_flops(cfg, batch, t30)
    total = 3.0 * fwd.total
    ideal = 3.0 * fwd.ideal_seconds(adaln_int8=False,
                                    float32=cfg.denoiser.compute_dtype == "float32")
    return {
        "achieved_tflops": round(total / seconds / 1e12, 1),
        "mfu_pct": round(100.0 * ideal / seconds, 1),
    }
