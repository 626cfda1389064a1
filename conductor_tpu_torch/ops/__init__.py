"""Plain ops and the wrappers of the port's CUDA kernels.

Each kernel wrapper keeps a plain integer ``launches`` count, raised by one
each time it launches its kernel on a CUDA tensor (never on the plain CPU
path); K1 and K2 keep one more for each opt-in mode (``launches_int8``,
``launches_vpu_bf16``), K1-K7 and K9-K11 one for their float32 mode
(``launches_f32``; K1 also ``launches_f32_int8`` and
``launches_f32_vpu_bf16``, K2 ``launches_f32_int8``), each launch counted
in one mode's count only (but K1 with both int8 AdaLN and bf16 VPU,
counted in both).
`launch_counts` / `reset_launch_counts` read and clear them.
A kernel that K1, K5 and K6 launch as one of their parts, the AdaLN GEMM, keeps
its own count of launches, as the C entry points that launch it report
them, which `part_launch_counts` reads.
"""

from .attention import fused_linear_attention, linear_attention_kernel  # noqa: F401
from .conv_block import fold_bn, fused_conv_block  # noqa: F401
from .conv_train import conv3x3_dkernel, conv3x3_train  # noqa: F401
from .decoder_layer import decoder_layer_plain, fused_decoder_layer  # noqa: F401
from .decoder_layer_bwd import (  # noqa: F401
    decoder_layer_bwd,
    decoder_layer_bwd_plain,
    fused_decoder_layer_train,
)
from .decoder_stack import adaln_modulation, fused_decoder_stack, quantize_rows  # noqa: F401
from .linear_attention import linear_attention, qk_softmax, temporal_linear_attention  # noqa: F401
from .max_pool import fused_max_pool, max_pool_bwd, max_pool_train  # noqa: F401
from .sampler_glue import ddim_affine_tables, sampler_epilogue, sampler_prologue  # noqa: F401
from .stgcn import (  # noqa: F401
    frozen_stgcn_plain,
    fused_frozen_stgcn,
    pack_frozen_stgcn,
    stgcn_backward,
    stgcn_forward,
)

# count name -> (wrapper, attribute): one count per kernel and per mode
KERNELS = {
    "decoder_stack": (fused_decoder_stack, "launches"),
    "decoder_stack_int8": (fused_decoder_stack, "launches_int8"),
    "decoder_stack_vpu_bf16": (fused_decoder_stack, "launches_vpu_bf16"),
    "sampler_prologue": (sampler_prologue, "launches"),
    "sampler_prologue_int8": (sampler_prologue, "launches_int8"),
    "sampler_epilogue": (sampler_epilogue, "launches"),
    "conv_block": (fused_conv_block, "launches"),
    "decoder_layer": (fused_decoder_layer, "launches"),
    "decoder_layer_bwd": (decoder_layer_bwd, "launches"),
    "stgcn_forward": (stgcn_forward, "launches"),
    "stgcn_backward": (stgcn_backward, "launches"),
    "conv3x3_dkernel": (conv3x3_dkernel, "launches"),
    "max_pool": (fused_max_pool, "launches"),
    "max_pool_bwd": (max_pool_bwd, "launches"),
    "linear_attention": (linear_attention_kernel, "launches"),
    "conv_block_f32": (fused_conv_block, "launches_f32"),
    "conv3x3_dkernel_f32": (conv3x3_dkernel, "launches_f32"),
    "max_pool_f32": (fused_max_pool, "launches_f32"),
    "max_pool_bwd_f32": (max_pool_bwd, "launches_f32"),
    "decoder_stack_f32": (fused_decoder_stack, "launches_f32"),
    "decoder_stack_f32_int8": (fused_decoder_stack, "launches_f32_int8"),
    "decoder_stack_f32_vpu_bf16": (fused_decoder_stack, "launches_f32_vpu_bf16"),
    "sampler_prologue_f32": (sampler_prologue, "launches_f32"),
    "sampler_prologue_f32_int8": (sampler_prologue, "launches_f32_int8"),
    "sampler_epilogue_f32": (sampler_epilogue, "launches_f32"),
    "decoder_layer_f32": (fused_decoder_layer, "launches_f32"),
    "decoder_layer_bwd_f32": (decoder_layer_bwd, "launches_f32"),
    "stgcn_forward_f32": (stgcn_forward, "launches_f32"),
    "stgcn_backward_f32": (stgcn_backward, "launches_f32"),
}
# count name -> (wrapper, attribute) of the kernels launched as parts of others
PARTS = {
    "adaln_modulation": (adaln_modulation, "launches"),
    "adaln_modulation_f32": (adaln_modulation, "launches_f32"),
}


def launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in KERNELS.items()}


def part_launch_counts() -> dict[str, int]:
    return {name: getattr(fn, attr) for name, (fn, attr) in PARTS.items()}


def reset_launch_counts() -> None:
    for fn, attr in (*KERNELS.values(), *PARTS.values()):
        setattr(fn, attr, 0)
