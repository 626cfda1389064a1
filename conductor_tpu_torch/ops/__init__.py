"""Plain ops and the wrappers of the port's CUDA kernels.

Each kernel wrapper keeps a plain integer ``launches`` count, raised by one
each time it launches its kernel on a CUDA tensor (never on the plain CPU
path).  `launch_counts` / `reset_launch_counts` read and clear them.
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
from .decoder_stack import fused_decoder_stack  # noqa: F401
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

KERNELS = {
    "decoder_stack": fused_decoder_stack,
    "sampler_prologue": sampler_prologue,
    "sampler_epilogue": sampler_epilogue,
    "conv_block": fused_conv_block,
    "decoder_layer": fused_decoder_layer,
    "decoder_layer_bwd": decoder_layer_bwd,
    "stgcn_forward": stgcn_forward,
    "stgcn_backward": stgcn_backward,
    "conv3x3_dkernel": conv3x3_dkernel,
    "max_pool": fused_max_pool,
    "max_pool_bwd": max_pool_bwd,
    "linear_attention": linear_attention_kernel,
}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in KERNELS.items()}


def reset_launch_counts() -> None:
    for fn in KERNELS.values():
        fn.launches = 0
