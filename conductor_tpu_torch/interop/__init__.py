"""Reference-format weights into the port's modules."""

from .synth import synth_state_dict  # noqa: F401
from .weights import (  # noqa: F401
    load_m2snet_state_dict,
    load_motion_encoder_state_dict,
    load_reference_state_dict,
    manifest,
    reference_state_dict,
    synthetic_m2snet_state_dict,
    synthetic_motion_encoder_state_dict,
    synthetic_state_dict,
)
