"""Reference-format weights into the port's modules."""

from .weights import (  # noqa: F401
    load_motion_encoder_state_dict,
    load_reference_state_dict,
    manifest,
    reference_state_dict,
    synthetic_motion_encoder_state_dict,
    synthetic_state_dict,
)
