"""Reference-format weights into the port's modules."""

from .synth import synth_state_dict  # noqa: F401
from .weights import (  # noqa: F401
    load_discriminator_state_dict,
    load_generator_state_dict,
    load_m2snet_state_dict,
    load_motion_encoder_state_dict,
    load_music_encoder_from_m2snet,
    load_reference_state_dict,
    manifest,
    reference_state_dict,
    synthetic_discriminator_state_dict,
    synthetic_generator_state_dict,
    synthetic_m2snet_state_dict,
    synthetic_motion_encoder_state_dict,
    synthetic_state_dict,
)
