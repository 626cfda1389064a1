"""Motion post-processing and rendering (`motion`)."""

from .motion import (  # noqa: F401
    bandpass_motion,
    cm100_to_coco,
    coco_to_cm100,
    mux_audio,
    norm_motion,
    render_frame,
    render_motion_video,
    smooth_motion,
)
