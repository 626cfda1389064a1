"""The text-to-motion (HumanML3D / KIT) stack inherited from MotionDiffuse,
on PyTorch (the port of `conductor_tpu/t2m/`).

Quaternion algebra, the FK / IK skeleton, the RIC feature extraction and
recovery, the kinematic chains, the GloVe word vectorizer, the dataset,
3-D plotting (`plot_3d`, imported on its own, as in JAX) and the BiGRU
co-embedding evaluator with the reference's key names.  The tensor
functions compute where their input lives; the numpy-in preprocessing and
the evaluator run on the card unless the caller asks for the CPU.
"""

from . import param_util, quaternion  # noqa: F401
from .motion_process import (  # noqa: F401
    extract_ric_features,
    recover_from_ric,
    recover_from_rot,
    recover_root_rot_pos,
)
from .skeleton import Skeleton  # noqa: F401
from .word_vectorizer import POS_ENUMERATOR, WordVectorizer  # noqa: F401
