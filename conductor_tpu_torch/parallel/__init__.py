"""Data parallelism over `torch.distributed` (`mesh`) and the linear
attention over a time-sharded sequence (`context`): the counterparts of
`conductor_tpu/parallel/`."""

from .context import cp_linear_attention  # noqa: F401
from .mesh import Mesh, init_from_env, pad_to_multiple, shutdown  # noqa: F401
