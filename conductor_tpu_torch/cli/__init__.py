"""Command-line entry points: `train` (stage 2), `train_m2snet` and
`train_m2sgan` (stage 1), serving: `visualize` (one track) and
`test_unseen` (a directory of tracks), evaluation: `evaluate`,
`evaluate_protocol` and `serving_delta_ci`, and the reference's
checkpoints in and out: `import_torch` and `export_torch`."""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch
import torch.distributed as dist

from ..parallel.mesh import ENV_KEYS, Mesh, init_from_env, shutdown


def training_device(name: str, task: str = "training") -> torch.device:
    """The device a CLI runs on: ``name`` (``--device``), and of several
    cards only the first, since the CLIs run on one device."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} CUDA devices: {task} on cuda:0 only "
              "(one device; no data parallelism)")
    return device


@contextmanager
def run_mesh(name: str, backend: str | None = None, task: str = "training"):
    """(mesh, device) of a CLI run: under torchrun (its ``RANK`` /
    ``WORLD_SIZE`` / ``LOCAL_RANK`` set) the group `parallel.init_from_env`
    joins over ``backend`` and this rank's device, left on exit if this
    call joined it; otherwise one process on `training_device`."""
    if not any(k in os.environ for k in ENV_KEYS):
        yield Mesh(), training_device(name, task)
        return
    joined = not dist.is_initialized()
    mesh, device = init_from_env(backend, name)
    try:
        yield mesh, device
    finally:
        if joined:
            shutdown(mesh)
