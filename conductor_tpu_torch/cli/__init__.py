"""Command-line entry points: `train` (stage 2), `train_m2snet` and
`train_m2sgan` (stage 1), serving: `visualize` (one track) and
`test_unseen` (a directory of tracks), and evaluation: `evaluate`,
`evaluate_protocol` and `serving_delta_ci`."""

from __future__ import annotations

import torch


def training_device(name: str, task: str = "training") -> torch.device:
    """The device a CLI runs on: ``name`` (``--device``), and of several
    cards only the first, since the CLIs run on one device."""
    device = torch.device(name)
    if device.type == "cuda" and device.index is None and torch.cuda.device_count() > 1:
        device = torch.device("cuda:0")
        print(f"{torch.cuda.device_count()} CUDA devices: {task} on cuda:0 only "
              "(one device; no data parallelism)")
    return device
