"""Timestep samplers for training.

Port of `conductor_tpu/diffusion/timestep_samplers.py:35`: the uniform
sampler, on a `torch.Generator`.  The loss-second-moment importance sampler
is not ported yet and raises.
"""

from __future__ import annotations

import torch


def uniform_sample(num_timesteps: int, batch: int, *, generator: torch.Generator | None = None):
    """Uniform t in [0, num_timesteps) and unit weights, both (batch,), on
    the generator's device."""
    device = generator.device if generator is not None else "cpu"
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


def loss_aware_sample(*args, **kwargs):
    raise NotImplementedError("the loss-second-moment timestep sampler is not ported yet")
