"""Timestep samplers for training.

Port of `conductor_tpu/diffusion/timestep_samplers.py`: the uniform
sampler on a `torch.Generator`, and the loss-second-moment importance
sampler (`LossSecondMomentResampler`, reference
`Diffusion_Stage/models/gaussian_diffusion.py:122-152`).  The latter's
state is a (num_timesteps, 10) float32 ring of recent losses per timestep
and their counts, kept on the host in numpy: it is updated once a step
from the step's per-sample MSE, in batch order, so that repeated
timesteps shift their ring in order (`update_state`, exact against JAX).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


def uniform_sample(num_timesteps: int, batch: int, *, generator: torch.Generator | None = None):
    """Uniform t in [0, num_timesteps) and unit weights, both (batch,), on
    the generator's device."""
    device = generator.device if generator is not None else "cpu"
    t = torch.randint(0, num_timesteps, (batch,), generator=generator, device=device)
    return t, torch.ones((batch,), dtype=torch.float32, device=device)


class SamplerState(NamedTuple):
    """Loss-history ring per timestep (JAX `SamplerState`)."""

    loss_history: np.ndarray  # (num_timesteps, history_per_term) float32
    loss_counts: np.ndarray   # (num_timesteps,) int32


def init_state(num_timesteps: int, history_per_term: int = 10) -> SamplerState:
    return SamplerState(np.zeros((num_timesteps, history_per_term), np.float32),
                        np.zeros((num_timesteps,), np.int32))


def _weights(state: SamplerState, uniform_prob: float) -> np.ndarray:
    """Sampling probabilities from the loss second moments, float32: uniform
    until every timestep has a full history, then sqrt(mean(loss²))
    normalised and mixed with ``uniform_prob`` of the uniform
    (`gaussian_diffusion.py:132-139`)."""
    hist = state.loss_history
    n, history_per_term = hist.shape
    if not (state.loss_counts == history_per_term).all():
        return np.full((n,), 1.0 / n, np.float32)
    w = np.sqrt(np.mean(hist ** 2, axis=-1, dtype=np.float32))
    w = w / np.maximum(np.sum(w, dtype=np.float32), np.float32(1e-12))
    return (w * np.float32(1 - uniform_prob) + np.float32(uniform_prob / n)).astype(np.float32)


def loss_aware_sample(state: SamplerState, batch: int, *, generator: torch.Generator | None = None,
                      uniform_prob: float = 0.001):
    """t (batch,) drawn from `_weights` on the generator's device, and the
    unbiasing weights 1 / (N p[t]) (`ScheduleSampler.sample`,
    `gaussian_diffusion.py:47-62`).  The trainer, as JAX's, uses t only."""
    p = torch.from_numpy(_weights(state, uniform_prob).astype(np.float64))
    device = generator.device if generator is not None else "cpu"
    t = torch.multinomial(p.to(device), batch, replacement=True, generator=generator)
    return t, (1.0 / (p.shape[0] * p.to(device)[t])).float()


def update_state(state: SamplerState, t, losses) -> SamplerState:
    """Append the (t, loss) pairs to the rings, one after the other
    (`update_with_all_losses`, `gaussian_diffusion.py:141-149`): a ring
    with room takes the loss at its count, a full one drops its oldest."""
    hist, counts = state.loss_history.copy(), state.loss_counts.copy()
    history_per_term = hist.shape[1]
    for ti, li in zip(np.asarray(t).tolist(), np.asarray(losses, np.float32)):
        if counts[ti] == history_per_term:
            hist[ti, :-1] = hist[ti, 1:].copy()
            hist[ti, -1] = li
        else:
            hist[ti, counts[ti]] = li
            counts[ti] += 1
    return SamplerState(hist, counts)
