"""The generic samplers: eta=0 DDIM and the ancestral (DDPM) ladder.

Port of `ddim_step`, `ancestral_step`, `ddim_sample_loop` and
`p_sample_loop` (`conductor_tpu/diffusion/sampling.py:43-195`) for eta=0
DDIM, the serving setting, and every mean type and fixed variance the
trainer takes: one Python loop over the ladder in place of the
`lax.scan`.  The random numbers are passed in or drawn from a
`torch.Generator` (JAX's random streams cannot be reproduced in torch):
x_T as ``noise``, and the ancestral ladder's per-step noise as
``step_noise`` (S, B, T, C) in ladder order (t = S-1 .. 0), or else drawn
step by step.  As in JAX, the last step (t = 0) adds its noise times zero.
These are the plain samplers the kernel ladder
(`train/fused_denoiser.FusedDenoiser.ddim_sample`) is checked against.
"""

from __future__ import annotations

import torch

from .gaussian import ModelFn, extract, p_mean_variance, predict_eps_from_xstart
from .schedule import DiffusionSchedule


def ddim_step(sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor, *,
              mean_type: str = "start_x", var_type: str = "fixed_small"):
    """One eta=0 DDIM update x_t -> x_{t-1}; returns (sample, pred_xstart)."""
    nd = x.ndim
    out = p_mean_variance(sched, model_fn, x, t, mean_type=mean_type, var_type=var_type)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
    sample = (
        out.pred_xstart * torch.sqrt(alpha_bar_prev)
        + torch.sqrt(1 - alpha_bar_prev) * eps
    )
    return sample, out.pred_xstart


def ancestral_step(sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
                   noise: torch.Tensor, *, mean_type: str = "start_x",
                   var_type: str = "fixed_small"):
    """One ancestral update: the posterior mean plus ``noise`` scaled by the
    variance's standard deviation, none at t = 0 (JAX `ancestral_step`);
    returns (sample, pred_xstart)."""
    out = p_mean_variance(sched, model_fn, x, t, mean_type=mean_type, var_type=var_type)
    nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (x.ndim - 1))
    sample = out.mean + nonzero * torch.exp(0.5 * out.log_variance) * noise
    return sample, out.pred_xstart


def _sample_loop(sched: DiffusionSchedule, step, noise: torch.Tensor,
                 return_trajectory: bool = False):
    x = noise
    traj = []
    for i, t_scalar in enumerate(range(sched.num_timesteps - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.long, device=x.device)
        x = step(x, t, i)
        if return_trajectory:
            traj.append(x)
    if return_trajectory:
        return x, torch.stack(traj)
    return x


def ddim_sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
    return_trajectory: bool = False,
):
    """The whole eta=0 ladder from x_T = ``noise``.  With
    ``return_trajectory`` also returns every x_{t-1}, stacked in ladder order
    (t = T-1 .. 0)."""
    sched = sched.to(noise.device)

    def step(x, t, _):
        return ddim_step(sched, model_fn, x, t, mean_type=mean_type, var_type=var_type)[0]

    return _sample_loop(sched, step, noise, return_trajectory)


def p_sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    step_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
):
    """The whole ancestral ladder from x_T = ``noise``: step i (t = S-1-i)
    adds ``step_noise[i]`` (``step_noise`` (S, *noise.shape)), or without
    it a standard normal drawn from ``generator`` (on its own device) at
    that step."""
    sched = sched.to(noise.device)
    s = sched.num_timesteps
    if step_noise is not None and tuple(step_noise.shape) != (s, *noise.shape):
        raise ValueError(f"step_noise must have shape {(s, *noise.shape)}, "
                         f"got {tuple(step_noise.shape)}")

    def step(x, t, i):
        if step_noise is not None:
            z = step_noise[i].to(x.device, x.dtype)
        else:
            gen_device = generator.device if generator is not None else x.device
            z = torch.randn(x.shape, generator=generator, device=gen_device).to(x.device, x.dtype)
        return ancestral_step(sched, model_fn, x, t, z, mean_type=mean_type,
                              var_type=var_type)[0]

    return _sample_loop(sched, step, noise)
