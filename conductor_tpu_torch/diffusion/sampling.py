"""The generic samplers: DDIM (any eta) and the ancestral (DDPM) ladder.

Port of `ddim_step`, `ancestral_step`, `ddim_sample_loop` and
`p_sample_loop` (`conductor_tpu/diffusion/sampling.py:43-195`) for every
mean and variance type and any DDIM eta (0, the serving setting, draws
nothing): one Python loop over the ladder in place of the `lax.scan`.  The
random numbers are passed in or drawn from a `torch.Generator` (JAX's
random streams cannot be reproduced in torch): x_T as ``noise``; each
step's noise (the ancestral ladder's, and DDIM's for eta > 0) as
``step_noise`` (S, B, T, C) in ladder order (t = S-1 .. 0), JAX's
``fold_in(loop_rng, t)`` draws; and the inpainting clamp's as
``known_noise`` (S, B, T, C) in the same order, JAX's ``fold_in(loop_rng,
t + S)``; what is not given is drawn step by step, the clamp's before the
step's.  As in JAX, the last step (t = 0) adds its noise times zero.

Masked inpainting (`_sample_loop`'s ``known_mask`` / ``known_x0``, JAX's
generalisation of the reference's ``pre_seq`` / ``transl_req``,
`gaussian_diffusion.py:634-646`): before each step, where ``known_mask``
is true, x_t is replaced by a draw of q(x_t | known_x0).

These are the plain samplers the kernel ladder
(`train/fused_denoiser.FusedDenoiser.ddim_sample`, eta = 0) is checked
against.
"""

from __future__ import annotations

import torch

from .gaussian import ModelFn, extract, p_mean_variance, predict_eps_from_xstart, q_sample
from .schedule import DiffusionSchedule


def ddim_step(sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor,
              noise: torch.Tensor | None = None, *, eta: float = 0.0,
              mean_type: str = "start_x", var_type: str = "fixed_small"):
    """One DDIM update x_t -> x_{t-1} (`gaussian_diffusion.py:783-831`);
    with ``eta > 0`` it adds ``noise`` times sigma (none at t = 0).
    Returns (sample, pred_xstart)."""
    nd = x.ndim
    out = p_mean_variance(sched, model_fn, x, t, mean_type=mean_type, var_type=var_type)
    eps = predict_eps_from_xstart(sched, x, t, out.pred_xstart)
    alpha_bar_prev = extract(sched.alphas_cumprod_prev, t, nd)
    if eta == 0.0:  # the deterministic step draws nothing
        sample = (
            out.pred_xstart * torch.sqrt(alpha_bar_prev)
            + torch.sqrt(1 - alpha_bar_prev) * eps
        )
        return sample, out.pred_xstart
    if noise is None:
        raise ValueError("DDIM with eta > 0 adds noise: pass the step's noise")
    alpha_bar = extract(sched.alphas_cumprod, t, nd)
    sigma = (eta * torch.sqrt((1 - alpha_bar_prev) / (1 - alpha_bar))
             * torch.sqrt(1 - alpha_bar / alpha_bar_prev))
    mean_pred = (out.pred_xstart * torch.sqrt(alpha_bar_prev)
                 + torch.sqrt(1 - alpha_bar_prev - sigma ** 2) * eps)
    nonzero = (t != 0).to(x.dtype).reshape((-1,) + (1,) * (nd - 1))
    return mean_pred + nonzero * sigma * noise, out.pred_xstart


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


def _draws(noise: torch.Tensor, given: torch.Tensor | None, name: str,
           generator: torch.Generator | None, steps: int):
    """``draw(i)``: the i-th of the ladder's ``given`` draws (``steps``,
    *noise.shape), or a standard normal drawn from ``generator`` (on its
    own device) at that step."""
    if given is not None:
        if tuple(given.shape) != (steps, *noise.shape):
            raise ValueError(f"{name} must have shape {(steps, *noise.shape)}, "
                             f"got {tuple(given.shape)}")
        return lambda i: given[i].to(noise.device, noise.dtype)

    def draw(i):
        gen_device = generator.device if generator is not None else noise.device
        return torch.randn(noise.shape, generator=generator, device=gen_device).to(noise)

    return draw


def _sample_loop(sched: DiffusionSchedule, step, noise: torch.Tensor, *,
                 known_mask: torch.Tensor | None = None, known_x0: torch.Tensor | None = None,
                 known_noise: torch.Tensor | None = None,
                 generator: torch.Generator | None = None, return_trajectory: bool = False):
    """The ladder from x_T = ``noise``: ``step(x, t, i)`` at t = S-1-i,
    after the inpainting clamp where ``known_mask`` is given."""
    x = noise
    traj = []
    n = sched.num_timesteps
    if known_mask is not None:
        if known_x0 is None:
            raise ValueError("known_mask needs known_x0")
        known_mask = known_mask.to(x.device, torch.bool)
        known_x0 = known_x0.to(x)
        clamp_noise = _draws(noise, known_noise, "known_noise", generator, n)
    for i, t_scalar in enumerate(range(n - 1, -1, -1)):
        t = torch.full((x.shape[0],), t_scalar, dtype=torch.long, device=x.device)
        if known_mask is not None:
            x = torch.where(known_mask, q_sample(sched, known_x0, t, clamp_noise(i)), x)
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
    eta: float = 0.0,
    step_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
    known_mask: torch.Tensor | None = None,
    known_x0: torch.Tensor | None = None,
    known_noise: torch.Tensor | None = None,
    return_trajectory: bool = False,
):
    """The whole DDIM ladder from x_T = ``noise``; with ``eta > 0`` step i
    (t = S-1-i) adds ``step_noise[i]``, or a normal drawn from
    ``generator``.  With ``return_trajectory`` also returns every x_{t-1},
    stacked in ladder order (t = T-1 .. 0)."""
    sched = sched.to(noise.device)
    if eta == 0.0 and step_noise is not None:
        raise ValueError("step_noise is for eta > 0: DDIM at eta = 0 draws none")
    z = _draws(noise, step_noise, "step_noise", generator, sched.num_timesteps)

    def step(x, t, i):
        return ddim_step(sched, model_fn, x, t, z(i) if eta != 0.0 else None, eta=eta,
                         mean_type=mean_type, var_type=var_type)[0]

    return _sample_loop(sched, step, noise, known_mask=known_mask, known_x0=known_x0,
                        known_noise=known_noise, generator=generator,
                        return_trajectory=return_trajectory)


def p_sample_loop(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    noise: torch.Tensor,
    *,
    step_noise: torch.Tensor | None = None,
    generator: torch.Generator | None = None,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
    known_mask: torch.Tensor | None = None,
    known_x0: torch.Tensor | None = None,
    known_noise: torch.Tensor | None = None,
):
    """The whole ancestral ladder from x_T = ``noise``: step i (t = S-1-i)
    adds ``step_noise[i]`` (``step_noise`` (S, *noise.shape)), or without
    it a standard normal drawn from ``generator`` (on its own device) at
    that step."""
    sched = sched.to(noise.device)
    z = _draws(noise, step_noise, "step_noise", generator, sched.num_timesteps)

    def step(x, t, i):
        return ancestral_step(sched, model_fn, x, t, z(i), mean_type=mean_type,
                              var_type=var_type)[0]

    return _sample_loop(sched, step, noise, known_mask=known_mask, known_x0=known_x0,
                        known_noise=known_noise, generator=generator)
