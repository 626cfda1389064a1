"""Gaussian-diffusion math of the serving and training paths.

Port of `conductor_tpu/diffusion/gaussian.py`: `extract`, `q_sample`,
`q_posterior_mean_variance`, `predict_eps_from_xstart`, `model_timesteps`
and `p_mean_variance` for the trainer's START_X / FIXED_SMALL setting with
``clip_denoised=False``, and `mean_flat` / `training_losses` for the MSE
family with the reference's hard-coded velocity channel groups.  The KL
losses and the learned variances are not ported and raise.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .schedule import DiffusionSchedule

ModelFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# Channel groups of the (T, 26) flattened pose used by the velocity losses,
# joint-major (x0, y0, x1, y1, ...) as in `conductor_tpu/diffusion/
# gaussian.py:56-58` (the reference's hard-coded lists).
HEAD_CHANNELS = tuple(range(0, 10))
BODY_CHANNELS = (10, 11, 12, 13, 22, 23, 24, 25)
ELBOW_CHANNELS = tuple(range(14, 22))


def extract(table: torch.Tensor, t: torch.Tensor, ndim: int) -> torch.Tensor:
    """Gather per-timestep coefficients, shaped to broadcast over an
    ndim-rank operand."""
    out = table[t]
    return out.reshape(out.shape + (1,) * (ndim - 1))


def q_sample(sched: DiffusionSchedule, x_start, t, noise):
    """Sample q(x_t | x_0)."""
    nd = x_start.ndim
    return (
        extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
        + extract(sched.sqrt_one_minus_alphas_cumprod, t, nd) * noise
    )


def q_posterior_mean_variance(sched: DiffusionSchedule, x_start, x_t, t):
    """q(x_{t-1} | x_t, x_0) moments."""
    nd = x_t.ndim
    mean = (
        extract(sched.posterior_mean_coef1, t, nd) * x_start
        + extract(sched.posterior_mean_coef2, t, nd) * x_t
    )
    variance = extract(sched.posterior_variance, t, nd)
    log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    return mean, variance, log_variance


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def model_timesteps(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Respaced-ladder indices -> the original-ladder timesteps the model
    was trained on."""
    return sched.timestep_map[t]


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


def p_mean_variance(
    sched: DiffusionSchedule, model_fn: ModelFn, x: torch.Tensor, t: torch.Tensor
) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments plus the x0 prediction under START_X /
    FIXED_SMALL, without clipping.  ``t`` indexes the (possibly respaced)
    schedule; the model receives original-ladder timesteps through
    ``timestep_map``."""
    pred_xstart = model_fn(x, model_timesteps(sched, t))
    return PMeanVariance(*q_posterior_mean_variance(sched, pred_xstart, x, t), pred_xstart)


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def training_losses(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    x_start: torch.Tensor,
    t: torch.Tensor,
    noise: torch.Tensor,
    *,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
    loss_type: str = "mse",
) -> dict[str, torch.Tensor]:
    """The MSE-family training terms (`conductor_tpu/diffusion/gaussian.py:
    265-350`).  ``x_start`` is (B, T, J, 2) or flat (B, T, 26); returns the
    per-batch ``mse`` (B,), the scalar velocity terms, and the flat
    ``target`` / ``pred`` for the trainer's masked and feature losses."""
    if loss_type not in ("mse", "rescaled_mse"):
        raise NotImplementedError(f"loss_type {loss_type!r} is not ported (MSE family only)")
    if var_type in ("learned", "learned_range"):
        raise NotImplementedError("learned variances are not ported")
    x_t = q_sample(sched, x_start, t, noise)
    model_output = model_fn(x_t, model_timesteps(sched, t))
    if mean_type == "start_x":
        target = x_start
    elif mean_type == "epsilon":
        target = noise
    elif mean_type == "previous_x":
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
    else:
        raise ValueError(f"unknown mean_type {mean_type!r}")
    b, n = target.shape[:2]
    target = target.reshape(b, n, -1)
    model_output = model_output.reshape(b, n, -1)

    def vel(x):
        return x[:, 1:] - x[:, :-1]

    def group(ch):
        return model_output[..., list(ch)]

    return {
        "mse": mean_flat((target - model_output) ** 2),
        "velocity_body": mean_flat(vel(group(BODY_CHANNELS)) ** 2).mean(),
        "velocity_elbow": mean_flat(vel(group(ELBOW_CHANNELS)) ** 2).mean(),
        "velocity_head": mean_flat(vel(group(HEAD_CHANNELS)) ** 2).mean(),
        "velocity": mean_flat((vel(target) - vel(model_output)) ** 2).mean(),
        "target": target,
        "pred": model_output,
    }
