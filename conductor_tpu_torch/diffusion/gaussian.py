"""Gaussian-diffusion math of the serving and training paths.

Port of `conductor_tpu/diffusion/gaussian.py`: `extract`, `q_sample`,
`q_posterior_mean_variance`, the x0 / eps conversions, `model_timesteps`
and `p_mean_variance` for the mean types the trainer takes ("start_x",
"epsilon", "previous_x") and the fixed variances ("fixed_small",
"fixed_large"), without clipping the x0 prediction (the trainer's
setting), and
`mean_flat` / `training_losses` for the MSE family with the reference's
hard-coded velocity channel groups.  The KL losses and the learned
variances are not ported and raise.
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


def predict_xstart_from_eps(sched: DiffusionSchedule, x_t, t, eps):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t
        - extract(sched.sqrt_recipm1_alphas_cumprod, t, nd) * eps
    )


def predict_eps_from_xstart(sched: DiffusionSchedule, x_t, t, pred_xstart):
    nd = x_t.ndim
    return (
        extract(sched.sqrt_recip_alphas_cumprod, t, nd) * x_t - pred_xstart
    ) / extract(sched.sqrt_recipm1_alphas_cumprod, t, nd)


def predict_xstart_from_xprev(sched: DiffusionSchedule, x_t, t, xprev):
    nd = x_t.ndim
    coef1, coef2 = sched.posterior_mean_coef1, sched.posterior_mean_coef2
    return extract(1.0 / coef1, t, nd) * xprev - extract(coef2 / coef1, t, nd) * x_t


def model_timesteps(sched: DiffusionSchedule, t: torch.Tensor) -> torch.Tensor:
    """Respaced-ladder indices -> the original-ladder timesteps the model
    was trained on."""
    return sched.timestep_map[t]


class PMeanVariance(NamedTuple):
    mean: torch.Tensor
    variance: torch.Tensor
    log_variance: torch.Tensor
    pred_xstart: torch.Tensor


MEAN_TYPES = ("start_x", "epsilon", "previous_x")
VAR_TYPES = ("fixed_small", "fixed_large")


def check_types(mean_type: str, var_type: str) -> None:
    """Raise on a mean or variance type the port does not sample with: the
    learned variances need a 2x-wide denoiser head, which the JAX trainer
    refuses too (`conductor_tpu/train/ddpm_trainer.py:115-118`)."""
    if var_type in ("learned", "learned_range"):
        raise NotImplementedError("learned variances are not ported (the trainer takes "
                                  f"{VAR_TYPES})")
    if mean_type not in MEAN_TYPES or var_type not in VAR_TYPES:
        raise ValueError(f"unknown mean_type / var_type: {mean_type!r}, {var_type!r}")


def p_mean_variance(
    sched: DiffusionSchedule,
    model_fn: ModelFn,
    x: torch.Tensor,
    t: torch.Tensor,
    *,
    mean_type: str = "start_x",
    var_type: str = "fixed_small",
) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments plus the x0 prediction (JAX
    `p_mean_variance`, `conductor_tpu/diffusion/gaussian.py:137-196`).
    ``t`` indexes the (possibly respaced) schedule; the model receives
    original-ladder timesteps through ``timestep_map``.  The x0 prediction
    is not clipped: JAX's trainer samples with ``clip_denoised=False``."""
    check_types(mean_type, var_type)
    nd = x.ndim
    model_output = model_fn(x, model_timesteps(sched, t))
    if var_type == "fixed_small":
        variance = extract(sched.posterior_variance, t, nd)
        log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    else:
        variance = extract(sched.fixed_large_variance, t, nd)
        log_variance = extract(sched.fixed_large_log_variance, t, nd)
    if mean_type == "previous_x":
        pred_xstart = predict_xstart_from_xprev(sched, x, t, model_output)
        mean = model_output
    else:
        pred_xstart = (predict_xstart_from_eps(sched, x, t, model_output)
                       if mean_type == "epsilon" else model_output)
        mean = q_posterior_mean_variance(sched, pred_xstart, x, t)[0]
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


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
    check_types(mean_type, var_type)
    x_t = q_sample(sched, x_start, t, noise)
    model_output = model_fn(x_t, model_timesteps(sched, t))
    if mean_type == "start_x":
        target = x_start
    elif mean_type == "epsilon":
        target = noise
    else:
        target = q_posterior_mean_variance(sched, x_start, x_t, t)[0]
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
