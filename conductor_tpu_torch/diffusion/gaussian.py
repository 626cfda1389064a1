"""Gaussian-diffusion math of the serving and training paths.

Port of `conductor_tpu/diffusion/gaussian.py`, the whole engine:
`extract`, `q_mean_variance`, `q_sample`, `q_posterior_mean_variance`, the
x0 / eps conversions, `model_timesteps`, `p_mean_variance` for every mean
type ("start_x", "epsilon", "previous_x") and variance type (the fixed
"fixed_small" / "fixed_large", and the learned "learned" / "learned_range",
whose model returns twice the channels, the second half the variance's
log or its interpolation fraction), the x0 prediction clipped to [-1, 1]
only with ``clip_denoised`` (off on the serving and training paths, the
trainer's setting, on in the VLB terms by default, as in JAX); the
variational bound: `normal_kl`, `discretized_gaussian_log_likelihood`,
`vb_terms_bpd`, `prior_bpd` and `calc_bpd_loop` (its per-step noise
handed over or drawn from a generator, where JAX splits its key a step);
and `training_losses` for the MSE family with the reference's hard-coded
velocity channel groups (and the ``vb`` term under learned variances) and
for the KL family.  `train.ddpm_trainer.DDPMTrainer` keeps refusing the KL
losses and the learned variances, as JAX's does: its 5-term objective is
the MSE family's.
"""

from __future__ import annotations

import math
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


def q_mean_variance(sched: DiffusionSchedule, x_start, t):
    """q(x_t | x_0) moments."""
    nd = x_start.ndim
    mean = extract(sched.sqrt_alphas_cumprod, t, nd) * x_start
    variance = extract(1.0 - sched.alphas_cumprod, t, nd)
    log_variance = extract(sched.log_one_minus_alphas_cumprod, t, nd)
    return mean, variance, log_variance


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
VAR_TYPES = ("fixed_small", "fixed_large", "learned", "learned_range")
LOSS_TYPES = ("mse", "rescaled_mse", "kl", "rescaled_kl")


def check_types(mean_type: str, var_type: str) -> None:
    """Raise ValueError on an unknown mean or variance type."""
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
    clip_denoised: bool = False,
) -> PMeanVariance:
    """p(x_{t-1} | x_t) moments plus the x0 prediction (JAX
    `p_mean_variance`, `conductor_tpu/diffusion/gaussian.py:137-196`).
    ``t`` indexes the (possibly respaced) schedule; the model receives
    original-ladder timesteps through ``timestep_map``.  Under a learned
    variance the model's output splits in two along the last axis: the
    mean's parameterisation, then the log variance ("learned") or the
    fraction between the clipped posterior's and beta's log variances
    ("learned_range", from [-1, 1]).  With ``clip_denoised`` the x0
    prediction is clipped to [-1, 1] (the serving and training paths leave
    it off, JAX's trainer's setting)."""
    check_types(mean_type, var_type)
    nd = x.ndim
    model_output = model_fn(x, model_timesteps(sched, t))
    if var_type in ("learned", "learned_range"):
        model_output, var_values = model_output.chunk(2, dim=-1)
        if var_type == "learned":
            log_variance = var_values
        else:
            min_log = extract(sched.posterior_log_variance_clipped, t, nd)
            max_log = extract(torch.log(sched.betas), t, nd)
            frac = (var_values + 1) / 2
            log_variance = frac * max_log + (1 - frac) * min_log
        variance = torch.exp(log_variance)
    elif var_type == "fixed_small":
        variance = extract(sched.posterior_variance, t, nd)
        log_variance = extract(sched.posterior_log_variance_clipped, t, nd)
    else:
        variance = extract(sched.fixed_large_variance, t, nd)
        log_variance = extract(sched.fixed_large_log_variance, t, nd)

    def process(x0):
        return x0.clamp(-1.0, 1.0) if clip_denoised else x0

    if mean_type == "previous_x":
        pred_xstart = process(predict_xstart_from_xprev(sched, x, t, model_output))
        mean = model_output
    else:
        pred_xstart = process(predict_xstart_from_eps(sched, x, t, model_output)
                              if mean_type == "epsilon" else model_output)
        mean = q_posterior_mean_variance(sched, pred_xstart, x, t)[0]
    return PMeanVariance(mean, variance, log_variance, pred_xstart)


def _like(v, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(v, dtype=ref.dtype, device=ref.device)


def normal_kl(mean1, logvar1, mean2, logvar2) -> torch.Tensor:
    """KL between two diagonal Gaussians (guided-diffusion `losses.py`);
    any argument may be a number."""
    ref = next(v for v in (mean1, logvar1, mean2, logvar2) if torch.is_tensor(v))
    mean1, logvar1, mean2, logvar2 = (_like(v, ref) for v in (mean1, logvar1, mean2, logvar2))
    return 0.5 * (-1.0 + logvar2 - logvar1 + torch.exp(logvar1 - logvar2)
                  + ((mean1 - mean2) ** 2) * torch.exp(-logvar2))


def approx_standard_normal_cdf(x: torch.Tensor) -> torch.Tensor:
    return 0.5 * (1.0 + torch.tanh(math.sqrt(2.0 / math.pi) * (x + 0.044715 * x ** 3)))


def discretized_gaussian_log_likelihood(x, *, means, log_scales) -> torch.Tensor:
    """The log-likelihood of ``x`` in [-1, 1] under a Gaussian discretized
    to 255 bins (guided-diffusion `losses.py`; the VLB's decoder term,
    `gaussian_diffusion.py:989-995`)."""
    centered = x - means
    inv_stdv = torch.exp(-log_scales)
    cdf_plus = approx_standard_normal_cdf(inv_stdv * (centered + 1.0 / 255.0))
    cdf_min = approx_standard_normal_cdf(inv_stdv * (centered - 1.0 / 255.0))
    log_cdf_plus = torch.log(cdf_plus.clamp(min=1e-12))
    log_one_minus_cdf_min = torch.log((1.0 - cdf_min).clamp(min=1e-12))
    log_delta = torch.log((cdf_plus - cdf_min).clamp(min=1e-12))
    return torch.where(x < -0.999, log_cdf_plus,
                       torch.where(x > 0.999, log_one_minus_cdf_min, log_delta))


def mean_flat(x: torch.Tensor) -> torch.Tensor:
    """Mean over all non-batch axes."""
    return x.mean(dim=tuple(range(1, x.ndim)))


def vb_terms_bpd(sched: DiffusionSchedule, model_fn: ModelFn, x_start, x_t, t, *,
                 mean_type: str = "start_x", var_type: str = "fixed_small",
                 clip_denoised: bool = True):
    """One term of the variational bound in bits per dimension, (B,): the
    decoder's negative log-likelihood at t = 0, the KL of the posterior
    from the model's p elsewhere (`gaussian_diffusion.py:967-1000`); returns
    (term, pred_xstart)."""
    true_mean, _, true_log_var = q_posterior_mean_variance(sched, x_start, x_t, t)
    out = p_mean_variance(sched, model_fn, x_t, t, mean_type=mean_type, var_type=var_type,
                          clip_denoised=clip_denoised)
    kl = mean_flat(normal_kl(true_mean, true_log_var, out.mean, out.log_variance)) / math.log(2.0)
    nll = -discretized_gaussian_log_likelihood(x_start, means=out.mean,
                                               log_scales=0.5 * out.log_variance)
    nll = mean_flat(nll) / math.log(2.0)
    return torch.where(t == 0, nll, kl), out.pred_xstart


def prior_bpd(sched: DiffusionSchedule, x_start: torch.Tensor) -> torch.Tensor:
    """The bound's prior term in bits per dimension, (B,)
    (`gaussian_diffusion.py:1092-1108`)."""
    t = torch.full((x_start.shape[0],), sched.num_timesteps - 1, dtype=torch.long,
                   device=x_start.device)
    qt_mean, _, qt_log_var = q_mean_variance(sched, x_start, t)
    return mean_flat(normal_kl(qt_mean, qt_log_var, 0.0, 0.0)) / math.log(2.0)


def calc_bpd_loop(sched: DiffusionSchedule, model_fn: ModelFn, x_start: torch.Tensor, *,
                  noise: torch.Tensor | None = None, generator: torch.Generator | None = None,
                  mean_type: str = "start_x", var_type: str = "fixed_small",
                  clip_denoised: bool = True) -> dict[str, torch.Tensor]:
    """The whole variational bound in bits per dimension
    (`gaussian_diffusion.py:1110-1165`): one step a timestep, t = T-1 ..
    0, each on x_t drawn from q(x_t | x_0) with that step's noise,
    ``noise[i]`` (``noise`` (T, *x_start.shape) in that order) or, without
    it, a standard normal drawn from ``generator`` at that step.  Returns
    ``total_bpd`` and ``prior_bpd`` (B,), and ``vb``, ``xstart_mse``,
    ``mse`` (B, T) with column 0 at t = T-1, as JAX's."""
    sched = sched.to(x_start.device)
    n = sched.num_timesteps
    if noise is not None and tuple(noise.shape) != (n, *x_start.shape):
        raise ValueError(f"noise must have shape {(n, *x_start.shape)}, got {tuple(noise.shape)}")
    vb, xstart_mse, mse = [], [], []
    for i, t_scalar in enumerate(range(n - 1, -1, -1)):
        t = torch.full((x_start.shape[0],), t_scalar, dtype=torch.long, device=x_start.device)
        if noise is not None:
            z = noise[i].to(x_start)
        else:
            gen_device = generator.device if generator is not None else x_start.device
            z = torch.randn(x_start.shape, generator=generator, device=gen_device).to(x_start)
        x_t = q_sample(sched, x_start, t, z)
        term, pred_xstart = vb_terms_bpd(sched, model_fn, x_start, x_t, t, mean_type=mean_type,
                                         var_type=var_type, clip_denoised=clip_denoised)
        eps = predict_eps_from_xstart(sched, x_t, t, pred_xstart)
        vb.append(term)
        xstart_mse.append(mean_flat((pred_xstart - x_start) ** 2))
        mse.append(mean_flat((eps - z) ** 2))
    vb_t = torch.stack(vb, dim=1)
    pb = prior_bpd(sched, x_start)
    return {"total_bpd": vb_t.sum(dim=1) + pb, "prior_bpd": pb, "vb": vb_t,
            "xstart_mse": torch.stack(xstart_mse, dim=1), "mse": torch.stack(mse, dim=1)}


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
    """The training terms of every loss type (`conductor_tpu/diffusion/
    gaussian.py:265-350`).  MSE family: ``x_start`` is (B, T, J, 2) or flat
    (B, T, 26) (flat under a learned variance); returns the per-batch
    ``mse`` (B,), the scalar velocity terms, the flat ``target`` / ``pred``
    for the trainer's masked and feature losses, and under a learned
    variance ``vb``, the bound's term with the mean's output detached so
    that only the variance learns from it (times T / 1000 for
    "rescaled_mse").  KL family: ``loss``, the bound's term (B,) (times T
    for "rescaled_kl")."""
    if loss_type not in LOSS_TYPES:
        raise ValueError(f"unknown loss_type {loss_type!r} (one of {LOSS_TYPES})")
    check_types(mean_type, var_type)
    x_t = q_sample(sched, x_start, t, noise)
    if loss_type in ("kl", "rescaled_kl"):
        out, _ = vb_terms_bpd(sched, model_fn, x_start, x_t, t, mean_type=mean_type,
                              var_type=var_type, clip_denoised=False)
        return {"loss": out * sched.num_timesteps if loss_type == "rescaled_kl" else out}
    model_output = model_fn(x_t, model_timesteps(sched, t))
    extra = {}
    if var_type in ("learned", "learned_range"):
        model_output, var_values = model_output.chunk(2, dim=-1)
        frozen = torch.cat([model_output.detach(), var_values], dim=-1)
        vb, _ = vb_terms_bpd(sched, lambda *_: frozen, x_start, x_t, t, mean_type=mean_type,
                             var_type=var_type, clip_denoised=False)
        extra["vb"] = vb * (sched.num_timesteps / 1000.0) if loss_type == "rescaled_mse" else vb
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
        **extra,
    }
