"""Diffusion engine: schedules, Gaussian math, the variational bound and
training losses, the DDIM and ancestral samplers."""

from .gaussian import (  # noqa: F401
    calc_bpd_loop,
    discretized_gaussian_log_likelihood,
    extract,
    mean_flat,
    model_timesteps,
    normal_kl,
    p_mean_variance,
    predict_eps_from_xstart,
    predict_xstart_from_eps,
    predict_xstart_from_xprev,
    prior_bpd,
    q_mean_variance,
    q_posterior_mean_variance,
    q_sample,
    training_losses,
    vb_terms_bpd,
)
from .sampling import ancestral_step, ddim_sample_loop, ddim_step, p_sample_loop  # noqa: F401
from .schedule import (  # noqa: F401
    DiffusionSchedule,
    get_named_beta_schedule,
    make_schedule,
    respaced_schedule,
    schedule_from_betas,
    space_timesteps,
)
from .timestep_samplers import uniform_sample  # noqa: F401
