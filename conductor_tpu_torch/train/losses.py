"""The stage-1 GAN losses (reference `Contrastive_Stage/utils/loss.py`).

Port of `conductor_tpu/train/losses.py:20-93`:

- `gradient_penalty`, the WGAN-GP menu of five interpolation terms
  (`loss.py:65-125`, centre 0).  'real' / 'fake' / 'real_motion' /
  'fake_motion' take a per-sample norm over time (torch's
  ``norm(2, dim=1)``), squared and averaged; 'real_fake', the trainer's
  default, the straight line between real and fake with one weight a
  sample and the reference's two quirks: the norm over the WHOLE tensor
  and centre 0, so the term is the sum of the squared gradient.  The
  gradient at the interpolate is `torch.autograd.grad` with
  ``create_graph=True``, so the penalty differentiates again with respect
  to the critic's parameters (a double backward through its convolutions
  and max-pools).  The interpolation weights are handed over (``alpha``:
  a scalar for each motion term, (B, 1, 1, 1) for 'real_fake') or drawn
  from a `torch.Generator` (`draw_gp_alpha`, uniform on [0, 1)).
- `sync_loss`: L1 between the last frozen motion-encoder features of fake
  and real (`loss.py:30-46`), the real's without gradient or handed over;
  the trainer's SyncLoss term;
- `feature_matching_loss`: MSE summed over the whole feature stack
  (`loss.py:10-23`).
"""

from __future__ import annotations

from collections.abc import Callable, Sequence

import torch

GP_TERMS = ("real", "fake", "real_fake", "real_motion", "fake_motion")
# the terms that interpolate, in the order JAX draws their weights
ALPHA_TERMS = ("real_motion", "fake_motion", "real_fake")


def alpha_shape(term: str, batch: int) -> tuple[int, ...]:
    return (batch, 1, 1, 1) if term == "real_fake" else ()


def draw_gp_alpha(terms: Sequence[str], batch: int, iters: int = 1,
                  generator: torch.Generator | None = None,
                  device: torch.device | str = "cpu") -> dict[str, torch.Tensor]:
    """Each interpolating term's weights for ``iters`` critic iterations,
    (iters, *shape) uniform on [0, 1), drawn on the generator's device and
    moved to ``device``."""
    where = generator.device if generator is not None else device
    return {t: torch.rand((iters, *alpha_shape(t, batch)), generator=generator,
                          device=where).to(device)
            for t in ALPHA_TERMS if t in terms}


def _grad_at(d_fn: Callable, x: torch.Tensor) -> torch.Tensor:
    """d(sum d_fn(x)) / dx, itself differentiable."""
    if not x.requires_grad:
        x = x.detach().requires_grad_(True)
    (g,) = torch.autograd.grad(d_fn(x).sum(), x, create_graph=True)
    return g


def _per_sample_sq_norm(g: torch.Tensor) -> torch.Tensor:
    # the norm over time, then squared and averaged over the rest
    return (torch.sqrt((g * g).sum(dim=1)) ** 2).mean()


def gradient_penalty(d_fn: Callable[[torch.Tensor], torch.Tensor], real: torch.Tensor,
                     fake: torch.Tensor, terms: Sequence[str] = ("real_fake",),
                     alpha: dict[str, torch.Tensor] | None = None,
                     generator: torch.Generator | None = None) -> torch.Tensor:
    """The penalty of ``terms`` on motion (B, T, 13, 2), a 0-d tensor.
    ``alpha`` maps each interpolating term to its weight (reshaped to
    `alpha_shape`); without it the weights are drawn from ``generator``."""
    unknown = set(terms) - set(GP_TERMS)
    if unknown:
        raise ValueError(f"unknown gradient-penalty terms: {sorted(unknown)}")
    b = real.shape[0]
    if alpha is None:
        alpha = {k: v[0] for k, v in draw_gp_alpha(terms, b, 1, generator, real.device).items()}
    a = {k: alpha[k].reshape(alpha_shape(k, b)).to(real.device) for k in ALPHA_TERMS if k in terms}
    with torch.enable_grad():
        loss = real.new_zeros((), dtype=torch.float32)
        if "real" in terms:
            loss = loss + _per_sample_sq_norm(_grad_at(d_fn, real))
        if "fake" in terms:
            loss = loss + _per_sample_sq_norm(_grad_at(d_fn, fake))
        real_structure = real.mean(dim=1, keepdim=True)
        fake_structure = fake.mean(dim=1, keepdim=True)
        if "real_motion" in terms:
            w = a["real_motion"]
            x = w * (real - real_structure) + w * fake_structure + (1 - w) * real_structure
            loss = loss + _per_sample_sq_norm(_grad_at(d_fn, x))
        if "fake_motion" in terms:
            w = a["fake_motion"]
            x = w * (fake - fake_structure) + w * fake_structure + (1 - w) * real_structure
            loss = loss + _per_sample_sq_norm(_grad_at(d_fn, x))
        if "real_fake" in terms:
            w = a["real_fake"]
            g = _grad_at(d_fn, w * real + (1 - w) * fake)
            loss = loss + (g * g).sum()
    return loss


def sync_loss(latent_fn: Callable, fake: torch.Tensor, real: torch.Tensor,
              real_latents: torch.Tensor | None = None) -> torch.Tensor:
    """L1 between the LAST frozen motion-encoder features, ``latent_fn``'s,
    of fake and of real; ``real_latents``, where given, stand for
    latent_fn(real) (the trainer's ``cached_sync_latents``)."""
    ff = latent_fn(fake)
    if real_latents is None:
        with torch.no_grad():
            real_latents = latent_fn(real)
    return (ff - real_latents.to(ff.dtype)).abs().mean()


def feature_matching_loss(features_fn: Callable, fake: torch.Tensor,
                          real: torch.Tensor) -> torch.Tensor:
    """MSE over the FULL frozen feature stack."""
    with torch.no_grad():
        rf = features_fn(real)
    loss = 0.0
    for f, r in zip(features_fn(fake), rf):
        loss = loss + ((f - r) ** 2).mean()
    return loss
