"""The port's optimizers: stage 2's optax ``chain(clip_by_global_norm(c),
adam(lr))`` (`ClippedAdam`), and the M2SGAN trainer's optax ``rmsprop``
(`RMSprop`).

`clip_by_global_norm` is optax's own rule: the gradients are scaled by
``c / norm`` only when ``norm >= c``, with no ``+ 1e-6`` on the norm
(`torch.nn.utils.clip_grad_norm_` adds one).  The Adam step is
`torch.optim.Adam` with its defaults (betas 0.9 / 0.999, eps 1e-8), whose
update equals optax's `adam` (`tests/test_torch_import.py:472`).
"""

from __future__ import annotations

import torch


def global_norm(grads: list[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every gradient, float32 (optax
    `global_norm`)."""
    return torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float) -> tuple[list, torch.Tensor]:
    """(grads, their global norm before clipping); where the norm is at
    least ``max_norm`` each gradient becomes ``g / norm * max_norm``."""
    norm = global_norm(grads)
    keep = norm < max_norm
    return [torch.where(keep, g, g / norm * max_norm) for g in grads], norm


class ClippedAdam:
    """Adam over ``params`` after global-norm clipping of their gradients."""

    def __init__(self, params, lr: float, max_norm: float):
        self.params = [p for p in params if p.requires_grad]
        self.max_norm = max_norm
        self.adam = torch.optim.Adam(self.params, lr=lr)

    def step(self, reduce=None) -> torch.Tensor:
        """Clip the parameters' ``.grad`` in place and take one Adam step;
        returns the unclipped global norm.  A parameter without a gradient
        counts as a zero gradient, as in optax.  ``reduce`` (the gradients,
        in place) runs first: the data-parallel step's sum over the
        ranks."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        if reduce is not None:
            reduce([p.grad for p in self.params])
        clipped, norm = clip_by_global_norm([p.grad for p in self.params], self.max_norm)
        for p, g in zip(self.params, clipped):
            p.grad = g
        self.adam.step()
        self.adam.zero_grad(set_to_none=True)
        return norm


class RMSprop:
    """optax's ``rmsprop(lr, decay, eps)`` with its defaults of optax 0.2.6
    (``eps_in_sqrt=True``, ``initial_scale=0``, no momentum or centring),
    the M2SGAN trainer's (`conductor_tpu/train/m2sgan_trainer.py:151-152`):
    nu = (1 - decay) g² + decay nu, then p += -lr (g rsqrt(nu + eps)), in
    optax's order of operations.  `torch.optim.RMSprop` divides by
    sqrt(nu) + eps instead, which departs from it where nu is near eps."""

    def __init__(self, params, lr: float, decay: float = 0.99, eps: float = 1e-8):
        self.params = [p for p in params if p.requires_grad]
        self.lr, self.decay, self.eps = lr, decay, eps
        self.nu = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One update from the parameters' ``.grad`` (a missing one counts
        as zero, as in optax), which it then clears."""
        for p, nu in zip(self.params, self.nu):
            g = p.grad if p.grad is not None else torch.zeros_like(p)
            nu.copy_((g * g) * (1 - self.decay) + self.decay * nu)
            p.add_((g * torch.rsqrt(nu + self.eps)) * -self.lr)
            p.grad = None

    def state_dict(self) -> dict:
        """The second moments (optax's ``nu``) on the host, in parameter order."""
        return {"nu": [nu.detach().to("cpu", copy=True) for nu in self.nu]}

    @torch.no_grad()
    def load_state_dict(self, state: dict) -> None:
        if len(state["nu"]) != len(self.nu):
            raise ValueError(f"{len(state['nu'])} second moments for {len(self.nu)} parameters")
        for nu, saved in zip(self.nu, state["nu"]):
            nu.copy_(saved)
