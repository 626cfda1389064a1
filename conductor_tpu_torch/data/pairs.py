"""Contrastive pair sampling for the stage-1 M2SNet step.

Port of `conductor_tpu/data/pairs.py:26-82`.  Difficulty levels:

- easy: one window; the partner is the batch flipped (another item);
- hard: the same clip, two windows at least 10 s apart;
- super_hard: the same clip, the second window shifted by an offset drawn
  from [0, 4.5) s, as the reference's code has it.

Starts are drawn on the 30 Hz motion grid and scaled x3 for the 90 Hz mel,
so the crops align exactly.  JAX's random keys cannot be reproduced in
torch, so ``starts`` (30 Hz ints: one for easy, two otherwise) bypasses the
draw; without it the starts come from ``generator``, in the same ranges.
A start past the end is clamped so that the crop fits, as
`jax.lax.dynamic_slice` clamps.
"""

from __future__ import annotations

import torch

MEL_HZ = 90
MOTION_HZ = 30
RATIO = MEL_HZ // MOTION_HZ

STRATEGIES = ("easy", "hard", "super_hard")


def _randint(lo: int, hi: int, generator: torch.Generator | None) -> int:
    """Uniform in [lo, max(hi, lo + 1)), as `jax.random.randint` with the
    JAX function's guard."""
    return int(torch.randint(lo, max(hi, lo + 1), (), generator=generator))


def draw_starts(strategy: str, sample_length: int, clip_length: int,
                generator: torch.Generator | None = None) -> tuple[int, ...]:
    """The window starts (30 Hz frames) of one step, in the JAX function's
    ranges."""
    s, c = sample_length, clip_length
    if strategy == "easy":
        return (_randint(0, (s - c) * MOTION_HZ, generator),)
    if strategy == "hard":
        start_1 = _randint(0, (s - c - 10) * MOTION_HZ, generator)
        lo = start_1 + 10 * MOTION_HZ
        return start_1, _randint(lo, (s - c) * MOTION_HZ, generator)
    start_1 = _randint(0, (s - c - 5) * MOTION_HZ, generator)
    return start_1, start_1 + _randint(0, int(4.5 * MOTION_HZ), generator)


def _cut(music: torch.Tensor, motion: torch.Tensor, start30: int, clip30: int):
    start30 = min(max(start30, 0), motion.shape[1] - clip30)
    return (music[:, start30 * RATIO:(start30 + clip30) * RATIO],
            motion[:, start30:start30 + clip30])


def build_pairs(music: torch.Tensor, motion: torch.Tensor, strategy: str, sample_length: int,
                clip_length: int, *, starts=None, generator: torch.Generator | None = None):
    """music (B, S*90, 128), motion (B, S*30, 13, 2) -> (music_1, music_2,
    motion_1, motion_2), each a ``clip_length``-second crop."""
    if strategy not in STRATEGIES:
        raise ValueError(f"strategy must be one of {STRATEGIES}, got {strategy!r}")
    if clip_length > sample_length / 3:
        raise ValueError("clip_length must be <= sample_length/3")
    if starts is None:
        starts = draw_starts(strategy, sample_length, clip_length, generator)
    starts = tuple(int(s) for s in starts)
    if len(starts) != (1 if strategy == "easy" else 2):
        raise ValueError(f"strategy {strategy!r} takes {1 if strategy == 'easy' else 2} starts, "
                         f"got {starts}")
    c30 = clip_length * MOTION_HZ
    m1, p1 = _cut(music, motion, starts[0], c30)
    if strategy == "easy":
        return m1, m1.flip(0), p1, p1.flip(0)
    m2, p2 = _cut(music, motion, starts[1], c30)
    return m1, m2, p1, p2
