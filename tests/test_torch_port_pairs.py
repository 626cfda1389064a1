"""PyTorch port: stage 1's contrastive pair sampling against
`conductor_tpu.data.pairs.build_pairs`.

JAX's random keys cannot be reproduced in torch, so the port takes the
window starts; `test_torch_port_m2s_parity.jax_starts` recovers JAX's by replaying the key
arithmetic of `conductor_tpu/data/pairs.py:53-81` (and the trainer's
`fold_in(rng, step)`), and the crops must then be equal.  Starts the port
draws itself must keep each strategy's bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import MOTION_HZ, jax_starts

from conductor_tpu.data.pairs import build_pairs as jax_build_pairs
from conductor_tpu_torch.data.pairs import STRATEGIES, build_pairs, draw_starts


def _data(sample_length, seed=0):
    rng = np.random.RandomState(seed)
    music = rng.normal(size=(3, sample_length * 90, 4)).astype(np.float32)
    motion = rng.normal(size=(3, sample_length * 30, 13, 2)).astype(np.float32)
    return music, motion


@pytest.mark.parametrize("strategy", STRATEGIES)
@pytest.mark.parametrize("sample_length,clip_length", [(30, 10), (6, 2)])
def test_crops_match_jax_given_its_starts(strategy, sample_length, clip_length):
    """(6, 2): the "hard" second window lies past the end and is clamped, as
    `jax.lax.dynamic_slice` clamps."""
    music, motion = _data(sample_length)
    for seed, step in ((0, 0), (1, 3), (7, 11)):
        rng = jax.random.PRNGKey(seed)
        want = jax_build_pairs(jax.random.fold_in(rng, step), jnp.asarray(music),
                               jnp.asarray(motion), strategy, sample_length, clip_length)
        starts = jax_starts(rng, strategy, sample_length, clip_length, step)
        got = build_pairs(torch.from_numpy(music), torch.from_numpy(motion), strategy,
                          sample_length, clip_length, starts=starts)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_drawn_starts_keep_the_bounds(strategy):
    s, c = 30, 10
    gen = torch.Generator().manual_seed(0)
    music, motion = _data(s)
    for _ in range(200):
        starts = draw_starts(strategy, s, c, gen)
        if strategy == "easy":
            assert 0 <= starts[0] < (s - c) * MOTION_HZ
        elif strategy == "hard":
            assert 0 <= starts[0] < (s - c - 10) * MOTION_HZ
            assert starts[0] + 10 * MOTION_HZ <= starts[1] < (s - c) * MOTION_HZ
        else:
            assert 0 <= starts[0] < (s - c - 5) * MOTION_HZ
            assert 0 <= starts[1] - starts[0] < 4.5 * MOTION_HZ
    m1, m2, p1, p2 = build_pairs(torch.from_numpy(music), torch.from_numpy(motion), strategy,
                                 s, c, generator=gen)
    assert m1.shape == (3, c * 90, 4) and p1.shape == (3, c * 30, 13, 2)
    if strategy == "easy":
        assert torch.equal(m2, m1.flip(0)) and torch.equal(p2, p1.flip(0))


def test_rejects_bad_arguments():
    music, motion = (torch.from_numpy(a) for a in _data(6))
    with pytest.raises(ValueError, match="strategy"):
        build_pairs(music, motion, "medium", 6, 2, starts=(0,))
    with pytest.raises(ValueError, match="clip_length"):
        build_pairs(music, motion, "easy", 6, 3, starts=(0,))
    with pytest.raises(ValueError, match="starts"):
        build_pairs(music, motion, "hard", 6, 2, starts=(0,))
