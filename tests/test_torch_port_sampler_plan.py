"""K2's and K3's tilings and arithmetic on the CPU: `ops.sampler_glue.plan`
over a grid of B and T, and numpy float32 emulations of what
`csrc/sampler_glue.cu` computes against the JAX package's
`sampler_prologue` / `sampler_epilogue` (Pallas in interpret mode, as
tests/test_torch_port_sampler_modes.py runs them).

K2 (`prologue_rows`): a warp a row; lane l owns h columns 4l..4l+3, whose
chains run over the pose in ascending c (the pose values passed from lanes
0..C-1), and emb_base's 16-byte pieces l, l + 32, ..., whose SiLU it
computes; in the int8 mode each lane takes the largest |value| of its 16,
five xor-shuffle steps give the row's, and the codes are the IEEE quotient
by the scale rounded half to even.  K3 (`epilogue_outputs`): lane c owns
column c of a warp's run of rows, each output a 128-deep chain in
ascending d, then alpha (sum + b_out) + beta x_t.  A fused multiply-add
is emulated in float64 (the product of two float32 is exact there) and
rounded to float32.  The card's `expf` and its FMA order round otherwise
than numpy's and JAX's own order: h and x_{t-1} are held to the existing
atol 2e-4, bf16 emb_act to one bf16 step, the int8 codes to the existing
rule (at most 1 apart at no more than 0.1 % of them, scales within 1e-6);
on exact ties the codes and scales must be exact.  The card's output is
held to the plain version there (`tests/test_torch_port_cuda.py`,
`chip_smoke.py`)."""

import collections

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.pallas_sampler import sampler_epilogue as jax_epilogue
from conductor_tpu.ops.pallas_sampler import sampler_prologue as jax_prologue
from conductor_tpu_torch.ops.sampler_glue import (
    EPI_BLOCKS_PER_SM,
    EPI_GROUP,
    EPI_MAX_GROUPS,
    EPI_WARPS,
    PRO_BLOCKS_PER_SM,
    PRO_WARPS,
    epilogue_outputs,
    plan,
    prologue_rows,
)

F32 = np.float32
B, T, C, D, E = 2, 24, 26, 128, 512
SMEM_PER_SM = 228 * 1024  # an H100 SM's shared memory
SMEM_PER_BLOCK = 227 * 1024


def _fma(a, b, c):
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(F32)


def _bf16(a):
    return torch.from_numpy(np.ascontiguousarray(a, F32)).to(torch.bfloat16).float().numpy()


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(F32)


@pytest.mark.parametrize("t", [1, 7, 24, 900, 1800])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_prologue_plan_takes_every_row_once(b, t):
    """K2's plan: every row of B x T in exactly one block's range and warp,
    each block's rows its own contiguous range, warps in order within it;
    the grid within `PRO_BLOCKS_PER_SM` blocks an SM, whose shared memory
    fits the SM's."""
    n = b * t
    p = plan(b, t, "prologue")
    rows = collections.Counter()
    for blk, warp, row in prologue_rows(p, n):
        assert blk * p["rows"] <= row < min(n, (blk + 1) * p["rows"]) and 0 <= warp < PRO_WARPS
        assert (row - blk * p["rows"]) % PRO_WARPS == warp
        rows[row] += 1
    assert sorted(rows) == list(range(n)) and set(rows.values()) == {1}
    assert (p["blocks"] - 1) * p["rows"] < n <= p["blocks"] * p["rows"]
    assert p["blocks"] <= 132 * PRO_BLOCKS_PER_SM and p["threads"] == 32 * PRO_WARPS
    assert PRO_BLOCKS_PER_SM * (p["smem_bytes"] + 1024) <= SMEM_PER_SM


@pytest.mark.parametrize("t", [1, 7, 24, 900, 1800])
@pytest.mark.parametrize("b", [1, 2, 8])
def test_epilogue_plan_takes_every_output_once(b, t):
    """K3's plan: every (row, column) of the B x T x 26 output computed by
    exactly one lane, lane c column c, each warp's rows one contiguous run
    of whole `EPI_GROUP`-row groups (up to `EPI_MAX_GROUPS`); the rows a
    warp as few as give every warp slot of `EPI_BLOCKS_PER_SM` blocks an SM
    at most one run (where the cap allows); the block's shared memory
    within an SM's share."""
    n = b * t
    p = plan(b, t, "epilogue")
    warp_rows = p["rows"] // EPI_WARPS
    assert warp_rows % EPI_GROUP == 0 and warp_rows <= EPI_GROUP * EPI_MAX_GROUPS
    outs = collections.Counter()
    runs = collections.defaultdict(list)
    for blk, warp, lane, row, col in epilogue_outputs(p, n):
        assert lane == col
        outs[row, col] += 1
        if lane == 0:
            runs[blk, warp].append(row)
    assert len(outs) == n * C and set(outs.values()) == {1}
    for rows in runs.values():
        assert rows == list(range(rows[0], rows[0] + len(rows))) and len(rows) <= warp_rows
    slots = 132 * EPI_BLOCKS_PER_SM * EPI_WARPS
    assert -(-n // warp_rows) <= slots or warp_rows == EPI_GROUP * EPI_MAX_GROUPS
    assert warp_rows == EPI_GROUP or -(-n // (warp_rows - EPI_GROUP)) > slots
    assert (p["blocks"] - 1) * p["rows"] < n <= p["blocks"] * p["rows"]
    assert EPI_BLOCKS_PER_SM * (p["smem_bytes"] + 1024) <= SMEM_PER_SM


def emulate_prologue(x, temb, emb_base, w_joint, seq_bias, *, rnd, quantize):
    """K2 in numpy float32, row by row in each warp's order: (h, emb_act
    as float32 of bf16, None) or (h, codes, scales)."""
    b, t, c = x.shape
    e = emb_base.shape[-1]
    n = b * t
    xf, eb = x.reshape(n, c), emb_base.reshape(n, e)
    w = _bf16(w_joint) if rnd else w_joint  # staged once, rounded once
    lanes = np.arange(32)
    hcols = 4 * lanes[:, None] + np.arange(4)                          # (32, 4)
    ecols = 4 * (np.arange(e // 128)[:, None, None] * 32 + lanes[:, None]) + np.arange(4)
    ecols = ecols.transpose(1, 0, 2).reshape(32, -1)                   # (32, 16) a lane's
    h = np.zeros((n, D), F32)
    act = np.zeros((n, e), F32)
    scale = np.zeros((n, 1), F32)
    for _, _, row in prologue_rows(plan(b, t, "prologue", c=c, e=e), n):
        xv = _bf16(xf[row]) if rnd else xf[row]   # lanes 0..C-1, then shuffled
        acc = np.zeros((32, 4), F32)
        for ci in range(c):
            acc = _fma(xv[ci], w[ci][hcols], acc)
        h[row][hcols] = acc + seq_bias[row % t][hcols]
        v = temb[ecols] + eb[row][ecols]
        if not quantize:
            act[row][ecols] = _bf16(v / (F32(1) + np.exp(-v)))
            continue
        a = v * (F32(1) / (F32(1) + np.exp(-v)))
        m = np.abs(a).max(axis=1)                  # each lane's largest
        for o in (16, 8, 4, 2, 1):
            m = np.maximum(m, m[lanes ^ o])
        s = np.maximum(m[0], F32(1e-8)) / F32(127)
        act[row][ecols] = np.rint(a / s)
        scale[row] = s
    h = h.reshape(b, t, D)
    if quantize:
        return h, act.reshape(b, t, e), scale.reshape(b, t, 1)
    return h, act.reshape(b, t, e), None


def emulate_epilogue(h, x_t, w_out, b_out, alpha, beta, *, rnd):
    """K3 in numpy float32: each output's chain in ascending d, lane c's
    column of W_out (rounded once) against each of its warp's rows, then
    the affine."""
    b, t, d = h.shape
    n = b * t
    hf = _bf16(h.reshape(n, d)) if rnd else h.reshape(n, d)
    w = _bf16(w_out) if rnd else w_out
    rows, cols = np.array([(r, c) for *_, r, c in epilogue_outputs(plan(b, t, "epilogue"), n)]).T
    acc = np.zeros(len(rows), F32)
    for k in range(d):
        acc = _fma(hf[rows, k], w[k, cols], acc)
    sums = np.zeros((n, C), F32)
    sums[rows, cols] = acc
    xf = x_t.reshape(n, C)
    out = _fma(F32(alpha), sums + b_out, F32(beta) * xf)
    return out.reshape(b, t, C)


def _prologue_inputs(seed):
    rng = np.random.RandomState(seed)
    return (_rand(rng, B, T, C), _rand(rng, E), _rand(rng, B, T, E, scale=2.0),
            _rand(rng, C, D, scale=0.2), _rand(rng, T + 3, D))


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
def test_prologue_emulation_matches_jax_bf16_mode(mxu):
    """The emulation with bf16 emb_act against the JAX kernel (emb_dtype
    bf16): h within atol 2e-4, emb_act within one bf16 step."""
    x, temb, emb_base, w_joint, seq_bias = _prologue_inputs(3)
    h, act, _ = emulate_prologue(x, temb, emb_base, w_joint, seq_bias, rnd=mxu == "bfloat16",
                                 quantize=False)
    h_want, act_want = jax_prologue(
        jnp.asarray(x), jnp.asarray(temb[None, None] + emb_base), jnp.asarray(w_joint),
        jnp.asarray(seq_bias[:T]), mxu_dtype=getattr(jnp, mxu), emb_dtype=jnp.bfloat16)
    np.testing.assert_allclose(h, np.asarray(h_want), atol=2e-4)
    np.testing.assert_allclose(act, np.asarray(act_want).astype(F32), rtol=2 ** -7, atol=0)


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
def test_prologue_emulation_matches_jax_int8_mode(mxu):
    """The emulation with int8 output against the JAX kernel
    (``quantize_emb``): h within atol 2e-4, codes at most 1 apart at no
    more than 0.1 % of them, scales within 1e-6 relative."""
    x, temb, emb_base, w_joint, seq_bias = _prologue_inputs(4)
    h, q, s = emulate_prologue(x, temb, emb_base, w_joint, seq_bias, rnd=mxu == "bfloat16",
                               quantize=True)
    h_want, q_want, s_want = map(np.asarray, jax_prologue(
        jnp.asarray(x), jnp.asarray(temb[None, None] + emb_base), jnp.asarray(w_joint),
        jnp.asarray(seq_bias[:T]), mxu_dtype=getattr(jnp, mxu), quantize_emb=True))
    np.testing.assert_allclose(h, h_want, atol=2e-4)
    diff = np.abs(q.astype(np.int32) - q_want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s, s_want, rtol=1e-6)


def test_prologue_emulation_rounds_ties_half_to_even():
    """On `kernel_checks.prologue_tie_errors`' rows (SiLU exact, scale
    1/4, every other code on a half) the emulated codes are the
    half-to-even ones and every scale is 1/4, exactly."""
    x, _, _, w_joint, seq_bias = _prologue_inputs(5)
    n = B * T
    k = 68 + (np.arange(E) + np.arange(n)[:, None]) % 58
    ties, want = ((k + 0.5) / 4).astype(F32), k + k % 2
    ties[:, 0], want[:, 0] = 31.75, 127
    _, q, s = emulate_prologue(x, np.zeros(E, F32), ties.reshape(B, T, E), w_joint, seq_bias,
                               rnd=True, quantize=True)
    np.testing.assert_array_equal(q.reshape(n, E), want)
    np.testing.assert_array_equal(s, F32(0.25))


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
def test_epilogue_emulation_matches_jax(mxu):
    """The emulation of K3's lanes and chains against the JAX kernel: within
    atol 2e-4."""
    rng = np.random.RandomState(6)
    h, x_t = _rand(rng, B, T, D), _rand(rng, B, T, C)
    w_out, b_out = _rand(rng, D, C, scale=0.1), _rand(rng, C, scale=0.1)
    got = emulate_epilogue(h, x_t, w_out, b_out, 0.9, 0.1, rnd=mxu == "bfloat16")
    want = jax_epilogue(jnp.asarray(h), jnp.asarray(x_t), jnp.asarray(w_out), jnp.asarray(b_out),
                        jnp.float32(0.9), jnp.float32(0.1), mxu_dtype=getattr(jnp, mxu))
    np.testing.assert_allclose(got, np.asarray(want), atol=2e-4)
