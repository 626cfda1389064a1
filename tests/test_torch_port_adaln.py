"""PyTorch port: K1's AdaLN modulation as its own function.  The plain
version (`adaln_modulation_plain`) against the JAX kernel's formula
(`conductor_tpu/ops/pallas_layer.py:112-120`) on the same numpy inputs:
the int8 mode exactly (the integer product by `jax.lax.dot_general` into
int32, then JAX's dequantization), the bf16 and float32 modes within a
float32 summation order; stacked layers as each layer's columns in
turn; the wrapper on CPU tensors; and the plain K1
built on it against the JAX `fused_decoder_stack` in interpret mode at
T = 100, 2 layers.  The GEMM kernel itself runs only on the card
(`tests/test_torch_port_cuda.py::test_adaln_modulation_matches_plain`)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.pallas_layer import fused_decoder_stack as jax_decoder_stack
from conductor_tpu.ops.pallas_layer import quantize_rows as jax_quantize_rows
from conductor_tpu_torch.ops import part_launch_counts, reset_launch_counts
from conductor_tpu_torch.ops.decoder_stack import (
    adaln_modulation,
    adaln_modulation_plain,
    fused_decoder_stack,
)

torch.set_num_threads(2)

E, N = 128, 192  # emb width, 6 D at D = 32


def _int8_operands(rng, rows):
    """int8 codes and float32 scales of emb (rows, E) and W (E, N), a bias."""
    emb = rng.randint(-127, 128, size=(rows, E)).astype(np.int8)
    w = rng.randint(-127, 128, size=(E, N)).astype(np.int8)
    emb_scale = rng.uniform(1e-3, 2e-2, size=(rows, 1)).astype(np.float32)
    w_scale = rng.uniform(1e-4, 1e-3, size=(1, N)).astype(np.float32)
    return emb, w, emb_scale, w_scale, rng.normal(size=N).astype(np.float32)


def _jax_int8_mod(emb, w, emb_scale, w_scale, bias):
    acc = jax.lax.dot_general(jnp.asarray(emb), jnp.asarray(w), (((1,), (0,)), ((), ())),
                              preferred_element_type=jnp.int32)
    scale = jnp.asarray(emb_scale) * jnp.asarray(w_scale)
    return acc.astype(jnp.float32) * scale + jnp.asarray(bias)


@pytest.mark.parametrize("rows", [37, 100])
def test_adaln_plain_int8_matches_jax_exactly(rows):
    """The int8 product is exact on both sides and the dequantization rounds
    each op in the same order, so the two agree bit for bit."""
    ops = _int8_operands(np.random.RandomState(rows), rows)
    want = np.asarray(_jax_int8_mod(*ops))
    emb, w, emb_scale, w_scale, bias = map(torch.from_numpy, ops)
    got = adaln_modulation_plain(emb, w, bias, emb_scale=emb_scale, adaln_w_scale=w_scale)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("mxu", ["bfloat16", "float32"])
def test_adaln_plain_matches_jax(mxu):
    """``md(emb, aw) + ab``: operands rounded to the MXU dtype, float32
    products; the sums differ only in order (1e-5 of the largest value)."""
    rng = np.random.RandomState(5)
    emb = rng.normal(size=(2, 37, E)).astype(np.float32)
    w = (rng.normal(size=(E, N)) * 0.05).astype(np.float32)
    bias = rng.normal(size=N).astype(np.float32)
    jd = getattr(jnp, mxu)
    want = np.asarray(jnp.dot(jnp.asarray(emb).astype(jd), jnp.asarray(w).astype(jd),
                              preferred_element_type=jnp.float32) + jnp.asarray(bias))
    got = adaln_modulation_plain(*map(torch.from_numpy, (emb, w, bias)),
                                 mxu_dtype=getattr(torch, mxu)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("int8", [False, True])
def test_adaln_plain_stacked_is_each_layer_in_turn(int8):
    """Stacked weights, (L, E, N) with (L, N) biases and (L, 1, N) scales,
    as K1 hands them to its GEMM: (rows, L N), layer l's N columns the JAX
    formula on layer l's weights (int8 bit for bit, bf16 within a float32
    summation order)."""
    rng = np.random.RandomState(7 + int(int8))
    layers = [_int8_operands(rng, 30) for _ in range(3)]
    emb, emb_scale = layers[0][0], layers[0][2]
    if not int8:
        emb = rng.normal(size=(30, E)).astype(np.float32)
        layers = [(None, (w * 1e-3).astype(np.float32), None, None, b) for _, w, _, _, b in layers]
    w, w_scale, bias = (np.stack([op[i] for op in layers]) for i in (1, 3, 4))
    if int8:
        want = [np.asarray(_jax_int8_mod(emb, w[i], emb_scale, w_scale[i], bias[i]))
                for i in range(3)]
        got = adaln_modulation_plain(*map(torch.from_numpy, (emb, w, bias)),
                                     emb_scale=torch.from_numpy(emb_scale),
                                     adaln_w_scale=torch.from_numpy(w_scale))
        np.testing.assert_array_equal(got.numpy(), np.concatenate(want, -1))
        return
    bf = jnp.bfloat16
    want = np.concatenate([
        np.asarray(jnp.dot(jnp.asarray(emb).astype(bf), jnp.asarray(w[i]).astype(bf),
                           preferred_element_type=jnp.float32) + bias[i]) for i in range(3)], -1)
    got = adaln_modulation_plain(*map(torch.from_numpy, (emb, w, bias)), mxu_dtype=torch.bfloat16)
    assert got.shape == (30, 3 * N)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_adaln_wrapper_takes_the_plain_path_on_cpu():
    """On CPU tensors the wrapper (stacked weights, as K1 launches its GEMM)
    is its plain version and counts no launch; one scale of the int8 pair
    raises."""
    rng = np.random.RandomState(6)
    emb, w, emb_scale, w_scale, bias = map(torch.from_numpy, _int8_operands(rng, 20))
    w, w_scale, bias = (torch.stack([w, -w]), torch.stack([w_scale, w_scale]),
                        torch.stack([bias, bias]))
    reset_launch_counts()
    got = adaln_modulation(emb, w, bias, emb_scale=emb_scale, adaln_w_scale=w_scale)
    assert torch.equal(got, adaln_modulation_plain(emb, w, bias, emb_scale=emb_scale,
                                                   adaln_w_scale=w_scale))
    assert part_launch_counts() == {"adaln_modulation": 0, "adaln_modulation_f32": 0}
    with pytest.raises(ValueError):
        adaln_modulation(emb, w, bias, emb_scale=emb_scale)


# K1 at T = 100 (a ragged tile), 2 layers: B = 2, D = 32, H = 4, E = 128
B, T, D, H, L = 2, 100, 32, 4, 2


def _stack_args(rng):
    head = np.arange(D) // (D // H)
    seg = (head[:, None] == head[None, :]).astype(np.float32)
    vecs = (rng.normal(size=(L, 24, D)) * 0.3).astype(np.float32)
    vecs[:, [0, 5, 8, 11, 16]] += 1.0  # LN gains around 1
    return [
        rng.normal(size=(B, T, D)).astype(np.float32),                          # x
        rng.normal(size=(B, T, E)).astype(np.float32),                          # emb_act
        (rng.normal(size=(L, B, D, D)) * 0.3).astype(np.float32) * seg,         # cross KV
        (rng.normal(size=(L, 9, D, D)) * 0.2).astype(np.float32),               # mats
        vecs,
        (rng.normal(size=(L, E, 6 * D)) * 0.05).astype(np.float32),            # adaln_w
        (rng.normal(size=(L, 6 * D)) * 0.1).astype(np.float32),                 # adaln_b
    ]


@pytest.mark.parametrize("int8", [False, True])
def test_decoder_stack_plain_on_adaln_plain_matches_jax_kernel(int8):
    """Plain K1, whose modulation is `adaln_modulation_plain`, against the JAX
    kernel in interpret mode (float32 operands; in the int8 mode the JAX
    quantization of emb_act and the AdaLN weights handed to both); atol 2e-4."""
    args = _stack_args(np.random.RandomState(10 + int(int8)))
    kw_jax, kw = {}, {}
    if int8:
        q, s = jax_quantize_rows(jnp.asarray(args[1]))
        qw, sw = jax_quantize_rows(jnp.swapaxes(jnp.asarray(args[5]), 1, 2))
        args[1], args[5] = np.array(q), np.array(jnp.swapaxes(qw, 1, 2))
        scales = np.array(s), np.array(jnp.swapaxes(sw, 1, 2))
        kw_jax = dict(emb_scale=jnp.asarray(scales[0]), adaln_w_scale=jnp.asarray(scales[1]))
        kw = dict(emb_scale=torch.from_numpy(scales[0]),
                  adaln_w_scale=torch.from_numpy(scales[1]))
    want = np.asarray(jax_decoder_stack(*map(jnp.asarray, args), H, mxu_dtype=jnp.float32,
                                        **kw_jax))
    got = fused_decoder_stack(*(torch.from_numpy(a) for a in args), H,
                              mxu_dtype=torch.float32, **kw)
    assert float(np.abs(want).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4)
