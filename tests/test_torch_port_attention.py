"""PyTorch port: K8, the standalone linear attention, on the CPU (its plain
version through the autograd Function) against the JAX package's
`fused_linear_attention` (Pallas in interpret mode, as
tests/test_pallas_attention.py runs it), and the "xla" module math
against JAX's, with its type promotion.

Bounds: float32 outputs within 1e-5 and gradients within 1e-4, the JAX
kernel's own bounds against its XLA formulation; bf16 within 2 % of the
largest value, the bound the JAX package holds its bf16 modes to."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.ops.linear_attention import temporal_linear_attention as jax_attention
from conductor_tpu.ops.pallas_attention import fused_linear_attention as jax_fused
from conductor_tpu_torch.ops import launch_counts, reset_launch_counts
from conductor_tpu_torch.ops.attention import fused_linear_attention, linear_attention_plain
from conductor_tpu_torch.ops.linear_attention import temporal_linear_attention

torch.set_num_threads(2)

DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _qkv(b, tq, tk, d, seed, dtype="float32"):
    rng = np.random.RandomState(seed)
    arrays = [rng.normal(size=(b, t, d)).astype(np.float32) for t in (tq, tk, tk)]
    tdt, jdt = DTYPES[dtype]
    return ([torch.from_numpy(a).to(tdt) for a in arrays],
            [jnp.asarray(a).astype(jdt) for a in arrays])


def _ragged_mask(lengths, t):
    return (np.arange(t)[None, :] < np.asarray(lengths)[:, None]).astype(np.float32)[..., None]


def _close(got, want, dtype, tol=1e-5):
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=tol)
    else:
        assert float(np.abs(got - want).max()) <= 0.02 * float(np.abs(want).max())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tq,tk,d,h", [(64, 64, 128, 8), (60, 20, 128, 8), (33, 17, 64, 4)])
def test_kernel_plain_version_matches_jax_kernel(tq, tk, d, h, dtype):
    (q, k, v), (jq, jk, jv) = _qkv(2, tq, tk, d, tq + tk, dtype)
    reset_launch_counts()
    got = fused_linear_attention(q, k, v, h)
    assert got.dtype == q.dtype and launch_counts()["linear_attention"] == 0
    _close(got, jax_fused(jq, jk, jv, h), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ragged_key_mask_matches_jax_kernel(dtype):
    """Lengths [50, 20] at T = 50: the masked keys get no weight.  With a
    float32 mask, bf16 k and v become float32 in both wrappers."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 50, 50, 128, 1, dtype)
    mask = _ragged_mask([50, 20], 50)
    got = fused_linear_attention(q, k, v, 8, torch.from_numpy(mask))
    _close(got, jax_fused(jq, jk, jv, 8, jnp.asarray(mask)), dtype)
    # the second clip equals its first 20 frames' attention alone
    alone = linear_attention_plain(q[1:, :, :], k[1:, :20], v[1:, :20], 8)
    _close(got[1:], alone.numpy() if dtype == "float32" else alone.float().numpy(), dtype)


@pytest.mark.parametrize("masked", [False, True])
def test_gradients_match_jax_custom_vjp(masked):
    """float32 gradients of sum(y^2) through the autograd Function (the
    plain formula's autograd) against `jax.grad` through the JAX
    custom_vjp (its XLA formulation's VJP)."""
    (q, k, v), (jq, jk, jv) = _qkv(1, 24, 24, 128, 3)
    mask = _ragged_mask([17], 24) if masked else None

    def loss(q, k, v):
        m = None if mask is None else jnp.asarray(mask)
        return jnp.sum(jax_fused(q, k, v, 8, m) ** 2)

    want = jax.grad(loss, argnums=(0, 1, 2))(jq, jk, jv)
    ins = [a.clone().requires_grad_(True) for a in (q, k, v)]
    m = None if mask is None else torch.from_numpy(mask)
    (fused_linear_attention(*ins, 8, m) ** 2).sum().backward()
    for a, w in zip(ins, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=1e-4)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_xla_impl_matches_jax_with_its_promotion(dtype):
    """The module math with a float32 mask: bf16 k and v promote to float32
    and q's softmax stays bf16, so y is float32, as in JAX."""
    (q, k, v), (jq, jk, jv) = _qkv(2, 40, 40, 128, 2, dtype)
    mask = _ragged_mask([40, 25], 40)
    got = temporal_linear_attention(q, k, v, 8, torch.from_numpy(mask), impl="xla")
    want = jax_attention(jq, jk, jv, 8, jnp.asarray(mask), impl="xla")
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == "float32"
    _close(got, want, dtype)
    # and without a mask, everything stays in the inputs' dtype
    got = temporal_linear_attention(q, k, v, 8, None, impl="xla")
    want = jax_attention(jq, jk, jv, 8, None, impl="xla")
    assert str(got.dtype).split(".")[-1] == str(want.dtype) == dtype
    _close(got, want, dtype)


def test_pallas_impl_routes_to_the_kernel_wrapper():
    """impl="pallas" is `fused_linear_attention`; an unknown impl raises."""
    (q, k, v), _ = _qkv(1, 16, 16, 64, 4)
    mask = torch.ones(1, 16, 1)
    torch.testing.assert_close(temporal_linear_attention(q, k, v, 4, mask, impl="pallas"),
                               fused_linear_attention(q, k, v, 4, mask), rtol=0, atol=0)
    torch.testing.assert_close(temporal_linear_attention(q, k, v, 4, mask, impl="pallas"),
                               temporal_linear_attention(q, k, v, 4, mask), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="impl"):
        temporal_linear_attention(q, k, v, 4, mask, impl="cuda")
