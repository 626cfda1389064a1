"""PyTorch port: the plain MotionTransformer at bf16 (flax's ``dtype=`` rule,
`conductor_tpu_torch/models/precision.py`) against the flax
MotionTransformer(dtype=jnp.bfloat16) on the same synthetic reference
weights: 2 layers, T = 24, the self-attention on the module math ("xla")
and on K8 ("pallas": the port's plain version, JAX's kernel in interpret
mode).  Compared: the frozen encoder's tokens, `precompute_cond` and
`denoise` with a ragged key mask.

Bounds: bf16 within 2 % of each output's largest value, the bound the JAX
package holds its bf16 modes to, with every output's dtype JAX's; float32
within 1e-5 of the largest value, tight enough that a rounding point
moved to the wrong place would show there and not hide in the bf16
bound."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.models import MotionTransformer as FlaxMotionTransformer
from conductor_tpu_torch.interop import synthetic_state_dict
from conductor_tpu_torch.interop.weights import load_reference_state_dict
from conductor_tpu_torch.models.transformer import MotionTransformer

torch.set_num_threads(2)

T = 24
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


@pytest.fixture(scope="module")
def case():
    sd = synthetic_state_dict(MotionTransformer(num_frames=T, num_layers=2), seed=5)
    rng = np.random.RandomState(6)
    mel = rng.uniform(0, 1, size=(2, 3 * T, 128)).astype(np.float32)
    x = rng.normal(size=(2, T, 26)).astype(np.float32)
    mask = (np.arange(T)[None, :] < np.array([T, 15])[:, None]).astype(np.float32)[..., None]
    return sd, mel, x, mask


def _models(sd, dtype, impl):
    tdt, jdt = DTYPES[dtype]
    port = MotionTransformer(num_frames=T, num_layers=2, dtype=tdt, attention_impl=impl).eval()
    load_reference_state_dict(port, sd)
    flax = FlaxMotionTransformer(num_frames=T, num_layers=2, dtype=jdt, attention_impl=impl)
    return port, flax, jax.tree.map(jnp.asarray, import_motion_transformer(sd))


def _close(got, want, dtype):
    assert str(got.dtype).split(".")[-1] == str(want.dtype), (got.dtype, want.dtype)
    got, want = got.float().numpy(), np.asarray(want, dtype=np.float32)
    scale = float(np.abs(want).max())
    assert scale > 1e-3
    tol = 1e-5 if dtype == "float32" else 0.02
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("impl", ["xla", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_module_matches_flax(case, dtype, impl):
    sd, mel, x, mask = case
    port, flax, variables = _models(sd, dtype, impl)
    t = np.array([3, 7], np.int32)  # small arguments: cos / sin agree to float32 rounding
    xf = flax.apply(variables, jnp.asarray(mel), method=flax.encode_music)
    cond = flax.apply(variables, *xf, method=flax.precompute_cond)
    want = flax.apply(variables, jnp.asarray(x), jnp.asarray(t), cond, jnp.asarray(mask),
                      method=flax.denoise)
    with torch.no_grad():
        txf = port.encode_music(torch.from_numpy(mel))
        if dtype == "bfloat16":  # the tokens, then everything from JAX's tokens
            for g, w in zip(txf, xf):
                _close(g, w, dtype)
        txf = tuple(torch.from_numpy(np.array(a, np.float32)).to(DTYPES[dtype][0]) for a in xf)
        tcond = port.precompute_cond(*txf)
        _close(tcond["emb_base"], cond["emb_base"], dtype)
        for g, w in zip(tcond["cross"], cond["cross"]):
            _close(g, w, dtype)
        got = port.denoise(torch.from_numpy(x), torch.from_numpy(t).long(), tcond,
                           torch.from_numpy(mask))
    _close(got, want, dtype)


def test_parameters_stay_float32_and_rounding_moves_output(case):
    """bf16 leaves the parameters float32 and changes the output by more
    than float32 rounding but within the bf16 bound."""
    sd, mel, x, _ = case
    outs = []
    for dtype in ("float32", "bfloat16"):
        port = _models(sd, dtype, "xla")[0]
        assert {p.dtype for p in port.parameters()} == {torch.float32}
        with torch.no_grad():
            cond = port.precompute_cond(*port.encode_music(torch.from_numpy(mel)))
            outs.append(port.denoise(torch.from_numpy(x), torch.tensor([3, 7]), cond))
    ref, low = outs
    err = float((low - ref).abs().max())
    assert low.dtype == torch.float32
    assert 1e-5 * float(ref.abs().max()) < err <= 0.02 * float(ref.abs().max())
