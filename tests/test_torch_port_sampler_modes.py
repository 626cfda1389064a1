"""PyTorch port: the int8-AdaLN and bf16-VPU serving modes of K1 and K2
against the JAX package.  `quantize_rows`, the int8 weight pack, the plain
K1 in each mode (with bf16 and with float32 matmul operands) and the plain
K2 with int8 output against the JAX Pallas kernels (interpret mode), and
`generate` under bench.py's serving config, in bf16 and in float32,
against JAX's `DDPMTrainer.generate` of the same config, at a small size
(B = 2, T = 37 ragged, D = 32, H = 4, L = 2, E = 128)."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.synth import synth_state_dict
from conductor_tpu.ops.pallas_layer import fused_decoder_stack as jax_decoder_stack
from conductor_tpu.ops.pallas_layer import quantize_rows as jax_quantize_rows
from conductor_tpu.ops.pallas_sampler import sampler_prologue as jax_prologue
from conductor_tpu.train import fused_denoiser as jfd
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxDDPMTrainer
from conductor_tpu.train.ddpm_trainer import TrainState
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.interop import load_reference_state_dict, manifest
from conductor_tpu_torch.models.transformer import MotionTransformer
from conductor_tpu_torch.ops.decoder_stack import decoder_stack_plain, quantize_rows
from conductor_tpu_torch.ops.sampler_glue import sampler_prologue
from conductor_tpu_torch.train.fused_denoiser import FusedDenoiser

torch.set_num_threads(2)

B, T, D, H, L, E, C = 2, 37, 32, 4, 2, 128, 26
BF16, F32 = torch.bfloat16, torch.float32


def _rand(rng, *shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)


def test_quantize_rows_matches_jax():
    """Codes equal and scales within 1 ulp on random rows, on rows whose
    values sit exactly on half codes (scale 1/8: half-to-even decides) and
    on an all-zero row (scale 1e-8 / 127)."""
    rng = np.random.RandomState(0)
    tie = (np.arange(-126, 126) + 0.5) / 8
    ties = np.stack([np.concatenate([tie[i::4], [127 / 8]]) for i in range(4)]).astype(np.float32)
    for x in (_rand(rng, 3, 37, 128, scale=2.0), ties, np.zeros((2, 64), np.float32)):
        q, s = quantize_rows(torch.from_numpy(x))
        jq, js = jax_quantize_rows(jnp.asarray(x))
        assert q.dtype == torch.int8 and s.dtype == F32 and s.shape == x.shape[:-1] + (1,)
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        np.testing.assert_array_max_ulp(s.numpy(), np.asarray(js), maxulp=1)
    assert np.abs(q.numpy()).max() == 0
    # the ties themselves: each x / scale is k + 0.5, rounded to the even k
    q, s = quantize_rows(torch.from_numpy(ties))
    assert float(s[0, 0]) == 1 / 8
    codes = ties[:, :-1] * 8
    np.testing.assert_array_equal(q.numpy()[:, :-1], np.round(codes))
    assert (np.abs(q.numpy()[:, :-1] - codes) == 0.5).all()


CFG = Config(denoiser=DenoiserConfig(num_frames=40, latent_dim=D, ff_size=16, num_layers=L,
                                     num_heads=H, compute_dtype="float32"))


def test_int8_pack_matches_jax():
    """The int8 pack's adaln_w / adaln_w_scale equal JAX
    `FusedDenoiser(int8 cfg)`'s, quantized from the float32 weights."""
    model = MotionTransformer.from_config(CFG.denoiser).eval()
    sd = synth_state_dict(manifest(model), seed=1)
    load_reference_state_dict(model, sd)
    params = jax.tree.map(jnp.asarray, import_motion_transformer(sd))["params"]
    cfg = CFG.replace(denoiser=dataclasses.replace(CFG.denoiser, sampler_adaln_int8=True))
    got, want = FusedDenoiser(model, cfg), jfd.FusedDenoiser(params, cfg)
    assert got.adaln_w.dtype == torch.int8 and got.adaln_w.shape == (L, E, 6 * D)
    assert got.adaln_w_scale.shape == (L, 1, 6 * D)
    np.testing.assert_array_equal(got.adaln_w.numpy(), np.asarray(want.adaln_w))
    np.testing.assert_array_equal(got.adaln_w_scale.numpy(), np.asarray(want.adaln_w_scale))


def _stack_args(seed):
    """Random K1 operands: x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b."""
    rng = np.random.RandomState(seed)
    head = np.arange(D) // (D // H)
    seg = (head[:, None] == head[None, :]).astype(np.float32)
    vecs = _rand(rng, L, 24, D, scale=0.3)
    vecs[:, [0, 5, 8, 11, 16]] += 1.0  # LN gains around 1
    return [_rand(rng, B, T, D), _rand(rng, B, T, E), _rand(rng, L, B, D, D, scale=0.3) * seg,
            _rand(rng, L, 9, D, D, scale=0.2), vecs, _rand(rng, L, E, 6 * D, scale=0.05),
            _rand(rng, L, 6 * D, scale=0.1)]


def _jax_quantized(a, per_column=False):
    """JAX's int8 codes and scales of ``a``: per row, or per column of each
    (E, 6D) matrix, as the JAX pack quantizes adaln_w."""
    if not per_column:
        return tuple(np.array(r) for r in jax_quantize_rows(jnp.asarray(a)))
    return tuple(np.ascontiguousarray(np.array(r).transpose(0, 2, 1))
                 for r in jax_quantize_rows(jnp.asarray(a.transpose(0, 2, 1))))


def test_decoder_stack_int8_plain_matches_jax_kernel():
    """Plain K1 in the int8-AdaLN mode against the JAX fused_decoder_stack
    (interpret) on the same int8 operands and scales, float32 MXU: the
    integer product is exact on both sides; atol 2e-4."""
    x, emb, kvc, mats, vecs, aw, ab = _stack_args(3)
    emb_q, emb_s = _jax_quantized(emb)
    aw_q, aw_s = _jax_quantized(aw, per_column=True)
    args = (x, emb_q, kvc, mats, vecs, aw_q, ab)
    want = jax_decoder_stack(*map(jnp.asarray, args), H, mxu_dtype=jnp.float32,
                             emb_scale=jnp.asarray(emb_s), adaln_w_scale=jnp.asarray(aw_s))
    got = decoder_stack_plain(*map(torch.from_numpy, args), H, mxu_dtype=F32,
                              emb_scale=torch.from_numpy(emb_s),
                              adaln_w_scale=torch.from_numpy(aw_s))
    assert float(np.abs(np.asarray(want)).max()) > 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-4)


def test_sampler_prologue_int8_plain_matches_jax_kernel():
    """Plain K2 with int8 output against the JAX sampler_prologue
    (``quantize_emb``, interpret): h within atol 2e-4; codes at most 1
    apart, at no more than 0.1 % of entries (a one-ulp difference in the
    SiLU can cross a half code); scales within 1e-6 relative."""
    rng = np.random.RandomState(2)
    x, temb, emb_base = _rand(rng, B, T, C), _rand(rng, E), _rand(rng, B, T, E, scale=2.0)
    w_joint, seq_bias = _rand(rng, C, D, scale=0.2), _rand(rng, T, D)
    h_want, q_want, s_want = map(np.asarray, jax_prologue(
        jnp.asarray(x), jnp.asarray(temb[None, None] + emb_base), jnp.asarray(w_joint),
        jnp.asarray(seq_bias), quantize_emb=True))
    h, q, s = sampler_prologue(*map(torch.from_numpy, (x, temb, emb_base, w_joint, seq_bias)),
                               quantize_emb=True)
    assert q.dtype == torch.int8 and s.shape == (B, T, 1)
    np.testing.assert_allclose(h.numpy(), h_want, atol=2e-4)
    diff = np.abs(q.numpy().astype(np.int32) - q_want.astype(np.int32))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3, (diff.max(), (diff > 0).mean())
    np.testing.assert_allclose(s.numpy(), s_want, rtol=1e-6)


def _vpu_operands(int8):
    """K1's operands for the bf16-VPU tests (seed 4): the seven arrays and
    the int8 scales, or none."""
    x, emb, kvc, mats, vecs, aw, ab = _stack_args(4)
    scales = {}
    if int8:
        emb, scales["emb_scale"] = _jax_quantized(emb)
        aw, scales["adaln_w_scale"] = _jax_quantized(aw, per_column=True)
    return (x, emb, kvc, mats, vecs, aw, ab), scales


# JAX's kernel in the bf16-VPU mode, run in a process of its own with XLA's
# excess precision off (XLA reads its flags once, at start).  With it on, as
# in this process, XLA on the CPU fuses each bf16 chain with its float32
# neighbours and skips its roundings: the port was then 0.0065 of the
# largest value from JAX, as far as the mode itself moves the output.
_JAX_VPU = """
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_allow_excess_precision=false"
import jax, jax.numpy as jnp, numpy as np
jax.config.update("jax_platforms", "cpu")
from conductor_tpu.ops.pallas_layer import fused_decoder_stack
a = np.load(sys.argv[1])
out = {}
for case in ("bf16", "int8", "f32_bf16", "f32_int8"):
    args = [jnp.asarray(a[f"{case}_{i}"]) for i in range(7)]
    kw = {k: jnp.asarray(a[f"{case}_{k}"]) for k in ("emb_scale", "adaln_w_scale")
          if f"{case}_{k}" in a}
    mxu = jnp.float32 if case.startswith("f32") else jnp.bfloat16
    out[case] = np.asarray(fused_decoder_stack(*args, int(a["heads"]), mxu_dtype=mxu,
                                               vpu_dtype=jnp.bfloat16, **kw))
np.savez(sys.argv[2], **out)
"""


def _vpu_case(int8: bool, mxu: str) -> str:
    """The name of a bf16-VPU case of `jax_vpu_outputs`: its matmul
    operands (bf16 or float32) and its AdaLN product (bf16 or int8)."""
    return ("f32_" if mxu == "float32" else "") + ("int8" if int8 else "bf16")


@pytest.fixture(scope="module")
def jax_vpu_outputs(tmp_path_factory):
    """JAX's bf16-VPU K1 (interpret) on `_vpu_operands`, each bf16 op
    rounded, with bf16 and with float32 matmul operands: {`_vpu_case`:
    output}."""
    tmp = tmp_path_factory.mktemp("vpu")
    arrays = {"heads": np.int32(H)}
    for int8, mxu in ((False, "bfloat16"), (True, "bfloat16"), (False, "float32"),
                      (True, "float32")):
        case = _vpu_case(int8, mxu)
        args, scales = _vpu_operands(int8)
        arrays.update({f"{case}_{i}": a for i, a in enumerate(args)})
        arrays.update({f"{case}_{k}": v for k, v in scales.items()})
    np.savez(tmp / "in.npz", **arrays)
    root = str(Path(__file__).resolve().parents[1])
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([root, os.environ.get("PYTHONPATH", "")]))
    subprocess.run([sys.executable, "-c", _JAX_VPU, str(tmp / "in.npz"), str(tmp / "out.npz")],
                   check=True, cwd=root, env=env, timeout=300)
    return dict(np.load(tmp / "out.npz"))


# Measured on these inputs (largest value 10.0): the port's bf16-VPU plain
# K1 is 9.5e-8 of the largest value from JAX's bf16-VPU kernel, alone and
# with int8 AdaLN; the mode moves both 0.0055 (0.0094 with int8) from their
# float32-VPU paths.  With float32 matmul operands the products round, and
# XLA and torch sum them in other orders: the float32-VPU paths agree to
# 3.3e-7 of the largest value, but a bf16 rounding of the mode's chains then
# lands on the other side of a tie now and then, and moves its row and,
# through the next layer's KV, its clip (the port's own output moves up to
# 0.0009 of the largest value under 1-2 ulp of noise on x, in either
# operand type).  There the mode is held by the mean distance (2.7e-5 of the
# largest value measured alone, 3.6e-9 with int8 AdaLN, which flipped
# nothing), the largest one within the mode's own largest move (0.0026
# against 0.0050 measured), the port's own move by at least half of JAX's
# (a plain path that skipped the bf16 chains would not move), and the
# float32-VPU paths by VPU_REL_TOL.
VPU_REL_TOL = 1e-4


@pytest.mark.parametrize("int8,mxu", [(False, "bfloat16"), (True, "bfloat16"),
                                      (False, "float32"), (True, "float32")],
                         ids=["False", "True", "f32-False", "f32-True"])
def test_decoder_stack_vpu_bf16_plain_matches_jax_kernel(jax_vpu_outputs, int8, mxu):
    """Plain K1 in the bf16-VPU mode (bf16 or float32 MXU, alone and with
    int8 AdaLN) against the JAX kernel in that mode (interpret, every bf16
    op rounded), within VPU_REL_TOL of the largest value, far below the
    mode's own move; each side within 2 % of its float32-VPU path, JAX's
    own bound (tests/test_fused_denoiser.py:221-241)."""
    args, scales = _vpu_operands(int8)
    want = jax_vpu_outputs[_vpu_case(int8, mxu)]
    want_exact = np.asarray(jax_decoder_stack(
        *map(jnp.asarray, args), H, mxu_dtype=getattr(jnp, mxu), vpu_dtype=jnp.float32,
        **{k: jnp.asarray(v) for k, v in scales.items()}))
    kw = {k: torch.from_numpy(v) for k, v in scales.items()}
    got, got_exact = (decoder_stack_plain(*map(torch.from_numpy, args), H,
                                          mxu_dtype=getattr(torch, mxu), vpu_dtype=vd,
                                          **kw).numpy() for vd in (BF16, F32))
    scale = float(np.abs(want_exact).max())
    mode = float(np.abs(want - want_exact).max())
    assert scale > 1.0
    if mxu == "float32":
        assert np.abs(got_exact - want_exact).max() <= VPU_REL_TOL * scale
        assert np.abs(got - want).mean() <= VPU_REL_TOL * scale
        assert np.abs(got - want).max() <= mode
        assert np.abs(got - got_exact).max() >= mode / 2  # the port's own output moves with it
    else:
        assert np.abs(got - want).max() <= VPU_REL_TOL * scale
    assert np.abs(got - got_exact).max() <= 0.02 * scale
    assert 10 * VPU_REL_TOL * scale < mode <= 0.02 * scale  # the mode moves the numbers


# bench.py's serving config (bench.py:41-50) at a small size
BENCH = dict(attention_impl="pallas", compute_dtype="bfloat16", layer_impl="pallas_fused",
             sampler_adaln_int8=True, music_encoder_impl="pallas")
SMALL = dict(num_frames=32, latent_dim=32, ff_size=16, num_layers=2, num_heads=4)
# measured here: the port 0.0031 (0.0030 with bf16 VPU) of the largest value
# from JAX, both 0.0020-0.0022 of it from the float32 flax path
GEN_REL_TOL = 0.005  # port against JAX, of the largest value
LADDER_REL_TOL = 0.03  # each against the float32 flax path (tests/test_fused_denoiser.py:189-218)


@pytest.fixture(scope="module")
def generate_setup():
    """Synthetic weights from the port model's manifest, a seeded mel, JAX's
    flax float32 generate as the ladder's reference and the x_T it draws."""
    base = Config(denoiser=DenoiserConfig(**SMALL),
                  diffusion=DiffusionConfig(steps=8, schedule="cosine"),
                  train=TrainConfig(sample_length=1))
    sd = synth_state_dict(manifest(MotionTransformer.from_config(base.denoiser)), seed=2)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], feat_variables=None, opt_state=None)
    rng = jax.random.PRNGKey(0)
    mel = np.random.RandomState(4).uniform(0, 1, size=(1, 96, 128)).astype(np.float32)
    flax_cfg = base.replace(denoiser=dataclasses.replace(base.denoiser, layer_impl="flax",
                                                         compute_dtype="float32"))
    ref = np.asarray(JaxDDPMTrainer(flax_cfg).generate(state, jnp.asarray(mel), rng))
    x_t = np.array(jax.random.normal(jax.random.split(rng)[0], (1, 32, 26)))
    return base, sd, state, rng, mel, ref, x_t


@pytest.mark.parametrize("vpu,dtype", [("float32", "bfloat16"), ("bfloat16", "bfloat16"),
                                       ("float32", "float32"), ("bfloat16", "float32")],
                         ids=["float32", "bfloat16", "f32-float32", "f32-bfloat16"])
def test_generate_bench_config_matches_jax(generate_setup, vpu, dtype):
    """`DDPMTrainer.generate` under bench.py's serving config (int8 AdaLN;
    with bf16 VPU as a second case), and under it with
    ``compute_dtype="float32"`` (the fused ladder's float32 mode, with int8
    AdaLN and bf16 VPU), on the CPU against JAX's generate of the same
    config on the same weights and x_T: within 0.5 % of the largest value,
    and both within 3 % of the float32 flax path."""
    base, sd, state, rng, mel, ref, x_t = generate_setup
    cfg = base.replace(denoiser=dataclasses.replace(
        base.denoiser, sampler_vpu_dtype=vpu, **dict(BENCH, compute_dtype=dtype)))
    port = DDPMTrainer(cfg, device="cpu")
    port.load_reference_state_dict(sd)
    assert port.fused.adaln_w.dtype == torch.int8 and port.fused.vpu_dtype == getattr(torch, vpu)
    assert port.fused.mats.dtype == getattr(torch, dtype)
    got = port.generate(torch.from_numpy(mel), noise=torch.from_numpy(x_t)).numpy()
    want = np.asarray(JaxDDPMTrainer(cfg).generate(state, jnp.asarray(mel), rng))
    scale = float(np.abs(ref).max())
    assert got.shape == want.shape == (1, 32, 26) and scale > 1e-2
    assert np.abs(got - want).max() <= GEN_REL_TOL * float(np.abs(want).max())
    assert np.abs(got - ref).max() <= LADDER_REL_TOL * scale
    assert np.abs(want - ref).max() <= LADDER_REL_TOL * scale
