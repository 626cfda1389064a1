"""PyTorch port: the model widths the decoder kernels take beside the
flagship's, on the CPU.

- F13: an FFN wider than D does not fit the fused layers' (D, D) banks.
  The port's `pack_layer_weights` raises where JAX's `_pad_to` raises, on
  the same shapes, and a config that reaches a fused layer path with
  ``ff_size > latent_dim`` is refused where the trainer is built.
- The refusal grid: `_check_training_config` on "cuda" takes D = 32, 64
  and 128 with head widths 8, 16 and 32 on K1-K3 / K5 / K6, and head
  widths 8-64 on K8; it refuses D = 256, head widths above 32 on the
  fused layers, head widths outside 8-64 on K8, ff > D and a pose other
  than 26.
- Parity at the new head widths: the plain K5 / K6 (`decoder_layer_plain`,
  `fused_decoder_layer_train` on CPU tensors) against JAX's Pallas layer
  and its custom_vjp in interpret mode, at D = 64 with 8 heads and D = 128
  with 4 heads, float32 and bf16 products; the plain K8 against JAX's
  `fused_linear_attention` at head widths 8, 32 and 64.  Bounds: those of
  tests/test_torch_port_layer_train.py (float32) and
  tests/test_torch_port_attention.py (float32 1e-5; bf16 2 % of the
  largest value, the bound the JAX package holds its bf16 modes to).
- The launch plans of every widened kernel at every width: threads,
  grid and shared bytes within an H100 block's 232,448 (the kernels' own
  exports are held to the same formulas on the card)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config as JaxConfig
from conductor_tpu.config import DenoiserConfig as JaxDenoiserConfig
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.synth import synth_state_dict
from conductor_tpu.ops.pallas_attention import fused_linear_attention as jax_attention
from conductor_tpu.ops.pallas_layer import fused_decoder_layer as jax_layer
from conductor_tpu.ops.pallas_layer_bwd import fused_decoder_layer_train as jax_layer_train
from conductor_tpu.train import fused_denoiser as jfd
from conductor_tpu_torch.config import Config, DenoiserConfig, TrainConfig, resolve_auto
from conductor_tpu_torch.interop import load_reference_state_dict, manifest
from conductor_tpu_torch.models.transformer import MotionTransformer
from conductor_tpu_torch.ops import decoder_layer_plain, fused_decoder_layer_train
from conductor_tpu_torch.ops import attention, decoder_stack, sampler_glue
from conductor_tpu_torch.ops.attention import fused_linear_attention
from conductor_tpu_torch.ops.decoder_layer_bwd import plan as layer_bwd_plan
from conductor_tpu_torch.train.ddpm_trainer import _check_training_config
from conductor_tpu_torch.train.fused_denoiser import pack_layer_weights

torch.set_num_threads(2)

SMEM_LIMIT = 232_448  # shared bytes a block can have on an H100
SM_SMEM = 233_472     # shared bytes an SM holds for its resident blocks
CUDA = torch.device("cuda")  # only its type is read: no card is needed


# ---------------------------------------------------------------- F13


def test_ffn_wider_than_d_raises_in_both_packages():
    """D = 32 with ff_size = 64: JAX's `pack_layer_weights` raises
    (`_pad_to`'s negative pad), and the port's raises on the same weights
    instead of cropping the FFN; at ff_size = 16 both pack the same banks."""
    for ff in (64, 16):
        den = dict(num_frames=40, latent_dim=32, ff_size=ff, num_layers=1, num_heads=4)
        model = MotionTransformer.from_config(DenoiserConfig(**den)).eval()
        sd = synth_state_dict(manifest(model), seed=2)
        load_reference_state_dict(model, sd)
        params = jax.tree.map(jnp.asarray, import_motion_transformer(sd))["params"]
        cfg = JaxConfig(denoiser=JaxDenoiserConfig(**den))
        if ff > 32:
            with pytest.raises(ValueError):
                jfd.pack_layer_weights(params, 0, cfg)
            with pytest.raises(ValueError, match="ff_size > latent_dim"):
                pack_layer_weights(model, 0)
        else:
            with torch.no_grad():
                got = pack_layer_weights(model, 0)
            for g, w in zip(got, jfd.pack_layer_weights(params, 0, cfg)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("knobs", [{}, dict(layer_impl="pallas_fused"),
                                   dict(train_layer_impl="pallas_fused", layer_impl="flax")])
def test_ffn_wider_than_d_refused_on_fused_layers(knobs, device):
    """ff_size > latent_dim on a config that reaches a fused layer path,
    by hand or by "auto" (CUDA), is refused where the trainer is built on
    both devices, naming the knobs that run the plain layers; with those
    pinned it builds."""
    den = DenoiserConfig(latent_dim=32, ff_size=64, num_heads=4, **knobs)
    cfg = resolve_auto(Config(denoiser=den), device)
    fused = "pallas_fused" in (cfg.denoiser.layer_impl, cfg.denoiser.train_layer_impl)
    if fused:
        with pytest.raises(ValueError, match="ff_size=64 > latent_dim=32") as err:
            _check_training_config(cfg, torch.device(device))
        assert "layer_impl='flax'" in str(err.value)
        assert "train_layer_impl='flax'" in str(err.value)
    else:  # "auto" on the CPU: the plain layers
        _check_training_config(cfg, torch.device(device))
    plain = resolve_auto(Config(denoiser=DenoiserConfig(
        latent_dim=32, ff_size=64, num_heads=4, layer_impl="flax", train_layer_impl="flax")),
        device)
    _check_training_config(plain, torch.device(device))


# ---------------------------------------------------------------- the grid


def _cfg(latent_dim, num_heads, ff_size=None, input_feats=26, plain=False, mask=False):
    den = dict(latent_dim=latent_dim, num_heads=num_heads, input_feats=input_feats,
               ff_size=min(64, latent_dim) if ff_size is None else ff_size)
    if plain:
        den.update(layer_impl="flax", train_layer_impl="flax")
    return resolve_auto(Config(denoiser=DenoiserConfig(**den),
                               train=TrainConfig(replicate_reference_mask=mask)), CUDA)


@pytest.mark.parametrize("d,dh", [(d, dh) for d in (32, 64, 128) for dh in (8, 16, 32)])
def test_fused_layers_take_the_ported_widths(d, dh):
    """"auto" on CUDA (K1-K3, K5 / K6, K4, K7) builds at D in {32, 64, 128}
    with head widths 8, 16 and 32."""
    cfg = _cfg(d, d // dh)
    assert (cfg.denoiser.layer_impl, cfg.denoiser.train_layer_impl) == ("pallas_fused",) * 2
    _check_training_config(cfg, CUDA)


@pytest.mark.parametrize("dh", [8, 16, 32, 64])
@pytest.mark.parametrize("mask", [False, True])
def test_k8_takes_its_head_widths(dh, mask):
    """The plain layers' attention on K8 (``attention_impl`` "pallas" at
    "auto") builds at head widths 8-64, 4 heads (D = 256 at 64), on the
    plain serving layers and with the reference mask."""
    cfg = _cfg(4 * dh, 4, plain=True, mask=mask)
    assert cfg.denoiser.attention_impl == "pallas"
    _check_training_config(cfg, CUDA)


@pytest.mark.parametrize("cfg_kw,names", [
    (dict(latent_dim=256, num_heads=8), ("K1 / K2 / K3", "K5 / K6")),
    (dict(latent_dim=128, num_heads=2), ("K1 / K2 / K3", "K5 / K6")),
    (dict(latent_dim=96, num_heads=4), ("K1 / K2 / K3", "K5 / K6")),
    (dict(latent_dim=128, num_heads=8, input_feats=30), ("K1 / K2 / K3",)),
    (dict(latent_dim=256, num_heads=2, plain=True), ("K8",)),
    (dict(latent_dim=16, num_heads=4, plain=True, mask=True), ("K8",)),
    (dict(latent_dim=32, num_heads=4, ff_size=64), ("ff_size=64 > latent_dim=32",)),
])
def test_unported_widths_are_refused(cfg_kw, names):
    """What is still unported raises where the trainer is built: D outside
    {32, 64, 128} or a head width above 32 on K1-K3 / K5 / K6, a pose
    other than 26 on K3, a head width outside 8-64 on K8, and ff > D."""
    with pytest.raises(ValueError, match="would fail at the first call") as err:
        _check_training_config(_cfg(**cfg_kw), CUDA)
    msg = str(err.value)
    assert all(name in msg for name in names), msg
    assert all(n not in msg for n in {"K1 / K2 / K3", "K5 / K6", "K8"} - set(names)), msg


# ------------------------------------------------------ parity at new widths

LAYER_WIDTHS = [(64, 8), (128, 4)]  # (D, heads): head widths 8 and 32
MXU = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _layer_inputs(d, seed, b=2, t=24):
    """tests/test_torch_port_layer_train.py's `make_inputs` at width d."""
    rng = np.random.RandomState(seed)
    e = 4 * d

    def n(shape, s=1.0):
        return (rng.normal(size=shape) * s).astype(np.float32)

    vecs = n((24, d), 0.3)
    vecs[[0, 5, 8, 11, 16]] += 1.0
    return [n((b, t, d)), n((b, t, e), 0.5), n((b, d, d), 0.1), n((9, d, d), 0.08), vecs,
            n((e, 6 * d), 0.02), n((6 * d,), 0.05)]


def _assert_close(got, want, mxu, atol, rtol=0.0):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    if mxu == "float32":
        np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)
    else:
        assert float(np.abs(got - want).max()) <= 0.02 * float(np.abs(want).max())


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", LAYER_WIDTHS)
def test_plain_layer_matches_jax_at_new_head_widths(d, h, mxu):
    """K5's plain version against JAX's Pallas layer (interpret mode), one
    layer at B = 2, T = 24 with t_valid = 21."""
    tdt, jdt = MXU[mxu]
    args = _layer_inputs(d, d + h)
    want = jax_layer(*map(jnp.asarray, args), h, mxu_dtype=jdt, t_valid=21)
    got = decoder_layer_plain(*map(torch.from_numpy, args), h, mxu_dtype=tdt, t_valid=21)
    _assert_close(got.numpy(), want, mxu, 2e-4)


@pytest.mark.parametrize("mxu", ["float32", "bfloat16"])
@pytest.mark.parametrize("d,h", LAYER_WIDTHS)
def test_plain_gradients_match_jax_at_new_head_widths(d, h, mxu):
    """The seven gradients of the plain K6 path (`fused_decoder_layer_train`
    on CPU tensors) against `jax.grad` of JAX's custom_vjp (its backward
    kernel in interpret mode), B = 2, T = 24."""
    tdt, jdt = MXU[mxu]
    args = _layer_inputs(d, 2 * d + h)
    dy = np.random.RandomState(h).normal(size=args[0].shape).astype(np.float32)
    g_jax = jax.grad(lambda *a: (jax_layer_train(*a, h, jdt) * dy).sum(),
                     argnums=tuple(range(7)))(*map(jnp.asarray, args))
    inputs = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = fused_decoder_layer_train(*inputs, h, mxu_dtype=tdt)
    g_port = torch.autograd.grad(out, inputs, torch.from_numpy(dy))
    for name, a, g in zip(["dx", "demb", "dkvc", "dmats", "dvecs", "daw", "dab"], g_jax, g_port):
        scale = max(1.0, float(jnp.abs(a).max()))
        try:
            _assert_close(g.numpy(), a, mxu, 3e-4 * scale, 2e-3)
        except AssertionError as err:
            raise AssertionError(f"{name}: {err}") from err


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("dh", [8, 32, 64])
def test_plain_attention_matches_jax_at_head_widths(dh, dtype):
    """K8's plain version against JAX's kernel (interpret mode) at head
    width dh, 4 heads, Tq != Tk."""
    tdt, jdt = MXU[dtype]
    rng = np.random.RandomState(dh)
    arrays = [rng.normal(size=(2, t, 4 * dh)).astype(np.float32) for t in (33, 17, 17)]
    got = fused_linear_attention(*(torch.from_numpy(a).to(tdt) for a in arrays), 4)
    want = jax_attention(*(jnp.asarray(a).astype(jdt) for a in arrays), 4)
    assert got.dtype == tdt
    _assert_close(got.float().numpy(), want, dtype, 1e-5)


# ---------------------------------------------------------------- plans


@pytest.mark.parametrize("f32", [False, True])
@pytest.mark.parametrize("d", decoder_stack.WIDTHS)
def test_layer_plans_fit_at_every_width(d, f32):
    """K1 / K5's three passes and K6's launches at each width: a thread a
    column in pass A, tiles covering the rows, shared bytes within a
    block's; at D = 128 the layouts the flagship ran before the other
    widths came."""
    for t, t_valid in ((1800, 1800), (960, 900), (128, 100)):
        p = decoder_stack.plan(d, t, t_valid, f32)
        assert p["a_threads"] == p["b_threads"] == p["b_blocks"] == d
        assert p["c_threads"] == 256
        assert p["a_tiles"] * 64 >= t_valid > (p["a_tiles"] - 1) * 64
        assert p["c_tiles"] * 32 >= t > (p["c_tiles"] - 1) * 32
        assert max(p["a_smem"], p["c_smem"]) <= SMEM_LIMIT
        q = layer_bwd_plan(d, t - t % 64, f32)
        assert q["rows_tiles"] * 32 == t - t % 64
        assert max(q["rows_smem"], q["gemm_smem"]) <= SMEM_LIMIT
    if d == 128:  # 163 KB (float32 pass A), 105.5 KB (bf16 pass C), 97.5 KB
        assert (p["a_smem"], p["c_smem"]) == ((166_912, 99_840) if f32 else (84_992, 108_032))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.int8, torch.float32])
@pytest.mark.parametrize("d", decoder_stack.WIDTHS)
def test_adaln_plan_tiles_every_width(d, dtype):
    """The AdaLN GEMM's tiles for N = 6D: 64 columns where 6D is no multiple
    of 128 (D = 32), 128 else; the tiles never straddle two layers' columns
    and cover every row; shared bytes within a block's."""
    for m, layers in ((3600, 8), (100, 1), (28_800, 1)):
        p = decoder_stack.adaln_plan(m, 6 * d, layers, dtype)
        assert p["bn"] == (64 if d == 32 else 128) and (6 * d) % p["bn"] == 0
        assert p["grid_x"] * p["bn"] == layers * 6 * d
        assert p["grid_y"] * p["bm"] >= m > (p["grid_y"] - 1) * p["bm"]
        assert p["smem"] <= SMEM_LIMIT and p["threads"] in (128, 256)


@pytest.mark.parametrize("which", ["prologue", "epilogue"])
@pytest.mark.parametrize("d", decoder_stack.WIDTHS)
def test_sampler_plans_at_every_width(d, which):
    """K2 / K3 at width D (E = 4D): the rows covered, shared bytes within a
    block's and, for the blocks an SM their launch bounds ask for, within
    an SM's."""
    per_sm = {"prologue": sampler_glue.PRO_BLOCKS_PER_SM,
              "epilogue": sampler_glue.EPI_BLOCKS_PER_SM}[which]
    for b, t in ((2, 1800), (8, 1800), (1, 5)):
        p = sampler_glue.plan(b, t, which, e=4 * d, d=d)
        assert p["rows"] * p["blocks"] >= b * t > p["rows"] * (p["blocks"] - 1)
        assert per_sm * p["smem_bytes"] <= SM_SMEM


@pytest.mark.parametrize("dh", attention.HEAD_DIMS)
def test_attention_plan_at_every_head_width(dh):
    """K8 at each head width: a chunk of 4096 / Dh rows, and the blocks an SM
    its launch bounds ask for fit an SM's shared memory with their
    dynamic and static bytes, in every dtype mix."""
    for q_dtype in (torch.bfloat16, torch.float32):
        for kv_dtype in (torch.bfloat16, torch.float32):
            p = attention.plan(dh, q_dtype, kv_dtype)
            block = p["smem"] + p["static_smem"]
            assert p["chunk"] * dh == 4096 and p["threads"] % dh == 0
            assert block <= SMEM_LIMIT and p["blocks_per_sm"] * block <= SM_SMEM
    assert attention.cluster_size(2, 4, head_dim=dh) == 8
    assert attention.cluster_size(32, 8, head_dim=dh) == 2
