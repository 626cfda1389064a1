"""PyTorch port, denoiser dropout against the flax MotionTransformer applied
with ``train=True`` (JAX's trainer cannot be the oracle: its step hands the
model no "dropout" key, so flax raises), at 2 layers, D = 32, 4 heads, ff
16, T = 24, on one synthetic reference weight set.

flax's masks are read by applying the same "dropout" key once with every
Dropout's input replaced by ones (`nn.intercept_methods`; a site's key
depends on its module path, not on the values), then handed to the port by
site name.  Compared: the forward and the gradient of every parameter
(flax's through `export_motion_transformer`, the reference's key names);
float32 within 1e-5 of the output's largest value (the gradients of the
largest gradient), bf16 within 3e-2.
Also: the bf16 division rule bit for bit against `nn.Dropout`, masks
drawn from a generator, ``train=False``, serving that ignores dropout on
both layer paths and the fused ladder, and a trainer step."""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_export import export_motion_transformer
from conductor_tpu.models import MotionTransformer as FlaxMotionTransformer
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import synthetic_state_dict
from conductor_tpu_torch.interop.weights import load_reference_state_dict
from conductor_tpu_torch.models.transformer import Dropout, MotionTransformer

torch.set_num_threads(2)

T, P = 24, 0.1
WIDTHS = dict(latent_dim=32, ff_size=16, num_layers=2, num_heads=4)
DTYPES = {"float32": (torch.float32, jnp.float32, 1e-5),
          "bfloat16": (torch.bfloat16, jnp.bfloat16, 3e-2)}


def port_site(path: tuple[str, ...]) -> str:
    """A flax Dropout's module path -> the port's site name."""
    block, sub, *rest = path
    name = f"temporal_decoder_blocks.{block.removeprefix('blocks_')}."
    name += {"self_attn": "sa_block", "cross_attn": "ca_block", "ffn": "ffn"}[sub]
    return name + (".dropout" if rest == ["Dropout_0"] else ".proj_out.out_layers.1")


@pytest.fixture(scope="module")
def case():
    sd = synthetic_state_dict(MotionTransformer(num_frames=T, **WIDTHS), seed=5)
    rng = np.random.RandomState(6)
    x = rng.normal(size=(2, T, 26)).astype(np.float32)
    xf = rng.normal(size=(2, T, 64)).astype(np.float32)
    xf_proj = rng.normal(size=(2, T, 64)).astype(np.float32)
    cot = rng.normal(size=(2, T, 26)).astype(np.float32)
    return sd, x, xf_proj, xf, cot


def flax_masks(flax, variables, args, key) -> dict[str, np.ndarray]:
    """flax's keep masks under ``key``, by site name of the port."""
    masks = {}

    def ones(next_fun, a, kw, context):
        if isinstance(context.module, fnn.Dropout) and context.method_name == "__call__":
            out = next_fun(jnp.ones_like(a[0]), *a[1:], **kw)
            masks[port_site(context.module.path)] = np.asarray(out) != 0
            return out
        return next_fun(*a, **kw)

    with fnn.intercept_methods(ones):
        flax.apply(variables, *args, True, rngs={"dropout": key})
    return masks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_and_gradient_match_flax(case, dtype):
    sd, x, xf_proj, xf, cot = case
    tdt, jdt, tol = DTYPES[dtype]
    flax = FlaxMotionTransformer(num_frames=T, dropout=P, dtype=jdt, **WIDTHS)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    t = np.array([3, 7], np.int32)
    mask = (np.arange(T)[None, :] < np.array([T, 15])[:, None]).astype(np.float32)[..., None]
    args = (jnp.asarray(x), jnp.asarray(t), jnp.asarray(xf_proj, jdt), jnp.asarray(xf, jdt),
            jnp.asarray(mask))
    key = jax.random.PRNGKey(11)
    masks = flax_masks(flax, variables, args, key)
    port = MotionTransformer(num_frames=T, dropout=P, dtype=tdt, **WIDTHS)
    load_reference_state_dict(port, sd)
    assert sorted(masks) == sorted(port.dropout_sites()) and len(masks) == 4 * 2
    kept = np.mean([m.mean() for m in masks.values()])
    assert abs(kept - (1 - P)) < 0.03

    def loss(params):
        out = flax.apply({**variables, "params": params}, *args, True, rngs={"dropout": key})
        return jnp.sum(out * cot), out

    (_, want), grads = jax.jit(jax.value_and_grad(loss, has_aux=True))(variables["params"])
    want_grads = export_motion_transformer({"params": grads,
                                            "batch_stats": variables["batch_stats"]})
    got = port(torch.from_numpy(x), torch.from_numpy(t).long(),
               torch.from_numpy(xf_proj).to(tdt), torch.from_numpy(xf).to(tdt),
               torch.from_numpy(mask), train=True,
               dropout_keep={k: torch.from_numpy(v) for k, v in masks.items()})
    (got * torch.from_numpy(cot)).sum().backward()

    def close(g, w, name, scale):
        err = float(np.abs(g - np.asarray(w, np.float32)).max())
        assert err <= tol * scale, (name, err, scale)

    scale = float(np.abs(want).max())
    close(got.detach().numpy(), want, "out", scale)
    trained = [(name, p.grad.numpy()) for name, p in port.named_parameters()
               if not name.startswith("music_encoder.") and p.grad is not None]
    assert len(trained) >= 40
    # each gradient against the largest of them: some are zero up to
    # rounding (the key biases, which a softmax over keys cancels)
    gmax = max(float(np.abs(np.asarray(want_grads[n], np.float32)).max()) for n, _ in trained)
    for name, g in trained:
        close(g, want_grads[name], name, gmax)
    # the masks move the output (train=False differs) by more than twice
    # the port's distance from flax, and by over 1 % of its largest value
    with torch.no_grad():
        plain = port(torch.from_numpy(x), torch.from_numpy(t).long(),
                     torch.from_numpy(xf_proj).to(tdt), torch.from_numpy(xf).to(tdt),
                     torch.from_numpy(mask))
    moved = float((plain - got.detach()).abs().max())
    assert moved > max(2 * float(np.abs(got.detach().numpy() - np.asarray(want)).max()),
                       1e-2 * scale)


def test_bf16_division_rule_is_flax_bit_for_bit():
    """flax divides by ``keep_prob`` in x's dtype: in bf16 0.9 becomes
    0.8984375 and each kept element is rounded after the division.  The
    port's `Dropout` equals `nn.Dropout` bit for bit on bf16 and float32
    inputs; a float32 scale (x * (1 / 0.9), rounded once) does not."""
    x = np.random.RandomState(0).normal(size=(4, 300, 32)).astype(np.float32)
    key = jax.random.PRNGKey(3)
    layer = fnn.Dropout(P, deterministic=False)
    for jdt, tdt in ((jnp.bfloat16, torch.bfloat16), (jnp.float32, torch.float32)):
        xj = jnp.asarray(x, jdt)
        keep = np.asarray(layer.apply({}, jnp.ones_like(xj), rng=key)) != 0
        want = np.asarray(layer.apply({}, xj, rng=key).astype(jnp.float32))
        drop = Dropout(P)
        got = drop(torch.from_numpy(x).to(tdt), lambda site, shape: torch.from_numpy(keep))
        assert got.dtype == tdt
        np.testing.assert_array_equal(got.float().numpy(), want)
        if tdt == torch.bfloat16:
            scaled = torch.where(torch.from_numpy(keep),
                                 (torch.from_numpy(x).to(tdt).float() * (1 / 0.9)).to(tdt), 0)
            assert int((scaled.float() != got.float()).sum()) > 0
    assert not keep.all() and keep.any()


def test_generator_masks_repeat_and_keep_their_share():
    """Masks drawn from a generator repeat with its seed, differ between
    sites, and keep 1 - p of the elements within 1 % at T = 900."""
    port = MotionTransformer(num_frames=900, dropout=P, **WIDTHS)
    draws = []
    for _ in range(2):
        drop = port.dropper(True, generator=torch.Generator().manual_seed(4))
        draws.append([drop(site, (2, 900, 32)) for site in port.dropout_sites()])
    assert all(torch.equal(a, b) for a, b in zip(*draws))
    assert not torch.equal(draws[0][0], draws[0][1])
    share = float(torch.stack(draws[0]).float().mean())
    assert abs(share - (1 - P)) <= 0.01 * (1 - P)
    assert port.dropper(False) is None
    assert MotionTransformer(num_frames=900, **WIDTHS).dropper(True) is None


def test_train_false_drops_nothing(case):
    sd, x, xf_proj, xf, _ = case
    outs = []
    for p in (P, 0.0):
        port = MotionTransformer(num_frames=T, dropout=p, **WIDTHS)
        load_reference_state_dict(port, sd)
        with torch.no_grad():
            args = (torch.from_numpy(x), torch.tensor([3, 7]), torch.from_numpy(xf_proj),
                    torch.from_numpy(xf))
            outs.append(port(*args))
            if p:
                dropped = port(*args, train=True, generator=torch.Generator().manual_seed(0))
    assert torch.equal(outs[0], outs[1])
    assert float((dropped - outs[0]).abs().max()) > 1e-3


def _cfg(layer_impl="flax", dropout=P, **denoiser):
    return Config(
        denoiser=DenoiserConfig(num_frames=T, layer_impl=layer_impl, music_encoder_impl="flax",
                                compute_dtype="float32", dropout=dropout, **WIDTHS, **denoiser),
        diffusion=DiffusionConfig(steps=8, schedule="cosine"),
        train=TrainConfig(sample_length=1),
    )


@pytest.mark.parametrize("layer_impl,kwargs", [
    ("flax", {}),
    ("pallas_fused", {}),  # the all-kernel ladder (K2 -> K1 -> K3)
    ("pallas_fused", dict(guidance_scale=2.5)),  # K1 through FusedDenoiser.__call__
])
def test_generate_ignores_dropout(case, layer_impl, kwargs):
    """Serving runs with ``train=False`` (JAX's `generate`): a dropout
    config generates what the same weights generate at dropout 0."""
    sd = case[0]
    mel = torch.from_numpy(np.random.RandomState(1).uniform(0, 1, (1, 3 * T, 128))
                           .astype(np.float32))
    noise = torch.randn(1, T, 26, generator=torch.Generator().manual_seed(2))
    outs = []
    for p in (P, 0.0):
        tr = DDPMTrainer(_cfg(layer_impl, p), device="cpu")
        tr.load_reference_state_dict(sd)
        outs.append(tr.generate(mel, noise=noise, **kwargs))
    assert torch.equal(outs[0], outs[1])


def test_trainer_steps_with_dropout(case):
    """``DDPMTrainer(device="cpu")`` with dropout 0.1 constructs ("auto"
    resolves the training layers to the plain ones) and steps; masks handed
    over as a mapping reproduce a step that drew them from a callable,
    and masks drawn from the step's generator give another loss."""
    sd = case[0]
    cfg = _cfg("auto")
    cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, train_layer_impl="auto"))
    rng = np.random.RandomState(3)
    mel = rng.uniform(0, 1, (2, 3 * T, 128)).astype(np.float32)
    motion = rng.uniform(0, 1, (2, T, 13, 2)).astype(np.float32)
    runs = []

    def trainer():
        tr = DDPMTrainer(cfg, device="cpu")
        assert tr.cfg.denoiser.train_layer_impl == "flax"
        tr.load_reference_state_dict(sd)
        return tr

    seen = {}

    def recording(site, shape):
        m = torch.rand(shape, generator=gen) < 1 - P
        seen[site] = m
        return m

    gen = torch.Generator().manual_seed(9)
    runs.append(trainer().train_step(mel, motion, dropout_keep=recording,
                                     generator=torch.Generator().manual_seed(5)))
    assert sorted(seen) == sorted(trainer().model.dropout_sites())
    runs.append(trainer().train_step(mel, motion, dropout_keep=dict(seen),
                                     generator=torch.Generator().manual_seed(5)))
    runs.append(trainer().train_step(mel, motion, generator=torch.Generator().manual_seed(5)))
    assert all(bool(torch.isfinite(v)) for v in runs[0].values())
    # the same masks: equal up to float32 rounding (the CPU's GEMMs may sum
    # in another order in another trainer); other masks: another loss
    losses = [float(r["loss"]) for r in runs]
    assert abs(losses[1] - losses[0]) <= 1e-6 * abs(losses[0])
    assert abs(losses[2] - losses[0]) > 1e-4 * abs(losses[0])
    with pytest.raises(ValueError, match="dropout"):
        DDPMTrainer(_cfg("flax", -0.1), device="cpu")
