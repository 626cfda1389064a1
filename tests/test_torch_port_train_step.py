"""PyTorch port: one whole stage-2 training step against the JAX trainer,
at the size of tests/test_fused_train_path.py (2 layers, 8 cosine steps,
T = 60, cached features), on synthetic reference-format weights.

(a) the port's plain path against JAX ``train_layer_impl="flax"``;
(b) the port's ``"pallas_fused"`` path on the CPU (the plain versions of
    K5 / K6 through the autograd Function) against the JAX
    ``"pallas_fused"`` step in interpret mode;
(c) that path with ``feat_impl="pallas"``, the JAX accelerator
    configuration: the perceptual term on the plain version of K7 through
    its autograd Function, against JAX's K7 in interpret mode.  At T = 64:
    the JAX kernel departs from its module on a T that is not a multiple
    of 8 (see tests/test_torch_port_stgcn_kernel.py).

(a) and (b) with ``feat_impl="flax"``.  JAX's random numbers are reproduced and
handed to the port: t and the noise from ``split(fold_in(rng, step))`` as
in `_train_step_impl` / `_losses`, and the condition keep mask read from
JAX by calling `cond_from_features` on all-ones features with the same
``cond`` rng (its ``xf_out`` then is the mask).  Bounds are JAX's own:
loss and metrics at rtol 1e-4, every parameter at atol 5e-5, rtol 5e-3,
compared through the reference state dict and `import_motion_transformer`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.interop.torch_import import import_motion_encoder
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import resolve_auto
from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
from conductor_tpu_torch.train.ddpm_trainer import _check_training_config
from conductor_tpu_torch.train.fused_denoiser import pack_layer_weights

torch.set_num_threads(2)

B, T = 2, 60
METRICS = ("loss", "loss_mot_rec", "loss_mot_feat", "loss_velocity", "loss_elbow", "loss_head",
           "loss_body", "grad_norm")


def make_cfg(train_layer_impl, cached=True, feat_impl="flax"):
    return Config(
        denoiser=DenoiserConfig(num_layers=2, num_frames=64, train_layer_impl=train_layer_impl),
        diffusion=DiffusionConfig(steps=8, schedule="cosine"),
        train=TrainConfig(cached_features=cached, sample_length=2, batch_size=2,
                          feat_impl=feat_impl),
    )


def _batch(t):
    """Cached features (B, t, 64) and motion (B, t, 13, 2), seeded."""
    rng = np.random.RandomState(0)
    feats = rng.normal(size=(B, t, 64)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(B, t, 13, 2)).astype(np.float32)
    return feats, motion


@pytest.fixture(scope="module")
def weights():
    probe = DDPMTrainer(make_cfg("flax"), device="cpu")
    sd = synthetic_state_dict(probe.model, seed=1)
    feat_sd = synthetic_motion_encoder_state_dict(probe.feat_model, seed=2)
    return (sd, feat_sd, *_batch(T))


def _port_trainer(cfg, weights):
    sd, feat_sd = weights[:2]
    tr = DDPMTrainer(cfg, device="cpu")
    tr.load_reference_state_dict(sd, motion_encoder=feat_sd)
    return tr


def _jax_step(cfg, weights, m_lens=None):
    """One JAX train step on the imported weights and the batch in
    ``weights`` (clip lengths ``m_lens``, the full window by default);
    returns the step's metrics, its updated params and the random numbers
    it drew."""
    sd, feat_sd, feats, motion = weights
    B, T = motion.shape[:2]
    tr = JaxTrainer(cfg)
    rng = jax.random.PRNGKey(0)
    state = tr.init_state(rng)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = state.replace(
        params=variables["params"], batch_stats=variables["batch_stats"],
        feat_variables=jax.tree.map(jnp.asarray, import_motion_encoder(feat_sd)),
        opt_state=tr.tx.init(variables["params"]),
    )
    # the step's random numbers, as `_train_step_impl` / `_losses` draw them
    t_rng, loss_rng = jax.random.split(jax.random.fold_in(rng, 0))
    t = jax.random.randint(t_rng, (B,), 0, tr.sched.num_timesteps)
    noise_rng, cond_rng = jax.random.split(loss_rng)
    noise = jax.random.normal(noise_rng, (B, T, 26))
    _, ones_out = tr.model.apply(
        {"params": state.params, "batch_stats": state.batch_stats}, jnp.ones((B, T, 64)), True,
        method=tr.model.cond_from_features, rngs={"cond": cond_rng},
    )
    keep = np.asarray(ones_out[..., 0])
    assert set(np.unique(keep)) <= {0.0, 1.0}
    lens = jnp.full((B,), T, jnp.int32) if m_lens is None else jnp.asarray(m_lens, jnp.int32)
    batch = (jnp.asarray(feats), jnp.asarray(motion), lens)
    state, metrics = tr.train_step(state, batch, rng)
    drawn = {"t": np.asarray(t), "noise": np.asarray(noise), "cond_keep": keep}
    return {k: float(v) for k, v in metrics.items()}, state.params, drawn


def _compare(port_tr, port_metrics, jax_metrics, jax_params):
    for k in METRICS:
        np.testing.assert_allclose(float(port_metrics[k]), jax_metrics[k], rtol=1e-4, err_msg=k)
    got = import_motion_transformer(
        {k: v.detach().numpy() for k, v in port_tr.model.state_dict().items()})["params"]
    want = dict((jax.tree_util.keystr(k), v)
                for k, v in jax.tree_util.tree_leaves_with_path(jax_params))
    leaves = jax.tree_util.tree_leaves_with_path(got)
    assert len(leaves) == len(want)
    for key, g in leaves:
        name = jax.tree_util.keystr(key)
        np.testing.assert_allclose(np.asarray(g), np.asarray(want[name]), atol=5e-5, rtol=5e-3,
                                   err_msg=name)


@pytest.mark.parametrize("impl,feat_impl,t", [("flax", "flax", T), ("pallas_fused", "flax", T),
                                              ("pallas_fused", "pallas", 64)],
                         ids=["flax", "pallas_fused", "pallas_fused-feat_pallas"])
def test_train_step_matches_jax(impl, feat_impl, t, weights):
    weights = (*weights[:2], *_batch(t))
    cfg = make_cfg(impl, feat_impl=feat_impl)
    jax_metrics, jax_params, drawn = _jax_step(cfg, weights)
    _, _, feats, motion = weights
    port = _port_trainer(cfg, weights)
    assert (port.cfg.denoiser.train_layer_impl, port.cfg.train.feat_impl) == (impl, feat_impl)
    assert (port.feat_pack is not None) == (feat_impl == "pallas")
    metrics = port.train_step(feats, motion, np.full((B,), t), **drawn)
    _compare(port, metrics, jax_metrics, jax_params)


def test_mel_input_matches_cached_features(weights):
    """cached_features=False: a step from the mel equals the step from the
    frozen encoder's features of that mel."""
    _, _, _, motion = weights
    mel = np.random.RandomState(1).uniform(0, 1, size=(B, 3 * T, 128)).astype(np.float32)
    rng = np.random.RandomState(2)
    drawn = {"t": rng.randint(0, 8, size=B), "noise": rng.normal(size=(B, T, 26)),
             "cond_keep": (rng.uniform(size=(B, T)) > 0.1).astype(np.float32)}
    from_mel = _port_trainer(make_cfg("flax", cached=False), weights)
    cached = _port_trainer(make_cfg("flax"), weights)
    with torch.no_grad():
        feats = cached.model.music_encoder(torch.from_numpy(mel))
    m_mel = from_mel.train_step(mel, motion, **drawn)
    m_cached = cached.train_step(feats, motion, **drawn)
    for k in METRICS:
        np.testing.assert_allclose(float(m_mel[k]), float(m_cached[k]), rtol=1e-6, err_msg=k)
    for (k, a), b in zip(from_mel.model.state_dict().items(), cached.model.state_dict().values()):
        torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-7, msg=k)
    # the frozen encoder did not move
    for k, v in from_mel.model.music_encoder.state_dict().items():
        torch.testing.assert_close(v, cached.model.music_encoder.state_dict()[k], rtol=0, atol=0)


def test_drawn_randomness_and_sampling_pack_refresh(weights):
    """Without explicit t / noise / mask the step draws them from the
    generator (same seed, same step); a later generate sees the new weights."""
    _, _, feats, motion = weights
    cfg = make_cfg("flax").replace(denoiser=dataclasses.replace(
        make_cfg("flax").denoiser, layer_impl="pallas_fused"))
    a, b = _port_trainer(cfg, weights), _port_trainer(cfg, weights)
    ma = a.train_step(feats, motion, generator=torch.Generator().manual_seed(5))
    mb = b.train_step(feats, motion, generator=torch.Generator().manual_seed(5))
    assert all(float(ma[k]) == float(mb[k]) for k in METRICS)
    before = a.fused.mats.clone()
    out = a.generate(torch.rand(1, 3 * T, 128), noise=torch.zeros(1, T, 26))
    assert torch.isfinite(out).all()
    with torch.no_grad():
        now = torch.stack([pack_layer_weights(a.model, i)[0] for i in range(2)])
    assert torch.equal(a.fused.mats, now) and not torch.equal(before, now)
    assert torch.equal(a.temb_table, a.model.time_embed_table(8).detach())


@pytest.mark.parametrize("change,error,match", [
    (dict(denoiser=dict(train_layer_impl="pallas_fused", dropout=0.1)), ValueError, "dropout"),
    (dict(denoiser=dict(dropout=0.1)), NotImplementedError, "dropout"),
    (dict(denoiser=dict(train_layer_impl="pallas_fused"),
          train=dict(replicate_reference_mask=True)), ValueError, "src_mask"),
    (dict(train=dict(feat_impl="bogus")), ValueError, "feat_impl"),
    (dict(train=dict(timestep_sampler="bogus")), ValueError, "sampler"),
    (dict(diffusion=dict(loss_type="kl")), NotImplementedError, "loss_type"),
])
def test_training_gating(change, error, match):
    cfg = make_cfg("auto")
    cfg = cfg.replace(**{sec: dataclasses.replace(getattr(cfg, sec), **kw)
                         for sec, kw in change.items()})
    with pytest.raises(error, match=match):
        DDPMTrainer(cfg, device="cpu")


def test_explicit_pallas_features_need_bf16_operands_on_cuda():
    """K7 takes bf16 operands: an explicit ``feat_impl="pallas"`` with
    float32 is refused for a CUDA device (checked where no card is needed;
    ``DDPMTrainer(cfg, "cuda")`` raises first for the missing card), and
    runs the plain version on the CPU."""
    cfg = make_cfg("flax", feat_impl="pallas")
    f32 = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, compute_dtype="float32"))
    with pytest.raises(ValueError, match="bf16"):
        _check_training_config(resolve_auto(f32, "cuda"), torch.device("cuda"))
    bf16 = cfg.replace(denoiser=dataclasses.replace(
        cfg.denoiser, compute_dtype="bfloat16", train_layer_impl="pallas_fused"))
    _check_training_config(resolve_auto(bf16, "cuda"), torch.device("cuda"))
    _check_training_config(resolve_auto(f32, "cpu"), torch.device("cpu"))
    assert DDPMTrainer(f32, device="cpu").feat_pack["m"].dtype == torch.float32


def test_bf16_plain_training_raises_but_serving_builds(weights):
    """A bf16 config serves on the CPU through the plain kernel versions, and
    its plain training path (the bf16 modules, K8's plain version in the
    self-attention) takes a finite step that moves the weights."""
    _, _, feats, motion = weights
    cfg = make_cfg("flax")
    cfg = cfg.replace(denoiser=dataclasses.replace(
        cfg.denoiser, compute_dtype="bfloat16", layer_impl="pallas_fused",
        music_encoder_impl="pallas", attention_impl="pallas"))
    tr = _port_trainer(cfg, weights)
    assert tr.model.dtype == torch.bfloat16 and tr.fused is not None
    before = tr.model.out.weight.detach().clone()
    metrics = tr.train_step(feats, motion, generator=torch.Generator().manual_seed(0))
    assert all(bool(torch.isfinite(metrics[k])) for k in METRICS), metrics
    assert tr.model.out.weight.dtype == torch.float32
    assert not torch.equal(tr.model.out.weight, before)
    out = tr.generate(torch.rand(1, 3 * T, 128), noise=torch.zeros(1, T, 26))
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
