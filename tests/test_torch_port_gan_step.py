"""PyTorch port: one M2SGAN step (`M2SGANTrainer.train_step`) against the
JAX trainer's on the CPU, B = 2, 6-s samples (540 mel / 180 motion
frames), two critic iterations, float32.

The weights are the port's synthetic generator, critic and M2SNet, carried
to the JAX side as reference state dicts (`import_generator`,
`import_discriminator`, `import_motion_encoder`); the generator's music
encoder and the SyncLoss ST-GCN come from the M2SNet.  JAX's random
numbers are rebuilt with jax and handed over: the noise from
``split(fold_in(key, 0))[0]``, each critic iteration's interpolation
weights from ``split(fold_in(gp_rng, i))[1]``
(`conductor_tpu/train/m2sgan_trainer.py:234-236, 266`,
`train/losses.py:717-719`).

- every metric within 1e-5 relative of JAX's;
- each critic iteration's gradient, and the generator's, within 1e-4 of
  the largest of `jax.grad` of the JAX losses in float64 under
  `jax.enable_x64`, at the same parameters (the port's critic before
  that iteration; for the generator, the updated critic the step used);
  the generator's BatchNorm statistics after the step within 1e-5;
- the frozen encoders stay bit-identical, and with `train_music_encoder`
  the trainable encoder moves; the cached features and SyncLoss latents
  give the uncached step's metrics bit for bit; the bf16 SyncLoss through
  K7's plain version against the bf16 flax module; `generate` from mel and
  from features; the JAX trainer's refusals.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import as_reference, close_trees, tree

from conductor_tpu.interop.torch_import import (
    import_discriminator,
    import_generator,
    import_motion_encoder,
)
from conductor_tpu.models.generator import Discriminator1DCNN as FlaxD
from conductor_tpu.models.generator import Generator as FlaxG
from conductor_tpu.models.stgcn import MotionEncoderSTGCN as FlaxSTGCN
from conductor_tpu.train import losses as jax_losses
from conductor_tpu.train.m2sgan_trainer import GANState
from conductor_tpu.train.m2sgan_trainer import M2SGANTrainer as JaxTrainer
from conductor_tpu_torch import M2SGANTrainer
from conductor_tpu_torch.interop import (
    synthetic_discriminator_state_dict,
    synthetic_generator_state_dict,
    synthetic_m2snet_state_dict,
)
from conductor_tpu_torch.models.generator import Discriminator1DCNN, Generator
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.train.losses import sync_loss
from conductor_tpu_torch.train.m2sgan_trainer import resolve_gan_impls

torch.set_num_threads(2)

S, B, ITERS = 6, 2, 2


def weights():
    return (synthetic_generator_state_dict(Generator(), seed=0),
            synthetic_discriminator_state_dict(Discriminator1DCNN(), seed=1),
            synthetic_m2snet_state_dict(M2SNet(), seed=2))


def batch():
    rng = np.random.RandomState(7)
    mel = rng.uniform(0, 1, size=(B, S * 90, 128)).astype(np.float32)
    real = rng.uniform(0, 1, size=(B, S * 30, 13, 2)).astype(np.float32)
    return mel, real


def port_trainer(**kw) -> M2SGANTrainer:
    tr = M2SGANTrainer(sample_length=S, critic_iters=ITERS, device="cpu", **kw)
    g, d, m = weights()
    tr.load_reference_state_dict(g, d, m2snet=m)
    return tr


def jax_random(key):
    """The step's noise and each critic iteration's 'real_fake' weights, as
    the JAX step draws them at step 0."""
    noise_rng, gp_rng = jax.random.split(jax.random.fold_in(key, 0))
    noise = jax.random.normal(noise_rng, (B, S, 8))
    alpha = [jax.random.uniform(jax.random.split(jax.random.fold_in(gp_rng, i))[1], (B, 1, 1, 1))
             for i in range(ITERS)]
    return np.asarray(noise), np.stack([np.asarray(a) for a in alpha])


def flax_variables(tr: M2SGANTrainer):
    """The port trainer's generator, critic and SyncLoss network in flax's
    layout, copied (the arrays would otherwise share the parameters'
    memory, which the port's optimizer updates in place)."""
    g = import_generator(as_reference(tr.G, tr.G.state_dict()))
    d = import_discriminator(as_reference(tr.D, tr.D.state_dict()))
    s = import_motion_encoder(as_reference(tr.sync_encoder, tr.sync_encoder.state_dict()))
    return jax.tree.map(np.array, (g, d, s))


def capture(opt, module):
    """Record, at each step of ``opt``, the module's parameters before it and
    the gradients it takes (name -> array)."""
    seen, step = [], opt.step

    def recording_step():
        seen.append(({k: v.detach().clone() for k, v in module.state_dict().items()},
                     {k: p.grad.clone() for k, p in module.named_parameters()
                      if p.grad is not None}))
        step()

    opt.step = recording_step
    return seen


@pytest.fixture(scope="module")
def step_case():
    """The port's step and the JAX float32 trainer's on one case, with the
    port's critic and generator gradients and what they were taken at."""
    key = jax.random.PRNGKey(3)
    noise, alpha = jax_random(key)
    mel, real = batch()
    tr = port_trainer()
    g_vars, d_vars, s_vars = flax_variables(tr)
    d_seen, g_seen = capture(tr.d_opt, tr.D), capture(tr.g_opt, tr.G)
    got = tr.train_step(torch.from_numpy(mel), torch.from_numpy(real),
                        noise=torch.from_numpy(noise), gp_alpha={"real_fake": torch.from_numpy(alpha)})
    jtr = JaxTrainer(sample_length=S, critic_iters=ITERS)
    state = GANState(step=jnp.zeros((), jnp.int32), g_params=tree(g_vars["params"]),
                     g_batch_stats=tree(g_vars["batch_stats"]), d_params=tree(d_vars["params"]),
                     g_opt=jtr.g_tx.init(tree(g_vars["params"])),
                     d_opt=jtr.d_tx.init(tree(d_vars["params"])), sync_variables=tree(s_vars))
    new, want = jtr.train_step(state, (jnp.asarray(mel), jnp.asarray(real)), key)
    return dict(tr=tr, got=got, want=jax.device_get(want), new=jax.device_get(new), d_seen=d_seen,
                g_seen=g_seen, mel=mel, real=real, noise=noise, alpha=alpha, g_vars=g_vars,
                s_vars=s_vars)


def test_step_metrics_match_jax(step_case):
    got, want = step_case["got"], step_case["want"]
    assert set(got) == set(want) == {"w_distance", "gp", "loss_adv", "loss_sync", "loss_mse"}
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5, err_msg=k)
    # the generator's BatchNorm statistics after its train-mode forward
    port = import_generator(as_reference(step_case["tr"].G, step_case["tr"].G.state_dict()))
    close_trees(port["batch_stats"], step_case["new"].g_batch_stats, atol=1e-5)


def _x64(a):
    return jax.tree.map(lambda v: jnp.asarray(v, jnp.float64), a)


def test_step_gradients_match_float64_jax(step_case, monkeypatch):
    """The critic's gradient at each iteration and the generator's, against
    `jax.grad` of the JAX trainer's losses (`_train_step_impl`'s
    ``d_loss_fn`` and ``g_loss_fn``, the SyncLoss on the flax module) in
    float64, the interpolation weights handed to `losses.gradient_penalty`
    through its draw."""
    c = step_case
    tr = c["tr"]
    with jax.enable_x64(True):
        f64 = jnp.float64
        G, D, sync = FlaxG(dtype=f64), FlaxD(dtype=f64), FlaxSTGCN(dtype=f64)
        g_vars, s_vars = _x64(c["g_vars"]), _x64(c["s_vars"])
        mel, real, noise = (jnp.asarray(a, jnp.float64) for a in (c["mel"], c["real"], c["noise"]))
        hx = jax.jit(lambda v, m: G.apply(v, m, method=G.encode_music))(g_vars, mel)
        fake = jax.jit(lambda v, h, z: G.apply(v, h, z, False, method=G.decode))(g_vars, hx, noise)
        drawn = []  # the weight `gradient_penalty` draws: this iteration's, handed over
        monkeypatch.setattr(jax.random, "uniform", lambda key, shape=(), *_, **__: drawn[-1])

        def d_loss(dp, a):
            drawn.append(a)
            gp = jax_losses.gradient_penalty(lambda x: D.apply({"params": dp}, x), real, fake,
                                             jax.random.PRNGKey(0))
            return (-D.apply({"params": dp}, real).mean() + D.apply({"params": dp}, fake).mean()
                    + tr.w_gp * gp)

        d_grad = jax.jit(jax.grad(d_loss))
        for i, (before, port_grads) in enumerate(c["d_seen"]):
            d_params = _x64(import_discriminator(as_reference(tr.D, before))["params"])
            want = jax.device_get(d_grad(d_params, jnp.asarray(c["alpha"][i], jnp.float64)))
            gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
            got = import_discriminator(as_reference(tr.D, port_grads))["params"]
            close_trees(got, want, atol=1e-4 * gmax)
        monkeypatch.undo()

        (_, port_grads), = c["g_seen"]
        d_final = _x64(import_discriminator(as_reference(tr.D, tr.D.state_dict()))["params"])

        def g_loss(gp_):
            out, _ = G.apply({"params": gp_, "batch_stats": g_vars["batch_stats"]}, hx, noise, True,
                             mutable=["batch_stats"], method=G.decode)
            adv = -D.apply({"params": d_final}, out).mean()
            ff, rf = sync.apply(s_vars, out), jax.lax.stop_gradient(sync.apply(s_vars, real))
            mse = ((out - real) ** 2).mean()
            return tr.w_adv * adv + tr.w_sync * jnp.abs(ff - rf).mean() + tr.w_mse * mse

        want = jax.device_get(jax.jit(jax.grad(g_loss))(g_vars["params"]))
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    got = import_generator(as_reference(tr.G, port_grads))["params"]
    close_trees(got, want, atol=1e-4 * gmax)


def test_frozen_networks_stay_and_the_trainable_encoder_moves():
    """The SyncLoss ST-GCN never moves; the generator's music encoder moves
    only with `train_music_encoder` (then its BatchNorm statistics too)."""
    mel, real = batch()
    for train_encoder in (False, True):
        tr = port_trainer(train_music_encoder=train_encoder)
        sync0 = {k: v.clone() for k, v in tr.sync_encoder.state_dict().items()}
        enc0 = {k: v.clone() for k, v in tr.G.music_encoder.state_dict().items()}
        tr.train_step(torch.from_numpy(mel), torch.from_numpy(real),
                      generator=torch.Generator().manual_seed(0))
        for k, v in tr.sync_encoder.state_dict().items():
            assert torch.equal(v, sync0[k]), k
        moved = [k for k, v in tr.G.music_encoder.state_dict().items()
                 if not torch.equal(v, enc0[k]) and "num_batches" not in k]
        if train_encoder:
            assert any(k.endswith("weight") for k in moved) and any("running" in k for k in moved)
        else:
            assert moved == []


def test_cached_features_and_latents_match_the_uncached_step():
    """`music_features` and `sync_latents` are what the uncached step
    computes: the cached step's metrics equal the uncached one's bit for
    bit, over two steps."""
    mel, real = batch()
    plain = port_trainer()
    cached = port_trainer(cached_features=True, cached_sync_latents=True)
    feats = cached.music_features(torch.from_numpy(mel))
    with torch.no_grad():
        latents = cached.sync_latents(torch.from_numpy(real))
    for seed in (0, 1):
        a = plain.train_step(torch.from_numpy(mel), torch.from_numpy(real),
                             generator=torch.Generator().manual_seed(seed))
        b = cached.train_step(feats, torch.from_numpy(real), latents,
                              generator=torch.Generator().manual_seed(seed))
        for k in a:
            assert torch.equal(a[k], b[k]), (seed, k, a[k], b[k])
    with pytest.raises(ValueError, match="real_latents"):
        cached.train_step(feats, torch.from_numpy(real))


def test_bf16_sync_loss_on_k7_plain_matches_bf16_flax():
    """SyncLoss with ``sync_encoder_impl="pallas"`` (K7's plain version on
    the CPU; `losses.sync_loss` on `sync_latents`, as the step runs it) in
    bf16 against the JAX trainer's ``_sync_loss`` on the bf16
    flax module, the F5 oracle at T30 = 180: the loss within 3e-2.  The
    L1's gradient to the fake is sign(ff - rf) / N, which bf16 flips where
    the latents nearly agree, so the two bf16 gradients are not compared
    with each other element by element: the port's must be no farther from
    the float32 module's gradient (relative L2) than the flax bf16
    module's is."""
    tr = port_trainer(sync_encoder_impl="pallas", sync_encoder_dtype="bfloat16")
    assert (tr.sync_encoder_impl, tr.sync_dtype) == ("pallas", torch.bfloat16)
    _, real = batch()
    fake = np.random.RandomState(9).uniform(0, 1, size=real.shape).astype(np.float32)
    f = torch.from_numpy(fake).requires_grad_(True)
    loss = sync_loss(tr.sync_latents, f, torch.from_numpy(real))
    loss.backward()
    s_vars = tree(flax_variables(tr)[2])
    want = {}
    for dtype in ("bfloat16", "float32"):
        jtr = JaxTrainer(sample_length=S, sync_encoder_impl="flax", sync_encoder_dtype=dtype)
        value, grad = jax.jit(jax.value_and_grad(
            lambda x, r: jtr._sync_loss(s_vars, x, r)))(jnp.asarray(fake), jnp.asarray(real))
        want[dtype] = float(value), np.asarray(grad, np.float32)
    np.testing.assert_allclose(float(loss), want["bfloat16"][0], rtol=3e-2)
    exact = want["float32"][1]

    def off(g):
        return np.linalg.norm(g - exact) / np.linalg.norm(exact)

    assert off(f.grad.numpy()) <= off(want["bfloat16"][1]), (off(f.grad.numpy()),
                                                              off(want["bfloat16"][1]))


def test_generate_from_mel_and_from_features():
    tr = port_trainer()
    mel, _ = batch()
    noise = np.random.RandomState(4).normal(size=(B, S, 8)).astype(np.float32)
    g_vars = tree(flax_variables(tr)[0])
    G = FlaxG()
    want = np.asarray(jax.jit(lambda m, z: G.apply(g_vars, m, z, False))(jnp.asarray(mel),
                                                                        jnp.asarray(noise)))
    got = tr.generate(torch.from_numpy(mel), noise=torch.from_numpy(noise))
    assert got.shape == (B, S * 30, 13, 2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5 * np.abs(want).max())
    feats = tr.music_features(torch.from_numpy(mel))
    from_feats = tr.generate(feats, noise=torch.from_numpy(noise), from_features=True)
    np.testing.assert_array_equal(from_feats.numpy(), got.numpy())
    drawn = tr.generate(torch.from_numpy(mel), generator=torch.Generator().manual_seed(0))
    assert drawn.shape == got.shape and bool(torch.isfinite(drawn).all())


@pytest.mark.parametrize("make,error", [
    (lambda: M2SGANTrainer(sample_length=S, train_music_encoder=True, music_encoder_impl="pallas",
                           device="cpu"), ValueError),
    (lambda: M2SGANTrainer(sample_length=S, train_music_encoder=True, cached_features=True,
                           device="cpu"), ValueError),
    (lambda: M2SGANTrainer(sample_length=S, sync_encoder_impl="xla", device="cpu"), ValueError),
    (lambda: resolve_gan_impls("auto", "float16", "pallas", "auto", "auto", False,
                               torch.device("cuda")), ValueError),
    (lambda: Generator(decoder_kind="gru"), ValueError),
])
def test_refusals(make, error):
    """The JAX trainer's refusals (`m2sgan_trainer.py:110-115, 125-130`),
    a SyncLoss dtype K7 has no mode for (float16), and a decoder kind that
    is neither "tcn" nor "bilstm" (the BiLSTM decoders are ported:
    tests/test_torch_port_generator_lstm.py)."""
    with pytest.raises(error):
        make()


def test_auto_resolution():
    """JAX's "auto" with "on TPU" read as "on CUDA"; an explicit float32
    SyncLoss on CUDA stays on K7 (its float32 mode)."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    frozen = resolve_gan_impls("auto", "auto", "auto", "auto", "auto", False, cuda)
    assert frozen == {"music_encoder_impl": "pallas", "sync_encoder_dtype": "bfloat16",
                      "sync_encoder_impl": "pallas", "compute_dtype": "float32",
                      "music_conv_impl": "lax"}
    sync_f32 = resolve_gan_impls("auto", "float32", "pallas", "auto", "auto", False, cuda)
    assert (sync_f32["sync_encoder_impl"], sync_f32["sync_encoder_dtype"]) == ("pallas", "float32")
    trains = resolve_gan_impls("auto", "auto", "auto", "auto", "auto", True, cuda)
    assert (trains["music_encoder_impl"], trains["compute_dtype"], trains["music_conv_impl"]) == (
        "flax", "bfloat16", "pallas_train")
    for train_encoder in (False, True):
        assert resolve_gan_impls("auto", "auto", "auto", "auto", "auto", train_encoder, cpu) == {
            "music_encoder_impl": "flax", "sync_encoder_dtype": "float32",
            "sync_encoder_impl": "flax", "compute_dtype": "float32", "music_conv_impl": "lax"}
