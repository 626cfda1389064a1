"""Helpers shared by the PyTorch port's stage-1 tests (no tests of its
own): JAX's pair starts, one M2SNet step of the JAX trainer against the
port's on the same weights, data and starts
(tests/test_torch_port_m2s_step_*.py), and the port's state and gradients
read in flax's layout (tests/test_torch_port_m2s_models.py,
tests/test_torch_port_m2snet.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from conductor_tpu.data.pairs import build_pairs
from conductor_tpu.interop import import_m2snet
from conductor_tpu.train.m2snet_trainer import M2SNetState
from conductor_tpu.train.m2snet_trainer import M2SNetTrainer as JaxTrainer
from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet

MOTION_HZ = 30
S, C = 6, 2  # sample and crop seconds: 540 / 180 mel frames, 180 / 60 motion frames


def jax_starts(rng, strategy: str, sample_length: int, clip_length: int, step: int = 0):
    """The 30 Hz window starts `M2SNetTrainer._train_step_impl` draws at
    ``step`` from ``rng``: `build_pairs(fold_in(rng, step), ...)`, its key
    arithmetic replayed (`conductor_tpu/data/pairs.py:53-81`)."""
    s, c = sample_length, clip_length
    k1, k2 = jax.random.split(jax.random.fold_in(rng, step))

    def sec30(key, lo_sec, hi_sec):
        lo, hi = jnp.int32(lo_sec * MOTION_HZ), jnp.int32(hi_sec * MOTION_HZ)
        return jax.random.randint(key, (), lo, jnp.maximum(hi, lo + 1))

    if strategy == "easy":
        return (int(sec30(k1, 0, s - c)),)
    if strategy == "hard":
        start_1 = sec30(k1, 0, s - c - 10)
        hi = jnp.int32((s - c) * MOTION_HZ)
        start_2 = jax.random.randint(k2, (), start_1 + 10 * MOTION_HZ,
                                     jnp.maximum(hi, start_1 + 10 * MOTION_HZ + 1))
        return int(start_1), int(start_2)
    start_1 = sec30(k1, 0, s - c - 5)
    offset = jax.random.randint(k2, (), 0, jnp.int32(4.5 * MOTION_HZ))
    return int(start_1), int(start_1 + offset)


def case():
    """Synthetic M2SNet weights (reference format), seeded music and motion
    (B = 2, 6-s samples) and the step's key."""
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=0)
    rng = np.random.RandomState(11)
    music = rng.normal(size=(2, S * 90, 128)).astype(np.float32)
    motion = rng.uniform(0, 1, size=(2, S * MOTION_HZ, 13, 2)).astype(np.float32)
    return sd, music, motion, jax.random.PRNGKey(5)


def jax_step(strategy: str, share_encodes: bool, conv_impl: str = "lax", exact: bool = True):
    """One step of the JAX trainer in float32 on the music path
    ``conv_impl`` ("lax", or "pallas_train": its Pallas kernels, in
    interpret mode off the TPU) (its metrics and new variables), with
    ``exact`` the exact gradient of that step's loss and Adam's first update
    from it (else None), and the case it ran on.

    The gradient is `jax.grad` of the step's ``loss_fn``
    (`conductor_tpu/train/m2snet_trainer.py:184-191`), rebuilt from the
    trainer's own `_forward4` and `_bce` on the pairs the step cuts, in
    float64: the four BCE terms' gradients largely cancel, and the float32
    step's gradient carries rounding of up to 0.8 % of the largest, where
    the port's float32 one is within 3e-6 of the float64 one."""
    sd, music, motion, key = case()
    tr = JaxTrainer(sample_length=S, clip_length=C, compute_dtype="float32",
                    music_conv_impl=conv_impl, share_encodes=share_encodes)
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    state = M2SNetState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tr.tx.init(v["params"]))
    batch = (jnp.asarray(music), jnp.asarray(motion))
    pairs = [np.asarray(a) for a in build_pairs(jax.random.fold_in(key, 0), *batch, strategy, S, C)]
    grads = update = None
    with jax.enable_x64(True):
        tr64 = JaxTrainer(sample_length=S, clip_length=C, compute_dtype="float64",
                          music_conv_impl="lax", share_encodes=share_encodes)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), import_m2snet(sd))
        pairs64 = [jnp.asarray(a, jnp.float64) for a in pairs]

        def loss(params):
            (p11, p12, p22, p21), _ = tr64._forward4(params, v64["batch_stats"], pairs64, train=True)
            return tr64._bce(p11, 1.0) + tr64._bce(p12, 0.0) + tr64._bce(p22, 1.0) + tr64._bce(p21, 0.0)

        if exact:
            grads = jax.jit(jax.grad(loss))(v64["params"])
            update, _ = tr64.tx.update(grads, tr64.tx.init(v64["params"]), v64["params"])
            grads, update = jax.device_get((grads, update))
    new, metrics = tr.train_step(state, batch, key, strategy)
    want = {"params": jax.device_get(new.params), "batch_stats": jax.device_get(new.batch_stats),
            "grads": grads, "update": update}
    return {k: float(m) for k, m in metrics.items()}, want, (sd, music, motion, key)


def check_port_step(conv_impl: str, strategy: str, share_encodes: bool, reference) -> None:
    """The port's step on ``conv_impl`` against ``reference`` (`jax_step`'s
    result).

    - where the reference has the exact gradient: every parameter's
      gradient within 1e-4 of the largest of the exact one (the step's
      backward: the four BCEs, the chained forwards, the shared latents,
      the fusion head), and its update (new - old parameters) within 1e-6
      of optax's first Adam update from the exact gradient, where that
      gradient is at least 1e-3 of the largest (below, its sign is float32
      rounding; the update is about lr * sign);
    - the JAX package's own lax / packed bounds against the JAX float32
      step (tests/test_conv_train.py:290-325): loss rtol 1e-4, accuracy
      1e-6, every parameter after Adam within atol 5e-3; BN statistics
      within 1e-5.

    The port's gradients (still on its parameters after the step) and
    parameters are read in flax's layout by `import_m2snet`."""
    metrics_want, want, (sd, music, motion, key) = reference
    tr = M2SNetTrainer(sample_length=S, clip_length=C, music_conv_impl=conv_impl,
                       share_encodes=share_encodes, device="cpu")
    tr.load_reference_state_dict(sd)
    got = tr.train_step(torch.from_numpy(music), torch.from_numpy(motion), strategy,
                        starts=jax_starts(key, strategy, S, C))
    np.testing.assert_allclose(float(got["loss"]), metrics_want["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(got["accuracy"]), metrics_want["accuracy"], atol=1e-6)
    for k in ("sync_prob", "non_sync_prob"):
        np.testing.assert_allclose(float(got[k]), metrics_want[k], rtol=1e-4)
    state = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    port = import_m2snet(state)
    for group, tol in (("params", 5e-3), ("batch_stats", 1e-5)):
        close_trees(port[group], want[group], atol=tol)
    if want["grads"] is None:
        return
    step_grads = {k: (np.zeros_like(state[k]) if p.grad is None else p.grad.numpy())
                  for k, p in tr.model.named_parameters()}
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want["grads"]))
    close_trees(import_m2snet(state | step_grads)["params"], want["grads"], atol=1e-4 * gmax)
    moved = jax.tree.map(lambda new, old: new - old, port["params"], import_m2snet(sd)["params"])
    sure = jax.tree.map(lambda g, u: np.where(np.abs(g) >= 1e-3 * gmax, u, 0.0),
                        want["grads"], moved)
    close_trees(sure, jax.tree.map(lambda g, u: np.where(np.abs(g) >= 1e-3 * gmax, u, 0.0),
                                   want["grads"], want["update"]), atol=1e-6)


def tree(x):
    return jax.tree.map(jnp.asarray, x)


def as_reference(module, values):
    """``values`` (name -> tensor, a subset of the module's state dict) in
    a full reference-format dict of numpy arrays, zeros elsewhere."""
    return {k: (values[k] if k in values else torch.zeros_like(v)).detach().numpy()
            for k, v in module.state_dict().items()}


def grads(module):
    return as_reference(module, {k: p.grad for k, p in module.named_parameters()
                                 if p.grad is not None})


def close_trees(got, want, **tol):
    def flat(tree):
        return {jax.tree_util.keystr(p): np.asarray(v)
                for p, v in jax.tree_util.tree_leaves_with_path(tree)}

    got, want = flat(got), flat(want)
    assert got.keys() == want.keys()
    for k, v in want.items():
        np.testing.assert_allclose(got[k], v, err_msg=k, **tol)


def jax_option_step(sd, music, motion, key, strategy: str, sample_length: int, clip_length: int,
                    **options):
    """One step of the JAX trainer on the lax float32 path with ``options``
    (``remat``, ``microbatch``, ``share_encodes``): its metrics and new
    variables, and the exact gradient of that step's loss: `jax.grad` in
    float64 of the mean over the microbatch chunks of the step's loss
    (`_forward4` / `_bce` on each chunk of the pairs the step cuts), the
    forwards under the same ``remat``.  Each chunk normalises by its own
    batch statistics; the running ones do not enter a train-mode loss."""
    s, c, k = sample_length, clip_length, options.get("microbatch", 1)
    tr = JaxTrainer(sample_length=s, clip_length=c, compute_dtype="float32",
                    music_conv_impl="lax", **options)
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    state = M2SNetState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=tr.tx.init(v["params"]))
    batch = (jnp.asarray(music), jnp.asarray(motion))
    pairs = [np.asarray(a) for a in build_pairs(jax.random.fold_in(key, 0), *batch, strategy, s, c)]
    with jax.enable_x64(True):
        tr64 = JaxTrainer(sample_length=s, clip_length=c, compute_dtype="float64",
                          music_conv_impl="lax", **options)
        v64 = jax.tree.map(lambda a: jnp.asarray(a, jnp.float64), import_m2snet(sd))
        b = pairs[0].shape[0] // k

        def loss(params, chunk):
            (p11, p12, p22, p21), _ = tr64._forward4(params, v64["batch_stats"], chunk, train=True)
            return (tr64._bce(p11, 1.0) + tr64._bce(p12, 0.0)
                    + tr64._bce(p22, 1.0) + tr64._bce(p21, 0.0))

        grad = jax.jit(jax.grad(loss))
        chunk_grads = [grad(v64["params"], [jnp.asarray(a[i * b:(i + 1) * b], jnp.float64)
                                            for a in pairs]) for i in range(k)]
        grads = jax.device_get(jax.tree.map(lambda *g: sum(g) / k, *chunk_grads))
    new, metrics = tr.train_step(state, batch, key, strategy)
    return ({name: float(m) for name, m in metrics.items()}, jax.device_get(new.batch_stats),
            grads)


def check_option_step(tr: M2SNetTrainer, got, reference) -> None:
    """The port's step (its metrics ``got``; its gradients still on the
    parameters) against `jax_option_step`'s: loss rtol 1e-4, accuracy
    atol 1e-6, the probabilities rtol 1e-4, every gradient within 1e-4 of
    the largest of the exact one, the new BN statistics within 1e-5."""
    metrics, stats, want = reference
    np.testing.assert_allclose(float(got["loss"]), metrics["loss"], rtol=1e-4)
    np.testing.assert_allclose(float(got["accuracy"]), metrics["accuracy"], atol=1e-6)
    for k in ("sync_prob", "non_sync_prob"):
        np.testing.assert_allclose(float(got[k]), metrics[k], rtol=1e-4)
    state = {k: v.detach().numpy() for k, v in tr.model.state_dict().items()}
    step_grads = {k: (np.zeros_like(state[k]) if p.grad is None else p.grad.numpy())
                  for k, p in tr.model.named_parameters()}
    gmax = max(float(np.abs(g).max()) for g in jax.tree.leaves(want))
    close_trees(import_m2snet(state | step_grads)["params"], want, atol=1e-4 * gmax)
    close_trees(import_m2snet(state)["batch_stats"], stats, atol=1e-5)
