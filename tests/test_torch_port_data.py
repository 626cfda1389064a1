"""PyTorch port: the stage-2 data layer against the JAX package's.

`data.dataset` (the synthetic dataset, `scan_split`, both windowing modes
over two epochs, `BatchIterator`'s order) and the native loader (built
from `native/dataloader.cpp` into `build/`) bit for bit against JAX's; the
native iterator against the port's own Python one in sequential mode; the
feature cache's sidecar rules, and its features against JAX's
`precompute_music_features` on the same float32 weights at 1e-5 of the
largest value.  Clips are 6 s (`DatasetSpec(clip_seconds=6)`), so that
the music encoder runs on short mel.
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config as JaxConfig
from conductor_tpu.config import DatasetSpec as JaxSpec
from conductor_tpu.config import DenoiserConfig as JaxDenoiserConfig
from conductor_tpu.data import dataset as jds
from conductor_tpu.data import feature_cache as jfc
from conductor_tpu.data import native_loader as jnl
from conductor_tpu.interop import import_motion_transformer
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer
from conductor_tpu_torch import DDPMTrainer
from conductor_tpu_torch.config import Config, DatasetSpec, DenoiserConfig, DiffusionConfig
from conductor_tpu_torch.data import dataset as pds
from conductor_tpu_torch.data import feature_cache as pfc
from conductor_tpu_torch.data import native_loader as pnl
from conductor_tpu_torch.interop import synthetic_state_dict

torch.set_num_threads(2)

SPEC, JSPEC = DatasetSpec(clip_seconds=6), JaxSpec(clip_seconds=6)
N_CLIPS = 5


def _equal_batches(a, b):
    a, b = list(a), list(b)
    assert len(a) == len(b) > 0
    for x, y in zip(a, b):
        assert len(x) == len(y)
        for u, v in zip(x, y):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """One synthetic root written by the port; JAX's writer must give the
    same bytes."""
    port_root = str(tmp_path_factory.mktemp("port_cm"))
    jax_root = str(tmp_path_factory.mktemp("jax_cm"))
    pds.make_synthetic_dataset(port_root, "train", num_clips=N_CLIPS, spec=SPEC, seed=3)
    jds.make_synthetic_dataset(jax_root, "train", num_clips=N_CLIPS, spec=JSPEC, seed=3)
    for i in range(N_CLIPS):
        for f in ("mel.npy", "motion.npy"):
            np.testing.assert_array_equal(np.load(os.path.join(port_root, "train", str(i), f)),
                                          np.load(os.path.join(jax_root, "train", str(i), f)))
    return port_root


def test_correlated_synthetic_dataset_matches_jax(tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    pds.make_synthetic_dataset(a, "train", num_clips=2, spec=SPEC, seed=1, correlated=True)
    jds.make_synthetic_dataset(b, "train", num_clips=2, spec=JSPEC, seed=1, correlated=True)
    for f in ("0/mel.npy", "1/motion.npy"):
        np.testing.assert_array_equal(np.load(os.path.join(a, "train", f)),
                                      np.load(os.path.join(b, "train", f)))


@pytest.mark.parametrize("limit_hours", [None, 0.003])
def test_scan_split_matches_jax(root, limit_hours):
    port = pds.scan_split(root, "train", limit_hours)
    ref = jds.scan_split(root, "train", limit_hours)
    assert [dataclasses.astuple(c) for c in port] == [dataclasses.astuple(c) for c in ref]
    assert len(port) == (N_CLIPS if limit_hours is None else 2)  # 6 s a clip: 0.00167 h


@pytest.mark.parametrize("mode,sample_length,times,drop_last", [
    ("sequential", 2, 1, True), ("sequential", 3, 2, False), ("random", 2, 3, True),
    ("random", 4, 2, False)])
def test_windows_and_batch_order_match_jax(root, mode, sample_length, times, drop_last):
    """Two epochs of shuffled batches: the same windows, order, m_lens and
    tail as JAX's `BatchIterator`, bit for bit."""
    port = pds.BatchIterator(pds.ConductorMotionDataset(root, "train", sample_length, mode, spec=SPEC),
                             3, seed=7, times=times, drop_last=drop_last)
    ref = jds.BatchIterator(jds.ConductorMotionDataset(root, "train", sample_length, mode, spec=JSPEC),
                            3, seed=7, times=times, drop_last=drop_last)
    assert len(port) == len(ref)
    for _ in range(2):
        _equal_batches(port, ref)
    assert port.epoch == ref.epoch == 2
    m_lens = next(iter(port))[2]
    assert m_lens.dtype == np.int32 and (m_lens == SPEC.clip_seconds).all()  # the full clip


def test_native_iterator_matches_jax_native(root):
    """The same C source, seed and mode: the port's native batches are JAX's
    `NativeBatchIterator`'s, bit for bit, over two epochs."""
    if not jnl.native_available(build=True):
        pytest.skip("the JAX package's native loader did not build")
    ds = pds.ConductorMotionDataset(root, "train", 2, "random", spec=SPEC)
    jds_ = jds.ConductorMotionDataset(root, "train", 2, "random", spec=JSPEC)
    port = pnl.NativeBatchIterator(ds, 2, seed=11, times=3)
    ref = jnl.NativeBatchIterator(jds_, 2, seed=11, times=3)
    assert len(port) == len(ref) == N_CLIPS * 3 // 2
    for _ in range(2):
        _equal_batches(port, ref)
    port.close()


@pytest.mark.parametrize("shuffle", [False, True])
def test_native_iterator_matches_python_sequential(root, shuffle):
    """Sequential windows unshuffled: the native batches equal the Python
    iterator's; shuffled: the same windows (5 a batch, none dropped), in
    the native loader's order."""
    ds = pds.ConductorMotionDataset(root, "train", 2, "sequential", spec=SPEC)
    it = pnl.make_batch_iterator(ds, 5, shuffle=shuffle, seed=2)
    assert it.kind == "native"
    py = pds.BatchIterator(ds, 5, shuffle=shuffle, seed=2)
    if not shuffle:
        _equal_batches(it, py)
    else:
        key = lambda bs: sorted(w.tobytes() for b in bs for w in b[1])  # noqa: E731
        assert key(list(it)) == key(list(py))


def test_native_library_lives_in_build(root):
    path = pnl.library_path()
    pnl.load_library()
    assert path.exists() and path.parent.name == "conductor_tpu_torch"
    assert path.parent.parent.name == "build"


def test_make_batch_iterator_falls_back_and_says_so(root, monkeypatch):
    def broken():
        raise RuntimeError("g++ failed: no compiler")

    monkeypatch.setattr(pnl, "load_library", broken)
    ds = pds.ConductorMotionDataset(root, "train", 2, "sequential", spec=SPEC)
    it = pnl.make_batch_iterator(ds, 4, shuffle=False)
    assert it.kind == "python" and "g++ failed" in it.fallback_reason
    assert len(list(it)) == len(it) == N_CLIPS * 3 // 4


# ------------------------------------------------------------ feature cache


TINY = dict(latent_dim=32, ff_size=16, num_layers=1, num_heads=4, num_frames=180)


def _tiny():
    return Config(dataset=SPEC, denoiser=DenoiserConfig(**TINY),
                  diffusion=DiffusionConfig(steps=8, schedule="cosine"))


@pytest.fixture(scope="module")
def trainer():
    tr = DDPMTrainer(_tiny(), device="cpu")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=4))
    return tr


def _meta(tr):
    return {"fingerprint": pfc.state_dict_fingerprint(tr.model.music_encoder.state_dict())}


def test_cached_features_match_jax_precompute(root, trainer, tmp_path):
    """The port's cache (`DDPMTrainer.music_features`) against JAX's
    `precompute_music_features` with `encode_music` on the same float32
    weights, at 1e-5 of the largest feature; the cached dataset yields
    the cache's windows."""
    import shutil

    jax_root = str(tmp_path / "jax")
    shutil.copytree(root, jax_root, ignore=shutil.ignore_patterns("music_feat.npy", ".music*"))
    port_root = str(tmp_path / "port")
    shutil.copytree(jax_root, port_root)
    n = pfc.precompute_music_features(trainer.music_features, port_root, "train", batch_size=2,
                                      meta=_meta(trainer))
    assert n == N_CLIPS

    jtr = JaxTrainer(JaxConfig(dataset=JSPEC, denoiser=JaxDenoiserConfig(**TINY)))
    sd = {k: v.numpy() for k, v in trainer.model.state_dict().items()}
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    enc = jax.jit(lambda mel: jtr.model.apply(variables, mel, method=jtr.model.encode_music)[1])
    assert jfc.precompute_music_features(enc, jax_root, "train", batch_size=2) == N_CLIPS
    for i in range(N_CLIPS):
        got = np.load(os.path.join(port_root, "train", str(i), pfc.FEATURE_FILE))
        want = np.load(os.path.join(jax_root, "train", str(i), jfc.FEATURE_FILE))
        assert got.shape == want.shape == (SPEC.clip_seconds * 30, 64) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())

    ds = pfc.FeatureCachedDataset(port_root, "train", 2, "sequential", spec=SPEC)
    f, m, m_len = ds[4]  # clip 1, window 1
    clip1 = np.load(os.path.join(port_root, "train", "1", pfc.FEATURE_FILE))
    np.testing.assert_array_equal(f, clip1[60:120])
    assert m.shape == (60, 13, 2) and m_len == SPEC.clip_seconds
    # the native loader streams the cache at 30 Hz, as the Python iterator
    _equal_batches(pnl.NativeBatchIterator(ds, 3, shuffle=False), pds.BatchIterator(ds, 3, shuffle=False))


def test_feature_cache_sidecar_rules(root, trainer, tmp_path):
    """Reuse under the same fingerprint, refusal under another, recompute
    with ``overwrite``, refusal of a cache without a sidecar, and a resume
    that fills only the files a cut precompute left missing."""
    import shutil

    r = str(tmp_path / "r")
    shutil.copytree(root, r, ignore=shutil.ignore_patterns("music_feat.npy", ".music*"))
    meta = _meta(trainer)
    calls = []

    def encode(mel):
        calls.append(len(mel))
        return trainer.music_features(mel)

    assert pfc.precompute_music_features(encode, r, meta=meta) == N_CLIPS
    sidecar = os.path.join(r, "train", f".{pfc.FEATURE_FILE}.meta.json")
    assert json.load(open(sidecar)) == meta
    assert pfc.precompute_music_features(encode, r, meta=meta) == 0  # reuse
    other = {"fingerprint": "0" * 32}
    with pytest.raises(ValueError, match="different settings"):
        pfc.precompute_music_features(encode, r, meta=other)
    assert pfc.precompute_music_features(encode, r, meta=other, overwrite=True) == N_CLIPS
    assert json.load(open(sidecar)) == other
    os.remove(sidecar)
    with pytest.raises(ValueError, match="no provenance sidecar"):
        pfc.precompute_music_features(encode, r, meta=meta)
    # a precompute cut after two clips: the sidecar was written first
    assert pfc.precompute_music_features(encode, r, meta=meta, overwrite=True) == N_CLIPS
    for i in (2, 3, 4):
        os.remove(os.path.join(r, "train", str(i), pfc.FEATURE_FILE))
    calls.clear()
    assert pfc.precompute_music_features(encode, r, meta=meta) == 3 and sum(calls) == 3


def test_state_dict_fingerprint(trainer):
    sd = trainer.model.music_encoder.state_dict()
    fp = pfc.state_dict_fingerprint(sd)
    assert fp == pfc.state_dict_fingerprint({k: v.clone() for k, v in reversed(sd.items())})
    moved = dict(sd)
    key = next(k for k in sd if k.endswith("running_mean"))
    moved[key] = sd[key] + 1e-6
    assert pfc.state_dict_fingerprint(moved) != fp
    assert pfc.state_dict_fingerprint({k: v.double() for k, v in sd.items()}) != fp
