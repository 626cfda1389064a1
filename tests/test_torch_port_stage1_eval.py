"""PyTorch port: the stage-1 evaluators (`eval.stage1`), the copied metrics
(`eval.metrics`, `eval.beat`) and the image dumps of `utils.logging`, on
the CPU.

- every function of `eval.metrics` and `eval.beat` against the JAX
  package's on the same seeded inputs, within 1e-6 relative;
- `M2SNetTrainer.evaluate` (one batch at each difficulty) against JAX's
  `evaluate` on the same synthetic weights, data and starts: accuracy
  within 1e-6, the probabilities rtol 1e-4;
- both evaluators' aggregation and key sets against JAX's, fed the same
  deterministic numpy stubs (the per-batch seed JAX draws its key from
  seeds the port's generator), within 1e-6 relative;
- the image dumps with matplotlib and with it blocked in `sys.modules`:
  PNG files, or the arrays as ``.npy`` files, and nothing raises.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_port_m2s_parity import jax_starts

from conductor_tpu.eval import beat as jax_beat
from conductor_tpu.eval import metrics as jax_metrics
from conductor_tpu.eval.stage1 import M2SGANEvaluator as JaxGANEvaluator
from conductor_tpu.eval.stage1 import M2SNetEvaluator as JaxNetEvaluator
from conductor_tpu.interop import import_m2snet
from conductor_tpu.train.m2snet_trainer import M2SNetState
from conductor_tpu.train.m2snet_trainer import M2SNetTrainer as JaxTrainer
from conductor_tpu_torch import M2SNetTrainer
from conductor_tpu_torch.eval import beat, metrics
from conductor_tpu_torch.eval.stage1 import M2SGANEvaluator, M2SNetEvaluator, batch_seed
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict
from conductor_tpu_torch.models.m2snet import M2SNet
from conductor_tpu_torch.utils.logging import MetricLogger

torch.set_num_threads(2)

RNG = np.random.RandomState(3)
T30, T90 = 120, 360


def _motion(b, seed):
    r = np.random.RandomState(seed)
    t = np.arange(T30)[None, :, None, None] / 30.0
    freq = 0.5 + r.rand(b, 1, 13, 2) * 2
    return (0.5 + 0.3 * np.sin(2 * np.pi * freq * t + r.rand(b, 1, 13, 2) * 6)).astype(np.float32)


def _mel(seed):
    """A mel with beat pulses at ~2 Hz over noise, (T90, 128)."""
    r = np.random.RandomState(seed)
    pulse = np.maximum(0.0, np.sin(2 * np.pi * 2.1 * np.arange(T90) / 90.0)) ** 8
    return (0.2 * r.rand(T90, 128) + pulse[:, None]).astype(np.float32)


LAT_A, LAT_B = RNG.normal(size=(200, 8)), RNG.normal(size=(200, 8)) * 1.3 + 0.2
MOT_A, MOT_B = _motion(2, 1), _motion(2, 2)
EMB_A, EMB_B = RNG.normal(size=(12, 6)), RNG.normal(size=(12, 6))
MEL = _mel(4)
ONSET = beat.onset_strength(MEL.T)

CASES = {
    "frechet_distance": (LAT_A, LAT_B),
    "diversity_score": ([LAT_A[i * 20:(i + 1) * 20] for i in range(10)],),
    "feat_distance": (LAT_A, LAT_B),
    "normalize_01": (LAT_A,),
    "motion_peak_onehot": (MOT_A[0],),
    "music_beat_onehot": (MEL,),
    "alignment_score": (np.arange(T30) % 17 == 0, np.arange(T30) % 13 == 3),
    "beat_consistency": (MOT_A[0], MEL),
    "strength_contour_error": (MOT_A, MOT_B),
    "rhythm_density_error": (MOT_A, MOT_B),
    "std_percentage": (MOT_A, MOT_B),
    "motion_mse": (MOT_A, MOT_B),
    "sync_error": (LAT_A, LAT_B),
    "mean_perceptual_error": (LAT_A, LAT_B),
    "per_frame_std": (MOT_A,),
    "wasserstein_1d": (MOT_A, MOT_B),
    "euclidean_distance_matrix": (EMB_A, EMB_B),
    "calculate_top_k": (np.argsort(RNG.rand(12, 12), axis=1), 3),
    "calculate_r_precision": (EMB_A, EMB_B, 3),
    "calculate_matching_score": (EMB_A, EMB_B),
    "calculate_activation_statistics": (LAT_A,),
    "calculate_diversity": (LAT_A, 50),
    "calculate_multimodality": (RNG.normal(size=(5, 12, 4)), 6),
    "calculate_frechet_distance": (LAT_A.mean(0), np.cov(LAT_A, rowvar=False), LAT_B.mean(0),
                                   np.cov(LAT_B, rowvar=False)),
}
BEAT_CASES = {
    "onset_strength": (MEL.T,),
    "estimate_tempo_period": (ONSET, 90),
    "beat_track": (ONSET, 90),
    "music_beats_from_mel": (MEL,),
}


def _same(got, want):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    else:
        np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                                   rtol=1e-6)


def test_every_copied_function_is_tested():
    public = lambda mod: {n for n, f in vars(mod).items()  # noqa: E731
                          if callable(f) and getattr(f, "__module__", "") == mod.__name__}
    assert public(metrics) == set(CASES)
    assert public(beat) == set(BEAT_CASES)


@pytest.mark.parametrize("name", sorted(CASES))
def test_metric_matches_jax(name):
    _same(getattr(metrics, name)(*CASES[name]), getattr(jax_metrics, name)(*CASES[name]))


@pytest.mark.parametrize("name", sorted(BEAT_CASES))
def test_beat_tracking_matches_jax(name):
    _same(getattr(beat, name)(*BEAT_CASES[name]), getattr(jax_beat, name)(*BEAT_CASES[name]))


def test_beat_consistency_in_motion_frames_matches_jax():
    args = (MOT_B[1], MEL)
    _same(metrics.beat_consistency(*args, beat_scale=1 / 3),
          jax_metrics.beat_consistency(*args, beat_scale=1 / 3))


S, C = 3, 1


@pytest.mark.parametrize("strategy", ["easy", "hard", "super_hard"])
def test_m2snet_evaluate_matches_jax(strategy):
    sd = synthetic_m2snet_state_dict(M2SNet(), seed=0)
    r = np.random.RandomState(5)
    music = r.normal(size=(3, S * 90, 128)).astype(np.float32)
    motion = r.uniform(0, 1, size=(3, S * 30, 13, 2)).astype(np.float32)
    key = jax.random.PRNGKey(2)
    jtr = JaxTrainer(sample_length=S, clip_length=C, compute_dtype="float32", music_conv_impl="lax")
    v = jax.tree.map(jnp.asarray, import_m2snet(sd))
    state = M2SNetState(step=jnp.zeros((), jnp.int32), params=v["params"],
                        batch_stats=v["batch_stats"], opt_state=None)
    want = jtr.evaluate(state, (music, motion), jax.random.fold_in(key, 0), strategy)
    tr = M2SNetTrainer(sample_length=S, clip_length=C, device="cpu")
    tr.load_reference_state_dict(sd)
    got = tr.evaluate(music, motion, strategy, starts=jax_starts(key, strategy, S, C))
    assert got.keys() == want.keys()
    np.testing.assert_allclose(got["accuracy"], want["accuracy"], atol=1e-6)
    for k in ("sync_prob", "non_sync_prob"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-4)


def _stub_metrics(music, strategy):
    level = ("easy", "hard", "super_hard").index(strategy)
    m = float(np.asarray(music).mean())
    return {"accuracy": m + level, "sync_prob": m * 2 - level, "non_sync_prob": m ** 2}


class _JaxStubTrainer:
    def evaluate(self, state, batch, rng, strategy):
        return _stub_metrics(batch[0], strategy)


class _PortStubTrainer:
    def __init__(self):
        self.seeds = []

    def evaluate(self, music, motion, strategy, *, generator):
        self.seeds.append(generator.initial_seed())
        return _stub_metrics(music, strategy)


def _batches(n, b=3):
    return [(_mel(10 + i)[None].repeat(b, 0) * (1 + i), _motion(b, 20 + i)) for i in range(n)]


def test_m2snet_evaluator_aggregates_as_jax():
    batches = [(mel[:, :270], mot[:, :90]) for mel, mot in _batches(3)]
    want = JaxNetEvaluator(_JaxStubTrainer()).evaluate(None, iter(batches), seed=7)
    stub = _PortStubTrainer()
    got = M2SNetEvaluator(stub).evaluate(iter(batches), seed=7)
    assert got.keys() == want.keys() and all(got[s].keys() == want[s].keys() for s in want)
    for s in want:
        _same([got[s][k] for k in want[s]], [want[s][k] for k in want[s]])
    assert stub.seeds == [batch_seed(7, i) for i in range(3)] * 3  # one stream a batch


def _generate(mel):
    """A deterministic stand-in generator: motion that follows the mel."""
    env = np.asarray(mel)[:, ::3].mean(axis=-1)  # (B, T30)
    t = np.arange(env.shape[1])[None, :, None, None]
    return (0.5 + 0.2 * np.sin(t / 7.0 + np.cumsum(env, 1)[:, :, None, None])
            + np.zeros((1, 1, 13, 2))).astype(np.float32)


W = np.random.RandomState(9).normal(size=(26, 64)).astype(np.float32)


def _latents(motion):
    motion = np.asarray(motion)
    return np.tanh(motion.reshape(*motion.shape[:2], 26) @ W)


@pytest.mark.parametrize("with_beat", [True, False])
def test_m2sgan_evaluator_aggregates_as_jax(with_beat):
    batches = _batches(2)
    want = JaxGANEvaluator(lambda mel, rng: _generate(mel), latents_fn=_latents).evaluate(
        iter(batches), seed=3, with_beat=with_beat)
    seeds = []

    def generate(mel, generator):
        seeds.append(generator.initial_seed())
        return torch.from_numpy(_generate(mel)).to(torch.bfloat16).float()

    got = M2SGANEvaluator(generate, latents_fn=lambda m: torch.from_numpy(_latents(m))).evaluate(
        iter(batches), seed=3, with_beat=with_beat)
    assert list(got) == list(want)
    assert {"MSE", "RDE", "SCE", "MPE", "FGD", "Diversity"} <= got.keys()
    assert ("BC" in got) == with_beat
    assert seeds == [batch_seed(3, 0), batch_seed(3, 1)]
    # the port's stub rounds its motion to bf16 and back: the metric math
    # runs on float32 host arrays, so JAX fed those same values agrees
    rounded = JaxGANEvaluator(
        lambda mel, rng: np.asarray(torch.from_numpy(_generate(mel)).to(torch.bfloat16).float()),
        latents_fn=_latents).evaluate(iter(batches), seed=3, with_beat=with_beat)
    _same([got[k] for k in want], [rounded[k] for k in want])


@pytest.mark.parametrize("matplotlib", [True, False])
def test_image_dumps_never_raise(matplotlib, tmp_path, monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    if not matplotlib:
        for name in ("matplotlib", "matplotlib.pyplot", "matplotlib.cm"):
            monkeypatch.setitem(sys.modules, name, None)
    logger = MetricLogger(str(tmp_path))
    music_feats = [torch.rand(1, 30, 16), torch.rand(1, 30, 64)]
    motion_feats = [torch.rand(1, 30, 26) for _ in range(5)]
    logger.log_feature_maps(3, music_feats, motion_feats)
    logger.log_motion_plot(3, _motion(1, 1), torch.from_numpy(_motion(1, 2)))
    logger.close()
    files = sorted(os.listdir(tmp_path / "images"))
    assert len(files) == 2 + 3 + 1  # of the motion maps 0, 2 and 4 (even; 4 the last)
    assert all(f.endswith(".png" if matplotlib else ".npy") for f in files)
    if not matplotlib:
        trace = np.load(tmp_path / "images" / "motion_traces_00000003.npy")
        assert trace.dtype == np.uint8 and trace.shape == (26 * 32, T30, 3)
        heat = np.load(tmp_path / "images" / "M2SNet_Music_feature_layer_1_00000003.npy")
        assert heat.shape == (64, 30, 3)
