"""PyTorch port, the serving CLIs and their host-side modules on the CPU.

The copies of `data/mel.py`, `prospective/unseen.py` and the numpy parts of
`viz/motion.py` against the JAX package's on the same WAV files and arrays
(16-bit mono at 22.05 kHz, 8-bit stereo at 16 kHz, which resamples): equal
bit for bit, as copies of numpy code, and where cv2 is installed one
skeleton frame of `render_frame`; `render_motion_video` raises without cv2
and `mux_audio` hands back the silent video without ffmpeg or moviepy, as
JAX's do.  Then both CLIs end to end from a tiny run
written by the port's `cli.train` (latent 32, 2 layers, 8 cosine steps,
``--device cpu``), with `render_motion_video` replaced by a recorder: a
150-s track gives motion (4501, 13, 2) from three windows of 60, 60 and
30 s, as JAX's `generate_long` gives, equal to an in-process
`generate_long` over the loaded run; `--max_seconds 60` one window,
``--guidance`` moving it; `test_unseen` the same motion as `visualize` and
its mel cache.  TensorBoard is kept out, as in tests/test_torch_port_train_cli.py.
"""

import os
import sys
import wave

import numpy as np
import pytest
import torch

from conductor_tpu.data import mel as jax_mel
from conductor_tpu.prospective import unseen as jax_unseen
from conductor_tpu.viz import motion as jax_viz
from conductor_tpu_torch.cli import test_unseen as unseen_cli
from conductor_tpu_torch.cli import visualize
from conductor_tpu_torch.cli.train import main as train_main
from conductor_tpu_torch.config import DatasetSpec
from conductor_tpu_torch.data import mel
from conductor_tpu_torch.data.dataset import make_synthetic_dataset
from conductor_tpu_torch.prospective import unseen
from conductor_tpu_torch.train.ddpm_trainer import DDPMTrainer
from conductor_tpu_torch.viz import motion as viz

torch.set_num_threads(2)

TINY = ["--batch_size", "4", "--diffusion_steps", "8", "--schedule", "cosine", "--sample_length",
        "2", "--latent_dim", "32", "--ff_size", "16", "--num_layers", "2", "--num_heads", "4",
        "--device", "cpu"]
LONG_S = 150  # three windows: 60 + 60 + 30 s


def write_wav(path, seconds, sr=22050, width=2, channels=1, seed=0):
    """A tone with a beat and some noise, as a PCM WAV through `wave`."""
    rng = np.random.RandomState(seed)
    t = np.arange(int(seconds * sr)) / sr
    y = 0.4 * np.sin(2 * np.pi * 220 * t) * (1 + np.sin(2 * np.pi * 2 * t)) / 2
    y = np.clip(y + 0.05 * rng.normal(size=t.shape), -1, 1)
    y = np.repeat(y[:, None], channels, axis=1)
    if width == 1:
        data = (y * 127 + 128).astype(np.uint8)
    else:
        data = (y * 32767).astype(np.int16)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(channels)
        w.setsampwidth(width)
        w.setframerate(sr)
        w.writeframes(data.tobytes())
    return str(path)


@pytest.fixture(autouse=True)
def _no_tensorboard(monkeypatch):
    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)


@pytest.fixture(scope="module")
def wavs(tmp_path_factory):
    d = tmp_path_factory.mktemp("wavs")
    return {"short": write_wav(d / "short.wav", 7.3),
            "stereo8": write_wav(d / "stereo8.wav", 4.2, sr=16000, width=1, channels=2, seed=1),
            "long": write_wav(d / "long.wav", LONG_S, seed=2)}


@pytest.mark.parametrize("name", ["short", "stereo8"])
def test_mel_matches_jax(wavs, name):
    path = wavs[name]
    y, sr = mel.load_audio(path)
    jy, jsr = jax_mel.load_audio(path)
    assert sr == jsr == 22050
    np.testing.assert_array_equal(y, jy)
    np.testing.assert_array_equal(mel.mel_filterbank(sr, 2048), jax_mel.mel_filterbank(sr, 2048))
    np.testing.assert_array_equal(mel.stft_power(y[:30000]), jax_mel.stft_power(y[:30000]))
    for kw in ({}, {"max_seconds": 3.0}, {"mel_len_90fps": 200}):
        got, want = mel.extract_mel_feature(path, **kw), jax_mel.extract_mel_feature(path, **kw)
        assert got.shape == want.shape and got.shape[1] == 128
        np.testing.assert_array_equal(got, want)
        assert 0.0 <= got.min() and got.max() <= 1.0


@pytest.mark.parametrize("seconds", [LONG_S, 125.5, 123.0, 42.0])
def test_generate_long_matches_jax(seconds):
    """The window split and its quirks: a 30-s tail, a tail truncated to a
    whole second, a tail under 5 s skipped (zeros), one short window."""
    t90 = int(seconds * 90)
    m = np.random.RandomState(int(seconds)).uniform(size=(t90, 128)).astype(np.float32)
    calls = []

    def fn(mel_step):  # (1, t90, 128) -> (1, t90 // 3, 26), a function of the window
        calls.append(mel_step.shape)
        return mel_step[:, ::3, :26] + mel_step.shape[1]

    got = unseen.generate_long(fn, m)
    n_port = len(calls)
    want = jax_unseen.generate_long(fn, m)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (t90 // 3 + 1, 13, 2) and len(calls) == 2 * n_port
    if seconds == LONG_S:
        assert calls[:n_port] == [(1, 5400, 128), (1, 5400, 128), (1, 2700, 128)]


def test_cached_mel(wavs, tmp_path):
    cache = tmp_path / "cache"
    first = unseen.cached_mel(wavs["short"], str(cache))
    assert (cache / "mel_short.wav.npy").exists()
    np.testing.assert_array_equal(unseen.cached_mel(wavs["short"], str(cache)), first)
    np.testing.assert_array_equal(first, jax_unseen.cached_mel(wavs["short"], str(tmp_path / "j")))


def test_viz_numpy_parts_match_jax(monkeypatch, tmp_path):
    rng = np.random.RandomState(9)
    motion = rng.uniform(0.3, 0.7, size=(120, 13, 2))
    for fn in ("smooth_motion", "bandpass_motion", "coco_to_cm100", "cm100_to_coco"):
        np.testing.assert_array_equal(getattr(viz, fn)(motion), getattr(jax_viz, fn)(motion), fn)
    raw = rng.uniform(0, 600, size=(50, 17, 2))
    np.testing.assert_array_equal(viz.norm_motion(raw, 600, 600), jax_viz.norm_motion(raw, 600, 600))
    try:  # one skeleton frame, where cv2 is installed
        import cv2  # noqa: F401
    except ImportError:
        pass
    else:
        kp = viz.cm100_to_coco(motion[:1] * 600)[0]
        trace = np.concatenate([np.full((5, 2, 2), -1.0), motion[:25, 9:11] * 600])
        scores = np.r_[np.ones(13), np.zeros(4)]
        frames = [m.render_frame(np.full((600, 600, 3), 255, np.uint8), kp, scores, trace)
                  for m in (viz, jax_viz)]
        np.testing.assert_array_equal(*frames)
        assert (frames[0] != 255).any()
    # cv2 stays a lazy import of the renderer; without ffmpeg or moviepy the
    # silent video comes back
    monkeypatch.setitem(sys.modules, "cv2", None)
    with pytest.raises(ImportError):
        viz.render_motion_video([motion], str(tmp_path))
    monkeypatch.setattr("shutil.which", lambda name: None)
    monkeypatch.setitem(sys.modules, "moviepy", None)
    monkeypatch.setitem(sys.modules, "moviepy.editor", None)
    assert viz.mux_audio("v.avi", "a.wav") == jax_viz.mux_audio("v.avi", "a.wav") == "v.avi"


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """A tiny stage-2 run written by the port's CLI (one epoch on 6-s clips)."""
    root = str(tmp_path_factory.mktemp("cm100_serving"))
    make_synthetic_dataset(root, "train", num_clips=4, spec=DatasetSpec(clip_seconds=6))
    ckpts = tmp_path_factory.mktemp("runs")
    mp = pytest.MonkeyPatch()
    mp.setitem(sys.modules, "torch.utils.tensorboard", None)
    try:
        train_main(["--data_root", root, "--name", "tiny", "--checkpoints_dir", str(ckpts), *TINY,
                    "--epochs", "1"])
    finally:
        mp.undo()
    return os.path.join(str(ckpts), "ConductorMotion100", "tiny")


@pytest.fixture
def recorder(monkeypatch):
    """`render_motion_video` and `DDPMTrainer.generate` recorded: the motions
    handed to the renderer, and each generate call's mel shape and kwargs."""
    seen = {"videos": [], "generate": []}

    def render(motions, save_path, name="motion", **kw):
        seen["videos"].append((name, motions[0]))
        return os.path.join(save_path, f"{name}.avi")

    generate = DDPMTrainer.generate

    def recorded(self, m, **kw):
        seen["generate"].append((tuple(np.shape(m)), kw.get("guidance_scale")))
        return generate(self, m, **kw)

    monkeypatch.setattr(viz, "render_motion_video", render)
    monkeypatch.setattr(DDPMTrainer, "generate", recorded)
    return seen


def test_visualize_long_track_in_windows(run, wavs, tmp_path, recorder, capsys):
    out = tmp_path / "viz"
    visualize.main(["--run_dir", run, "--music", wavs["long"], "--max_seconds", "0", "--steps",
                    "4", "--save_npy", "--device", "cpu", "--out_dir", str(out)])
    assert "device: cpu" in capsys.readouterr().out
    [(name, motion)] = recorder["videos"]
    assert name == "long" and motion.shape == (4501, 13, 2) and np.isfinite(motion).all()
    assert [s for s, _ in recorder["generate"]] == [(1, 5400, 128)] * 2 + [(1, 2700, 128)]
    np.testing.assert_array_equal(np.load(out / "long.npy"), motion)
    assert not motion[4500].any() and motion[:4500].std() > 0  # the last frame has no window
    # the same motion in process: the loaded run, a generator seeded anew a window
    trainer = visualize.load_run(run, None, "cpu")
    generate = visualize.window_generator(trainer, 0, num_steps=4, guidance_scale=1.0)
    np.testing.assert_array_equal(unseen.generate_long(generate, mel.extract_mel_feature(
        wavs["long"])), motion)


def test_visualize_first_minute_with_guidance(run, wavs, tmp_path, recorder):
    argv = ["--run_dir", run, "--music", wavs["long"], "--steps", "4", "--device", "cpu",
            "--out_dir", str(tmp_path)]
    visualize.main(argv)
    visualize.main(argv + ["--guidance", "2.5", "--step", "1"])
    (_, plain), (_, guided) = recorder["videos"]
    assert plain.shape == guided.shape == (1800, 13, 2)
    assert [g for _, g in recorder["generate"]] == [1.0, 2.5]
    assert np.abs(plain - guided).max() > 1e-3


def test_test_unseen_matches_visualize(run, wavs, tmp_path, recorder, capsys):
    music = tmp_path / "music"
    music.mkdir()
    os.link(wavs["long"], music / "long.wav")
    unseen_cli.main(["--run_dir", run, "--music_dir", str(music), "--steps", "4", "--device",
                     "cpu", "--out_dir", str(tmp_path / "out")])
    out = capsys.readouterr().out
    assert "found 1 test samples: ['long.wav']" in out and "test finished" in out
    assert (music / "cache" / "mel_long.wav.npy").exists()
    visualize.main(["--run_dir", run, "--music", wavs["long"], "--max_seconds", "0", "--steps",
                    "4", "--device", "cpu", "--out_dir", str(tmp_path / "viz")])
    (_, got), (_, want) = recorder["videos"]
    assert got.shape == (4501, 13, 2)
    np.testing.assert_array_equal(got, want)
