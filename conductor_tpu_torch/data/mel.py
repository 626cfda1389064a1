"""Mel-spectrogram extraction (librosa-free), the serving CLIs' input.

A copy of `conductor_tpu/data/mel.py`, kept in the port so that it imports
nothing of the JAX package (`tests/test_torch_port_serving_cli.py` holds
the two equal): the reference's `extract_mel_feature`
(`Contrastive_Stage/utils/music_utils.py:8-23`,
`Diffusion_Stage/tools/visualization.py:152-167`): audio -> 128-mel power
spectrogram (n_fft 2048, hop 256, Hann, centered) -> dB (ref=max, top 80
dB) -> `flip(|dB + 80| / 80)` in [0, 1] -> resized to 90 fps.  The STFT
and the Slaney mel filterbank are numpy (librosa's public formulas); WAV
decodes with the stdlib `wave`, other formats through soundfile or
librosa when installed, resampling with scipy.  Host-side preprocessing:
no tensor here touches the card.
"""

from __future__ import annotations

import wave

import numpy as np


def load_audio(path: str, target_sr: int = 22050) -> tuple[np.ndarray, int]:
    """Load mono float32 audio.  WAV via stdlib; other formats need soundfile
    or librosa (not bundled) — raises with a clear message otherwise."""
    if path.lower().endswith(".wav"):
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            width = w.getsampwidth()
            ch = w.getnchannels()
            raw = w.readframes(w.getnframes())
        dtype = {1: np.uint8, 2: np.int16, 4: np.int32}[width]
        y = np.frombuffer(raw, dtype=dtype).astype(np.float32)
        if width == 1:
            y = (y - 128.0) / 128.0
        else:
            y = y / float(np.iinfo(dtype).max)
        if ch > 1:
            y = y.reshape(-1, ch).mean(axis=1)
    else:
        try:
            import soundfile as sf  # type: ignore

            y, sr = sf.read(path, dtype="float32", always_2d=False)
            if y.ndim > 1:
                y = y.mean(axis=1)
        except ImportError:
            try:
                import librosa  # type: ignore

                y, sr = librosa.load(path, sr=None, mono=True)
            except ImportError as e:
                raise RuntimeError(
                    f"cannot decode {path!r}: only .wav is supported without "
                    "soundfile/librosa installed"
                ) from e
    if sr != target_sr:
        from scipy.signal import resample_poly
        from math import gcd

        g = gcd(int(target_sr), int(sr))
        y = resample_poly(y, target_sr // g, sr // g).astype(np.float32)
        sr = target_sr
    return y.astype(np.float32), sr


def hz_to_mel(f: np.ndarray | float) -> np.ndarray:
    """Slaney mel scale (librosa default, htk=False)."""
    f = np.asarray(f, dtype=np.float64)
    f_sp = 200.0 / 3
    mels = f / f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, 1e-10) / min_log_hz) / logstep, mels)


def mel_to_hz(m: np.ndarray | float) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    f_sp = 200.0 / 3
    freqs = m * f_sp
    min_log_hz = 1000.0
    min_log_mel = min_log_hz / f_sp
    logstep = np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: float | None = None) -> np.ndarray:
    """Slaney-normalized triangular mel filterbank, (n_mels, 1 + n_fft/2)."""
    fmax = fmax or sr / 2.0
    fft_freqs = np.linspace(0, sr / 2.0, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    lower = -ramps[:-2] / fdiff[:-1, None]
    upper = ramps[2:] / fdiff[1:, None]
    weights = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])
    return (weights * enorm[:, None]).astype(np.float32)


def stft_power(y: np.ndarray, n_fft: int = 2048, hop: int = 256) -> np.ndarray:
    """|STFT|^2 with a Hann window and centered reflect padding,
    (1 + n_fft/2, frames)."""
    y = np.pad(y, n_fft // 2, mode="reflect")
    n_frames = 1 + (len(y) - n_fft) // hop
    window = np.hanning(n_fft + 1)[:-1].astype(np.float32)
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * window[None, :]
    spec = np.fft.rfft(frames, n=n_fft, axis=1)
    return (np.abs(spec) ** 2).T.astype(np.float32)


def melspectrogram(y: np.ndarray, sr: int = 22050, n_mels: int = 128,
                   n_fft: int = 2048, hop: int = 256) -> np.ndarray:
    """(n_mels, frames) mel power spectrogram."""
    return mel_filterbank(sr, n_fft, n_mels) @ stft_power(y, n_fft, hop)


def power_to_db(S: np.ndarray, top_db: float = 80.0) -> np.ndarray:
    """10·log10(S / max(S)), floored at -top_db (librosa `power_to_db`
    with ref=np.max)."""
    ref = np.maximum(S.max(), 1e-10)
    db = 10.0 * np.log10(np.maximum(S, 1e-10) / ref)
    return np.maximum(db, -top_db)


def extract_mel_feature(
    audio: str | np.ndarray,
    sr: int = 22050,
    mel_len_90fps: int | None = None,
    max_seconds: float | None = None,
) -> np.ndarray:
    """audio (path or waveform) -> (T90, 128) normalized mel in [0, 1]
    (`music_utils.py:8-23`; `visualization.py:152-167` adds the 60-s cap via
    ``max_seconds=60``)."""
    if isinstance(audio, str):
        y, sr = load_audio(audio, target_sr=sr)
    else:
        y = np.asarray(audio, dtype=np.float32)
    if max_seconds is not None and len(y) > sr * max_seconds:
        y = y[: int(sr * max_seconds)]
    if mel_len_90fps is None:
        mel_len_90fps = int(len(y) / sr * 90)

    mel_db = power_to_db(melspectrogram(y, sr))
    norm = np.flip(np.abs(mel_db + 80.0) / 80.0, axis=0)  # low freqs last
    resized = _resize_time(norm, mel_len_90fps)
    return resized.T.astype(np.float32)  # (T90, 128)


def _resize_time(S: np.ndarray, new_len: int) -> np.ndarray:
    """Resize (F, T) -> (F, new_len); cv2 bilinear when available (matching
    the reference's `cv2.resize`), else numpy linear interpolation."""
    try:
        import cv2

        return cv2.resize(S, (new_len, S.shape[0]))
    except ImportError:
        old = np.linspace(0.0, 1.0, S.shape[1])
        new = np.linspace(0.0, 1.0, new_len)
        return np.stack([np.interp(new, old, row) for row in S])
