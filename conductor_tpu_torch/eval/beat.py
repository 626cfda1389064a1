"""Music beat tracking: spectral-flux onset strength + Ellis (2007) DP beats.

The port's copy of `conductor_tpu/eval/beat.py`.  The reference's Beat
Consistency metric calls librosa's `onset_strength` / `beat_track` on the
90 Hz mel (`Diffusion_Stage/tools/eval_new_metrics.py:319-340`).  Without
librosa this module tracks beats with numpy alone, by the same public
algorithms:

- onset strength = half-wave-rectified first difference of the (log-power)
  mel spectrogram, averaged over frequency (spectral flux);
- tempo estimation = onset autocorrelation weighted by a log-normal prior
  centred on 120 BPM;
- beat tracking = Ellis' dynamic program maximizing onset strength along the
  beat sequence with a log-squared tempo-deviation penalty
  (score[t] = o[t] + max_τ score[t-τ] - tightness·log²(τ/period)).

If librosa *is* importable it is used, as the reference does; the numpy
tracker finds the same beats to within a frame or two, which the BC
metric's σ=3 Gaussian absorbs.
"""

from __future__ import annotations

import numpy as np

try:  # optional fast path, matches reference bit-for-bit
    import librosa  # type: ignore

    HAVE_LIBROSA = True
except Exception:  # pragma: no cover
    librosa = None
    HAVE_LIBROSA = False


def onset_strength(S: np.ndarray, lag: int = 1) -> np.ndarray:
    """Spectral flux onset envelope from a (freq, time) spectrogram."""
    S = np.atleast_2d(np.asarray(S, dtype=np.float64))
    diff = S[:, lag:] - S[:, :-lag]
    env = np.maximum(0.0, diff).mean(axis=0)
    return np.concatenate([np.zeros(lag), env])


def estimate_tempo_period(
    onset_env: np.ndarray,
    fps: float,
    start_bpm: float = 120.0,
    std_bpm: float = 1.0,
    max_period: int | None = None,
) -> int:
    """Dominant beat period (in frames) from the onset autocorrelation with a
    log-normal tempo prior (librosa's `tempo` approach)."""
    o = onset_env - onset_env.mean()
    n = len(o)
    if max_period is None:
        max_period = min(n - 1, int(fps * 60.0 / 30.0))  # >= 30 BPM
    min_period = max(1, int(fps * 60.0 / 300.0))         # <= 300 BPM
    ac = np.correlate(o, o, mode="full")[n - 1 :]
    ac = ac[: max_period + 1]
    periods = np.arange(len(ac), dtype=np.float64)
    with np.errstate(divide="ignore"):
        bpms = 60.0 * fps / np.maximum(periods, 1e-9)
        prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    score = ac * prior
    score[:min_period] = -np.inf
    return int(np.argmax(score))


def beat_track(
    onset_env: np.ndarray,
    fps: float,
    tightness: float = 100.0,
    start_bpm: float = 120.0,
) -> np.ndarray:
    """Beat frame indices via Ellis' dynamic program."""
    if len(onset_env) == 0 or onset_env.max() <= 0:
        return np.zeros(0, dtype=int)
    o = onset_env / (onset_env.std() + 1e-12)  # normalize like librosa
    period = max(1, estimate_tempo_period(onset_env, fps, start_bpm))

    n = len(o)
    lo, hi = max(1, period // 2), min(n, 2 * period)
    taus = np.arange(lo, hi + 1)
    penalty = -tightness * np.log(taus / period) ** 2

    score = np.full(n, -np.inf)
    backlink = np.full(n, -1, dtype=int)
    score[: min(hi + 1, n)] = o[: min(hi + 1, n)]
    for t in range(lo, n):
        prev = t - taus
        valid = prev >= 0
        if not valid.any():
            continue
        cand = score[prev[valid]] + penalty[valid]
        best = int(np.argmax(cand))
        best_score = cand[best]
        if best_score + o[t] > score[t]:
            score[t] = o[t] + best_score
            backlink[t] = prev[valid][best]

    # backtrack from the best-scoring tail position
    tail_from = max(0, n - period)
    t = tail_from + int(np.argmax(score[tail_from:]))
    beats = [t]
    while backlink[t] >= 0:
        t = backlink[t]
        beats.append(t)
    return np.array(beats[::-1], dtype=int)


def music_beats_from_mel(
    mel: np.ndarray, fps: int = 90, hop_length: int = 512, tightness: float = 100.0
) -> np.ndarray:
    """(T90, 128) mel -> (T90,) one-hot beat array, matching the reference's
    `get_music_beat` (`eval_new_metrics.py:319-340`)."""
    if HAVE_LIBROSA:
        sr = fps * hop_length
        env = librosa.onset.onset_strength(S=mel.T, sr=sr)
        _, beat_idxs = librosa.beat.beat_track(
            onset_envelope=env, sr=sr, hop_length=hop_length, tightness=tightness
        )
        onehot = np.zeros_like(env, dtype=np.float32)
        onehot[np.asarray(beat_idxs, dtype=int)] = 1.0
        return onehot
    env = onset_strength(mel.T)
    beats = beat_track(env, fps=fps, tightness=tightness)
    onehot = np.zeros(mel.shape[0], dtype=np.float32)
    onehot[beats[beats < mel.shape[0]]] = 1.0
    return onehot
