"""Unseen-music serving: audio of any length through a fixed-window model.

A copy of `conductor_tpu/prospective/unseen.py` (the reference's
`ProspectiveCup/test_unseen.py:26-73`), kept in the port so that it imports
nothing of the JAX package.  The denoiser's sequence embedding caps a
window at 60 s (1800 motion frames), so longer music is cut into 60-s mel
windows, each generated on its own, and the motion concatenated, with the
reference's quirks: the tail is truncated to a whole mel second, and a
tail shorter than 5 s is skipped (left as zeros).
"""

from __future__ import annotations

import os

import numpy as np

from ..data.mel import extract_mel_feature


def cached_mel(music_path: str, cache_dir: str) -> np.ndarray:
    """Mel extraction with the kit's npy cache (`test_unseen.py:26-35`)."""
    os.makedirs(cache_dir, exist_ok=True)
    name = os.path.basename(music_path)
    cache = os.path.join(cache_dir, f"mel_{name}.npy")
    if os.path.exists(cache):
        return np.load(cache)
    mel = extract_mel_feature(music_path)
    np.save(cache, mel)
    return mel


def generate_long(
    generate_fn,
    mel: np.ndarray,
    *,
    chunk_seconds: int = 60,
    min_tail_seconds: int = 5,
    mel_hz: int = 90,
    motion_hz: int = 30,
    n_joints: int = 13,
    joint_dim: int = 2,
) -> np.ndarray:
    """mel (T90, 128) of any length -> motion (ceil(T90/3), 13, 2).

    ``generate_fn(mel (1, t90, 128)) -> motion (1, t90//3, ...)``, a numpy
    array (or anything ``np.asarray`` takes), handles one window; windows
    are independent and run one after another, as the reference runs them.
    """
    t90 = mel.shape[0]
    ratio = mel_hz // motion_hz
    chunk90 = chunk_seconds * mel_hz
    motion = np.zeros([t90 // ratio + 1, n_joints, joint_dim], np.float32)

    n_chunks = t90 // chunk90 + 1
    for split in range(n_chunks):
        if (split + 1) * chunk90 <= t90:
            mel_step = mel[split * chunk90 : (split + 1) * chunk90]
        else:
            end = t90 - t90 % mel_hz  # truncate to a whole second
            mel_step = mel[split * chunk90 : end]
            if end - split * chunk90 < min_tail_seconds * mel_hz:
                continue
        out = np.asarray(generate_fn(mel_step[None]))[0]
        if out.ndim == 2:  # (T, 26) -> (T, 13, 2)
            out = out.reshape(-1, n_joints, joint_dim)
        start30 = split * chunk_seconds * motion_hz
        motion[start30 : start30 + out.shape[0]] = out
    return motion
