"""Caches of frozen-network outputs: music features and SyncLoss latents.

The port of `conductor_tpu/data/feature_cache.py`.  The stage-2 denoiser
and M2SGAN (with its encoder frozen) consume a stage-1 music encoder
frozen, so its (T30, 64) outputs can be computed once per clip, 18x
smaller than the mel they replace, and training reads them directly
(``TrainConfig.cached_features``, ``M2SGANTrainer(cached_features=True)``).
Condition dropout and the trainable ``proj`` come after the cache boundary
(`MotionTransformer.cond_from_features`).  As in JAX, the features are
encoded from whole clips and the windows sliced afterwards, so near a
window's borders they differ from those of the window encoded alone,
which the uncached step computes: the music encoder's convolutions and
pools reach across the border.

M2SGAN's second cache, `precompute_sync_latents`, holds the frozen
SyncLoss ST-GCN's latents of the real motion per training window (the
encoder's temporal convolutions reach across a window's border too, so
they are not sliced from whole clips); `GANCachedDataset` serves either
cache or both.

Each cache is keyed to the frozen weights that made it by a sidecar
``.<filename>.meta.json`` in the split holding their `state_dict_fingerprint`,
checked by JAX's rules (`_resolve_meta`).  The port's fingerprint hashes a
state dict, JAX's a flax tree, so a cache that either package wrote is
foreign to the other and refused unless overwritten.
"""

from __future__ import annotations

import hashlib
import json
import os
from collections.abc import Callable, Mapping

import numpy as np
import torch

from .dataset import ClipIndex, ConductorMotionDataset, scan_split

FEATURE_FILE = "music_feat.npy"
SYNC_LATENT_FILE = "sync_latent.npy"


def state_dict_fingerprint(sd: Mapping[str, torch.Tensor]) -> str:
    """A content hash of a state dict: its sorted names, and each tensor's
    shape, dtype and bytes.  Two runs from other checkpoints or init seeds
    give caches of the same shapes, so only the weights can tell them apart."""
    h = hashlib.sha256()
    for name in sorted(sd):
        t = sd[name].detach().cpu().contiguous()
        h.update(name.encode())
        h.update(str(tuple(t.shape)).encode())
        h.update(str(t.dtype).encode())
        h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
    return h.hexdigest()[:32]


def _meta_path(root: str, split: str, filename: str) -> str:
    return os.path.join(root, split, f".{filename}.meta.json")


def _resolve_meta(
    root: str, split: str, filename: str, meta: dict | None,
    overwrite: bool, clips: list[ClipIndex], cache_dir_of: Callable[[ClipIndex], str],
) -> bool:
    """Validate the cache's sidecar against ``meta``; returns the effective
    ``overwrite``.  JAX's rules (`conductor_tpu/data/feature_cache.py:44-96`):

    - ``meta=None``: no provenance check (callers that key caches themselves);
    - sidecar present and equal to ``meta``: reuse (fill missing files only);
    - sidecar present but different, or absent while cache files exist:
      raise unless ``overwrite``, since a silent reuse would train on
      features of other frozen weights.

    The sidecar is written before any feature, so a run interrupted during
    the precompute resumes (matching meta: fill the missing files)."""
    if meta is None:
        return overwrite
    mp = _meta_path(root, split, filename)
    if not overwrite:
        if os.path.exists(mp):
            with open(mp) as f:
                old = json.load(f)
            if old != meta:
                diff = {k: (old.get(k), meta.get(k)) for k in set(old) | set(meta)
                        if old.get(k) != meta.get(k)}
                raise ValueError(
                    f"feature cache '{filename}' under {root}/{split} was precomputed with "
                    f"different settings {diff}; pass overwrite=True (CLI: --overwrite_cache) "
                    "to recompute")
        elif any(os.path.exists(os.path.join(cache_dir_of(c), filename)) for c in clips):
            raise ValueError(
                f"feature cache '{filename}' under {root}/{split} has no provenance sidecar "
                "(written by another tool); pass overwrite=True (CLI: --overwrite_cache) to "
                "recompute it under the current frozen weights")
    with open(mp, "w") as f:
        json.dump(meta, f, indent=2, sort_keys=True)
    return overwrite


def check_cache_meta(root: str, split: str, meta: dict, filename: str = FEATURE_FILE) -> None:
    """Raise ValueError unless the split's cache sidecar holds ``meta``:
    what a rank that did not write the cache checks before it reads it."""
    mp = _meta_path(root, split, filename)
    old = None
    if os.path.exists(mp):
        with open(mp) as f:
            old = json.load(f)
    if old != meta:
        raise ValueError(f"feature cache '{filename}' under {root}/{split} holds {old}, this "
                         f"process's frozen encoder {meta}")


def precompute_music_features(
    encode_fn: Callable[[np.ndarray], np.ndarray | torch.Tensor],
    root: str,
    split: str = "train",
    *,
    batch_size: int = 8,
    overwrite: bool = False,
    filename: str = FEATURE_FILE,
    meta: dict | None = None,
) -> int:
    """Run ``encode_fn(mel (B, T90, 128)) -> (B, T30, C)`` over every clip of
    a split, writing ``filename`` (float32) beside each `mel.npy`; returns
    the number of clips written.  Clips are batched ``batch_size`` at a
    time among those of one length.  ``filename`` keeps apart the caches
    of different frozen encoders on one root (stage 2's grafted encoder,
    M2SGAN's transferred one); ``meta`` (holding the frozen encoder's
    `state_dict_fingerprint`) is checked against the split's sidecar."""
    clips = scan_split(root, split)
    overwrite = _resolve_meta(root, split, filename, meta, overwrite, clips,
                              lambda c: os.path.dirname(c.mel_path))
    todo = [c for c in clips if overwrite
            or not os.path.exists(os.path.join(os.path.dirname(c.mel_path), filename))]
    by_len: dict[int, list[ClipIndex]] = {}
    for c in todo:
        by_len.setdefault(c.mel_frames, []).append(c)
    written = 0
    for group in by_len.values():
        for i in range(0, len(group), batch_size):
            chunk = group[i:i + batch_size]
            mel = np.stack([np.load(c.mel_path).astype(np.float32) for c in chunk])
            feats = encode_fn(mel)
            if torch.is_tensor(feats):
                feats = feats.float().cpu().numpy()
            for c, f in zip(chunk, np.asarray(feats, np.float32)):
                # C order: the native loader maps C-ordered npy files only
                np.save(os.path.join(os.path.dirname(c.mel_path), filename),
                        np.ascontiguousarray(f))
                written += 1
    return written


def precompute_sync_latents(
    latent_fn: Callable[[np.ndarray], np.ndarray | torch.Tensor],
    root: str,
    split: str = "train",
    *,
    sample_length: int,
    batch_size: int = 8,
    overwrite: bool = False,
    filename: str = SYNC_LATENT_FILE,
    motion_hz: int = 30,
    meta: dict | None = None,
) -> int:
    """Run ``latent_fn(motion (B, S*30, 13, 2)) -> (B, S*30, C)``, the
    frozen SyncLoss motion encoder, over every sequential
    ``sample_length``-second window of every clip, writing a (n_windows,
    S*30, C) float32 array beside each `motion.npy`; returns the number
    of clips written.

    Cached per window, not encoded per clip and sliced: the latents of a
    window must be what the uncached step computes on it.  They are stored
    as float32 whatever the encoder's dtype; a bf16 value goes to float32
    and back exactly.  The windows of consecutive clips go through
    ``latent_fn`` ``batch_size`` at a time, the last call filled up with
    copies of its last window (JAX batches each clip's windows apart): a
    caller that passes its step's batch size gets every window's latents
    from a call of the step's shape, whatever algorithm a library picks
    for a shape.  ``meta`` (the encoder's `state_dict_fingerprint`, the
    sample length, its dtype and implementation) is checked against the
    split's sidecar."""
    clips = scan_split(root, split)
    overwrite = _resolve_meta(root, split, filename, meta, overwrite, clips,
                              lambda c: os.path.dirname(c.motion_path))
    frames = sample_length * motion_hz
    todo = [c for c in clips if c.motion_frames // frames and (
        overwrite or not os.path.exists(os.path.join(os.path.dirname(c.motion_path), filename)))]
    windows = [(ci, w) for ci, c in enumerate(todo) for w in range(c.motion_frames // frames)]
    done: dict[int, list[np.ndarray]] = {}
    written = 0
    for i in range(0, len(windows), batch_size):
        chunk = windows[i:i + batch_size]
        motion = np.stack([np.asarray(np.load(todo[ci].motion_path, mmap_mode="r")
                                      [w * frames:(w + 1) * frames], dtype=np.float32)
                           for ci, w in chunk])
        if len(windows) >= batch_size > len(chunk):
            motion = np.concatenate([motion, np.repeat(motion[-1:], batch_size - len(chunk), 0)])
        lats = latent_fn(motion)
        lats = lats.float().cpu().numpy() if torch.is_tensor(lats) else np.asarray(lats, np.float32)
        for (ci, _), lat in zip(chunk, lats):
            done.setdefault(ci, []).append(lat)
            clip = todo[ci]
            if len(done[ci]) == clip.motion_frames // frames:
                np.save(os.path.join(os.path.dirname(clip.motion_path), filename),
                        np.stack(done.pop(ci)))
                written += 1
    return written


class FeatureCachedDataset(ConductorMotionDataset):
    """`ConductorMotionDataset` yielding (features (s*30, C), motion, m_len)
    windows from the cache (``feature_file`` beside each `mel.npy`) instead
    of raw mel."""

    def __init__(self, *args, feature_file: str = FEATURE_FILE, **kwargs):
        super().__init__(*args, **kwargs)
        self.feature_file = feature_file

    def _load_window(self, clip: ClipIndex, start_sec: int):
        s = self.spec
        feats = np.load(os.path.join(os.path.dirname(clip.mel_path), self.feature_file),
                        mmap_mode="r")
        mot = np.load(clip.motion_path, mmap_mode="r")
        f0, f1 = start_sec * s.motion_hz, (start_sec + self.sample_length) * s.motion_hz
        return (
            np.asarray(feats[f0:f1], dtype=np.float32),
            np.asarray(mot[f0:f1], dtype=np.float32),
            np.int32(clip.motion_frames // s.motion_hz),
        )


class GANCachedDataset(ConductorMotionDataset):
    """M2SGAN's cached view: sequential windows ``(cond, motion[,
    sync_latents])``, ``cond`` the cached music features (``feature_file``
    given) or the raw mel, ``sync_latents`` the window's cached SyncLoss
    latents (``sync_latent_file`` given, `precompute_sync_latents`).
    Sequential mode only: the latent cache is kept on the fixed window
    grid."""

    def __init__(self, *args, feature_file: str | None = None,
                 sync_latent_file: str | None = None, **kwargs):
        super().__init__(*args, **kwargs)
        if self.mode != "sequential":
            raise ValueError("GANCachedDataset requires mode='sequential': the sync-latent "
                             "cache is stored on the fixed non-overlapping window grid")
        self.feature_file, self.sync_latent_file = feature_file, sync_latent_file

    def _load_window(self, clip: ClipIndex, start_sec: int):
        s = self.spec
        folder = os.path.dirname(clip.motion_path)
        p0, p1 = start_sec * s.motion_hz, (start_sec + self.sample_length) * s.motion_hz
        motion = np.asarray(np.load(clip.motion_path, mmap_mode="r")[p0:p1], dtype=np.float32)
        if self.feature_file is not None:
            feats = np.load(os.path.join(folder, self.feature_file), mmap_mode="r")
            cond = np.asarray(feats[p0:p1], dtype=np.float32)
        else:
            m0, m1 = start_sec * s.mel_hz, (start_sec + self.sample_length) * s.mel_hz
            cond = np.asarray(np.load(clip.mel_path, mmap_mode="r")[m0:m1], dtype=np.float32)
        if self.sync_latent_file is None:
            return cond, motion
        lats = np.load(os.path.join(folder, self.sync_latent_file), mmap_mode="r")
        return cond, motion, np.asarray(lats[start_sec // self.sample_length], dtype=np.float32)
