"""Frozen music-encoder feature cache for stage-2 training.

The stage-2 part of `conductor_tpu/data/feature_cache.py`.  The stage-2
denoiser consumes the stage-1 music encoder frozen, so its (T30, 64)
outputs can be computed once per clip, 18x smaller than the mel they
replace, and training reads them directly (``TrainConfig.cached_features``).
Condition dropout and the trainable ``proj`` come after the cache boundary
(`MotionTransformer.cond_from_features`).

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


def precompute_music_features(
    encode_fn: Callable[[np.ndarray], np.ndarray | torch.Tensor],
    root: str,
    split: str = "train",
    *,
    batch_size: int = 8,
    overwrite: bool = False,
    meta: dict | None = None,
) -> int:
    """Run ``encode_fn(mel (B, T90, 128)) -> (B, T30, C)`` over every clip of
    a split, writing `FEATURE_FILE` (float32) beside each `mel.npy`; returns
    the number of clips written.  Clips are batched ``batch_size`` at a
    time among those of one length.  ``meta`` (holding the frozen encoder's
    `state_dict_fingerprint`) is checked against the split's sidecar."""
    clips = scan_split(root, split)
    overwrite = _resolve_meta(root, split, FEATURE_FILE, meta, overwrite, clips,
                              lambda c: os.path.dirname(c.mel_path))
    todo = [c for c in clips if overwrite
            or not os.path.exists(os.path.join(os.path.dirname(c.mel_path), FEATURE_FILE))]
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
                np.save(os.path.join(os.path.dirname(c.mel_path), FEATURE_FILE),
                        np.ascontiguousarray(f))
                written += 1
    return written


class FeatureCachedDataset(ConductorMotionDataset):
    """`ConductorMotionDataset` yielding (features (s*30, C), motion, m_len)
    windows from the cache (`FEATURE_FILE` beside each `mel.npy`) instead of
    raw mel."""

    def _load_window(self, clip: ClipIndex, start_sec: int):
        s = self.spec
        feats = np.load(os.path.join(os.path.dirname(clip.mel_path), FEATURE_FILE), mmap_mode="r")
        mot = np.load(clip.motion_path, mmap_mode="r")
        f0, f1 = start_sec * s.motion_hz, (start_sec + self.sample_length) * s.motion_hz
        return (
            np.asarray(feats[f0:f1], dtype=np.float32),
            np.asarray(mot[f0:f1], dtype=np.float32),
            np.int32(clip.motion_frames // s.motion_hz),
        )
