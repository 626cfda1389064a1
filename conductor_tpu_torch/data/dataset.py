"""ConductorMotion100 data layer: memory-mapped readers + windowing.

A numpy copy of `conductor_tpu/data/dataset.py` (the port imports nothing
of the JAX package); its windows, epoch order and synthetic datasets are
the JAX module's, bit for bit (`tests/test_torch_port_data.py`).

The reference loads every `{i}/mel.npy` (5400x128) and `{i}/motion.npy`
(1800x13x2) of a split fully into RAM at startup
(`Diffusion_Stage/datasets/dataset.py:396-455`).  Here files are
memory-mapped and windows are materialized per batch, so startup is
O(#folders) and resident memory is O(batch).

Two windowing modes cover both reference datasets:
- ``mode="sequential"``: every non-overlapping `sample_length`-second window of
  every clip, in order (stage-1 `ConductorMotionDataset.__getitem__`,
  `utils/dataset.py:43-53`);
- ``mode="random"``: one random window per clip per epoch, drawn from
  ``(epoch, clip)`` (stage-2 `Music2MotionDataset`,
  `datasets/dataset.py:439-448`).

Each sample is ``(mel (s*90, 128), motion (s*30, 13, 2), m_len)`` where
``m_len`` replicates the reference's quirk of being the *full clip's* length
in seconds (`dataset.py:448`), used only when
`TrainConfig.replicate_reference_mask` is on.
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import numpy as np

from ..config import DatasetSpec


@dataclass
class ClipIndex:
    """One 60-s dataset folder."""

    mel_path: str
    motion_path: str
    mel_frames: int
    motion_frames: int


def scan_split(root: str, split: str, limit_hours: float | None = None) -> list[ClipIndex]:
    """Enumerate `{root}/{split}/{i}/` folders (reference
    `utils/dataset.py:17-42`, incl. the `limit` hour cap)."""
    split_dir = os.path.join(root, split)
    if not os.path.isdir(split_dir):
        raise FileNotFoundError(f"dataset split not found: {split_dir}")
    clips: list[ClipIndex] = []
    hours = 0.0
    names = sorted(
        (d for d in os.listdir(split_dir) if d.isdigit()), key=int
    )
    for name in names:
        folder = os.path.join(split_dir, name)
        mel_p = os.path.join(folder, "mel.npy")
        mot_p = os.path.join(folder, "motion.npy")
        if not (os.path.isfile(mel_p) and os.path.isfile(mot_p)):
            continue
        mel = np.load(mel_p, mmap_mode="r")
        mot = np.load(mot_p, mmap_mode="r")
        clips.append(ClipIndex(mel_p, mot_p, mel.shape[0], mot.shape[0]))
        hours += mot.shape[0] / 30.0 / 3600.0
        if limit_hours is not None and hours >= limit_hours:
            break
    return clips


class ConductorMotionDataset:
    """Windowed view over a split; numpy in, numpy out (host-side)."""

    def __init__(
        self,
        root: str,
        split: str = "train",
        sample_length: int = 30,
        mode: str = "random",
        limit_hours: float | None = None,
        spec: DatasetSpec = DatasetSpec(),
        seed: int = 0,
    ):
        assert mode in ("sequential", "random")
        self.spec = spec
        self.sample_length = sample_length
        self.mode = mode
        self.seed = seed
        self.clips = scan_split(root, split, limit_hours)
        if not self.clips:
            raise FileNotFoundError(f"no clips under {root}/{split}")
        self._windows: list[tuple[int, int]] = []
        if mode == "sequential":
            for ci, clip in enumerate(self.clips):
                n_windows = clip.motion_frames // (sample_length * spec.motion_hz)
                self._windows += [(ci, w) for w in range(n_windows)]

    def __len__(self) -> int:
        return len(self._windows) if self.mode == "sequential" else len(self.clips)

    def _load_window(self, clip: ClipIndex, start_sec: int):
        s = self.spec
        mel = np.load(clip.mel_path, mmap_mode="r")
        mot = np.load(clip.motion_path, mmap_mode="r")
        m0, m1 = start_sec * s.mel_hz, (start_sec + self.sample_length) * s.mel_hz
        p0, p1 = start_sec * s.motion_hz, (start_sec + self.sample_length) * s.motion_hz
        m_len = clip.motion_frames // s.motion_hz  # full-clip seconds (`dataset.py:448`)
        return (
            np.asarray(mel[m0:m1], dtype=np.float32),
            np.asarray(mot[p0:p1], dtype=np.float32),
            np.int32(m_len),
        )

    def __getitem__(self, idx: int):
        if self.mode == "sequential":
            ci, w = self._windows[idx]
            return self._load_window(self.clips[ci], w * self.sample_length)
        clip = self.clips[idx]
        max_start = clip.motion_frames // self.spec.motion_hz - self.sample_length
        rng = np.random.default_rng((self.seed, idx))
        start = int(rng.integers(0, max(max_start, 0) + 1))
        return self._load_window(clip, start)

    def set_epoch(self, epoch: int):
        """Re-seed random windowing per epoch (epoch-seeded shuffling is the
        reference sampler's behavior, `datasets/dataloader.py:33-37`)."""
        self.seed = epoch


def make_synthetic_dataset(
    root: str,
    split: str = "train",
    num_clips: int = 4,
    spec: DatasetSpec = DatasetSpec(),
    seed: int = 0,
    correlated: bool = False,
) -> str:
    """Write a tiny synthetic ConductorMotion100-shaped dataset (for tests,
    benches, and smoke training).  Motion is smooth sinusoidal keypoints in
    [0, 1] (the dataset's normalization, reference `README.md:73-84`).

    ``correlated=False``: mel is pure noise — shape-correct but with ZERO
    music<->motion mutual information (fine for unit tests; the contrastive
    task is unlearnable by construction).  ``correlated=True``: each clip
    gets a beat frequency; the motion oscillates at it and the mel carries
    energy bursts at the beats plus a speed-following envelope — so sync
    learning, conditioning, and beat metrics have real signal (used by
    scripts/run_e2e_demo.py).  The music->motion phase relationship is
    CONSISTENT across clips (deterministic per-joint offsets + small random
    jitter), like real conducting where the gesture hits the beat the same
    way in every performance — otherwise sync detection is clip-specific
    memorization and can never generalize to held-out clips."""
    rng = np.random.default_rng(seed)
    s = spec
    for i in range(num_clips):
        folder = os.path.join(root, split, str(i))
        os.makedirs(folder, exist_ok=True)
        T90 = s.clip_seconds * s.mel_hz
        T30 = s.clip_seconds * s.motion_hz
        t30 = np.arange(T30)[:, None, None] / s.motion_hz
        if correlated:
            beat_hz = 0.8 + 1.5 * rng.random()
            # phase-locked to the beat: deterministic per-joint offsets
            # (identical in every clip) + small per-clip jitter, so held-out
            # clips carry the SAME beat->gesture phase relationship
            joint_phase = np.linspace(0.0, np.pi / 2, s.n_joints)[None, :, None]
            phase = joint_phase + 0.25 * (rng.random((1, s.n_joints, s.joint_dim)) - 0.5)
            amp = 0.15 + 0.1 * rng.random((1, s.n_joints, s.joint_dim))
            # every joint moves at the clip's beat rate (+ a weak harmonic)
            motion = 0.5 + amp * np.sin(2 * np.pi * beat_hz * t30 + phase)
            motion += 0.05 * np.sin(2 * np.pi * 2 * beat_hz * t30 + 2 * phase)
            t90 = np.arange(T90) / s.mel_hz
            pulse = np.maximum(0.0, np.sin(2 * np.pi * beat_hz * t90)) ** 8
            band = np.exp(
                -0.5 * ((np.arange(s.mel_bins) - 30 - 40 * rng.random()) / 8.0) ** 2
            )
            mel = 0.25 * rng.random((T90, s.mel_bins))
            mel += 0.75 * pulse[:, None] * band[None, :]
            mel = np.clip(mel, 0.0, 1.0).astype(np.float32)
        else:
            mel = rng.random((T90, s.mel_bins)).astype(np.float32)
            phase = rng.random((1, s.n_joints, s.joint_dim)) * 2 * np.pi
            freq = 0.5 + rng.random((1, s.n_joints, s.joint_dim))
            motion = 0.5 + 0.25 * np.sin(2 * np.pi * freq * t30 + phase)
        np.save(os.path.join(folder, "mel.npy"), mel)
        np.save(os.path.join(folder, "motion.npy"), motion.astype(np.float32))
    return root


class BatchIterator:
    """Shuffling, epoch-seeded host batch iterator (replaces torch DataLoader
    + DistributedSampler): the epoch's order is a permutation of
    ``times`` copies of the dataset drawn from ``(seed, epoch)``, cut into
    batches of ``batch_size``; ``drop_last`` drops the short tail.  Each
    pass advances ``epoch``.  One process loads every batch (the JAX
    iterator's ``host_shard`` waits for the port's multi-process training).
    """

    kind = "python"  # which loader `make_batch_iterator` chose

    def __init__(
        self,
        dataset: ConductorMotionDataset,
        batch_size: int,
        shuffle: bool = True,
        drop_last: bool = True,
        seed: int = 0,
        times: int = 1,
    ):
        self.ds = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = seed
        self.epoch = 0
        # `--times` dataset duplication to keep iteration counts constant
        # across world sizes (`Diffusion_Stage/README.md:59`) — implemented
        # here (the reference documents it but `Music2MotionDataset` ignores
        # it, SURVEY.md §7.4).
        self.times = times

    def __len__(self):
        n = len(self.ds) * self.times
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def __iter__(self):
        order = np.tile(np.arange(len(self.ds)), self.times)
        if self.shuffle:
            np.random.default_rng((self.seed, self.epoch)).shuffle(order)
        self.ds.set_epoch(self.epoch)
        for b0 in range(0, len(order) - self.batch_size + 1, self.batch_size):
            yield self._collate([self.ds[int(i)] for i in order[b0:b0 + self.batch_size]])
        rem = len(order) % self.batch_size
        if rem and not self.drop_last:
            yield self._collate([self.ds[int(i)] for i in order[-rem:]])
        self.epoch += 1

    @staticmethod
    def _collate(samples):
        # datasets yield fixed-arity tuples: (mel, motion, m_len)
        return tuple(
            np.stack([s[k] for s in samples]) for k in range(len(samples[0]))
        )
