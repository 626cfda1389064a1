"""Step-versioned training checkpoints, and the stage-1 file of the graft.

The counterpart of `conductor_tpu/train/checkpoints.py`, which keeps Orbax
directories: here each step is one ``torch.save`` file, ``<dir>/<step>.tar``,
holding whatever dict the caller saves; the stage-2 trainer's
`DDPMTrainer.state_dict` is the reference's ``latest.tar`` layout, which
the JAX package's `load_diffusion_tar` / `load_diffusion_optimizer` read.
A file is written to a temporary name and moved into place, so a crash
leaves the previous checkpoints whole.  A save copies nothing itself: the
caller hands over host tensors (``state_dict`` copies them), and the write
runs on a thread unless ``wait``.

`restore_raw` reads a reference-format M2SNet state dict for the graft:
a raw ``state_dict`` file (the reference's ``M2SNet_eval.py:118-119``
save) or a directory holding one.  It cannot read JAX's Orbax directories.
"""

from __future__ import annotations

import os
import threading
from pathlib import Path
from typing import Any

import torch

CHECKPOINT_SUFFIXES = (".pt", ".pth", ".tar", ".ckpt")


def restore_raw(path: str | os.PathLike) -> dict[str, torch.Tensor]:
    """The state dict in a file, or in the one checkpoint file of a
    directory (else ValueError)."""
    path = Path(path)
    if path.is_dir():
        files = sorted(p for p in path.iterdir() if p.suffix in CHECKPOINT_SUFFIXES)
        if len(files) != 1:
            raise ValueError(f"{path} must hold exactly one state-dict file "
                             f"({'/'.join(CHECKPOINT_SUFFIXES)}), found {[p.name for p in files]}")
        path = files[0]
    return torch.load(path, map_location="cpu", weights_only=True)


class CheckpointManager:
    """``<directory>/<step>.tar`` files, the newest ``max_to_keep`` kept."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int | None = 5):
        self.directory = Path(directory).resolve()
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self._writer: threading.Thread | None = None
        self._error: Exception | None = None

    def _path(self, step: int) -> Path:
        return self.directory / f"{step}.tar"

    def all_steps(self) -> list[int]:
        return sorted(int(p.stem) for p in self.directory.glob("*.tar") if p.stem.isdigit())

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _write(self, step: int, state: Any) -> None:
        try:
            tmp = self.directory / f".{step}.tar.{os.getpid()}.tmp"
            torch.save(state, tmp)
            os.replace(tmp, self._path(step))
            if self.max_to_keep is not None:
                for old in self.all_steps()[:-self.max_to_keep]:
                    self._path(old).unlink(missing_ok=True)
        except Exception as e:  # raised again by the next wait()
            self._error = e

    def wait(self) -> None:
        """Block until the last save is on disk; raise its error if it failed."""
        if self._writer is not None:
            self._writer.join()
            self._writer = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, step: int, state: Any, *, wait: bool = False) -> None:
        """Write ``state`` (host tensors, which the caller no longer
        changes) as ``step``: on a thread, or before returning with
        ``wait``.  One write at a time: a save first waits for the last."""
        self.wait()
        self._writer = threading.Thread(target=self._write, args=(step, state), daemon=False)
        self._writer.start()
        if wait:
            self.wait()

    def restore(self, step: int | None = None) -> dict:
        """The dict saved as ``step`` (the latest by default), on the host."""
        self.wait()
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.directory}")
        return torch.load(self._path(step), map_location="cpu", weights_only=True)

    def close(self) -> None:
        self.wait()
