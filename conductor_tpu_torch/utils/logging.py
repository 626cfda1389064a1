"""Training observability: console + JSONL metric logging (TensorBoard if present).

The port's copy of `MetricLogger` and `format_time`
(`conductor_tpu/utils/logging.py:25-72`): every scalar goes to an
append-only ``metrics.jsonl`` (one line a step, crash safe) and a console
line of the means every ``console_every`` steps; TensorBoard event files
too when `torch.utils.tensorboard` imports.  A step's metrics arrive as
0-d tensors on the device and are read to the host in one copy.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Mapping

import torch


def format_time(seconds: float) -> str:
    """hh:mm:ss (the reference's `as_minutes`/`time_since`, `utils.py:19-33`)."""
    s = int(seconds)
    return f"{s // 3600:02d}:{(s % 3600) // 60:02d}:{s % 60:02d}"


def host_scalars(metrics: Mapping[str, torch.Tensor | float]) -> dict[str, float]:
    """The metrics as floats, read from the device in one copy."""
    if not metrics:
        return {}
    device = next((v.device for v in metrics.values() if torch.is_tensor(v)), "cpu")
    stacked = torch.stack([torch.as_tensor(v).to(device, torch.float32).reshape(())
                           for v in metrics.values()])
    return dict(zip(metrics, stacked.tolist()))


class MetricLogger:
    def __init__(self, log_dir: str, *, console_every: int = 5):
        self.log_dir = log_dir
        self.console_every = console_every
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a", buffering=1)
        self._start = time.time()
        self._tb = self._try_tensorboard(log_dir)
        self._accum: dict[str, float] = {}
        self._accum_n = 0

    @staticmethod
    def _try_tensorboard(log_dir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:  # tensorboard is not installed
            return None
        return SummaryWriter(log_dir=log_dir)

    def log(self, step: int, metrics: Mapping[str, torch.Tensor | float], *,
            epoch: int | None = None) -> dict[str, float]:
        """Append one record; returns the metrics as floats."""
        values = host_scalars(metrics)
        record = {"step": int(step), "t": round(time.time() - self._start, 3)}
        if epoch is not None:
            record["epoch"] = int(epoch)
        for k, v in values.items():
            record[k] = v
            self._accum[k] = self._accum.get(k, 0.0) + v
            if self._tb is not None:
                self._tb.add_scalar(f"train/{k}", v, step)
        self._jsonl.write(json.dumps(record) + "\n")
        self._accum_n += 1

        if step % self.console_every == 0 and self._accum_n:
            means = {k: v / self._accum_n for k, v in self._accum.items()}
            parts = " | ".join(f"{k}: {v:.5f}" for k, v in means.items())
            ep = f"epoch: {epoch} | " if epoch is not None else ""
            print(f"[{format_time(time.time() - self._start)}] {ep}step: {step} | {parts}",
                  flush=True)
            self._accum, self._accum_n = {}, 0
        return values

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
