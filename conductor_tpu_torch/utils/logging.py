"""Training observability: console + JSONL metric logging (TensorBoard if present).

The port's copy of `MetricLogger` and `format_time`
(`conductor_tpu/utils/logging.py:25-160`): every scalar goes to an
append-only ``metrics.jsonl`` (one line a step, crash safe) and a console
line of the means every ``console_every`` steps; TensorBoard event files
too when `torch.utils.tensorboard` imports.  A step's metrics arrive as
0-d tensors on the device and are read to the host in one copy.

The images, the reference's training-health dumps (feature-map heatmaps,
real-against-generated motion traces; `M2SNet_eval.py:97-116`,
`utils/train_utils.py:104-150`), land under ``<log_dir>/images/`` as PNG
files where matplotlib imports, else as the image arrays in ``.npy``
files; without matplotlib the heatmaps are grey and the traces are drawn
with numpy.  No image dump raises for want of matplotlib.
"""

from __future__ import annotations

import json
import os
import time
from collections.abc import Mapping

import numpy as np
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

    def log_image(self, step: int, tag: str, img) -> None:
        """img: (H, W, 3) uint8, or float in [0, 1]."""
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(tag, img, step, dataformats="HWC")
        img_dir = os.path.join(self.log_dir, "images")
        os.makedirs(img_dir, exist_ok=True)
        path = os.path.join(img_dir, f"{tag.replace('/', '_').replace(' ', '_')}_{step:08d}")
        try:
            import matplotlib

            matplotlib.use("Agg", force=False)
            import matplotlib.pyplot as plt
        except ImportError:
            np.save(path + ".npy", img)
        else:
            plt.imsave(path + ".png", img)

    def log_feature_maps(self, step: int, music_feats, motion_feats) -> None:
        """The reference's per-eval encoder feature-map dump
        (`M2SNet_eval.py:110-116`): every music map; the motion maps at the
        first, the last and the even indices."""
        for i, f in enumerate(music_feats):
            self.log_image(step, f"M2SNet Music feature/layer {i}", feature_map_image(f))
        n = len(motion_feats)
        for i, f in enumerate(motion_feats):
            if i == 0 or i == n - 1 or i % 2 == 0:
                self.log_image(step, f"M2SNet Motion feature/layer {i}", feature_map_image(f))

    def log_motion_plot(self, step: int, fake_motion, real_motion,
                        tag: str = "motion/traces") -> None:
        self.log_image(step, tag, motion_plot_image(fake_motion, real_motion))

    def close(self):
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()


def host_array(x) -> np.ndarray:
    """A float32 host array of a tensor (on any device) or an array."""
    return x.detach().float().cpu().numpy() if torch.is_tensor(x) else np.asarray(x, np.float32)


def feature_map_image(feat) -> np.ndarray:
    """(B, T, C) or (T, C) feature map -> (C, T, 3) uint8 heatmap, plasma
    with matplotlib and grey without (the reference's
    `plot_hidden_feature`, `train_utils.py:138-150`); B > 1 shows the
    first."""
    f = host_array(feat)
    if f.ndim == 3:
        f = f[0]
    f = f.T  # (C, T), the reference's imshow orientation
    lo, hi = float(f.min()), float(f.max())
    f = (f - lo) / max(hi - lo, 1e-12)
    try:
        from matplotlib import cm

        return (cm.plasma(f)[..., :3] * 255).astype(np.uint8)
    except ImportError:
        g = (f * 255).astype(np.uint8)
        return np.stack([g, g, g], axis=-1)


TRACE_ROWS = 32  # pixel rows a channel's [0, 1] trace takes without matplotlib


def motion_plot_image(fake_motion, real_motion) -> np.ndarray:
    """Real-against-generated keypoint coordinate traces
    (`train_utils.py:104-135`), 13 joints x (x, y), real grey and fake red,
    as an RGB array: a matplotlib figure where it imports, else one band of
    `TRACE_ROWS` rows a channel, each frame's value marked in its column."""
    fake, real = host_array(fake_motion), host_array(real_motion)
    if fake.ndim == 4:
        fake = fake[0]
    if real.ndim == 4:
        real = real[0]
    try:
        import matplotlib

        matplotlib.use("Agg", force=False)
        import matplotlib.pyplot as plt
    except ImportError:
        t, j, c = fake.shape
        img = np.full((j * c * TRACE_ROWS, t, 3), 255, np.uint8)
        cols = np.arange(t)
        for m, colour in ((real, (128, 128, 128)), (fake, (255, 0, 0))):
            rows = np.rint((1.0 - np.clip(m.reshape(t, j * c), 0.0, 1.0)) * (TRACE_ROWS - 1))
            for ch in range(j * c):
                img[ch * TRACE_ROWS + rows[:, ch].astype(int), cols] = colour
        return img

    n_joints = fake.shape[1]
    fig, axes = plt.subplots(n_joints, 2, figsize=(18, 6))
    for j in range(n_joints):
        for xy in range(2):
            ax = axes[j][xy]
            ax.plot(real[:, j, xy], linewidth=0.5, color="gray")
            ax.plot(fake[:, j, xy], linewidth=0.5, color="r")
            ax.set_ylim(0, 1)
            ax.set_xticks([])
            ax.set_yticks([])
    fig.subplots_adjust(wspace=0, hspace=0, left=0.05, right=0.95, top=0.95, bottom=0.05)
    fig.canvas.draw()
    img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
    plt.close(fig)
    return img
