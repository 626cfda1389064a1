"""Stage-1 evaluation harnesses, the port of `conductor_tpu/eval/stage1.py`
(reference `M2SNet_eval.py:18-121`, `M2SGAN_eval.py:29-456`).

`M2SNetEvaluator` sweeps sync accuracy and the mean sync / non-sync
probabilities at the three pair difficulties over a list of batches;
`M2SGANEvaluator` runs the GAN metric suite: realism (per-frame SD,
Wasserstein), consistency (MSE, MPE, RDE, SCE), FGD on frozen ST-GCN
latents, Diversity and Beat Consistency.  The metric math is `eval.metrics`
on float32 host arrays.

JAX draws batch i's random numbers from ``PRNGKey((seed, i).__hash__() &
0x7FFFFFFF)``; its key streams cannot be replayed in torch, so the port
seeds a CPU `torch.Generator` with that integer (`batch_seed`), the same
for every strategy.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable

import numpy as np
import torch

from ..data.pairs import STRATEGIES
from ..utils.logging import host_array
from .metrics import (
    beat_consistency,
    diversity_score,
    frechet_distance,
    mean_perceptual_error,
    motion_mse,
    per_frame_std,
    rhythm_density_error,
    strength_contour_error,
    wasserstein_1d,
)


def batch_seed(seed: int, i: int) -> int:
    """The integer JAX seeds batch ``i``'s key with."""
    return (seed, i).__hash__() & 0x7FFFFFFF


def batch_generator(seed: int, i: int) -> torch.Generator:
    return torch.Generator().manual_seed(batch_seed(seed, i))


class M2SNetEvaluator:
    """Accuracy at easy / hard / super_hard over a test split
    (`M2SNet_eval.py:34-121`), through ``trainer.evaluate``
    (`train.m2snet_trainer.M2SNetTrainer`)."""

    def __init__(self, trainer, strategies: tuple[str, ...] = STRATEGIES):
        self.trainer = trainer
        self.strategies = strategies

    def evaluate(self, batches: Iterable[tuple], seed: int = 0) -> dict[str, dict[str, float]]:
        """{strategy: {metric: mean over the batches}} over (music, motion)
        batches, which are read once and reused for every strategy."""
        batches = list(batches)
        results: dict[str, dict[str, list[float]]] = {s: {} for s in self.strategies}
        for s in self.strategies:
            for i, (music, motion) in enumerate(batches):
                metrics = self.trainer.evaluate(music, motion, s,
                                                generator=batch_generator(seed, i))
                for k, v in metrics.items():
                    results[s].setdefault(k, []).append(v)
        return {s: {k: float(np.mean(v)) for k, v in ms.items()} for s, ms in results.items()}


class M2SGANEvaluator:
    """The stage-1 GAN metric suite (`M2SGAN_eval.py:62-456`).

    - ``generate_fn(mel, generator) -> motion (B, T30, 13, 2)``;
    - ``latents_fn(motion) -> (B, T30, 64)``, the frozen ST-GCN's latents
      for FGD / Diversity / MPE (`M2SGAN_eval.py:195-280`);
    - beat tracking on the raw mel for BC (`M2SGAN_eval.py:310-394`).
    """

    def __init__(self, generate_fn: Callable, latents_fn: Callable | None = None,
                 mel_hz: int = 90, motion_hz: int = 30):
        self.generate_fn = generate_fn
        self.latents_fn = latents_fn
        self.mel_hz = mel_hz
        self.motion_hz = motion_hz

    def evaluate(self, batches: Iterable[tuple], seed: int = 0,
                 with_beat: bool = True) -> dict[str, float]:
        sd_real, sd_fake, wdist = [], [], []
        mse, mpe, rde, sce = [], [], [], []
        real_lat, fake_lat, fake_clip_lat = [], [], []
        beat_scores = []
        for i, (mel, real) in enumerate(batches):
            mel, real = host_array(mel), host_array(real)
            # the metric math runs in float32 whatever the generator's dtype
            fake = host_array(self.generate_fn(mel, batch_generator(seed, i)))
            if fake.ndim == 3:
                fake = fake.reshape(real.shape)

            # realism (`M2SGAN_eval.py:62-120`)
            sd_real.append(per_frame_std(real))
            sd_fake.append(per_frame_std(fake))
            wdist.append(wasserstein_1d(real, fake))

            # consistency (`M2SGAN_eval.py:121-194`)
            mse.append(motion_mse(real, fake))
            rde.append(rhythm_density_error(real, fake))
            sce.append(strength_contour_error(real, fake))

            if self.latents_fn is not None:
                rl = host_array(self.latents_fn(real))
                fl = host_array(self.latents_fn(fake))
                mpe.append(mean_perceptual_error(rl, fl))
                real_lat += list(rl.reshape(-1, rl.shape[-1]))
                fake_lat += list(fl.reshape(-1, fl.shape[-1]))
                # whole clips' latent sequences for Diversity: the reference
                # shuffles clips, not frames (`M2SGAN_eval.py:292-308`)
                fake_clip_lat += [fl[b] for b in range(fl.shape[0])]

            if with_beat:
                for b in range(mel.shape[0]):
                    beat_scores.append(beat_consistency(fake[b], mel[b]))

        out = {
            "SD_real": float(np.mean(sd_real)),
            "SD_fake": float(np.mean(sd_fake)),
            "SDP": float(np.mean(sd_fake) / max(np.mean(sd_real), 1e-12) * 100),
            "wasserstein": float(np.mean(wdist)),
            "MSE": float(np.mean(mse)),
            "RDE": float(np.mean(rde)),
            "SCE": float(np.mean(sce)),
        }
        if mpe:
            out["MPE"] = float(np.mean(mpe))
            out["FGD"] = frechet_distance(np.stack(real_lat), np.stack(fake_lat))
            out["Diversity"] = diversity_score(fake_clip_lat)
        if beat_scores:
            out["BC"] = float(np.mean(beat_scores))
        return out
