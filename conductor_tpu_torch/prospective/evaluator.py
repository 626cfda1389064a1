"""Prospective Cup competition evaluator (reference `ProspectiveCup/eval.py:34-89`),
the port's copy of `conductor_tpu/prospective/evaluator.py:31-55`.

Scores any `generate_fn(mel) -> motion` over a test iterator on the four
competition metrics — MSE, RDE, SCE, SDP — where SDP is the generated
per-frame standard deviation as a percentage of the real one
(`eval.py:75-80`: `mean(SD_fake)/mean(SD_real)*100`; the plain zero-output
stub scores 0 %, `ProspectiveCup/README.md:91-93`).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterable

import numpy as np

from ..eval.metrics import rhythm_density_error, strength_contour_error


@dataclass
class ProspectiveResult:
    mse: float
    rde: float
    sce: float
    sdp: float

    def as_dict(self) -> dict:
        return {"MSE": self.mse, "RDE": self.rde, "SCE": self.sce, "SDP": self.sdp}


class ProspectiveEvaluator:
    """Batched equivalent of the reference's per-sample loop (`eval.py:44-80`)."""

    def __init__(self, generate_fn: Callable[[np.ndarray], np.ndarray]):
        self.generate_fn = generate_fn

    def evaluate(self, batches: Iterable[tuple[np.ndarray, np.ndarray]]) -> ProspectiveResult:
        """``batches`` yields (mel (B, 90s, 128), motion (B, 30s, 13, 2))."""
        sd_fake, sd_real, mse_all, rde_all, sce_all = [], [], [], [], []
        for mel, real in batches:
            real = np.asarray(real)
            fake = np.asarray(self.generate_fn(np.asarray(mel)))
            if fake.ndim == 3:  # (B, T, 26) -> (B, T, 13, 2)
                fake = fake.reshape(*fake.shape[:2], real.shape[2], real.shape[3])
            sd_fake.append(float(fake.std(axis=1).mean()))
            sd_real.append(float(real.std(axis=1).mean()))
            mse_all.append(float(np.mean((fake - real) ** 2)))
            rde_all.append(rhythm_density_error(real, fake))
            sce_all.append(strength_contour_error(real, fake))
        return ProspectiveResult(
            mse=float(np.mean(mse_all)),
            rde=float(np.mean(rde_all)),
            sce=float(np.mean(sce_all)),
            sdp=float(np.mean(sd_fake) / max(np.mean(sd_real), 1e-12) * 100.0),
        )
