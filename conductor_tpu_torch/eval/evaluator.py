"""The stage-2 evaluator: FGD / Diversity / Beat Consistency / MSE / SE /
MPE / SDP of a trained denoiser on a test split.

Port of `conductor_tpu/eval/evaluator.py:25-167` (the reference's
`Diffusion_Stage/tools/eval_new_metrics.py:94-390`): the split's clips are
generated in waves of ``batch_size`` through `DDPMTrainer.generate` (on
the trainer's device and layer path: on the card's fused ladder, K4 then
K2 -> K1 -> K3 a step), the frozen ST-GCN's 64-d latents of the real and
generated motion are taken, and beat consistency is tracked on the host;
the metrics are `eval.metrics` on float32 host arrays.

The latents always run in float32, whatever the trainer's compute dtype,
on a float32 copy of the trainer's frozen ST-GCN (`conductor_tpu/eval/
evaluator.py:70-83`): bf16 latents would make the numpy reductions
downstream accumulate in bf16, where FGD and Diversity collapse.  JAX runs
the flax module there, not its ST-GCN kernel, so the port runs its plain
module, not K7.

JAX draws wave ``i0``'s x_T from ``fold_in(rng, i0)``; its key streams
cannot be replayed in torch, so the port seeds a `torch.Generator` for each
wave from ``(seed, i0)`` (`eval.stage1.batch_seed`), or takes each wave's
x_T from ``wave_noise``.

With a ``mesh`` of several ranks (JAX's ``mesh``, `conductor_tpu/eval/
evaluator.py:44-56, 88-101`) a wave holds ``batch_size`` clips, 8 a rank
by default, rounded up to a multiple of the ranks; each wave's x_T is drawn
for the whole wave as one process draws it, the wave (mel and x_T) is
padded by `pad_to_multiple`, each rank generates its rows, and the motion
is gathered on rank 0, which takes the latents, beats and metrics; the
other ranks return None.  For the same global waves and x_T the ranks
generate what one process generates.
"""

from __future__ import annotations

import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np
import torch

from ..data.dataset import ConductorMotionDataset
from ..models.precision import full_float32
from ..models.stgcn import MotionEncoderSTGCN
from ..parallel.mesh import Mesh, pad_to_multiple
from . import metrics as M
from .stage1 import batch_generator


@dataclass
class EvalResult:
    fgd: float
    diversity: float
    feat_dist: float
    mse: float
    sync_error: float
    mpe: float
    sdp: float
    beat_consistency_real: float
    beat_consistency_generated: float

    def as_dict(self) -> dict:
        return self.__dict__.copy()


class DiffusionEvaluator:
    """Generate on a split and score against the ground truth.

    ``trainer`` is a `DDPMTrainer` holding the weights to score (its
    denoiser, and the frozen ST-GCN the latents come from); ``batch_size``
    clips a wave, 8 by default (JAX's single-device default), 8 a rank on
    a ``mesh`` of several ranks.  After `evaluate`, ``seconds`` holds its
    wall seconds by part: ``generate`` (the waves' `generate` calls, up to
    the host copy of their motion, gathered on rank 0 on a mesh),
    ``latents`` and ``beats``; ``generated`` the generated motion (on rank
    0)."""

    def __init__(self, trainer, batch_size: int | None = None, mesh: Mesh | None = None):
        self.trainer = trainer
        self.mesh = mesh if mesh is not None else Mesh()
        size = self.mesh.size
        if batch_size is None:
            batch_size = 8 * size  # 8 clips a device (JAX's measured serving sweet spot)
        self.batch_size = -(-batch_size // size) * size  # every wave fills the ranks evenly
        self._feat_model = MotionEncoderSTGCN(n_joints=trainer.cfg.dataset.n_joints,
                                              dtype=torch.float32).to(trainer.device).freeze()
        self.seconds: dict[str, float] = {}
        self.generated: np.ndarray | None = None

    @torch.no_grad()
    @full_float32()
    def _latents(self, motion: np.ndarray) -> np.ndarray:
        """The frozen ST-GCN's 64-d latents (B, T30, 64), in float32
        (`eval_new_metrics.py:143-150`)."""
        x = torch.from_numpy(np.ascontiguousarray(motion, np.float32)).to(self.trainer.device)
        return self._feat_model(x).float().cpu().numpy()

    def evaluate(
        self,
        dataset_root: str,
        *,
        split: str = "test",
        num_steps: int | None = None,
        max_clips: int | None = None,
        seed: int = 0,
        compute_beats: bool = True,
        wave_noise: Callable[[int, tuple[int, ...]], torch.Tensor] | None = None,
    ) -> EvalResult | None:
        """Score the first ``max_clips`` windows (all by default) of
        ``split``'s clip-length windows, read in order.  Wave ``i0`` (its
        first window's index) generates with ``num_steps`` DDIM steps from
        ``wave_noise(i0, shape)`` if given, else from a generator seeded
        with ``(seed, i0)``."""
        self._feat_model.load_state_dict(self.trainer.feat_model.state_dict())
        spec = self.trainer.cfg.dataset
        ds = ConductorMotionDataset(dataset_root, split, sample_length=spec.clip_seconds,
                                    mode="sequential", spec=spec)
        n = len(ds) if max_clips is None else min(max_clips, len(ds))

        real_list, gen_list, real_lat, gen_lat, bc_real, bc_gen = [], [], [], [], [], []
        seconds = {"generate": 0.0, "latents": 0.0, "beats": 0.0}
        mesh = self.mesh
        for i0 in range(0, n, self.batch_size):
            idxs = range(i0, min(i0 + self.batch_size, n))
            mel = np.stack([ds[i][0] for i in idxs])
            motion = np.stack([ds[i][1] for i in idxs])
            t0 = time.perf_counter()
            shape = (len(idxs), motion.shape[1], spec.n_joints * spec.joint_dim)
            if mesh.distributed:
                gen = self._generate_rows(mel, shape, num_steps, i0, seed, wave_noise)
            elif wave_noise is not None:
                gen = self.trainer.generate(mel, num_steps=num_steps, noise=wave_noise(i0, shape))
            else:
                gen = self.trainer.generate(mel, num_steps=num_steps,
                                            generator=batch_generator(seed, i0))
            gen = gen.cpu().numpy()
            if not mesh.is_main():
                seconds["generate"] += time.perf_counter() - t0
                continue
            b, t = gen.shape[0], gen.shape[1]
            gen = gen.reshape(b, t, spec.n_joints, spec.joint_dim)
            t1 = time.perf_counter()
            real_list.append(motion)
            gen_list.append(gen)
            real_lat.append(self._latents(motion))
            gen_lat.append(self._latents(gen))
            t2 = time.perf_counter()
            if compute_beats:
                for k in range(b):
                    bc_real.append(M.beat_consistency(motion[k], mel[k]))
                    bc_gen.append(M.beat_consistency(gen[k], mel[k]))
            seconds["generate"] += t1 - t0
            seconds["latents"] += t2 - t1
            seconds["beats"] += time.perf_counter() - t2
        self.seconds = seconds
        if not mesh.is_main():
            return None

        real = np.concatenate(real_list)
        gen = np.concatenate(gen_list)
        self.generated = gen
        real_lat_flat = np.concatenate([x.reshape(-1, x.shape[-1]) for x in real_lat])
        gen_lat_flat = np.concatenate([x.reshape(-1, x.shape[-1]) for x in gen_lat])
        per_clip_gen_lat = [x.reshape(-1, x.shape[-1]) for g in gen_lat for x in g]
        return EvalResult(
            fgd=M.frechet_distance(gen_lat_flat, real_lat_flat),
            diversity=M.diversity_score(per_clip_gen_lat),
            feat_dist=M.feat_distance(real_lat_flat, gen_lat_flat),
            mse=M.motion_mse(real, gen),
            sync_error=M.sync_error(real_lat_flat, gen_lat_flat),
            mpe=M.mean_perceptual_error(real_lat_flat, gen_lat_flat),
            sdp=M.std_percentage(real, gen),
            beat_consistency_real=float(np.mean(bc_real)) if bc_real else float("nan"),
            beat_consistency_generated=float(np.mean(bc_gen)) if bc_gen else float("nan"),
        )

    def _generate_rows(self, mel: np.ndarray, shape, num_steps, i0: int, seed: int,
                       wave_noise) -> torch.Tensor:
        """One wave on the mesh: x_T for the whole wave (as one process
        draws it), mel and x_T padded to a multiple of the ranks, this
        rank's rows generated, every rank's rows gathered and the padding
        dropped."""
        mesh = self.mesh
        if wave_noise is not None:
            noise = wave_noise(i0, shape)
        else:
            gen = batch_generator(seed, i0)
            noise = torch.randn(shape, generator=gen, device=gen.device)
        mel_p, n = pad_to_multiple(mel, mesh.size)
        noise_p, _ = pad_to_multiple(torch.as_tensor(noise, dtype=torch.float32), mesh.size)
        rows = self.trainer.generate(mesh.local(mel_p), num_steps=num_steps,
                                     noise=mesh.local(noise_p).contiguous())
        return mesh.gather_rows(rows)[:n]
