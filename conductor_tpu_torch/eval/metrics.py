"""Evaluation metrics: FGD, Diversity, Beat Consistency, SE, RDE, SCE, SDP.

The port's copy of `conductor_tpu/eval/metrics.py` (numpy and scipy only,
no change to the math), rebuilds of the reference's metric stack:
- FGD / feat-dist / Diversity: `Diffusion_Stage/tools/eval_new_metrics.py:
  159-251` (Fréchet on 64-d frozen-ST-GCN latents, Sutherland-stable sqrtm);
- Beat Consistency: `eval_new_metrics.py:253-340` — DanceFormer BC: for each
  music beat, distance to the nearest motion-velocity local minimum, scored
  exp(-d²/2σ²), σ=3; music beats tracked on the 90 Hz mel (`eval.beat`);
- Sync error (MPE) + MSE: `tools/eval_old_metrics.py:90-109` — MSE in the
  stage-1 motion-latent space;
- SCE (strength contour error): `Contrastive_Stage/utils/loss.py:128-151` —
  log-scaled MSE of 2-s avg-pooled |mean velocity| envelopes;
- RDE (rhythm density error): `utils/loss.py:154-190` — log-scaled MSE of
  Welch PSDs above bin 6 (≈0.7 Hz), averaged over 26 channels;
- SDP (standard deviation percentage): `Contrastive_Stage/ProspectiveCup/
  eval.py` — generated per-frame keypoint std as % of real std;
- per-frame std / Wasserstein realism metrics: `M2SGAN_eval.py:62-120`;
- the T2M protocol's retrieval metrics (`Diffusion_Stage/utils/metrics.py`).

Every function takes and returns host numpy arrays or floats.
"""

from __future__ import annotations

import numpy as np
import scipy.signal as scisignal
from scipy import linalg


# --------------------------------------------------------------------- FGD

def frechet_distance(
    samples_a: np.ndarray, samples_b: np.ndarray, eps: float = 1e-6
) -> float:
    """Fréchet distance between Gaussians fit to two (N, D) latent sets
    (`eval_new_metrics.py:169-251`)."""
    mu1, mu2 = samples_a.mean(axis=0), samples_b.mean(axis=0)
    sigma1 = np.cov(samples_a, rowvar=False)
    sigma2 = np.cov(samples_b, rowvar=False)

    diff = mu1 - mu2
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )


def diversity_score(
    latents: list[np.ndarray], max_samples: int = 500, seed: int = 0
) -> float:
    """Mean L1 between generated latents and a shuffled copy
    (`eval_new_metrics.py:159-166`)."""
    feat1 = np.vstack(latents[:max_samples])
    rng = np.random.default_rng(seed)
    idx = rng.permutation(len(latents))[:max_samples]
    feat2 = np.vstack([latents[i] for i in idx])
    return float(np.mean(np.sum(np.abs(feat1 - feat2), axis=-1)))


def feat_distance(real_feats: np.ndarray, gen_feats: np.ndarray) -> float:
    """Per-frame L1 distance in latent space (`eval_new_metrics.py:189-194`)."""
    return float(np.mean(np.sum(np.abs(real_feats - gen_feats), axis=-1)))


# --------------------------------------------------- beat consistency (BC)

def normalize_01(arr: np.ndarray) -> np.ndarray:
    lo, hi = np.min(arr), np.max(arr)
    return (arr - lo) / max(hi - lo, 1e-12)


def motion_peak_onehot(motion: np.ndarray, order: int = 10) -> np.ndarray:
    """Motion beats = local minima of the velocity envelope
    (`eval_new_metrics.py:285-309`).  motion: (T, J, 2) -> (T,) bool."""
    velocity = np.zeros_like(motion, dtype=np.float32)
    velocity[1:] = motion[1:] - motion[:-1]
    envelope = np.linalg.norm(velocity, axis=2).sum(axis=1)
    peak_idxs = scisignal.argrelextrema(envelope, np.less, axis=0, order=order)
    onehot = np.zeros_like(envelope, dtype=bool)
    onehot[peak_idxs] = True
    return onehot


def music_beat_onehot(
    mel: np.ndarray, fps: int = 90, hop_length: int = 512, tightness: float = 100
) -> np.ndarray:
    """Music beats on the (T90, 128) mel (`eval_new_metrics.py:319-340`):
    librosa when available, else the bundled Ellis-DP tracker (`beat.py`)."""
    from .beat import music_beats_from_mel

    return music_beats_from_mel(mel, fps=fps, hop_length=hop_length, tightness=tightness)


def alignment_score(
    music_beats: np.ndarray, motion_beats: np.ndarray, sigma: float = 3.0
) -> float:
    """DanceFormer beat consistency (`eval_new_metrics.py:253-275`): for each
    music beat, exp(-d²/2σ²) to the nearest motion beat."""
    if motion_beats.sum() == 0:
        return 0.0
    music_idx = np.where(music_beats)[0]
    motion_idx = np.where(motion_beats)[0]
    if len(music_idx) == 0:
        return 0.0
    scores = [
        float(np.exp(-np.min(np.abs(m - motion_idx).astype(np.float32)) ** 2
                     / 2 / sigma**2))
        for m in music_idx
    ]
    return float(sum(scores) / len(scores))


def beat_consistency(
    motion: np.ndarray, mel: np.ndarray, sigma: float = 3.0,
    beat_scale: float = 1.0,
) -> float:
    """End-to-end BC for one clip.

    Note the reference compares 90 Hz music-beat indices against 30 Hz
    motion-beat indices without rescaling (`eval_new_metrics.py:311-317`,
    motion (1800,) vs mel (5400,) index spaces); replicated by default
    (beat_scale=1.0).  Pass beat_scale=1/3 to land music beats in motion-frame
    space (the fixed variant)."""
    motion_beats = motion_peak_onehot(motion)
    music_beats = music_beat_onehot(mel)
    if beat_scale != 1.0:
        idx = np.where(music_beats)[0]
        scaled = np.zeros(motion.shape[0], dtype=np.float32)
        scaled_idx = np.clip(
            (idx * beat_scale).astype(int), 0, motion.shape[0] - 1
        )
        scaled[scaled_idx] = 1.0
        music_beats = scaled
    return alignment_score(music_beats, motion_beats, sigma)


# ----------------------------------------------------------- SCE / RDE / SDP

def strength_contour_error(real: np.ndarray, fake: np.ndarray) -> float:
    """SCE (`utils/loss.py:128-151`): |mean velocity| envelopes avg-pooled
    (k=60, s=30) then log-scaled MSE.  real/fake: (B, T, J, 2)."""
    def envelope(m):
        v = np.zeros_like(m)
        v[:, 1:] = m[:, :-1] - m[:, 1:]
        return np.abs(v.reshape(v.shape[0], v.shape[1], -1).mean(axis=2))

    def avgpool(x, k=60, s=30):
        n = (x.shape[1] - k) // s + 1
        return np.stack([x[:, i * s : i * s + k].mean(axis=1) for i in range(n)], axis=1)

    rv, fv = avgpool(envelope(real)), avgpool(envelope(fake))
    mse = np.mean((fv - rv) ** 2)
    return float(np.log(mse * 1e7 + 1))


def rhythm_density_error(real: np.ndarray, fake: np.ndarray) -> float:
    """RDE (`utils/loss.py:154-190`): Welch PSD per (joint, channel) at 30 Hz,
    averaged over the 26 channels, MSE above bin 6 (~0.7 Hz), log-scaled.
    real/fake: (B, T, J, 2)."""
    B, T, J, C = real.shape
    rde = np.zeros(B)
    for n in range(B):
        psd_real = psd_fake = None
        for j in range(J):
            for c in range(C):
                _, pr = scisignal.welch(real[n, :, j, c], 30)
                _, pf = scisignal.welch(fake[n, :, j, c], 30)
                psd_real = pr if psd_real is None else psd_real + pr
                psd_fake = pf if psd_fake is None else psd_fake + pf
        psd_real, psd_fake = psd_real / 26, psd_fake / 26
        rde[n] = np.mean((psd_real[6:26] - psd_fake[6:26]) ** 2)
    return float(np.log(rde.mean() * 1e7 + 1))


def std_percentage(real: np.ndarray, fake: np.ndarray) -> float:
    """SDP (ProspectiveCup `eval.py`): generated per-frame keypoint std as a
    percentage of the real std — 0 for constant outputs."""
    real_sd = real.std(axis=1).mean()
    fake_sd = fake.std(axis=1).mean()
    return float(fake_sd / max(real_sd, 1e-12) * 100.0)


# ------------------------------------------------------------ MSE / SE (MPE)

def motion_mse(real: np.ndarray, fake: np.ndarray) -> float:
    """Plain pose MSE (`eval_old_metrics.py`, `eval_new.py:37-134`)."""
    return float(np.mean((real - fake) ** 2))


def sync_error(real_latents: np.ndarray, fake_latents: np.ndarray) -> float:
    """SE: MSE in the frozen stage-1 motion-latent space
    (`eval_old_metrics.py:90-109`)."""
    return float(np.mean((real_latents - fake_latents) ** 2))


def mean_perceptual_error(real_latents: np.ndarray, fake_latents: np.ndarray) -> float:
    """MPE: L1 in the frozen stage-1 motion-latent space (the SyncLoss used as
    a metric, `M2SGAN_eval.py` / `utils/loss.py:30-46`)."""
    return float(np.mean(np.abs(real_latents - fake_latents)))


# ----------------------------------------------- realism (M2SGAN evaluator)

def per_frame_std(motion: np.ndarray) -> float:
    """Mean per-frame keypoint standard deviation over time
    (`M2SGAN_eval.py` realism)."""
    return float(motion.std(axis=1).mean())


def wasserstein_1d(real: np.ndarray, fake: np.ndarray) -> float:
    """1-D Wasserstein distance between flattened keypoint distributions
    (`M2SGAN_eval.py` realism)."""
    from scipy.stats import wasserstein_distance

    return float(wasserstein_distance(real.ravel(), fake.ravel()))


# ----------------------------------------- retrieval metrics (T2M protocol)
# The MotionDiffuse evaluation protocol the reference inherits for its t2m/kit
# datasets (`Diffusion_Stage/utils/metrics.py:5-145`, consumed by
# `tools/evaluation.py:33-238`).  Deterministic variants: sampling takes an
# explicit seed instead of mutating global numpy RNG state.

def euclidean_distance_matrix(matrix1: np.ndarray, matrix2: np.ndarray) -> np.ndarray:
    """Pairwise L2 distances, (N1, D) x (N2, D) -> (N1, N2)
    (`utils/metrics.py:5-19`)."""
    d1 = -2 * matrix1 @ matrix2.T
    d2 = np.sum(matrix1**2, axis=1, keepdims=True)
    d3 = np.sum(matrix2**2, axis=1)
    return np.sqrt(np.maximum(d1 + d2 + d3, 0.0))


def calculate_top_k(argsorted: np.ndarray, top_k: int) -> np.ndarray:
    """(N, N) argsorted index matrix -> (N, top_k) cumulative hit matrix:
    column k is True if the ground-truth index appears in the first k+1
    retrievals (`utils/metrics.py:21-33`)."""
    size = argsorted.shape[0]
    gt = np.arange(size)[:, None]
    hits = argsorted[:, :top_k] == gt
    return np.cumsum(hits, axis=1).astype(bool)


def calculate_r_precision(
    embedding1: np.ndarray, embedding2: np.ndarray, top_k: int, sum_all: bool = False
) -> np.ndarray:
    """R-precision: retrieve embedding2 rows by distance from embedding1 rows;
    the matched (diagonal) row should rank in the top k
    (`utils/metrics.py:36-43`)."""
    dist = euclidean_distance_matrix(embedding1, embedding2)
    top_k_mat = calculate_top_k(np.argsort(dist, axis=1), top_k)
    return top_k_mat.sum(axis=0) if sum_all else top_k_mat


def calculate_matching_score(
    embedding1: np.ndarray, embedding2: np.ndarray, sum_all: bool = False
) -> np.ndarray:
    """Row-wise L2 distance between co-embeddings (`utils/metrics.py:46-56`)."""
    dist = np.linalg.norm(embedding1 - embedding2, axis=1)
    return dist.sum(axis=0) if sum_all else dist


def calculate_activation_statistics(
    activations: np.ndarray,
) -> tuple[np.ndarray, np.ndarray]:
    """(N, D) latents -> (mean, covariance) for Fréchet metrics
    (`utils/metrics.py:59-69`)."""
    return np.mean(activations, axis=0), np.cov(activations, rowvar=False)


def calculate_diversity(
    activation: np.ndarray, diversity_times: int, seed: int = 0
) -> float:
    """Mean L2 between two random sample subsets (`utils/metrics.py:72-81`)."""
    assert activation.ndim == 2 and activation.shape[0] > diversity_times
    rng = np.random.default_rng(seed)
    first = rng.choice(activation.shape[0], diversity_times, replace=False)
    second = rng.choice(activation.shape[0], diversity_times, replace=False)
    return float(np.linalg.norm(activation[first] - activation[second], axis=1).mean())


def calculate_multimodality(
    activation: np.ndarray, multimodality_times: int, seed: int = 0
) -> float:
    """Mean L2 between repeated generations of the same condition:
    (N, R, D) latents, R generations per condition (`utils/metrics.py:84-92`)."""
    assert activation.ndim == 3 and activation.shape[1] > multimodality_times
    rng = np.random.default_rng(seed)
    first = rng.choice(activation.shape[1], multimodality_times, replace=False)
    second = rng.choice(activation.shape[1], multimodality_times, replace=False)
    return float(
        np.linalg.norm(activation[:, first] - activation[:, second], axis=2).mean()
    )


def calculate_frechet_distance(
    mu1: np.ndarray,
    sigma1: np.ndarray,
    mu2: np.ndarray,
    sigma2: np.ndarray,
    eps: float = 1e-6,
) -> float:
    """Fréchet distance from precomputed statistics (Sutherland-stable sqrtm,
    `utils/metrics.py:95-145`); `frechet_distance` above is the from-samples
    convenience wrapper."""
    diff = mu1 - mu2
    # no ``disp=False``: SciPy 1.18 removed the argument (the same square
    # root either way)
    covmean = linalg.sqrtm(sigma1.dot(sigma2))
    if not np.isfinite(covmean).all():
        offset = np.eye(sigma1.shape[0]) * eps
        covmean = linalg.sqrtm((sigma1 + offset).dot(sigma2 + offset))
    if np.iscomplexobj(covmean):
        if not np.allclose(np.diagonal(covmean).imag, 0, atol=1e-3):
            raise ValueError(
                f"Imaginary component {np.max(np.abs(covmean.imag))}"
            )
        covmean = covmean.real
    return float(
        diff.dot(diff) + np.trace(sigma1) + np.trace(sigma2) - 2 * np.trace(covmean)
    )
