"""Replicated evaluation protocol: R-precision / MatchingScore / FID /
Diversity / MultiModality with 95 % confidence intervals.

The port's copy of `conductor_tpu/eval/protocol.py:36-363` (numpy over
`eval.metrics`, the same seeded numpy draws, so on the same embeddings and
seed it gives JAX's numbers), the reference's MotionDiffuse protocol
(`Diffusion_Stage/tools/evaluation.py:33-238`, `datasets/evaluator.py:
16-130`): each metric is computed ``replication_times`` times over freshly
generated samples and reported as mean +- 95 % CI
(`evaluation.py:20-30` `get_metric_statistics`).

The reference's co-embedding is a pretrained text / motion BiGRU pair that
exists only for t2m / kit and raises for ConductorMotion100; here the
protocol is generic over a `CoEmbedding`, and `M2SNetCoEmbedding` takes
the frozen stage-1 M2SNet's mean-pooled 64-d music and motion latents
(`cli.evaluate_protocol` builds it from a stage-1 checkpoint).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Iterable, Protocol

import numpy as np

from .metrics import (
    calculate_activation_statistics,
    calculate_diversity,
    calculate_frechet_distance,
    calculate_multimodality,
    calculate_top_k,
    euclidean_distance_matrix,
)


def get_metric_statistics(values: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Mean and 95 % confidence interval over replications
    (`evaluation.py:20-30`)."""
    values = np.asarray(values)
    mean = values.mean(axis=0)
    conf = 1.96 * values.std(axis=0) / np.sqrt(values.shape[0])
    return mean, conf


class CoEmbedding(Protocol):
    def embed(self, cond, motion) -> tuple[np.ndarray, np.ndarray]:
        """-> (cond_emb (B, D), motion_emb (B, D))."""
        ...

    def embed_motion(self, motion) -> np.ndarray:
        """-> motion_emb (B, D)."""
        ...


class M2SNetCoEmbedding:
    """Mean-pooled frozen M2SNet latents as the co-embedding space.

    ``music_fn(mel (B, T90, 128)) -> (B, T30, 64)`` and
    ``motion_fn(motion (B, T30, 13, 2)) -> (B, T30, 64)`` are the frozen
    stage-1 encoders (`models.m2snet.M2SNet`'s ``music_encoder`` and
    ``motion_encoder`` in eval mode), returning host arrays or tensors.
    """

    def __init__(self, music_fn: Callable, motion_fn: Callable):
        self.music_fn = music_fn
        self.motion_fn = motion_fn

    def embed(self, cond, motion):
        return (
            np.asarray(self.music_fn(cond)).mean(axis=1),
            np.asarray(self.motion_fn(motion)).mean(axis=1),
        )

    def embed_motion(self, motion):
        return np.asarray(self.motion_fn(motion)).mean(axis=1)


@dataclass
class ProtocolConfig:
    """Protocol constants (`evaluation.py:241-247`)."""

    top_k: int = 3
    diversity_times: int = 300
    mm_num_times: int = 10
    replication_times: int = 1
    seed: int = 0


@dataclass
class ProtocolResult:
    """metric -> model -> list of per-replication values (scalars or arrays)."""

    metrics: dict = field(default_factory=dict)

    def add(self, metric: str, model: str, value) -> None:
        self.metrics.setdefault(metric, {}).setdefault(model, []).append(value)

    def summary(self) -> dict:
        out: dict = {}
        for metric, models in self.metrics.items():
            out[metric] = {}
            for model, values in models.items():
                mean, conf = get_metric_statistics(np.array(values))
                out[metric][model] = (mean, conf)
        return out

    def format_report(self) -> str:
        """Reference-style report (`evaluation.py:223-238`)."""
        lines = []
        for metric, models in self.summary().items():
            lines.append(f"========== {metric} Summary ==========")
            for model, (mean, conf) in models.items():
                if np.ndim(mean) == 0:
                    lines.append(
                        f"---> [{model}] Mean: {float(mean):.4f} "
                        f"CInterval: {float(conf):.4f}"
                    )
                else:
                    parts = [
                        "(top %d) Mean: %.4f CInt: %.4f;" % (i + 1, mean[i], conf[i])
                        for i in range(len(mean))
                    ]
                    lines.append(f"---> [{model}] " + " ".join(parts))
        return "\n".join(lines)


class EvaluationProtocol:
    """Runs the full replicated protocol.

    - ``batches_fn()`` (or ``batches_fn(rep)``) yields (cond, real_motion)
      pairs each replication.  A one-argument ``batches_fn`` receives the
      replication index and should reshuffle batch composition with it —
      the reference's loaders are epoch-seeded shuffling DataLoaders
      rebuilt/re-iterated every replication (`tools/evaluation.py:160-200`,
      `datasets/dataloader.py:33-37`), so the within-batch distance matrices
      behind MatchingScore/R-precision differ per replication and the
      ground-truth metrics carry a real 95 % CI.  A zero-argument
      ``batches_fn`` replays identical batches (ground-truth CIs collapse
      to 0 by construction — only correct for fixed-composition debugging).
    - ``generators`` maps model name -> ``generate(cond) -> motion``;
    - ``mm_generate(cond, repeats) -> (B, R, ...)`` enables MultiModality.
    """

    def __init__(self, wrapper: CoEmbedding, cfg: ProtocolConfig | None = None):
        self.wrapper = wrapper
        self.cfg = cfg or ProtocolConfig()

    def run(
        self,
        batches_fn: Callable[..., Iterable[tuple]],
        generators: dict[str, Callable],
        mm_generate: Callable | None = None,
        mm_conds=None,
    ) -> ProtocolResult:
        import inspect

        cfg = self.cfg
        try:
            sig = inspect.signature(batches_fn)
            # rep is passed POSITIONALLY, so the first parameter must itself
            # be positional-capable — a keyword-only first parameter (even
            # one with a default) cannot receive it and means "no rep arg"
            takes_rep = bool(sig.parameters) and next(
                iter(sig.parameters.values())
            ).kind in (
                inspect.Parameter.POSITIONAL_ONLY,
                inspect.Parameter.POSITIONAL_OR_KEYWORD,
                inspect.Parameter.VAR_POSITIONAL,
            )
        except (TypeError, ValueError):
            takes_rep = False
        result = ProtocolResult()
        for rep in range(cfg.replication_times):
            seed = cfg.seed + rep
            gt_embs: list[np.ndarray] = []
            gen_embs: dict[str, list[np.ndarray]] = {n: [] for n in generators}
            match_sums = {n: 0.0 for n in generators}
            gt_match_sum = 0.0
            topk_counts = {n: np.zeros(cfg.top_k) for n in generators}
            gt_topk = np.zeros(cfg.top_k)
            total = 0

            for cond, real in (batches_fn(rep) if takes_rep else batches_fn()):
                cond_emb, real_emb = self.wrapper.embed(cond, real)
                gt_embs.append(real_emb)
                total += cond_emb.shape[0]
                dist = euclidean_distance_matrix(cond_emb, real_emb)
                gt_match_sum += dist.trace()
                gt_topk += calculate_top_k(
                    np.argsort(dist, axis=1), cfg.top_k
                ).sum(axis=0)
                for name, gen in generators.items():
                    fake = np.asarray(gen(cond))
                    if fake.ndim == 3 and np.ndim(real) == 4:
                        fake = fake.reshape(np.shape(real))
                    fake_emb = self.wrapper.embed_motion(fake)
                    gen_embs[name].append(fake_emb)
                    dist = euclidean_distance_matrix(cond_emb, fake_emb)
                    match_sums[name] += dist.trace()
                    topk_counts[name] += calculate_top_k(
                        np.argsort(dist, axis=1), cfg.top_k
                    ).sum(axis=0)

            gt_all = np.concatenate(gt_embs, axis=0)
            gt_mu, gt_cov = calculate_activation_statistics(gt_all)
            result.add("MatchingScore", "ground truth", gt_match_sum / total)
            result.add("R_precision", "ground truth", gt_topk / total)
            dt = min(cfg.diversity_times, gt_all.shape[0] - 1)
            result.add(
                "Diversity", "ground truth",
                calculate_diversity(gt_all, dt, seed=seed),
            )
            for name in generators:
                embs = np.concatenate(gen_embs[name], axis=0)
                mu, cov = calculate_activation_statistics(embs)
                result.add("MatchingScore", name, match_sums[name] / total)
                result.add("R_precision", name, topk_counts[name] / total)
                result.add(
                    "FID", name, calculate_frechet_distance(gt_mu, gt_cov, mu, cov)
                )
                result.add(
                    "Diversity", name,
                    calculate_diversity(embs, dt, seed=seed),
                )

            if mm_generate is not None and mm_conds is not None:
                reps = []
                for cond in mm_conds:
                    gens = np.asarray(mm_generate(cond))  # (R, ...) per cond
                    reps.append(
                        np.stack([self.wrapper.embed_motion(g[None])[0] for g in gens])
                    )
                act = np.stack(reps)  # (N, R, D)
                mt = min(cfg.mm_num_times, act.shape[1] - 1)
                result.add(
                    "MultiModality", "model",
                    calculate_multimodality(act, mt, seed=seed),
                )
        return result


class PregeneratedSamples:
    """Pre-generated evaluation samples (reference `datasets/evaluator.py:
    16-130` `EvaluationDataset`): every sample — plus multimodality repeats
    for a random condition subset — is generated ONCE up front in device
    batches, then replayed into the protocol.  Generation dominates eval
    wall-clock (SURVEY.md §3.5), so metrics never trigger a second pass.

    ``generate_fn(conds (B, ...), repeats=1) -> (B, ...)`` or, with
    repeats=R, ``(B, R, ...)``.
    """

    def __init__(
        self,
        generate_fn: Callable,
        conds,
        *,
        mm_num_samples: int = 0,
        mm_num_repeats: int = 0,
        batch_size: int = 8,
        seed: int = 0,
    ):
        conds = list(conds)
        self.conds = conds
        fakes = []
        for i in range(0, len(conds), batch_size):
            chunk = np.stack(conds[i : i + batch_size])
            fakes.append(np.asarray(generate_fn(chunk)))
        self.fakes = np.concatenate(fakes, axis=0) if fakes else np.zeros((0,))

        self.mm_indices = []
        self.mm_fakes = None
        if mm_num_samples > 0 and mm_num_repeats > 0:
            rng = np.random.default_rng(seed)
            self.mm_indices = sorted(
                rng.choice(len(conds), min(mm_num_samples, len(conds)), replace=False)
            )
            reps = []
            for idx in self.mm_indices:
                out = np.asarray(
                    generate_fn(np.stack([conds[idx]]), repeats=mm_num_repeats)
                )
                reps.append(out[0])  # (R, ...)
            self.mm_fakes = np.stack(reps)  # (N_mm, R, ...)

    def __len__(self) -> int:
        return len(self.conds)

    def __getitem__(self, idx: int):
        return self.conds[idx], self.fakes[idx]

    def generator(self) -> Callable:
        """A `generate(cond_batch)` closure replaying the cached samples in
        protocol batch order — plug into `EvaluationProtocol.run`.

        The cursor wraps at `len(self)` so the replay restarts on every
        replication (the protocol re-iterates `batches_fn` per replication);
        without the wrap a `replication_times > 1` run would silently read
        past the end of the cache and feed empty batches into the metrics.
        Requires IDENTICAL batch composition every replication — with a
        reshuffling `batches_fn(rep)` use :meth:`lookup_generator` instead.
        Note a replayed cache makes replications identical by construction —
        for nonzero CIs on MatchingScore/R-precision/FID use a live
        fresh-noise generator (`cli.evaluate_protocol.make_generator`)."""
        cursor = {"i": 0}
        total = len(self)

        def gen(cond_batch):
            n = np.shape(cond_batch)[0]
            i = cursor["i"] % total if total else 0
            if i + n > total:
                raise IndexError(
                    f"replay batch [{i}:{i + n}) crosses the cache end "
                    f"({total}) — batch boundaries must match generation"
                )
            cursor["i"] = i + n
            return self.fakes[i : i + n]

        return gen

    def lookup_generator(self) -> Callable:
        """A `generate(cond_batch)` closure resolving cached samples BY
        CONDITION, not by replay order — the reference's semantics: its
        pregenerated `EvaluationDataset` sits under an epoch-seeded
        *shuffling* DataLoader (`datasets/evaluator.py:16-130` +
        `datasets/dataloader.py:33-37`), so each replication re-batches the
        same (cond, fake) PAIRS in a new composition.  Plug this into a
        reshuffling ``batches_fn(rep)`` protocol run; conditions are matched
        by exact byte identity (duplicate conditions share one fake, which
        is what a dataset keyed by sample does too)."""
        table = {
            np.ascontiguousarray(c).tobytes(): self.fakes[i]
            for i, c in enumerate(self.conds)
        }

        def gen(cond_batch):
            cond_batch = np.asarray(cond_batch)
            out = []
            for c in cond_batch:
                key = np.ascontiguousarray(c).tobytes()
                if key not in table:
                    raise KeyError(
                        "condition not in the pregenerated cache — the "
                        "protocol batches must draw from the same samples "
                        "the cache was generated for"
                    )
                out.append(table[key])
            return np.stack(out)

        return gen

    def mm_args(self):
        """(mm_generate, mm_conds) for `EvaluationProtocol.run`."""
        if self.mm_fakes is None:
            return None, None
        cursor = {"i": 0}
        total = len(self.mm_indices)

        def mm_generate(cond):
            i = cursor["i"] % total if total else 0
            cursor["i"] = i + 1
            return self.mm_fakes[i]

        return mm_generate, [self.conds[i] for i in self.mm_indices]
