#!/usr/bin/env python3
"""Where a training step of the PyTorch port spends its time on a CUDA
card: stage 2's `DDPMTrainer.train_step`, with ``--m2snet`` stage 1's
`M2SNetTrainer.train_step`, or with ``--m2sgan`` stage 1's
`M2SGANTrainer.train_step`.

    python3 scripts/profile_torch_train.py [--impl pallas_fused|flax] [--feat auto|flax|pallas]
                                           [--dtype auto|float32] [--cached] [--mask]
                                           [--tree DIR] [--walls N]
    python3 scripts/profile_torch_train.py --m2snet [--impl pallas_fused|flax] [--share] [--walls N]
    python3 scripts/profile_torch_train.py --m2sgan [--impl pallas_fused|flax] [--train-encoder]
                                           [--cached] [--walls N]

Flagship configuration (D = 128, 8 layers, E = 512) on synthetic weights,
B = 32 windows of 30 s (T = 900 motion / 2700 mel frames), seeded data; with
``--cached`` the batch carries frozen-encoder features instead of mel
(``TrainConfig.cached_features``), so the music encoder drops out.
``--feat`` picks the perceptual ST-GCN: "auto" is K7 on the kernel path,
"flax" the plain float32 module.  ``--dtype float32`` runs the kernel path
in float32 (K5 / K6's and K7's float32 modes).  ``--mask`` replicates the reference's
loss mask (``replicate_reference_mask``, m_lens = 60): "auto" then runs the
bf16 plain layers with the self-attention on K8, "flax" the float32 plain
layers with the mask.  After two warm-up steps it times ``--walls`` steps
(2 unless given) one by one, then `torch.profiler` records two more; the
script prints the wall time per step without the profiler (the median of
the timed steps, with their least and most) and under it, the device time
per step (the sum of the kernels' times), the device's busy share of the
wall time under the profiler, the perceptual term alone (its latents of pred and target and
its backward to pred, CUDA events, on pred and target of a training
forward), K7's and K8's device time and launches a step, the peak memory of one
more step (`torch.cuda.max_memory_allocated`), and the kernels by total
device time.  On the kernel path it
also splits K6's device time a step by kernel (`k6_split`: the kernels
launched inside each `decoder_layer_bwd` call, which the script wraps in
a `torch.profiler.record_function` range), and times one K5 and one K6
call alone on layer 0's inputs of a training forward at the step's shape
(B = 32, T = 900 padded to 960): CUDA-event ms a call and device ms a call
by kernel.  ``--tree`` profiles the port in another checkout (a
parent commit unpacked by `git archive`), which builds its own kernels.

``--m2snet``: the stage-1 step at the reference batch, B = 10 samples of
30 s (2700 mel / 900 motion frames), 10-s crops, strategy "hard", starts
drawn with numpy, on synthetic M2SNet weights (`synthetic_m2snet_state_dict`);
"pallas_fused" (the default) means "auto" on CUDA, the kernel path (bf16,
music_conv_impl "pallas_train"), "flax" the plain float32 "lax" path;
``--share`` sets ``share_encodes``.  The same timings and table, without
the perceptual term, and K9's, K4's, K11's and K10's device time and
launches a step.

``--m2sgan``: the WGAN-GP step at the reference batch, B = 55 samples of
30 s (2700 mel / 900 motion frames), 5 critic iterations, seeded noise and
interpolation weights, on synthetic generator, critic and M2SNet weights;
"pallas_fused" means "auto" on CUDA (K4 on the frozen encoder, K7 bf16 in
the SyncLoss; with ``--train-encoder`` the encoder trains in bf16 on K4's
training modes, K9, K10 and K11), "flax" the plain float32 path (cuDNN
encoder, float32 flax SyncLoss); ``--cached`` hands the step the frozen
encoder's features and the real motion's SyncLoss latents
(``cached_features``, ``cached_sync_latents``).  The same timings and
table, K4's, K7's, K9's, K10's and K11's device time and launches a step,
and the peak memory of one more step.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import subprocess
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

REPO = Path(__file__).resolve().parents[1]
STEPS = 2  # profiled steps, after two warm-up steps
K6_RANGE = "K6 decoder_layer_bwd"  # the profiler range around each K6 call
# K7's kernels: one a st_gcn block and direction; the row and temporal
# passes in trees before it was one launch a block
K7_KERNELS = ("stgcn_fwd_kernel", "stgcn_bwd_kernel", "rows_kernel", "tconv_kernel",
              "stgcn_f32_gemm", "stgcn_f32_tconv")  # the last two: K7's float32 mode


def profile_steps(step, walls: int = STEPS) -> tuple[list, float, float, str, dict, dict]:
    """Two warm-up calls of ``step``, then ``walls`` timed one by one, then
    STEPS under `torch.profiler`: (each timed step's wall ms without the
    profiler, the wall ms per step under it, device ms per step, the
    kernels table, {kernel name: (device ms, launches) per step}, `k6_split`
    per step)."""
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    wall_plain = []
    for _ in range(walls):
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        wall_plain.append((time.perf_counter() - t0) * 1e3)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(STEPS):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) / STEPS
    # device time: the kernels themselves (the CPU-side ops that launched
    # them carry the same time again)
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA and e.name != K6_RANGE]
    device = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / STEPS
    table = prof.key_averages().table(sort_by="self_cuda_time_total", row_limit=30)
    by_name: dict[str, tuple[float, float]] = {}
    for e in kernels:
        ms, n = by_name.get(e.name, (0.0, 0.0))
        by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3 / STEPS, n + 1 / STEPS)
    return wall_plain, wall * 1e3, device, table, by_name, k6_split(prof, STEPS)


def _short(name: str) -> str:
    """A kernel's name without its return type, namespace and arguments."""
    return name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]


def k6_split(prof, calls: int) -> dict[str, tuple[float, float]]:
    """{kernel: (device ms, launches)} per call of the kernels that ran on
    the card inside the K6_RANGE ranges of ``prof`` (the profiler marks each
    range on the device timeline too), divided by ``calls``."""
    dev = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    windows = [(e.time_range.start, e.time_range.end) for e in dev if e.name == K6_RANGE]
    out: dict[str, tuple[float, float]] = {}
    for e in dev:
        if e.name != K6_RANGE and any(a <= e.time_range.start and e.time_range.end <= b
                                      for a, b in windows):
            ms, n = out.get(_short(e.name), (0.0, 0.0))
            out[_short(e.name)] = (ms + e.time_range.elapsed_us() / 1e3 / calls, n + 1 / calls)
    return out


def wrap_k6_in_range() -> None:
    """Put each K6 call (`ops.decoder_layer_bwd.decoder_layer_bwd`, which the
    training layer's backward looks up in its module) in a K6_RANGE range;
    its launch count moves to the wrapper."""
    mod = importlib.import_module("conductor_tpu_torch.ops.decoder_layer_bwd")
    inner = mod.decoder_layer_bwd

    def wrapped(*args, **kw):
        with torch.profiler.record_function(K6_RANGE):
            return inner(*args, **kw)

    wrapped.launches = wrapped.launches_f32 = 0  # the bf16 and float32 modes' counts
    mod.decoder_layer_bwd = wrapped


def _split_text(split: dict[str, tuple[float, float]]) -> str:
    total = sum(ms for ms, _ in split.values())
    parts = "; ".join(f"{name} {ms:.4f} ms x {n:g}" for name, (ms, n)
                      in sorted(split.items(), key=lambda kv: -kv[1][0]))
    return f"{total:.4f} ms: {parts}" if split else "not measured (the trace linked no kernels)"


def layers_alone(tr, cond, motion, smi: str) -> str:
    """One K5 and one K6 call on layer 0's inputs of a training forward of
    ``tr`` on ``cond`` and ``motion`` (seeded t and noise, a seeded
    cotangent zero on the pad rows, as `kernel_checks.check_train_kernels`
    builds them): each one's CUDA-event ms a call and device ms a call by
    kernel."""
    from conductor_tpu_torch.diffusion import q_sample
    from conductor_tpu_torch.kernel_checks import launch_split, time_ms
    from conductor_tpu_torch.train.fused_denoiser import (
        cross_kv_state,
        pack_layer_weights,
        train_layer_inputs,
    )

    cfg, model = tr.cfg, tr.model
    b, n = motion.shape[0], motion.shape[1]
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.no_grad():
        t = torch.randint(0, tr.sched.num_timesteps, (b,), generator=gen, device="cuda")
        x0 = motion.reshape(b, n, -1)
        x_t = q_sample(tr.train_sched, x0, t, torch.randn(x0.shape, generator=gen, device="cuda"))
        encode = model.cond_from_features if cfg.train.cached_features else model.encode_music
        h, emb_act, xf_o = train_layer_inputs(model, cfg, x_t, t, *encode(cond))
        kvb = cross_kv_state(model.temporal_decoder_blocks[0].ca_block, xf_o).to(h.dtype)
        args = (h, emb_act, kvb, *pack_layer_weights(model, 0))
        dy = torch.randn(h.shape, generator=gen, device="cuda") * 1e-2
        dy[:, n:] = 0
        dy = dy.to(h.dtype)
    heads = cfg.denoiser.num_heads
    kw = dict(mxu_dtype=h.dtype, t_valid=n)
    calls = {
        "K5": lambda: importlib.import_module(
            "conductor_tpu_torch.ops.decoder_layer").fused_decoder_layer(*args, heads, **kw),
        "K6": lambda: importlib.import_module(
            "conductor_tpu_torch.ops.decoder_layer_bwd").decoder_layer_bwd(*args, dy, heads, **kw),
    }
    lines = []
    for name, call in calls.items():
        ms, split = time_ms(call, 10), launch_split(call)
        lines.append(f"{name} alone, {h.dtype}, B={b} T={n} (padded {h.shape[1]}): {ms:.4f} ms a "
                     f"call (CUDA events), device {sum(t for _, t in split):.4f} ms by launch: "
                     + "; ".join(f"{k} {t:.4f}" for k, t in split) + f", on {smi}")
    return "\n".join(lines)


def _smi() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]


def _times(wall_plain: list, wall: float, device: float) -> str:
    return (f"wall {float(np.median(wall_plain)):.2f} ms/step without the profiler (median of "
            f"{len(wall_plain)} steps, {min(wall_plain):.2f} to {max(wall_plain):.2f}), "
            f"{wall:.2f} ms/step under it; device {device:.2f} ms/step, busy "
            f"{100 * device / wall:.1f} % of the wall under the profiler")


def main_m2snet(args) -> None:
    from conductor_tpu_torch import M2SNetTrainer
    from conductor_tpu_torch.interop import synthetic_m2snet_state_dict

    b, s, c = 10, 30, 10  # the reference batch (cli/train_m2snet.py), 30-s samples, 10-s crops
    kw = {} if args.impl == "pallas_fused" else dict(compute_dtype="float32", music_conv_impl="lax")
    tr = M2SNetTrainer(sample_length=s, clip_length=c, share_encodes=args.share, device="cuda", **kw)
    tr.load_reference_state_dict(synthetic_m2snet_state_dict(tr.model, seed=0))
    rng = np.random.RandomState(0)
    music = torch.from_numpy(rng.uniform(0, 1, size=(b, s * 90, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(b, s * 30, 13, 2)).astype(np.float32)).cuda()

    def step():
        s1 = int(rng.randint(0, (s - c - 10) * 30))
        return float(tr.train_step(music, motion, "hard",
                                   starts=(s1, int(rng.randint(s1 + 300, (s - c) * 30))))["loss"])

    wall_plain, wall, device, table, by_name, _ = profile_steps(step, args.walls)
    k9 = [v for name, v in by_name.items() if "dkernel" in name]
    # K4's kernel: conv_block_kernel, conv3x3_kernel in trees before it ran on tensor cores
    k4 = [v for name, v in by_name.items() if "conv_block_kernel" in name or "conv3x3_kernel" in name]
    # K11's kernel: pool_bwd_kernel; pool_winner_kernel and pool_route_kernel
    # in trees before it was one launch
    k11 = [v for name, v in by_name.items()
           if any(k in name for k in ("pool_bwd_kernel", "pool_winner_kernel", "pool_route_kernel"))]
    # K10's kernel: pool_fwd_kernel; max_pool_kernel in trees before it was tiled
    k10 = [v for name, v in by_name.items() if "pool_fwd_kernel" in name or "max_pool_kernel" in name]
    print("\n".join([
        f"stage-1 M2SNet step, {tr.compute_dtype} / {tr.music_conv_impl}, share_encodes "
        f"{args.share}, B={b}, {c}-s crops of {s}-s samples, {STEPS} steps profiled on {_smi()}",
        _times(wall_plain, wall, device),
        f"K9 (csrc/conv_train.cu: dkernel_partial and dkernel_reduce, two launches a call): "
        f"{sum(ms for ms, _ in k9):.3f} ms/step, {sum(n for _, n in k9):.0f} launches/step",
        f"K4 (csrc/conv_block.cu, forward and d(input)): {sum(ms for ms, _ in k4):.3f} ms/step, "
        f"{sum(n for _, n in k4):.0f} launches/step",
        f"K11 (csrc/max_pool.cu, the pool backward): {sum(ms for ms, _ in k11):.3f} ms/step, "
        f"{sum(n for _, n in k11):.0f} launches/step; K10 (the pool forward): "
        f"{sum(ms for ms, _ in k10):.3f} ms/step, {sum(n for _, n in k10):.0f} launches/step",
        table]))


def _kernel_ms(by_name: dict, names: tuple[str, ...]) -> str:
    hits = [v for name, v in by_name.items() if any(k in name for k in names)]
    return f"{sum(ms for ms, _ in hits):.3f} ms/step, {sum(n for _, n in hits):.0f} launches/step"


def main_m2sgan(args) -> None:
    from conductor_tpu_torch import M2SGANTrainer
    from conductor_tpu_torch.interop import (
        synthetic_discriminator_state_dict,
        synthetic_generator_state_dict,
        synthetic_m2snet_state_dict,
    )
    from conductor_tpu_torch.models.m2snet import M2SNet

    b, s, iters = 55, 30, 5  # the reference batch and critic iterations (M2SGAN_train.py:168-196)
    kw = dict(train_music_encoder=args.train_encoder, cached_features=args.cached,
              cached_sync_latents=args.cached)
    if args.impl == "flax":
        kw.update(music_encoder_impl="flax", sync_encoder_impl="flax",
                  sync_encoder_dtype="float32", compute_dtype="float32", music_conv_impl="lax")
    tr = M2SGANTrainer(sample_length=s, critic_iters=iters, device="cuda", **kw)
    tr.load_reference_state_dict(synthetic_generator_state_dict(tr.G, seed=0),
                                 synthetic_discriminator_state_dict(tr.D, seed=1),
                                 m2snet=synthetic_m2snet_state_dict(M2SNet(), seed=0))
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(b, s * 90, 128)).astype(np.float32)).cuda()
    real = torch.from_numpy(rng.uniform(0, 1, size=(b, s * 30, 13, 2)).astype(np.float32)).cuda()
    batch = (mel, real)
    if args.cached:
        with torch.no_grad():
            batch = (tr.music_features(mel), real, tr.sync_latents(real))

    def step():
        noise = torch.from_numpy(rng.normal(size=(b, s, 8)).astype(np.float32)).cuda()
        alpha = {"real_fake": torch.from_numpy(rng.uniform(size=(iters, b)).astype(np.float32))}
        return float(tr.train_step(*batch, noise=noise, gp_alpha=alpha)["loss_sync"])

    wall_plain, wall, device, table, by_name, _ = profile_steps(step, args.walls)
    torch.cuda.reset_peak_memory_stats()
    step()
    peak = torch.cuda.max_memory_allocated()
    print("\n".join([
        f"M2SGAN step, music encoder {tr.music_encoder_impl} / {tr.compute_dtype} / "
        f"{tr.music_conv_impl} (trains: {tr.train_music_encoder}), SyncLoss "
        f"{tr.sync_encoder_impl} / {tr.sync_encoder_dtype}, cached {args.cached}, B={b}, {s}-s "
        f"samples, {iters} critic iterations, {STEPS} steps profiled on {_smi()}",
        _times(wall_plain, wall, device),
        f"K4 (csrc/conv_block.cu): {_kernel_ms(by_name, ('conv_block_kernel',))}; "
        f"K7 (csrc/stgcn.cu): {_kernel_ms(by_name, ('stgcn_fwd_kernel', 'stgcn_bwd_kernel'))}; "
        f"K9: {_kernel_ms(by_name, ('dkernel',))}; K10: {_kernel_ms(by_name, ('pool_fwd_kernel',))}; "
        f"K11: {_kernel_ms(by_name, ('pool_bwd_kernel',))}",
        f"peak memory of one step {peak} bytes",
        table]))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--impl", default="pallas_fused", choices=["pallas_fused", "flax"])
    ap.add_argument("--feat", default="auto", choices=["auto", "flax", "pallas"])
    ap.add_argument("--dtype", default="auto", choices=["auto", "float32"])
    ap.add_argument("--cached", action="store_true")
    ap.add_argument("--mask", action="store_true")
    ap.add_argument("--m2snet", action="store_true")
    ap.add_argument("--share", action="store_true")
    ap.add_argument("--m2sgan", action="store_true")
    ap.add_argument("--train-encoder", action="store_true")
    ap.add_argument("--tree", type=Path, default=REPO)
    ap.add_argument("--walls", type=int, default=STEPS)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_torch_train: needs a CUDA card")
    import sys

    sys.path.insert(0, str(args.tree.resolve()))
    print(f"tree {args.tree.resolve()}")
    # the plain paths are float32: no TF32 in cuBLAS or cuDNN
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if args.m2snet:
        return main_m2snet(args)
    if args.m2sgan:
        return main_m2sgan(args)
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import Config, DenoiserConfig
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
    from conductor_tpu_torch.kernel_checks import perceptual_inputs, time_ms

    cfg = Config()
    cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, compute_dtype=args.dtype),
                      train=dataclasses.replace(cfg.train, cached_features=args.cached,
                                                feat_impl=args.feat,
                                                replicate_reference_mask=args.mask))
    if args.impl == "flax":
        cfg = cfg.replace(denoiser=DenoiserConfig(layer_impl="flax", train_layer_impl="flax",
                                                  attention_impl="xla", compute_dtype="float32"),
                          train=dataclasses.replace(cfg.train, feat_impl="flax"))
    tr = DDPMTrainer(cfg, device="cuda")
    kernel_path = tr.cfg.denoiser.train_layer_impl == "pallas_fused"
    if kernel_path:
        wrap_k6_in_range()
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                 motion_encoder=synthetic_motion_encoder_state_dict(tr.feat_model))
    rng = np.random.RandomState(0)
    b, n = cfg.train.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    mel = torch.from_numpy(rng.uniform(0, 1, size=(b, 3 * n, 128)).astype(np.float32)).cuda()
    if args.cached:
        with torch.no_grad():
            mel = tr.model.music_encoder(mel)
    motion = torch.from_numpy(rng.uniform(0, 1, size=(b, n, 13, 2)).astype(np.float32)).cuda()
    gen = torch.Generator(device="cuda").manual_seed(0)
    m_lens = torch.full((b,), 60)  # the reference's m_lens (config.py TrainConfig)

    def step():
        return float(tr.train_step(mel, motion, m_lens, generator=gen)["loss"])

    wall_plain, wall, device, table, by_name, k6 = profile_steps(step, args.walls)
    k7 = [v for name, v in by_name.items() if _short(name).split("<")[0] in K7_KERNELS]
    k8 = [v for name, v in by_name.items() if "attention_" in name]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    step()
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    pred, target, _ = perceptual_inputs(tr, mel, motion)

    def perceptual():
        x = pred.detach().requires_grad_(True)
        tr.perceptual_loss(x, target).backward()

    feat_ms = time_ms(perceptual, 5)
    print("\n".join([
        f"train step, impl {args.impl}, feat_impl {tr.cfg.train.feat_impl}, "
        f"cached_features {args.cached}, reference mask {args.mask}, "
        f"{tr.cfg.denoiser.compute_dtype} / {tr.cfg.denoiser.train_layer_impl} / attention "
        f"{tr.cfg.denoiser.attention_impl}, B={b} T={n}, {STEPS} steps profiled on {_smi()}",
        f"{_times(wall_plain, wall, device)}; perceptual term {feat_ms:.2f} ms (CUDA events)",
        f"K7 (csrc/stgcn.cu, float32 csrc/stgcn_f32.cu, the perceptual ST-GCN): "
        f"{sum(ms for ms, _ in k7):.3f} ms/step device, "
        f"{sum(c for _, c in k7):.0f} launches/step; peak memory of a step "
        f"(torch.cuda.max_memory_allocated) {peak} bytes",
        *(f"{name}: {ms:.4f} ms device, {n:g} launches per step" for name, (ms, n)
          in sorted(by_name.items()) if "attention_" in name),  # K8's kernel(s)
        f"K8 (csrc/linear_attention.cu): {sum(ms for ms, _ in k8):.4f} ms/step device, "
        f"{sum(n for _, n in k8):.0f} launches/step",
        *([f"K6 a step: device {_split_text(k6)}", layers_alone(tr, mel, motion, _smi())]
          if kernel_path else []),
        table]))


if __name__ == "__main__":
    main()
