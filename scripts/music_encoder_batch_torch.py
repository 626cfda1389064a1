#!/usr/bin/env python3
"""The serving music encoder's time at the batches the port calls it at,
and whether a clip's features and served motion depend on its batch.

    python3 scripts/music_encoder_batch_torch.py [--tree DIR]

On a CUDA card, on synthetic weights from a seed: `FusedMusicEncoder`
(K4's seven blocks, then the float32 projection) as serving calls it (the
stage-2 trainer's, B = 2, 60-s clips), as an evaluation wave does (B = 8,
60 s) and as the M2SGAN trainer's frozen encoder does (the generator's, B
= 55, 30 s): the median ms of 20 calls by CUDA events after three
warm-up calls.  At B = 8 it also encodes the clips 2 at a time (a rank's
rows of a 4-rank evaluation wave) and serves them both ways through
`DDPMTrainer.generate` (ddim50, bench.py's int8 config and the bf16
config) on the same mel and x_T: whether each is bit-equal and the
largest gap.  It calls only public entry points, so ``--tree`` measures
another checkout of the port (a parent commit unpacked by `git archive`),
which builds its own kernels; run the two trees in turns (parent, change,
change, parent) in one call to compare them.  Prints one JSON line.  It
imports no JAX.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

SPLIT = 2  # clips a call in the split runs
REPEATS = 20
STEPS = 50


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("music_encoder_batch_torch: torch.cuda.is_available() is False", file=sys.stderr)
        return 2
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import DDPMTrainer
    from conductor_tpu_torch.config import Config
    from conductor_tpu_torch.interop import synthetic_generator_state_dict, synthetic_state_dict
    from conductor_tpu_torch.models.generator import Generator
    from conductor_tpu_torch.models.music_encoder import FusedMusicEncoder

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(0)

    def mel_of(b, seconds):
        return torch.from_numpy(rng.uniform(-1, 1, (b, 90 * seconds, 128)).astype(
            np.float32)).cuda()

    def median_ms(fn):
        for _ in range(3):
            fn()
        times = []
        for _ in range(REPEATS):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        return float(np.median(times))

    def gap(whole, parts):
        split = torch.cat(parts)
        return {"bit_equal": bool(torch.equal(whole, split)),
                "gap": float((whole - split).abs().max()), "max": float(whole.abs().max())}

    base = Config()
    configs = {"bench_int8": dict(sampler_adaln_int8=True), "bf16": {}}
    mel8 = mel_of(8, 60)
    noise8 = torch.from_numpy(rng.normal(size=(8, 1800, 26)).astype(np.float32)).cuda()
    chunks = [slice(i, i + SPLIT) for i in range(0, 8, SPLIT)]
    out: dict = {"ms": {}, "batch": {}}
    sd = None
    with torch.no_grad():
        for name, knobs in configs.items():
            cfg = base.replace(denoiser=dataclasses.replace(
                base.denoiser, layer_impl="pallas_fused", music_encoder_impl="pallas",
                compute_dtype="bfloat16", **knobs))
            tr = DDPMTrainer(cfg, device="cuda")
            sd = sd or synthetic_state_dict(tr.model, seed=0)
            tr.load_reference_state_dict(sd)
            enc = tr.fused_encoder
            if name == "bench_int8":  # the encoder is the same in both configs
                for b in (2, 8):
                    mel = mel8[:b]
                    out["ms"][f"serving B={b} 60 s"] = median_ms(lambda: enc(mel))
                out["batch"]["encoder"] = gap(enc(mel8), [enc(mel8[c]) for c in chunks])
            whole = tr.generate(mel8, num_steps=STEPS, noise=noise8)
            out["batch"][f"generate {name}"] = gap(whole, [
                tr.generate(mel8[c], num_steps=STEPS, noise=noise8[c]) for c in chunks])
            del tr, enc
        g = Generator()
        g.load_state_dict({k: torch.from_numpy(v) for k, v in
                           synthetic_generator_state_dict(g, seed=20).items()})
        enc = FusedMusicEncoder(g.cuda().eval().music_encoder)
        mel55 = mel_of(55, 30)
        out["ms"]["M2SGAN B=55 30 s"] = median_ms(lambda: enc(mel55))
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.splitlines()[0].strip()
    print(json.dumps({"tree": str(args.tree.resolve()), "card": card, "repeats": REPEATS,
                      "steps": STEPS, **out}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
