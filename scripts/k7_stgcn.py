#!/usr/bin/env python3
"""K7's time on a CUDA card, call by call, at the stage-2 step's shape.

    python3 scripts/k7_stgcn.py [--tree DIR] [--reps N]

The perceptual term's inputs of one training forward at B = 32, T = 900
(`kernel_checks.perceptual_inputs`, flagship synthetic weights of seed 0
and the synthetic ST-GCN of seed 0, seeded mel and motion): pred, target
and the cotangent dy of pred's latents.  For each of K7's three calls on
the stage-2 path, the forward of pred keeping what the backward reads
(`save`), the forward of target without it, and the backward from dy, it
prints the mean ms of a call by CUDA events, the device ms of each launch
(`kernel_checks.launch_split`, summed by kernel: the row passes and the
temporal passes of the two-pass design apart), whether a repeat gives the
same bits, and the bound; then the bytes `save` keeps and the memory a
forward with `save` holds after it returns and at its peak (over what was
allocated before it), and the checks: the forward against
`frozen_stgcn_plain`, the backward against `stgcn_backward_plain` on the
plain forward's masks where the tree has it, else against autograd through
the plain forward, the kernel reading the plain forward's activations.

The bounds count the function, whatever implements it (`kernel_checks.bound`
over 3.35 TB/s and 989 TFLOP/s bf16): the forward reads the motion and the
ST-GCN module's weights and writes the latents, with the module's FLOPs;
the backward reads the motion, dy and the weights and writes dx, with the
FLOPs of the module's forward and its d(input).  The old backward bound,
printed beside it, read the forward's ten float32 h and bf16 g slabs and
counted the d(input) FLOPs alone.  ``--tree`` measures the port in another
checkout (a parent commit unpacked by `git archive`), which builds its own
kernels.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

BAR_MS = 0.70  # K7's bar at this shape, each direction by CUDA events


def _bytes(obj) -> int:
    if torch.is_tensor(obj):
        return obj.numel() * obj.element_size()
    return sum(_bytes(o) for o in obj)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", type=Path, default=Path(__file__).resolve().parents[1])
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(args.tree.resolve()))
    from conductor_tpu_torch import DDPMTrainer, kernel_checks
    from conductor_tpu_torch.config import Config
    from conductor_tpu_torch.interop import synthetic_motion_encoder_state_dict, synthetic_state_dict
    from conductor_tpu_torch.ops import stgcn

    if not torch.cuda.is_available():
        raise SystemExit("k7_stgcn: no CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"tree {args.tree.resolve()} on {smi}", flush=True)
    reps = args.reps

    cfg = Config()
    tr = DDPMTrainer(cfg, device="cuda")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model, seed=0),
                                 motion_encoder=synthetic_motion_encoder_state_dict(tr.feat_model, seed=0))
    b, n = cfg.train.batch_size, cfg.train.sample_length * cfg.dataset.motion_hz
    rng = np.random.RandomState(0)
    mel = torch.from_numpy(rng.uniform(0, 1, size=(b, 3 * n, 128)).astype(np.float32)).cuda()
    motion = torch.from_numpy(rng.uniform(0, 1, size=(b, n, 13, 2)).astype(np.float32)).cuda()
    pred, target, dy = kernel_checks.perceptual_inputs(tr, mel, motion)
    del mel
    pack, mxu = tr.feat_pack, getattr(torch, tr.cfg.denoiser.compute_dtype)
    module = tr.feat_model
    weights = list(module.state_dict().values())

    with torch.no_grad():
        saved = stgcn.stgcn_forward(pred, pack, save=True)[1]
        calls = {
            "forward, save": lambda: stgcn.stgcn_forward(pred, pack, save=True),
            "forward": lambda: stgcn.stgcn_forward(target, pack),
            "backward": lambda: stgcn.stgcn_backward(dy, saved, pack),
        }

        def flat(o):
            return [o] if torch.is_tensor(o) else [t for x in o for t in flat(x)]

        out = calls["forward"]()
        dx = calls["backward"]()
        n_fwd = kernel_checks.flops(lambda: module(pred))
        with torch.enable_grad():
            xm = pred.detach().requires_grad_(True)
            out_m = module(xm)
            n_dinput = kernel_checks.flops(lambda: torch.autograd.grad(out_m, xm, dy))
        n_bwd = n_fwd + n_dinput
        saved_slabs = 10 * b * n * 416 * (4 + 2)  # the ten float32 h and bf16 g slabs of the old design
        bounds = {
            "forward, save": kernel_checks.bound((pred, weights), out, n_fwd),
            "forward": kernel_checks.bound((target, weights), out, n_fwd),
            "backward": kernel_checks.bound((pred, dy, weights), dx, n_bwd),
        }
        old = kernel_checks.bound((dy, weights), dx, n_dinput)
        old_bwd = old["bytes_ms"] + saved_slabs / kernel_checks.HBM_BYTES_PER_S * 1e3
        print(f"[k7] B={b} T={n}, bf16 operands, {reps} calls each ({smi})", flush=True)
        events = {}
        for name, fn in calls.items():
            first = flat(fn())
            repeat = all(torch.equal(x, y) for x, y in zip(first, flat(fn())))
            events[name] = ms = kernel_checks.time_ms(fn, reps)
            split = kernel_checks.launch_split(fn, reps)
            by_kernel: dict[str, float] = {}
            for k, d in split:
                key = k.split("<")[0]
                by_kernel[key] = by_kernel.get(key, 0.0) + d
            bd = bounds[name]
            old_text = (f"; old bound {max(old_bwd, old['ops_ms']):.4f} ms "
                        f"({'bytes' if old_bwd > old['ops_ms'] else 'operations'})"
                        if name == "backward" else "")
            print(f"  {name}: {ms:.4f} ms a call by CUDA events; device "
                  f"{sum(d for _, d in split):.4f} ms in {len(split)} launches ("
                  + "; ".join(f"{k} {d:.4f}" for k, d in by_kernel.items()) + "); by launch: "
                  + ", ".join(f"{d:.4f}" for _, d in split)
                  + f"; bound {bd['bound_ms']:.4f} ms ({bd['bound_by']}: bytes {bd['bytes_ms']:.4f}, "
                  f"ops {bd['ops_ms']:.4f}){old_text}; repeat bit-identical {repeat}", flush=True)
        fwd_ms = (events["forward, save"] + events["forward"]) / 2
        print(f"  forward (mean of its two calls) {fwd_ms:.4f} ms, backward {events['backward']:.4f} "
              f"ms: bar <= {BAR_MS} each: bar_met {fwd_ms <= BAR_MS and events['backward'] <= BAR_MS}",
              flush=True)

        del saved, calls
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        kept = stgcn.stgcn_forward(pred, pack, save=True)
        torch.cuda.synchronize()
        held = torch.cuda.memory_allocated() - before
        peak = torch.cuda.max_memory_allocated() - before
        print(f"  save keeps {_bytes(kept[1])} bytes ({', '.join(f'{tuple(t.shape)} {t.dtype}' for t in flat(kept[1]))}); "
              f"a forward with save holds {held} bytes after it returns (the latents "
              f"{_bytes(kept[0])} of them), {peak} at its peak", flush=True)
        del kept

        got, want = stgcn.stgcn_forward(pred, pack), stgcn.frozen_stgcn_plain(pred, pack, mxu)
        fwd_err = float((got - want).abs().max()) / float(want.abs().max())
        plain_saved = stgcn.frozen_stgcn_plain(pred, pack, mxu, save=True)[1]
        got = stgcn.stgcn_backward(dy, plain_saved, pack)
        if hasattr(stgcn, "stgcn_backward_plain"):
            ref = "stgcn_backward_plain on the plain forward's masks"
            want = stgcn.stgcn_backward_plain(dy, plain_saved, pack, mxu)
        else:
            ref = "autograd through the plain forward, on its activations"
            with torch.enable_grad():
                x = pred.detach().requires_grad_(True)
                want = torch.autograd.grad(stgcn.frozen_stgcn_plain(x, pack, mxu), x, dy)[0]
        bwd_err = float((got - want).abs().max()) / float(want.abs().max())
    ok = fwd_err <= kernel_checks.REL_TOL and bwd_err <= kernel_checks.REL_TOL
    print(f"  checks: forward within {fwd_err:.3g} of the plain version's largest value; backward "
          f"within {bwd_err:.3g} of {ref}: {'ok' if ok else 'FAILED'}", flush=True)
    if not ok:
        raise SystemExit("k7_stgcn: K7 disagrees with its plain versions")


if __name__ == "__main__":
    main()
