#!/usr/bin/env python3
"""How far a float32 "lax" stage-1 step's music encoder on a CUDA card is
from the CPU's, with `M2SNetTrainer`'s TF32 scope (`full_float32`) as it is
and with it replaced by a no-op, so that cuDNN runs float32 convolutions in
TF32 at torch's defaults.

    python3 scripts/tf32_stage1_probe.py

Prints, for each setting, the largest difference of the encoder's first
output and of its parameters' gradients, relative to the largest element:
"step" takes the step's own loss (its four BCE terms cancel in the
encoder's gradient, so the gradient is ill-conditioned), "encoder" one
train-mode forward and backward of the encoder under a seeded cotangent.
Synthetic M2SNet weights, B = 2, 6-s samples, 2-s crops.
"""
import contextlib
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import conductor_tpu_torch.train.m2snet_trainer as mt  # noqa: E402
from conductor_tpu_torch import M2SNetTrainer  # noqa: E402
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict  # noqa: E402

if not torch.cuda.is_available():
    raise SystemExit("tf32_stage1_probe: needs a CUDA card")
print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                     capture_output=True, text=True).stdout.strip())

sd = synthetic_m2snet_state_dict(M2SNetTrainer(device="cpu").model, seed=0)
rng = np.random.RandomState(5)
music = torch.from_numpy(rng.uniform(0, 1, size=(2, 540, 128)).astype(np.float32))
motion = torch.from_numpy(rng.uniform(0, 1, size=(2, 180, 13, 2)).astype(np.float32))


def run(device, loss_kind):
    tr = M2SNetTrainer(sample_length=6, clip_length=2, compute_dtype="float32",
                       music_conv_impl="lax", device=device)
    tr.load_reference_state_dict(sd)
    outs = []
    tr.model.music_encoder.register_forward_hook(lambda m, i, o: outs.append(o))
    if loss_kind == "step":
        tr.train_step(music, motion, "hard", starts=(0, 120))
        grads = {k: p.grad.detach().cpu() for k, p in tr.model.music_encoder.named_parameters()}
        return outs[0].detach().cpu(), grads
    # the encoder alone, train mode, a seeded cotangent
    tr.model.train()
    with mt.full_float32():
        y = tr.model.music_encoder(music[:, :180].to(device))
        w = torch.from_numpy(np.random.RandomState(1).normal(size=tuple(y.shape)).astype(np.float32)).to(device)
        (y * w).sum().backward()
    return y.detach().cpu(), {k: p.grad.detach().cpu() for k, p in tr.model.music_encoder.named_parameters()}


def compare(tag, loss_kind):
    (oc, gc), (og, gg) = run("cpu", loss_kind), run("cuda", loss_kind)
    gmax = max(float(g.abs().max()) for g in gc.values())
    worst = max(((float((gg[k] - g).abs().max()) / gmax), k) for k, g in gc.items())
    print(f"{tag} {loss_kind}: output err/max {float((og - oc).abs().max()) / float(oc.abs().max()):.3g}; "
          f"grad worst err/gmax {worst[0]:.3g} ({worst[1]}); tf32 flags now "
          f"{torch.backends.cudnn.allow_tf32} {torch.backends.cuda.matmul.allow_tf32}")


for kind in ("step", "encoder"):
    compare("entry point (TF32 scoped off)", kind)
real = mt.full_float32
mt.full_float32 = contextlib.nullcontext  # TF32 left at torch's defaults
for kind in ("step", "encoder"):
    compare("TF32 at defaults", kind)
mt.full_float32 = real
torch.backends.cudnn.deterministic = True
torch.backends.cudnn.benchmark = False
for kind in ("step", "encoder"):
    compare("entry point, cudnn deterministic", kind)
