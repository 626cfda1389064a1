"""The guided int8 drift at the flagship width, on the CPU: bench.py's
serving config (bf16, int8 AdaLN, the fused ladder) under classifier-free
guidance, in the JAX package and in the port, each against JAX's float32
fused path on the same weights, mel and x_T.

    python tests/guided_int8_drift.py [--steps 50] [--frames 32] [--guidance 2.5]

D = 128, 8 layers, 8 heads, ff 64 (the reference default), B = 2, the
1000-step linear ladder respaced to ``--steps``, T = ``--frames`` motion
frames; synthetic weights from the port model's manifest (seed 2).  JAX's
fused kernels run in interpret mode, the port's kernels their plain
versions.  Prints each path's drift as a share of the float32 path's
largest value, and the port's gap to JAX's same config.  It imports both
packages, as the port's tests do; it is not collected by pytest.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from conductor_tpu.config import Config, DenoiserConfig, TrainConfig  # noqa: E402
from conductor_tpu.interop import import_motion_transformer  # noqa: E402
from conductor_tpu.interop.synth import synth_state_dict  # noqa: E402
from conductor_tpu.train.ddpm_trainer import DDPMTrainer as JaxTrainer  # noqa: E402
from conductor_tpu.train.ddpm_trainer import TrainState  # noqa: E402
from conductor_tpu_torch import DDPMTrainer  # noqa: E402
from conductor_tpu_torch.interop import manifest  # noqa: E402

BENCH = dict(attention_impl="pallas", compute_dtype="bfloat16", sampler_adaln_int8=True)


def drift(steps: int, frames: int, guidance: float) -> dict:
    cfg = Config(denoiser=DenoiserConfig(num_frames=frames, layer_impl="pallas_fused",
                                         music_encoder_impl="flax", compute_dtype="float32"),
                 train=TrainConfig(sample_length=1))
    bench = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, **BENCH))
    sd = synth_state_dict(manifest(DDPMTrainer(cfg, device="cpu").model), seed=2)
    variables = jax.tree.map(jnp.asarray, import_motion_transformer(sd))
    state = TrainState(step=jnp.zeros((), jnp.int32), params=variables["params"],
                       batch_stats=variables["batch_stats"], feat_variables=None, opt_state=None)
    mel = np.random.RandomState(4).uniform(0, 1, size=(2, 3 * frames, 128)).astype(np.float32)
    rng = jax.random.PRNGKey(0)
    x_t = torch.from_numpy(np.array(jax.random.normal(jax.random.split(rng)[0], (2, frames, 26))))
    out, seconds = {}, {}
    for name, c in (("jax_f32", cfg), ("jax_bench", bench)):
        t0 = time.perf_counter()
        out[name] = np.asarray(JaxTrainer(c).generate(state, jnp.asarray(mel), rng,
                                                      num_steps=steps, guidance_scale=guidance))
        seconds[name] = time.perf_counter() - t0
    for name, c in (("port_f32", cfg), ("port_bench", bench)):
        tr = DDPMTrainer(c, device="cpu")
        tr.load_reference_state_dict(sd)
        t0 = time.perf_counter()
        out[name] = tr.generate(torch.from_numpy(mel), num_steps=steps, noise=x_t,
                                guidance_scale=guidance).numpy()
        seconds[name] = time.perf_counter() - t0
    scale = float(np.abs(out["jax_f32"]).max())
    rel = lambda a, b: float(np.abs(out[a] - out[b]).max()) / scale  # noqa: E731
    return {"steps": steps, "frames": frames, "guidance": guidance, "scale": scale,
            "jax_drift": rel("jax_bench", "jax_f32"), "port_drift": rel("port_bench", "jax_f32"),
            "port_bench_vs_jax_bench": rel("port_bench", "jax_bench"),
            "port_f32_vs_jax_f32": rel("port_f32", "jax_f32"),
            "seconds": {k: round(v, 2) for k, v in seconds.items()}}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--guidance", type=float, default=2.5)
    args = ap.parse_args()
    torch.set_num_threads(4)
    print(json.dumps(drift(args.steps, args.frames, args.guidance)))


if __name__ == "__main__":
    main()
