"""PyTorch port: the profiling hooks (`utils.profiling`) and the analytic
FLOP counts (`utils.flops`) against the JAX package's.

`StepTimer` with `time.perf_counter` patched in both modules to the same
clock sequence gives JAX's summary exactly, warm-up and ``p50`` index
included; `trace` writes a Chrome trace that holds the `annotate` names;
the FLOP counts are JAX's, the MFU is priced at the H100 peaks
(`kernel_checks`), not JAX's TPU ones."""

import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from conductor_tpu.config import Config as JaxConfig
from conductor_tpu.utils import flops as jax_flops
from conductor_tpu.utils import profiling as jax_profiling
from conductor_tpu_torch import kernel_checks
from conductor_tpu_torch.config import Config
from conductor_tpu_torch.utils import flops, profiling

torch.set_num_threads(2)


@pytest.mark.parametrize("warmup,ticks", [(2, 7), (0, 4), (3, 2)])
def test_step_timer_summary_matches_jax(monkeypatch, warmup, ticks):
    clock = np.cumsum(np.random.RandomState(warmup + ticks).uniform(0.01, 0.2, ticks + 1))

    def summary(module, result):
        it = iter(clock.tolist())
        monkeypatch.setattr(module.time, "perf_counter", lambda: next(it))
        timer = module.StepTimer(warmup=warmup)
        dts = [timer.tick(result) for _ in range(ticks)]
        return dts, timer.summary()

    got = summary(profiling, {"loss": torch.ones(2), "parts": [torch.zeros(1)]})
    want = summary(jax_profiling, jnp.ones(2))
    assert got == want
    assert got[1]["steps"] == max(ticks - warmup, 0)


def test_trace_holds_the_annotations(tmp_path):
    with profiling.trace(str(tmp_path)) as prof:
        with profiling.annotate("ladder_step"):
            torch.ones(64, 64) @ torch.ones(64, 64)
        with profiling.annotate("epilogue"):
            torch.ones(8).sum()
    path = prof.trace_path
    assert os.path.dirname(path) == str(tmp_path) and path.endswith("trace_0.json")
    with open(path) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {"ladder_step", "epilogue"} <= names
    with profiling.trace(str(tmp_path)) as prof2:  # a second trace does not overwrite
        torch.ones(2).sum()
    assert prof2.trace_path.endswith("trace_1.json")


def test_flops_are_jaxs_counts_priced_at_h100_peaks():
    cfg, jcfg = Config(), JaxConfig()
    for b, t in ((1, 1800), (8, 1800), (4, 900)):
        got, want = flops.denoiser_forward_flops(cfg, b, t), jax_flops.denoiser_forward_flops(
            jcfg, b, t)
        assert (got.adaln, got.other) == (want.adaln, want.other)
    assert (kernel_checks.BF16_FLOPS, kernel_checks.INT8_OPS, kernel_checks.F32_FLOPS) == (
        989e12, 1979e12, 67e12)
    fl = flops.denoiser_forward_flops(cfg, 8, 1800)
    ideal = fl.adaln / kernel_checks.INT8_OPS + fl.other / kernel_checks.BF16_FLOPS
    out = flops.sampling_mfu(cfg, 8, 1800, 1000, ideal * 1000, adaln_int8=True)
    assert out["mfu_pct"] == 100.0
    # the same wall and FLOPs as JAX's: the same TFLOP/s, an MFU scaled by
    # the peaks (v5e 197 TFLOP/s bf16 against the H100's 989)
    mine = flops.sampling_mfu(cfg, 8, 1800, 50, 0.5, adaln_int8=False)
    theirs = jax_flops.sampling_mfu(jcfg, 8, 1800, 50, 0.5, adaln_int8=False)
    assert mine["achieved_tflops"] == theirs["achieved_tflops"]
    np.testing.assert_allclose(mine["mfu_pct"], theirs["mfu_pct"] * 197 / 989, atol=0.06)
    f32 = cfg.replace(denoiser=cfg.denoiser.__class__(compute_dtype="float32"))
    assert flops.train_step_mfu(f32, 32, 900, 1.0)["mfu_pct"] > flops.train_step_mfu(
        cfg, 32, 900, 1.0)["mfu_pct"]
