"""Deterministic synthesis of reference-format state dicts from a key
manifest.

A copy of `conductor_tpu/interop/synth.py:31-58` (`synth_state_dict`), kept
in the port so that it imports nothing of the JAX package; the adjacency
comes from the port's `models.graph`.  The rules must stay in lockstep with
the JAX function, which made the committed fixtures
(`tests/fixtures/torch_*.npz`): the arrays are bit-identical
(`tests/test_torch_port_config.py`).

- keys are processed in sorted order, one RandomState stream;
- ``running_var`` and 1-D ``.1.weight`` keys (BatchNorm / LayerNorm scales)
  draw uniform(0.5, 1.5);
- ``num_batches_tracked`` is a constant 0;
- keys ending in ``.A`` (the ST-GCN adjacency buffer) take the true
  `build_adjacency` value and draw nothing;
- everything else draws normal(0, 0.05).
"""

from __future__ import annotations

import numpy as np


def synth_state_dict(manifest: dict[str, tuple[int, ...]], seed: int = 0) -> dict[str, np.ndarray]:
    rng = np.random.RandomState(seed)
    out: dict[str, np.ndarray] = {}
    for key in sorted(manifest):
        shape = tuple(manifest[key])
        base = key.rsplit(".", 1)[-1]
        if key.endswith(".A"):
            from ..models.graph import build_adjacency

            a = build_adjacency("ConductorMotionX", "uniform").astype(np.float32)
            assert a.shape == shape, (key, a.shape, shape)
            out[key] = a
        elif base == "num_batches_tracked":
            out[key] = np.zeros(shape, np.int64)
        elif base == "running_var" or (
            base == "weight" and key.endswith(".1.weight") and len(shape) == 1
        ):
            out[key] = rng.uniform(0.5, 1.5, size=shape).astype(np.float32)
        else:
            out[key] = rng.normal(0.0, 0.05, size=shape).astype(np.float32)
    return out
