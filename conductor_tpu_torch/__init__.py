"""conductor-tpu on PyTorch + CUDA: the serving path of `conductor_tpu`
(mel -> MusicEncoder -> eta=0 DDIM ladder over the MotionTransformer ->
motion), its stage-2 training step (`DDPMTrainer`), its stage-1 M2SNet
contrastive step (`M2SNetTrainer`) and its stage-1 WGAN-GP step
(`M2SGANTrainer`) ported to PyTorch, with the TPU's Pallas
kernels on those paths rewritten as hand-written CUDA C++ kernels for
Hopper (sm_90a).  The entry points run on the card unless the caller asks
for the CPU (``device="cpu"``).

The JAX package `conductor_tpu` stays the numerical reference; this package
imports nothing of it, nor `jax` or `flax`.  It keeps its own copies of the
config dataclasses (`config`) and of the weight synthesis
(`interop.synth`), and loads reference-format state dicts.
"""

from .config import Config, DenoiserConfig, DiffusionConfig, resolve_auto  # noqa: F401
from .train.ddpm_trainer import DDPMTrainer  # noqa: F401
from .train.m2sgan_trainer import M2SGANTrainer  # noqa: F401
from .train.m2snet_trainer import M2SNetTrainer  # noqa: F401
