"""PyTorch port, package contracts: no import of jax or of the JAX package
(in a fresh interpreter that blocks them, and in the source), the kernel
wrappers' CPU behaviour and launch counters, "auto" resolution, the entry
points on the card by default with no silent fallback from CUDA to the CPU,
the serving modes generating, and the options not ported yet raising."""

import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer, M2SNetTrainer
from conductor_tpu_torch.config import (
    Config,
    DenoiserConfig,
    DiffusionConfig,
    TrainConfig,
    resolve_auto,
)
from conductor_tpu_torch.interop import reference_state_dict, synthetic_state_dict
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN
from conductor_tpu_torch.ops import (
    conv3x3_dkernel,
    decoder_layer_bwd,
    fused_conv_block,
    fused_decoder_layer,
    fused_decoder_stack,
    fused_frozen_stgcn,
    fused_linear_attention,
    fused_max_pool,
    launch_counts,
    max_pool_bwd,
    pack_frozen_stgcn,
    quantize_rows,
    reset_launch_counts,
    sampler_epilogue,
    sampler_prologue,
)
from conductor_tpu_torch.eval.stage1 import M2SNetEvaluator
from conductor_tpu_torch.train.m2snet_trainer import resolve_impls

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = Config(
    denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2, num_heads=4),
    diffusion=DiffusionConfig(steps=8, schedule="cosine"),
)

_NO_JAX = """
import dataclasses, importlib.abc, sys

BLOCKED = ("jax", "jaxlib", "flax", "optax", "conductor_tpu")

class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError("blocked: " + name)

sys.meta_path.insert(0, Block())
import torch
import conductor_tpu_torch
from conductor_tpu_torch import DDPMTrainer, M2SGANTrainer, M2SNetTrainer
from conductor_tpu_torch.config import Config, DenoiserConfig, DiffusionConfig, TrainConfig
from conductor_tpu_torch.interop import synthetic_m2snet_state_dict, synthetic_state_dict
cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2,
                                     num_heads=4, layer_impl="pallas_fused",
                                     music_encoder_impl="pallas"),
             diffusion=DiffusionConfig(steps=4, schedule="cosine"))
tr = DDPMTrainer(cfg, device="cpu")
tr.load_reference_state_dict(synthetic_state_dict(tr.model))
out = tr.generate(torch.rand(1, 96, 128), generator=torch.Generator().manual_seed(0))
assert out.shape == (1, 32, 26), out.shape
out = tr.generate(torch.rand(1, 96, 128), guidance_scale=2.5, sampler="ancestral",
                  generator=torch.Generator().manual_seed(0))
assert out.shape == (1, 32, 26), out.shape
import conductor_tpu_torch.cli.test_unseen, conductor_tpu_torch.cli.visualize
cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, train_layer_impl="pallas_fused"),
                  train=TrainConfig(feat_impl="pallas"))
tr = DDPMTrainer(cfg, device="cpu")
assert tr.feat_pack is not None
m = tr.train_step(torch.rand(2, 96, 128), torch.rand(2, 32, 13, 2),
                  generator=torch.Generator().manual_seed(0))
assert torch.isfinite(m["loss"]), m
cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, train_layer_impl="auto",
                                               compute_dtype="bfloat16", attention_impl="pallas"),
                  train=TrainConfig(replicate_reference_mask=True))
tr = DDPMTrainer(cfg, device="cpu")
assert tr.cfg.denoiser.train_layer_impl == "flax"
m = tr.train_step(torch.rand(2, 96, 128), torch.rand(2, 32, 13, 2), torch.tensor([10, 40]),
                  generator=torch.Generator().manual_seed(0))
assert torch.isfinite(m["loss"]), m
s1 = M2SNetTrainer(sample_length=6, clip_length=2, music_conv_impl="pallas_train", device="cpu")
s1.load_reference_state_dict(synthetic_m2snet_state_dict(s1.model))
m = s1.train_step(torch.rand(2, 540, 128), torch.rand(2, 180, 13, 2), "hard", starts=(0, 120))
assert torch.isfinite(m["loss"]), m
gan = M2SGANTrainer(sample_length=6, critic_iters=1, sync_encoder_impl="pallas",
                    sync_encoder_dtype="bfloat16", device="cpu")
gan.load_reference_state_dict(m2snet=synthetic_m2snet_state_dict(s1.model))
m = gan.train_step(torch.rand(2, 540, 128), torch.rand(2, 180, 13, 2),
                   generator=torch.Generator().manual_seed(0))
assert all(bool(torch.isfinite(v)) for v in m.values()), m
cfg = Config(denoiser=DenoiserConfig(num_frames=32, latent_dim=32, ff_size=16, num_layers=2,
                                     num_heads=4, dropout=0.1),
             diffusion=DiffusionConfig(steps=4, schedule="cosine"))
tr = DDPMTrainer(cfg, device="cpu")
m = tr.train_step(torch.rand(2, 96, 128), torch.rand(2, 32, 13, 2),
                  generator=torch.Generator().manual_seed(0))
assert torch.isfinite(m["loss"]), m
import conductor_tpu_torch.cli.evaluate, conductor_tpu_torch.cli.evaluate_protocol
import conductor_tpu_torch.cli.serving_delta_ci, conductor_tpu_torch.eval.protocol
from conductor_tpu_torch.eval import DiffusionEvaluator
from conductor_tpu_torch.prospective import ProspectiveEvaluator
assert DiffusionEvaluator(tr).batch_size == 8
import conductor_tpu_torch.parallel
from conductor_tpu_torch.parallel import Mesh, cp_linear_attention, init_from_env
assert init_from_env(None, "cpu")[0] == Mesh()
import conductor_tpu_torch.cli.export_torch, conductor_tpu_torch.cli.import_torch
from conductor_tpu_torch.models.generator import Generator, GeneratorCVPRLSTM
from conductor_tpu_torch.models.stgcn import STGCN
from conductor_tpu_torch.prospective import CNNLSTMGenerator
from conductor_tpu_torch.utils import flops, profiling
from conductor_tpu_torch.diffusion import make_schedule, training_losses
x = torch.rand(1, 30, 26)
g = Generator(decoder_kind="bilstm")
assert g(torch.rand(1, 90, 128), torch.rand(1, 1, 8)).shape == (1, 30, 13, 2)
assert GeneratorCVPRLSTM()(torch.rand(1, 30, 20)).shape == (1, 30, 13, 2)
assert STGCN(mode="AE")(torch.rand(1, 30, 13, 2)).shape == (1, 16, 5, 13)
assert CNNLSTMGenerator()(torch.rand(1, 90, 128)).shape == (1, 30, 13, 2)
loss = training_losses(make_schedule("cosine", 4), lambda x, t: torch.cat([x, x], -1), x,
                       torch.tensor([1]), torch.randn(1, 30, 26), loss_type="kl",
                       var_type="learned_range")["loss"]
assert bool(torch.isfinite(loss).all()), loss
import numpy as np
import conductor_tpu_torch.t2m, conductor_tpu_torch.t2m.dataset, conductor_tpu_torch.t2m.plot_3d
from conductor_tpu_torch.t2m import param_util
from conductor_tpu_torch.t2m.evaluator_models import T2MEvaluatorWrapper
from conductor_tpu_torch.t2m.motion_process import process_file
from conductor_tpu_torch.t2m.skeleton import Skeleton
ev = T2MEvaluatorWrapper("t2m", device="cpu")
ev.init(torch.Generator().manual_seed(0))
assert ev.get_motion_embeddings(torch.rand(1, 16, 263), [16]).shape == (1, 512)
sk = Skeleton(param_util.t2m_raw_offsets, param_util.t2m_kinematic_chain)
sk.set_offset(param_util.t2m_raw_offsets * 0.25)
q = torch.nn.functional.normalize(torch.tensor([1.0, 0, 0, 0]) + 0.05 * torch.randn(6, 22, 4), dim=-1)
data = process_file(sk.forward_kinematics(q, torch.rand(6, 3)).numpy(), 0.002,
                    param_util.t2m_raw_offsets * 0.25, param_util.t2m_raw_offsets,
                    param_util.t2m_kinematic_chain, device="cpu")[0]
assert data.shape == (5, 263) and bool(np.isfinite(data).all()), data.shape
sys.path.insert(0, "scripts")
import multiprocess_check_torch, music_encoder_batch_torch, run_1000ladder_torch, run_e2e_demo_torch
bad = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
assert not bad, bad
print("no-jax-ok")
"""


def test_package_never_imports_jax():
    """In a fresh interpreter, with jax, flax and the JAX package
    (`conductor_tpu`, that top-level name alone) blocked, the package
    imports, serves a clip (also with guidance on the ancestral sampler),
    imports the serving CLIs, takes a stage-2 training step (K5 / K6 / K7
    path) and one with the reference mask (bf16 modules, K8 path), a
    stage-1 M2SNet step (K4 / K9 / K10 / K11 path), an M2SGAN step
    (SyncLoss on K7) and a stage-2 step with denoiser dropout on the CPU,
    and imports the evaluation modules and CLIs, the distributed layer
    (`parallel`) and the port's scripts (the demo, the 1000-step ladder,
    the multiprocess check, the batch-invariance probe); imports the
    reference import / export CLIs, the profiling and FLOP modules, and
    runs what once raised: the BiLSTM generators, the "AE" ST-GCN, the
    CNN-LSTM baseline and the engine's KL loss under a learned variance."""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", _NO_JAX], capture_output=True, text=True,
                          cwd=REPO, env=env, timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "no-jax-ok" in proc.stdout


def _imported_modules(path: Path) -> list[str]:
    names = []
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.append(node.module)
    return names


def test_no_source_imports_jax_or_the_jax_package():
    """Every module of the port, chip_smoke.py and the port's scripts
    (`scripts/*_torch.py`), read as source: no import of jax, jaxlib,
    flax, optax or conductor_tpu, at any depth."""
    files = sorted(Path(REPO, "conductor_tpu_torch").rglob("*.py")) + [Path(REPO, "chip_smoke.py")]
    files += sorted(Path(REPO, "scripts").glob("*_torch.py"))  # the port's scripts
    assert len([f for f in files if f.parent.name == "scripts"]) >= 3
    assert len(files) > 20
    bad = [(str(f.relative_to(REPO)), name) for f in files for name in _imported_modules(f)
           if name.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "conductor_tpu")]
    assert not bad, bad


def test_wrappers_take_the_plain_path_on_cpu():
    """On CPU tensors every kernel wrapper runs its plain version and leaves
    its launch counter at 0."""
    reset_launch_counts()
    rng = np.random.RandomState(0)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    fused_conv_block(t(1, 6, 16, 1), t(3, 3, 1, 16), t(16), t(16), pool=None)
    fused_decoder_stack(t(1, 5, 32), t(1, 5, 64), t(1, 1, 32, 32), t(1, 9, 32, 32),
                        t(1, 24, 32), t(1, 64, 192), t(1, 192), 4)
    h, _, _ = sampler_prologue(t(1, 5, 26), t(64), t(1, 5, 64), t(26, 32), t(5, 32))
    sampler_epilogue(h, t(1, 5, 26), t(32, 26), t(26), 0.5, 0.5)
    layer = (t(1, 5, 32), t(1, 5, 64), t(1, 32, 32), t(9, 32, 32), t(24, 32), t(64, 192), t(192))
    fused_decoder_layer(*layer, 4)
    decoder_layer_bwd(*layer, t(1, 5, 32), 4)
    motion = t(1, 5, 13, 2).requires_grad_(True)
    fused_frozen_stgcn(motion, pack_frozen_stgcn(MotionEncoderSTGCN().eval())).sum().backward()
    assert motion.grad is not None
    fused_conv_block(t(1, 6, 16, 16), t(3, 3, 16, 16), t(16), t(16), relu=False, edge="zero")
    fused_conv_block(t(1, 6, 16, 16), t(3, 3, 16, 16), t(16), t(16), res_mode=1,
                     pool=((3, 3), (1, 2), ((1, 1), (1, 1))), mxu_dtype=torch.float32)
    conv3x3_dkernel(t(1, 6, 16, 16), t(1, 6, 16, 32))
    pool = ((5, 5), (1, 2), ((2, 2), (2, 2)))
    x = t(1, 6, 16, 16)
    max_pool_bwd(x, fused_max_pool(x, pool), pool)
    q = t(1, 5, 32).requires_grad_(True)
    fused_linear_attention(q, t(1, 5, 32), t(1, 5, 32), 2, torch.ones(1, 5, 1)).sum().backward()
    assert q.grad is not None
    emb_q, emb_s = quantize_rows(t(1, 5, 64))
    aw_q, aw_s = quantize_rows(t(1, 192, 64))
    fused_decoder_stack(t(1, 5, 32), emb_q, t(1, 1, 32, 32), t(1, 9, 32, 32), t(1, 24, 32),
                        aw_q.transpose(1, 2), t(1, 192), 4, vpu_dtype=torch.bfloat16,
                        emb_scale=emb_s, adaln_w_scale=aw_s.transpose(1, 2))
    sampler_prologue(t(1, 5, 26), t(64), t(1, 5, 64), t(26, 32), t(5, 32), quantize_emb=True)
    assert launch_counts() == {"decoder_stack": 0, "decoder_stack_int8": 0,
                               "decoder_stack_vpu_bf16": 0, "sampler_prologue": 0,
                               "sampler_prologue_int8": 0,
                               "sampler_epilogue": 0, "conv_block": 0,
                               "decoder_layer": 0, "decoder_layer_bwd": 0,
                               "stgcn_forward": 0, "stgcn_backward": 0,
                               "conv3x3_dkernel": 0, "max_pool": 0, "max_pool_bwd": 0,
                               "linear_attention": 0, "conv_block_f32": 0,
                               "conv3x3_dkernel_f32": 0, "max_pool_f32": 0,
                               "max_pool_bwd_f32": 0, "decoder_stack_f32": 0,
                               "decoder_stack_f32_int8": 0, "decoder_stack_f32_vpu_bf16": 0,
                               "sampler_prologue_f32": 0, "sampler_prologue_f32_int8": 0,
                               "sampler_epilogue_f32": 0, "decoder_layer_f32": 0,
                               "decoder_layer_bwd_f32": 0, "stgcn_forward_f32": 0,
                               "stgcn_backward_f32": 0}


def test_auto_resolution():
    cfg = Config()
    cpu = resolve_auto(cfg, "cpu").denoiser
    assert (cpu.layer_impl, cpu.music_encoder_impl, cpu.compute_dtype) == ("flax", "flax", "float32")
    cuda = resolve_auto(cfg, "cuda").denoiser
    assert (cuda.layer_impl, cuda.music_encoder_impl, cuda.compute_dtype) == (
        "pallas_fused", "pallas", "bfloat16")
    assert resolve_auto(resolve_auto(cfg, "cuda"), "cpu") == resolve_auto(cfg, "cuda")
    pinned = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, layer_impl="flax"))
    assert resolve_auto(pinned, "cuda").denoiser.layer_impl == "flax"
    # the training knobs: kernels on CUDA unless dropout or the reference
    # mask rule them out; the perceptual ST-GCN on its kernel (K7) on CUDA
    # in either compute dtype, plain elsewhere
    assert resolve_auto(cfg, "cuda").denoiser.train_layer_impl == "pallas_fused"
    assert resolve_auto(cfg, "cpu").denoiser.train_layer_impl == "flax"
    assert resolve_auto(cfg, "cuda").train.feat_impl == "pallas"
    assert resolve_auto(cfg, "cpu").train.feat_impl == "flax"
    f32 = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, compute_dtype="float32"))
    assert resolve_auto(f32, "cuda").train.feat_impl == "pallas"
    assert resolve_auto(f32, "cpu").train.feat_impl == "flax"
    for change in (dict(denoiser=dataclasses.replace(cfg.denoiser, dropout=0.1)),
                   dict(train=dataclasses.replace(cfg.train, replicate_reference_mask=True))):
        assert resolve_auto(cfg.replace(**change), "cuda").denoiser.train_layer_impl == "flax"
    # the standalone attention: K8 on CUDA, the module math elsewhere
    assert resolve_auto(cfg, "cuda").denoiser.attention_impl == "pallas"
    assert resolve_auto(cfg, "cpu").denoiser.attention_impl == "xla"


def test_cuda_trainer_without_a_card_raises():
    """No silent CPU fallback: asking for the card without one raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DDPMTrainer(TINY, device="cuda")


@pytest.mark.parametrize("make", [lambda: DDPMTrainer(TINY), lambda: M2SNetTrainer(),
                                  lambda: M2SGANTrainer()])
def test_trainers_run_on_the_card_by_default(make):
    """The entry points take the card unless the caller asks for the CPU:
    without one, the default raises."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        make()


@pytest.mark.parametrize("cli", ["evaluate", "evaluate_protocol", "serving_delta_ci"])
def test_eval_entry_points_run_on_the_card_by_default(cli, tmp_path):
    """The evaluation CLIs (and `serving_delta_ci.sweep`) take the card
    unless ``--device cpu``: without one, the default raises where the
    run's trainer is built."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import importlib

    TINY.save(str(tmp_path / "config.json"))
    mod = importlib.import_module(f"conductor_tpu_torch.cli.{cli}")
    with pytest.raises(RuntimeError, match="CUDA"):
        if cli == "serving_delta_ci":
            mod.sweep(str(tmp_path), str(tmp_path / "data"), clips=1, seeds=1)
        else:
            extra = ["--m2snet_ckpt", str(tmp_path)] if cli == "evaluate_protocol" else []
            mod.main(["--run_dir", str(tmp_path), "--data_root", str(tmp_path), *extra])


@pytest.mark.parametrize("kwargs,error", [
    (dict(microbatch=0), ValueError),  # a positive number of chunks
    (dict(compute_dtype="float16"), ValueError),  # float32 and bfloat16 only
    (dict(music_conv_impl="xla"), ValueError),
])
def test_m2snet_trainer_unported_options_raise(kwargs, error):
    with pytest.raises(error):
        M2SNetTrainer(sample_length=6, clip_length=2, device="cpu", **kwargs)


def test_m2snet_trainer_resolves_auto_and_defers():
    """"auto" is the kernel path on CUDA (bf16, "pallas_train") and the
    plain one elsewhere; the kernels have a float32 mode, so an explicit
    "pallas_train" with float32 is accepted on CUDA, as in JAX (checked
    where no card is needed), and runs the plain versions on the CPU.  The
    options once deferred run: recalibration refuses only an empty list,
    the evaluator takes the trainer."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert resolve_impls("auto", "auto", cuda) == ("bfloat16", "pallas_train")
    assert resolve_impls("auto", "auto", cpu) == ("float32", "lax")
    assert resolve_impls("float32", "pallas_train", cuda) == ("float32", "pallas_train")
    assert resolve_impls("float32", "pallas_train", cpu) == ("float32", "pallas_train")
    tr = M2SNetTrainer(sample_length=6, clip_length=2, device="cpu")
    assert (tr.compute_dtype, tr.music_conv_impl) == ("float32", "lax")
    with pytest.raises(ValueError, match="at least one batch"):
        tr.recalibrate_batch_stats([])
    assert M2SNetEvaluator(tr).trainer is tr


@pytest.mark.parametrize("denoiser,feat_impl,names", [
    # "auto" on CUDA: the fused sampler (float32 on K1 / K2 / K3), the
    # fused training layers (K5 / K6) and the perceptual term on K7, all
    # in their float32 modes: builds
    ({}, "auto", ()),
    # the fused sampler in float32 with the plain training layers: builds
    (dict(train_layer_impl="flax"), "flax", ()),
    # the plain serving layers, K5 / K6 in float32 and the plain ST-GCN: builds
    (dict(layer_impl="flax"), "flax", ()),
    # K7's float32 mode asked for beside the plain layers: builds
    (dict(layer_impl="flax", train_layer_impl="flax"), "pallas", ()),
    # float32 at a width the decoder kernels do not take (D = 256): K1-K3
    # and K5 / K6 are named, K7 (which takes every denoiser width) is not
    (dict(latent_dim=256, num_heads=8), "auto", ("K1 / K2 / K3", "K5 / K6")),
])
def test_float32_config_on_unported_kernels_raises_at_construction(denoiser, feat_impl, names):
    """A float32 config that resolves on CUDA to a kernel that cannot take
    it is refused where the trainer is built, naming that kernel and the
    knobs that run (checked where no card is needed, as
    `_check_training_config` takes the device).  Every kernel has its
    float32 mode (K1 / K2 / K3, K4, K5 / K6, K7), so a float32 config at
    the kernels' widths passes in every mix of fused and plain modules;
    only the model widths the kernels are not built for (F12) are refused.
    The CPU takes every knob."""
    from conductor_tpu_torch.train.ddpm_trainer import _check_training_config

    cfg = Config(denoiser=DenoiserConfig(compute_dtype="float32", **denoiser),
                 train=TrainConfig(feat_impl=feat_impl))
    if names:
        with pytest.raises(ValueError, match="would fail at the first call") as err:
            _check_training_config(resolve_auto(cfg, "cuda"), torch.device("cuda"))
        assert all(name in str(err.value) for name in names), str(err.value)
        assert all(name not in str(err.value)
                   for name in {"K1 / K2 / K3", "K5 / K6", "K7", "K8"} - set(names)), str(err.value)
        assert "train_layer_impl='flax'" in str(err.value)
    else:
        resolved = resolve_auto(cfg, "cuda")
        _check_training_config(resolved, torch.device("cuda"))
        assert resolved.train.feat_impl == ("pallas" if feat_impl == "auto" else feat_impl)
    _check_training_config(resolve_auto(cfg, "cpu"), torch.device("cpu"))
    runs = Config(denoiser=DenoiserConfig(compute_dtype="float32", layer_impl="flax",
                                          train_layer_impl="flax", music_encoder_impl="pallas"),
                  train=TrainConfig(feat_impl="flax"))
    _check_training_config(resolve_auto(runs, "cuda"), torch.device("cuda"))


def test_train_cli_float32_resolves_to_the_fused_layers_on_cuda():
    """`cli.train --compute_dtype float32` at its other defaults resolves on
    "cuda" to the fused layers (K1 serving, K5 / K6 training, K4's music
    encoder) and the perceptual ST-GCN (K7) in float32, and passes the
    trainer's construction checks (where no card is needed); ``--faithful``
    still pins the plain modules."""
    from conductor_tpu_torch.cli.train import build_argparser, config_from_args
    from conductor_tpu_torch.train.ddpm_trainer import _check_training_config

    argv = ["--data_root", "unused", "--compute_dtype", "float32"]
    cfg = config_from_args(build_argparser().parse_args(argv), torch.device("cuda"))
    d = cfg.denoiser
    assert (d.compute_dtype, d.layer_impl, d.train_layer_impl, d.music_encoder_impl,
            cfg.train.feat_impl) == ("float32", "pallas_fused", "pallas_fused", "pallas", "pallas")
    _check_training_config(cfg, torch.device("cuda"))
    faithful = config_from_args(build_argparser().parse_args(argv + ["--faithful"]),
                                torch.device("cuda"))
    assert (faithful.denoiser.train_layer_impl, faithful.train.feat_impl) == ("flax", "flax")


@pytest.mark.parametrize("mxu", [torch.bfloat16, torch.float32])
def test_layer_kernel_operands_keep_the_mode_dtype(mxu):
    """The operands K5 and K6 take (`kernel_operands`, what their wrappers
    hand the C entry points): in float32 mode the weight banks and the
    cotangent stay float32, unrounded; in bf16 mode the matrices and dy are
    rounded to bf16 and the vectors stay float32; inputs of another dtype
    than the mode's, or of shapes the kernels do not take, raise."""
    from conductor_tpu_torch.ops.decoder_layer import kernel_operands

    rng = np.random.RandomState(3)

    def t(*shape, dtype=torch.float32):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(dtype)

    layer = (t(2, 64, 128, dtype=mxu), t(2, 64, 512, dtype=mxu), t(2, 128, 128, dtype=mxu),
             t(9, 128, 128), t(24, 128), t(512, 768), t(768))
    dy = t(2, 64, 128)
    ops = kernel_operands(*layer, 8, mxu_dtype=mxu, dy=dy)
    assert {k: v.dtype for k, v in ops.items()} == {
        "x": mxu, "emb_act": mxu, "kv_cross": mxu, "mats": mxu, "vecs": torch.float32,
        "adaln_w": mxu, "adaln_b": torch.float32, "dy": mxu}
    for name, src in (("mats", layer[3]), ("adaln_w", layer[5]), ("dy", dy)):
        assert torch.equal(ops[name], src.to(mxu)), name
        assert torch.equal(ops[name].float(), src) == (mxu == torch.float32), name
    assert all(v.is_contiguous() for v in ops.values())
    other = torch.float32 if mxu == torch.bfloat16 else torch.bfloat16
    with pytest.raises(ValueError):
        kernel_operands(layer[0].to(other), *layer[1:], 8, mxu_dtype=mxu)
    with pytest.raises(ValueError):
        kernel_operands(layer[0], layer[1], layer[2].to(other), *layer[3:], 8, mxu_dtype=mxu)
    with pytest.raises(ValueError):
        kernel_operands(*layer[:5], t(512, 640), layer[6], 8, mxu_dtype=mxu)


_PLAIN = dict(layer_impl="flax", train_layer_impl="flax")


@pytest.mark.parametrize("widths,extra,names", [
    # D = 256, 8 heads, on "auto": the fused sampler and training layers
    (dict(latent_dim=256, num_heads=8), {}, ("K1 / K2 / K3", "K5 / K6")),
    # D = 128, 2 heads (head width 64): the same
    (dict(num_heads=2), {}, ("K1 / K2 / K3", "K5 / K6")),
    # D = 256, 2 heads (head width 128): K8 wherever the plain layers run
    (dict(latent_dim=256, num_heads=2), dict(replicate_reference_mask=True, **_PLAIN), ("K8",)),
    (dict(latent_dim=256, num_heads=2), _PLAIN, ("K8",)),
    # an FFN wider than D on the fused layers (F13), which JAX refuses too
    (dict(latent_dim=32, ff_size=64, num_heads=4), {}, ("ff_size=64 > latent_dim=32",)),
])
def test_unported_widths_raise_at_construction(widths, extra, names):
    """A model width the port's kernels do not take is refused on CUDA where
    the trainer is built, naming the kernels the config would reach and the
    knobs that run it on the plain modules; the same config builds on the
    CPU, and on CUDA with those knobs pinned.  An FFN wider than D on the
    fused layers names the two layer knobs."""
    from conductor_tpu_torch.train.ddpm_trainer import _check_training_config

    layer = {k: v for k, v in extra.items() if k in _PLAIN}
    train = {k: v for k, v in extra.items() if k == "replicate_reference_mask"}
    cfg = Config(denoiser=DenoiserConfig(**widths, **layer), train=TrainConfig(**train))
    with pytest.raises(ValueError, match="would fail at the first call") as err:
        _check_training_config(resolve_auto(cfg, "cuda"), torch.device("cuda"))
    msg = str(err.value)
    assert all(name in msg for name in names), msg
    assert all(name not in msg for name in {"K1 / K2 / K3", "K5 / K6", "K8"} - set(names)), msg
    knobs = ("layer_impl='flax'", "train_layer_impl='flax'")
    if "ff_size" not in names[0]:
        knobs += ("attention_impl='xla'",)
    assert all(knob in msg for knob in knobs), msg
    _check_training_config(resolve_auto(cfg, "cpu"), torch.device("cpu"))
    DDPMTrainer(cfg, device="cpu")
    plain = cfg.replace(denoiser=dataclasses.replace(
        cfg.denoiser, layer_impl="flax", train_layer_impl="flax", attention_impl="xla"))
    _check_training_config(resolve_auto(plain, "cuda"), torch.device("cuda"))


@pytest.mark.parametrize("field,value", [("sampler_adaln_int8", True),
                                         ("sampler_vpu_dtype", "bfloat16")])
def test_sampler_modes_generate(field, value):
    """Each serving mode of K1 / K2 builds a trainer and generates a finite
    motion at TINY: on the flax layer path ("auto" on the CPU) the flag is
    ignored, as in JAX; on the fused path it packs and runs its mode."""
    cfg = TINY.replace(denoiser=dataclasses.replace(TINY.denoiser, **{field: value}))
    mel, noise = torch.rand(1, 96, 128), torch.randn(1, 32, 26)
    flax_tr = DDPMTrainer(cfg, device="cpu")
    assert flax_tr.fused is None
    flax_tr.load_reference_state_dict(synthetic_state_dict(flax_tr.model, seed=1))
    fused_cfg = cfg.replace(denoiser=dataclasses.replace(cfg.denoiser, layer_impl="pallas_fused"))
    fused_tr = DDPMTrainer(fused_cfg, device="cpu")
    fused_tr.load_reference_state_dict(flax_tr.model.state_dict())
    assert (fused_tr.fused.adaln_w.dtype == torch.int8) == (field == "sampler_adaln_int8")
    for tr in (flax_tr, fused_tr):
        out = tr.generate(mel, num_steps=4, noise=noise)
        assert out.shape == (1, 32, 26) and bool(torch.isfinite(out).all())


@pytest.mark.parametrize("kwargs", [{"diffusion": {"loss_type": "kl"}},
                                    {"diffusion": {"var_type": "learned_range"}}])
def test_unported_generate_options_raise(kwargs):
    """The trainer refuses, where it is built, the KL loss and the learned
    variances, as JAX's trainer does: its 5-term objective is the MSE
    family's over a fixed variance.  The engine takes them
    (tests/test_torch_port_engine.py); guidance, the ancestral sampler and
    denoiser dropout, once listed here, are ported
    (tests/test_torch_port_serving_modes.py, tests/test_torch_port_dropout.py)."""
    cfg = TINY.replace(**{sec: dataclasses.replace(getattr(TINY, sec), **kw)
                          for sec, kw in kwargs.items()})
    with pytest.raises(NotImplementedError):
        DDPMTrainer(cfg, device="cpu")


def test_generate_rejects_wrong_mel_bins():
    tr = DDPMTrainer(TINY, device="cpu")
    with pytest.raises(ValueError, match="mel must be"):
        tr.generate(torch.zeros(1, 96, 80))


def test_reference_state_dict_forms(tmp_path):
    """DataParallel prefixes are stripped, a latest.tar-style dict contributes
    its encoder entry, and a file path loads; the load is strict."""
    tr = DDPMTrainer(TINY, device="cpu")
    sd = synthetic_state_dict(tr.model, seed=3)
    wrapped = {"encoder": {f"module.{k}": torch.from_numpy(np.array(v)) for k, v in sd.items()},
               "ep": 1, "total_it": 2}
    path = tmp_path / "latest.tar"
    torch.save(wrapped, path)
    got = reference_state_dict(str(path))
    assert set(got) == set(sd)
    tr.load_reference_state_dict(str(path))
    np.testing.assert_array_equal(tr.model.out.weight.detach().numpy(), sd["out.weight"])
    with pytest.raises(RuntimeError):
        tr.load_reference_state_dict({k: v for k, v in sd.items() if k != "out.bias"})


def _stage2_step():
    tr = DDPMTrainer(TINY, device="cpu")
    tr.load_reference_state_dict(synthetic_state_dict(tr.model))
    return tr.model.music_encoder, lambda: tr.train_step(
        torch.rand(2, 96, 128), torch.rand(2, 32, 13, 2), generator=torch.Generator().manual_seed(0))


def _stage1_step():
    tr = M2SNetTrainer(sample_length=6, clip_length=2, device="cpu")
    return tr.model.music_encoder, lambda: tr.train_step(
        torch.rand(2, 540, 128), torch.rand(2, 180, 13, 2), "easy", starts=(0,))


@pytest.mark.parametrize("make", [_stage2_step, _stage1_step], ids=["stage2", "stage1"])
def test_float32_steps_run_without_tf32_and_restore_the_flags(make, monkeypatch):
    """With both TF32 flags set by the caller, a float32 step's music
    encoder runs with them off (cuDNN would otherwise take float32
    convolutions in TF32 on a card), and the caller's flags are back after
    the step."""
    for flags in (torch.backends.cudnn, torch.backends.cuda.matmul):
        monkeypatch.setattr(flags, "allow_tf32", True)
    encoder, step = make()
    seen = []
    encoder.register_forward_hook(lambda *_: seen.append(
        (torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32)))
    step()
    assert seen and set(seen) == {(False, False)}
    assert torch.backends.cudnn.allow_tf32 and torch.backends.cuda.matmul.allow_tf32


def test_bound_prices_products_at_the_rate_of_their_type():
    """`kernel_checks.bound` prices a float32 product at the card's float32
    rate outside the tensor cores (67 TFLOP/s: K4's and K9's float32
    modes), a bf16 one at the bf16 tensor-core rate (989 TFLOP/s) as
    before, and int8 at 1,979 TOP/s; bytes at 3.35 TB/s."""
    from conductor_tpu_torch.kernel_checks import bound

    x = torch.zeros(1024)  # 4 KB: far below the products' time
    f32 = bound([x], [], 67 * 10**9, product_dtype=torch.float32)
    bf16 = bound([x], [], 989 * 10**9)
    int8 = bound([x], [], 1979 * 10**9, int8_ops=1979 * 10**9)
    for r in (f32, bf16, int8):
        assert r["ops_ms"] == pytest.approx(1.0) and r["bound_by"] == "operations"
        assert r["bound_ms"] == r["ops_ms"]
    assert bound([x], [], 989 * 10**9, product_dtype=torch.bfloat16) == bf16
    mem = bound([torch.zeros(3350 * 10**3 // 4)], [], 0, product_dtype=torch.float32)
    assert mem["bytes_ms"] == pytest.approx(1e-3) and mem["bound_by"] == "bytes"


def test_stack_flops_counts_what_k1_needs():
    """`kernel_checks.stack_flops` is the plain K1's FLOP count less its
    head sums: with one head (k^T v and q @ KV then span all of D, as the
    plain version computes them) and ff = D (no FFN padding), the two
    block-diagonal products of each layer are all that differ; with 8
    heads and ff = D / 2 it counts those products at their own widths."""
    from conductor_tpu_torch.kernel_checks import flops, stack_flops
    from conductor_tpu_torch.ops.decoder_stack import decoder_stack_plain

    b, t, d, e, n_layers = 2, 5, 16, 32, 2
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (
        (b, t, d), (b, t, e), (n_layers, b, d, d), (n_layers, 9, d, d), (n_layers, 24, d),
        (n_layers, e, 6 * d), (n_layers, 6 * d))]
    rows = b * t
    plain = flops(lambda: decoder_stack_plain(*args, 1))
    assert stack_flops((*args, 1), d) == plain - n_layers * 2 * (2 * rows * d * d)
    per_layer = 7 * d * d + 2 * d * (d // 2) + 3 * d * (d // 8)
    assert stack_flops((*args, 8), d // 2) == 2 * rows * n_layers * (e * 6 * d + per_layer)


def test_layer_bwd_flops_counts_what_k6_needs():
    """`kernel_checks.layer_bwd_flops` is three of K5's forwards
    (`layer_flops`, `stack_flops` of one layer): the recomputed forward and
    two products for each of its products.  With one head and ff = D it is
    the plain K6's FLOP count less its head sums: the forward's two
    block-diagonal products and, in the backward, the one product each
    takes for the gradient of its non-constant operand."""
    from conductor_tpu_torch.kernel_checks import flops, layer_bwd_flops, layer_flops
    from conductor_tpu_torch.ops.decoder_layer_bwd import decoder_layer_bwd_plain

    b, t, d, e = 2, 5, 16, 32
    rng = np.random.RandomState(0)
    args = [torch.from_numpy(rng.randn(*s).astype(np.float32)) for s in (
        (b, t, d), (b, t, e), (b, d, d), (9, d, d), (24, d), (e, 6 * d), (6 * d,))]
    dy = torch.from_numpy(rng.randn(b, t, d).astype(np.float32))
    head_sums = 2 * (2 * b * t * d * d)
    plain = flops(lambda: decoder_layer_bwd_plain(*args, dy, 1))
    assert layer_bwd_flops((*args, 1), d) == plain - 2 * head_sums
    assert layer_bwd_flops((*args, 8), d // 2) == 3 * layer_flops((*args, 8), d // 2)
    per_layer = 7 * d * d + 2 * d * (d // 2) + 3 * d * (d // 8)
    assert layer_flops((*args, 8), d // 2) == 2 * b * t * (e * 6 * d + per_layer)
