"""Each CUDA kernel against its plain PyTorch version, on the card, on the
inputs the main paths give it.

`check_kernels` takes a `DDPMTrainer` on the kernel path, a mel and an x_T
on the card, rebuilds the first ladder step's kernel inputs from them
(the real conditioning, the real encoder activations), and runs every
serving kernel (K1-K4) and its plain version on the same inputs, K1 in
its bf16-VPU mode too, and K2 and K1 in the int8-AdaLN mode on the int8
operands of that step, with K1's AdaLN GEMM alone in both its modes at
the shape K1 launches it (`check_stack_kernels`), and K4 on the encoder's
7 blocks, a repeat bit-identical (`check_conv_blocks`); both also run alone
at other batch sizes; on a trainer with ``compute_dtype="float32"`` the
same checks run the float32 modes (the ``_f32`` names: K2 with float32
emb_act, K1 alone, with bf16 VPU and with int8 AdaLN, its float32 GEMM, and
K3), held to F32_REL_TOL (K1's bf16-VPU mode as `_check_vpu_mode` says) and
priced at the float32 rate.  K2 (both modes) and K3 (`check_sampler_glue`) also
report their device ms by launch, one launch a call, a repeat
bit-identical and the tiling `ops.sampler_glue.plan` computes against the
kernel's own, and run again at B = 8 against their bars
(`K2_K3_BAR_DEVICE_MS`).  `device_ms` reads device time from `torch.profiler`,
by kernel name (`k1_launch_split`: K1's device time by launch).
`check_train_kernels` does the same for the training layer kernels (K5,
K6) on layer 0 of a training forward (on a float32 trainer their float32
modes, ``decoder_layer_f32`` and ``decoder_layer_bwd_f32``, held to
F32_REL_TOL and priced at the float32 rate), `check_stgcn_kernels` for K7 on
the perceptual term's inputs (`perceptual_inputs`; over a float32 pack its
float32 mode, ``stgcn_forward_f32`` and ``stgcn_backward_f32``) and on the
M2SGAN SyncLoss's (`sync_loss_inputs`), and
`check_stage1_kernels` for the trainable music encoder's kernels (K9, K10,
K11, and K4 in its training modes, beside cuDNN's `F.conv2d`) on the
inputs and cotangents of its calls in one train-mode forward and
backward of a stage-1 step (`stage1_kernel_inputs`) or of an M2SGAN
generator step (`gan_encoder_kernel_inputs`), and
`check_attention_kernel` for K8 on q, k and v as its wrapper hands them
over, the key mask folded in.  For
each kernel it reports the largest absolute difference, the largest
absolute plain value (for a kernel with several outputs, those of the
output worst relative to its own scale, and every output's pair in
``parts``), whether the difference is within ``rel_tol`` of that value, the
time per call of both (CUDA events, after a warm-up call), ``bound_ms``,
the least time an H100 could take for the same work (`bound`), and
``library_ms``, the time of one PyTorch call computing the same function
where there is one (None otherwise; timed here, never called by the port).
Used by ``chip_smoke.py`` at the flagship shapes and by
``tests/test_torch_port_cuda.py`` at small ones.
"""

from __future__ import annotations

import dataclasses
import functools

import torch
import torch.nn.functional as F
from torch.utils.flop_counter import FlopCounterMode

from .diffusion import q_sample
from .ops import _build
from .ops import attention as attention_ops
from .ops import decoder_stack as stack_ops
from .ops.attention import (
    cluster_size,
    fold_key_mask,
    linear_attention_kernel,
    linear_attention_plain,
)
from .ops.conv_block import conv_block_plain, fused_conv_block
from .ops.conv_train import conv3x3_dkernel, conv3x3_dkernel_plain
from .ops.max_pool import (
    KERNEL_FWD_PLAN_KEYS,
    fused_max_pool,
    fwd_plan,
    kernel_fwd_plan,
    max_pool_bwd,
    max_pool_bwd_plain,
    max_pool_plain,
)
from .ops.decoder_layer import decoder_layer_plain, fused_decoder_layer
from .ops.decoder_layer_bwd import decoder_layer_bwd, decoder_layer_bwd_plain
from .ops.decoder_layer_bwd import kernel_plan as layer_bwd_kernel_plan
from .ops.decoder_layer_bwd import plan as layer_bwd_plan
from .ops.decoder_stack import (
    adaln_modulation,
    adaln_modulation_plain,
    decoder_stack_plain,
    fused_decoder_stack,
)
from .ops.sampler_glue import KERNEL_PLAN_KEYS as GLUE_PLAN_KEYS
from .ops.sampler_glue import (
    ddim_affine_tables,
    sampler_epilogue,
    sampler_epilogue_plain,
    sampler_prologue,
    sampler_prologue_plain,
)
from .ops.sampler_glue import kernel_plan as glue_kernel_plan
from .ops.sampler_glue import plan as glue_plan
from .ops.stgcn import (
    BLOCKS,
    KERNEL_PLAN_KEYS,
    WIDTH,
    frozen_stgcn_plain,
    kernel_plan,
    plan,
    stgcn_backward,
    stgcn_backward_plain,
    stgcn_forward,
    unpack_relu_masks,
)
from .train.fused_denoiser import (
    FusedDenoiser,
    cross_kv_state,
    pack_layer_weights,
    train_layer_inputs,
)

REL_TOL = 0.02  # the bound the JAX package holds its reduced-precision modes to
# the float32 modes of K4 and K9 within 1e-4 of their plain version's
# largest value: the same float32 products summed in another order (the
# JAX package holds its own float32 kernels to 1e-5 / 2e-5 absolute,
# tests/test_conv_train.py:47, 68, 73); K11's float32 mode within 1e-6
# (each dy goes to one place: only the order of the float32 sums of dy
# that meet in one dx moves it); K10's exact in both modes
F32_REL_TOL = 1e-4
K11_F32_REL_TOL = 1e-6
# K1's bf16-VPU mode moves its output 0.2 % of the largest value from the
# float32-VPU output at the serving shape (on an H100), well inside REL_TOL,
# so `vpu_mode_ok` holds it closer: the kernel within 0.2 % of its plain
# version's largest value (0.046 % measured there)
VPU_REL_TOL = 0.002
# an H100 SXM's published peaks (NVIDIA's data sheet): HBM3 bytes/s, dense
# bf16 tensor-core FLOP/s, dense int8 tensor-core OP/s and float32 FLOP/s
# outside the tensor cores; the products here take bf16 operands but K1's
# int8 AdaLN product, priced at the int8 rate so that quantization cannot
# flatter the bound (as JAX's utils/flops.py prices it at the int8 peak),
# and the float32 modes' products (K4, K9), priced at the float32 rate
# (`bound`'s ``product_dtype``): TF32 would round them
# traces `device_ms` and `launch_split` take before they give up on a
# profiler that keeps dropping records (3 did not do on an H100: a
# chip_smoke run died there on K1's int8 GEMM)
PROFILE_TRIES = 10
# the lead-in of every trace (`_traced`): two spin kernels of this many
# cycles, ~50 us each on an H100
SPIN_CYCLES = 100_000
# K11's bars over the three stage-1 pools at B = 10, summed: ms a call by
# CUDA events and device ms (within 2.7x of their 0.0559-ms byte bound)
K11_BAR_MS = 0.20
K11_BAR_DEVICE_MS = 0.15
# K10's bars over the same three pools' forwards, summed (byte bound 0.0321)
K10_BAR_MS = 0.10
K10_BAR_DEVICE_MS = 0.070
# K8's device-ms bars a call at its two paths' shapes: the reference-mask
# step (B = 32, T = 900, float32 k and v) and plain-layer serving (B = 2,
# T = 1800)
K8_BAR_DEVICE_MS = {"mask": 0.030, "serving": 0.012}
# K7's bar at B = 32, T = 900: ms a call by CUDA events, forward (the mean
# of its two calls) and backward each
K7_BAR_MS = 0.70
# the most ReLU mask bits K7's forward may set otherwise than the plain
# forward (flips between summation orders), a share of all its mask bits
K7_MASK_FLIP_SHARE = 1e-3
# K2's (bf16 and int8 emb_act) and K3's device-ms bars a call at the
# headline's shape, B = 8, T = 1800: twice their byte bounds (0.0161 /
# 0.0139 / 0.0031 ms), half the card's memory rate
K2_K3_BAR_DEVICE_MS = {"sampler_prologue": 0.032, "sampler_prologue_int8": 0.028,
                       "sampler_epilogue": 0.0062}
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12
INT8_OPS = 1979e12
F32_FLOPS = 67e12


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _tensors(obj):
    if torch.is_tensor(obj):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            yield from _tensors(v)


def flops(fn) -> int:
    """The matrix-product and convolution FLOPs of one call of ``fn``."""
    with FlopCounterMode(display=False) as counter:
        fn()
    return counter.get_total_flops()


def bound(inputs, outputs, n_flops: int, int8_ops: int = 0,
          product_dtype: torch.dtype = torch.bfloat16) -> dict:
    """The least time an H100 could take for a function of these inputs
    and outputs doing ``n_flops``, of which ``int8_ops`` are int8 products
    and the rest products of ``product_dtype`` operands: ``bound_ms``, the
    larger of its bytes (each input read once, each output written once)
    over the memory rate (``bytes_ms``) and its operations over the rate of
    their type, bf16 or int8 on the tensor cores, float32 outside them
    (``ops_ms``), and ``bound_by``, which of the two it is."""
    n_bytes = sum(t.numel() * t.element_size() for t in _tensors((inputs, outputs)))
    rate = F32_FLOPS if product_dtype == torch.float32 else BF16_FLOPS
    ops_s = (n_flops - int8_ops) / rate + int8_ops / INT8_OPS
    return _bound(n_bytes / HBM_BYTES_PER_S * 1e3, ops_s * 1e3)


def _bound(bytes_ms: float, ops_ms: float) -> dict:
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "operations" if ops_ms > bytes_ms else "bytes"}


def _errors(got, want) -> list[tuple[float, float]]:
    """(max |got - want|, max |want|) of each output."""
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    return [(float((g.float() - w.float()).abs().max()), float(w.float().abs().max()))
            for g, w in pairs if w is not None]


def _compare(name, kernel_fn, plain_fn, reps, rel_tol, inputs, library_fn=None, n_flops=None,
             int8_ops=0, view=None, product_dtype=torch.bfloat16):
    """``kernel_fn`` against ``plain_fn`` (no arguments, same inputs), both
    outputs seen through ``view`` if given.  The bound counts ``n_flops``,
    by default those of ``plain_fn``, ``int8_ops`` of them int8, the rest
    products of ``product_dtype``."""
    out = kernel_fn()
    view = view or (lambda o: o)
    parts = _errors(view(out), view(plain_fn()))
    torch.cuda.synchronize()
    err, ref = max(parts, key=lambda p: p[0] / max(p[1], 1e-30))
    return {
        "name": name, "max_abs_err": err, "ref_max_abs": ref,
        "ok": all(e <= rel_tol * r and r > 0 for e, r in parts),
        "ms": time_ms(kernel_fn, reps), "plain_ms": time_ms(plain_fn, reps),
        **bound(inputs, out, flops(plain_fn) if n_flops is None else n_flops, int8_ops,
                product_dtype),
        "library_ms": None if library_fn is None else time_ms(library_fn, reps),
        "parts": parts,
    }


def _merge(name: str, calls: list[dict]) -> dict:
    """One kernel's calls on the main path as one result: times and bounds
    summed, the error of the call worst relative to its scale."""
    worst = max(calls, key=lambda r: r["max_abs_err"] / max(r["ref_max_abs"], 1e-30))
    lib = [r["library_ms"] for r in calls]
    return {
        "name": name, "max_abs_err": worst["max_abs_err"], "ref_max_abs": worst["ref_max_abs"],
        "ok": all(r["ok"] for r in calls),
        "ms": sum(r["ms"] for r in calls), "plain_ms": sum(r["plain_ms"] for r in calls),
        **_bound(sum(r["bytes_ms"] for r in calls), sum(r["ops_ms"] for r in calls)),
        "library_ms": None if None in lib else sum(lib),
        "calls": calls,
    }


@torch.no_grad()
def check_kernels(trainer, mel, noise, *, reps: int = 5, rel_tol: float = REL_TOL,
                  glue_inputs=None) -> list[dict]:
    """Every serving kernel on the first ladder step of ``mel`` and
    ``noise`` (`check_sampler_glue`, `check_stack_kernels`,
    `check_conv_blocks`); with ``glue_inputs``, a (mel, noise) of B = 8,
    T = 1800, K2 and K3 again on that step against their bars
    (`K2_K3_BAR_DEVICE_MS`), named with ``_b8`` (``_b{B}``)."""
    results = []
    conv = check_conv_blocks(trainer.fused_encoder, mel, reps=reps, rel_tol=rel_tol)
    pro_args, cond, step = ladder_step_inputs(trainer, mel, noise)
    glue = check_sampler_glue(trainer, pro_args, cond, step, reps=reps, rel_tol=rel_tol)
    results.append(glue[0])
    results += check_stack_kernels(trainer, pro_args, cond, reps=reps, rel_tol=rel_tol)
    results += glue[1:]
    results.append(conv)
    if glue_inputs is not None:
        pro_args, cond, step = ladder_step_inputs(trainer, *glue_inputs)
        suffix = f"_b{pro_args[0].shape[0]}"
        results += [r | {"name": r["name"] + suffix} for r in check_sampler_glue(
            trainer, pro_args, cond, step, reps=reps, rel_tol=rel_tol, bars=K2_K3_BAR_DEVICE_MS)]
    return results


@torch.no_grad()
def check_sampler_glue(trainer, pro_args, cond, step, *, reps: int = 5, rel_tol: float = REL_TOL,
                       bars: dict | None = None) -> list[dict]:
    """K2 (bf16 emb_act), K2 with int8 output (`_check_prologue_int8`) and
    K3 against their plain versions on a ladder step's operands
    (`ladder_step_inputs`; K3's h from the plain prologue and decoder
    stack), each with `_glue_timing`'s device ms, launches, repeat and plan,
    and ``bar_met`` against ``bars`` (by name) where given.  On a float32
    trainer K2 with float32 emb_act, K2 with int8 output and K3 with float32
    products (the ``_f32`` names), their float32 outputs within
    F32_REL_TOL."""
    fused = trainer.fused
    mxu = fused.mxu_dtype
    f32 = mxu == torch.float32  # the float32 modes: K2's float32 emb_act, K3's float32 products
    sfx, tol = ("_f32", F32_REL_TOL) if f32 else ("", rel_tol)
    bars = bars or {}
    x, _, emb_base, w_joint = pro_args[:4]
    shape = (*x.shape, emb_base.shape[-1], w_joint.shape[-1])
    pro_kw = dict(mxu_dtype=mxu, emb_dtype=mxu)
    call = functools.partial(sampler_prologue, *pro_args, **pro_kw)
    glue = [_glue_timing(_compare("sampler_prologue" + sfx, call,
                                  lambda: sampler_prologue_plain(*pro_args, **pro_kw), reps, tol,
                                  pro_args, product_dtype=mxu), call, "prologue", shape, bars,
                         reps)]
    glue.append(_glue_timing(_check_prologue_int8(pro_args, mxu, reps, rel_tol),
                             functools.partial(sampler_prologue, *pro_args, mxu_dtype=mxu,
                                               quantize_emb=True), "prologue", shape, bars, reps))
    h, emb_act, _ = sampler_prologue_plain(*pro_args, **pro_kw)
    h = decoder_stack_plain(h, emb_act, cond["kv_stack"], fused.mats, fused.vecs, fused.adaln_w,
                            fused.adaln_b, fused.num_heads, mxu_dtype=mxu)
    alpha, beta = ddim_affine_tables(trainer.sched)
    epi_args = (h, x, fused.w_out, fused.b_out, float(alpha[step]), float(beta[step]))
    call = functools.partial(sampler_epilogue, *epi_args, mxu_dtype=mxu)
    glue.append(_glue_timing(_compare("sampler_epilogue" + sfx, call,
                                      lambda: sampler_epilogue_plain(*epi_args, mxu_dtype=mxu),
                                      reps, tol, epi_args, product_dtype=mxu), call, "epilogue",
                             shape, bars, reps))
    return glue


def _glue_timing(r: dict, call, which: str, shape, bars: dict, reps: int) -> dict:
    """K2 / K3 result ``r`` of ``call`` at ``shape`` (B, T, C, E, D) with
    ``device_ms`` a call (`launch_split`), ``launches_a_call`` (must be 1),
    a repeat bit-identical (`_repeat`), ``plan`` (`ops.sampler_glue.plan`
    for the card's SMs) and ``plan_ok`` (the kernel's `sampler_plan` equals
    it), all in ``ok``; ``bar_met``: ok and ``device_ms`` within the bar
    ``bars`` holds under ``r``'s name, or None without one."""
    b, t, c, e, d = shape
    split = launch_split(call, reps)
    want = glue_plan(b, t, which, c=c, e=e, d=d, sms=_build.sm_count(torch.cuda.current_device()))
    r = _repeat(r, call) | {
        "shape": [b, t], "launch_split": split, "launches_a_call": len(split),
        "device_ms": sum(ms for _, ms in split),
        "plan": {k: want[k] for k in GLUE_PLAN_KEYS}}
    r["plan_ok"] = glue_kernel_plan(b, t, which, c=c, e=e, d=d) == r["plan"]
    r["ok"] &= len(split) == 1 and r["plan_ok"]
    bar = r["bar_device_ms"] = bars.get(r["name"])
    r["bar_met"] = None if bar is None else r["ok"] and r["device_ms"] <= bar
    return r


def _repeat(r: dict, kernel_fn) -> dict:
    """``r`` with ``repeat_identical``: whether two more calls of
    ``kernel_fn`` give the same bits (part of ``ok``)."""
    first, again = kernel_fn(), kernel_fn()
    pairs = zip(first, again) if isinstance(first, (tuple, list)) else [(first, again)]
    r["repeat_identical"] = all(torch.equal(a, b) for a, b in pairs if a is not None)
    r["ok"] &= r["repeat_identical"]
    return r


def _device_totals(r: dict, kernel_fns, library_fns=None, reps: int = 5) -> dict:
    """Merged K4 result ``r`` with ``device_ms``, the device ms of all its
    calls ``kernel_fns`` (`launch_split` over them in one trace), and
    ``library_device_ms``, that of ``library_fns`` (`device_ms`): the
    CUDA-event times of calls this short also hold the host's cost of a
    call."""
    r["device_ms"] = sum(ms for _, ms in launch_split(lambda: [fn() for fn in kernel_fns], reps))
    if library_fns is not None:
        r["library_device_ms"] = device_ms(lambda: [fn() for fn in library_fns], reps)
    return r


@torch.no_grad()
def check_conv_blocks(encoder, mel, *, reps: int = 5, rel_tol: float | None = None) -> dict:
    """K4 on each block of ``encoder`` (a `FusedMusicEncoder`), each on the
    activations the plain chain gives it from ``mel``, against its plain
    version, a repeat bit-identical: one result over the 7 calls, each in
    ``calls``.  In the encoder's mode: bf16 within ``rel_tol`` (REL_TOL by
    default), float32 (``conv_block_f32``, priced at the float32 rate)
    within F32_REL_TOL, with ``cudnn_conv_ms``, cuDNN's float32 `F.conv2d`
    of the 7 blocks' convs alone (a yardstick for the products: no
    PyTorch call computes a block)."""
    mxu = encoder.mxu_dtype
    mode_f32 = mxu == torch.float32
    rel_tol = rel_tol if rel_tol is not None else F32_REL_TOL if mode_f32 else REL_TOL
    x = mel.to(mxu).contiguous()[..., None]
    blocks, kernels, convs = [], [], []
    for kw in encoder.block_args:
        kernel = functools.partial(fused_conv_block, x, mxu_dtype=mxu, **kw)
        blocks.append(_repeat(_compare(
            "conv_block", kernel, lambda: conv_block_plain(x, mxu_dtype=mxu, **kw), reps, rel_tol,
            (x, kw), product_dtype=mxu) | {"shape": list(x.shape)}, kernel))
        kernels.append(kernel)
        convs.append(_library_conv(x, kw["kernel"], "reflect"))
        x = conv_block_plain(x, mxu_dtype=mxu, **kw)
    r = _device_totals(_merge("conv_block_f32" if mode_f32 else "conv_block", blocks), kernels,
                       reps=reps)
    if mode_f32:  # no call computes a block; cuDNN's float32 conv of each, a yardstick
        r["cudnn_conv_ms"] = sum(time_ms(fn, reps) for fn in convs)
    return r


@torch.no_grad()
def ladder_step_inputs(trainer, mel, noise):
    """The first ladder step's K2 inputs (x_T, the step's time embedding,
    the conditioning's emb_base, the input projection and its sequence
    bias), the prepared conditioning and the step's index, from the real
    encoder and conditioning of ``mel``."""
    fused, model = trainer.fused, trainer.model
    feats = trainer.fused_encoder(mel)
    cond = fused.prepare_cond(dict(model.precompute_cond(*model.cond_from_features(feats)),
                                   temb_table=trainer.temb_table))
    step = trainer.sched.num_timesteps - 1
    temb = cond["temb_table"][int(trainer.sched.timestep_map[step])]
    seq_bias = (fused.seq_emb[:noise.shape[1]] + fused.b_joint).contiguous()
    return (noise, temb, cond["emb_base"], fused.w_joint, seq_bias), cond, step


def _int8_pack(trainer):
    """The trainer's weights packed as ``sampler_adaln_int8`` packs them."""
    cfg = trainer.cfg
    return FusedDenoiser(trainer.model, cfg.replace(
        denoiser=dataclasses.replace(cfg.denoiser, sampler_adaln_int8=True)))


def _check_adaln(name, emb_act, adaln_w, adaln_b, reps, rel_tol, **kw) -> dict:
    """K1's AdaLN GEMM alone as K1 launches it, all layers of the stacked
    weights in one launch, against its plain version and one PyTorch call
    on the layers' weights side by side, (E, L N), made outside the timed
    call (never called by the port).  ``library_ms``: in bf16 `torch.addmm`
    with float32 out, the same function (in float32 `torch.addmm`, TF32
    off); in int8 `torch._int_mm` (int32 out, the weights as a column-major
    view, the layout cuBLASLt takes), since no one call dequantizes.  The
    yardstick of the bar the GEMM is held to, `torch.matmul` in bf16 (bf16
    out, no bias) or float32, or `torch._int_mm`,
    and the GEMM are also timed in device time (`device_ms`):
    ``no_slower_than_yardstick`` says whether the GEMM's is at most the
    yardstick's."""
    int8 = "adaln_w_scale" in kw
    args = (emb_act, adaln_w, adaln_b)
    m = emb_act.numel() // emb_act.shape[-1]
    n_layers, e, n = adaln_w.shape
    n_ops = 2 * m * e * n * n_layers
    a2 = emb_act.reshape(m, e)
    w_cat = adaln_w.permute(1, 0, 2).reshape(e, n_layers * n)
    if int8:
        w_cm = w_cat.t().contiguous().t()
        library = yardstick = lambda: torch._int_mm(a2, w_cm)  # noqa: E731
        yardstick_name = "torch._int_mm"
    elif emb_act.dtype == torch.float32:  # TF32 off: the callers run under full_float32
        b_cat = adaln_b.reshape(-1)
        library = lambda: torch.addmm(b_cat, a2, w_cat)  # noqa: E731
        yardstick = lambda: torch.matmul(a2, w_cat)  # noqa: E731
        yardstick_name = "torch.matmul float32"
    else:
        b_cat = adaln_b.reshape(-1)
        library = lambda: torch.addmm(b_cat, a2, w_cat, out_dtype=torch.float32)  # noqa: E731
        yardstick = lambda: torch.matmul(a2, w_cat)  # noqa: E731
        yardstick_name = "torch.matmul bf16"
    kernel = lambda: adaln_modulation(*args, **kw)  # noqa: E731
    r = _compare(name, kernel, lambda: adaln_modulation_plain(*args, **kw), reps, rel_tol,
                 (args, list(kw.values())), library, n_flops=n_ops,
                 int8_ops=n_ops if int8 else 0, product_dtype=emb_act.dtype) | {
                     "shape": [*emb_act.shape, n_layers, n]}
    _repeat(r, kernel)
    r.update(device_ms=device_ms(kernel, reps), yardstick=yardstick_name,
             yardstick_device_ms=device_ms(yardstick, reps))
    r["no_slower_than_yardstick"] = r["device_ms"] <= r["yardstick_device_ms"]
    return r


@torch.no_grad()
def stack_operands(trainer, pro_args, cond) -> dict:
    """K1's arguments in each of its modes on the first ladder step's
    operands (`ladder_step_inputs`), in the trainer's operand type (bf16 or
    float32): {the bf16 mode's count name: (args, kwargs)}, K2's plain
    output as x and emb_act, and in the int8-AdaLN mode its int8 codes and
    row scales with the trainer's weights packed as ``sampler_adaln_int8``
    packs them."""
    fused = trainer.fused
    mxu = fused.mxu_dtype
    h, emb_act, _ = sampler_prologue_plain(*pro_args, mxu_dtype=mxu, emb_dtype=mxu)
    args = (h, emb_act, cond["kv_stack"], fused.mats, fused.vecs, fused.adaln_w, fused.adaln_b,
            fused.num_heads)
    pack = _int8_pack(trainer)
    _, q, s = sampler_prologue_plain(*pro_args, mxu_dtype=mxu, quantize_emb=True)
    args8 = (h, q, cond["kv_stack"], pack.mats, pack.vecs, pack.adaln_w, pack.adaln_b,
             pack.num_heads)
    return {"decoder_stack": (args, dict(mxu_dtype=mxu)),
            "decoder_stack_vpu_bf16": (args, dict(mxu_dtype=mxu, vpu_dtype=torch.bfloat16)),
            "decoder_stack_int8": (args8, dict(mxu_dtype=mxu, emb_scale=s,
                                               adaln_w_scale=pack.adaln_w_scale))}


def stack_flops(stack_args, ff: int) -> int:
    """K1's matrix-product FLOPs on ``stack_args`` (`fused_decoder_stack`'s
    arguments) with an FFN of width ``ff``: the AdaLN GEMM and, a layer,
    seven D x D products, the FFN's two at width ``ff`` and three per-head
    ones (k^T v, and the softmaxed q against the self and the cross KV).
    `flops` of the plain version counts more than the function needs: its
    head sums as products with a block-diagonal matrix, k^T v and q @ KV
    across all of D, and the FFN zero-padded to D."""
    x, adaln_w, num_heads = stack_args[0], stack_args[5], stack_args[7]
    b, t, d = x.shape
    n_layers, e, n = adaln_w.shape
    per_layer = 7 * d * d + 2 * d * ff + 3 * d * (d // num_heads)
    return 2 * b * t * n_layers * (e * n + per_layer)


def layer_flops(layer_args, ff: int) -> int:
    """K5's matrix-product FLOPs on one layer's ``layer_args`` (x, emb_act,
    kv_cross, mats, vecs, adaln_w, adaln_b, num_heads): `stack_flops` of
    that layer."""
    x, emb_act, kv_cross, mats, vecs, adaln_w, adaln_b, heads = layer_args
    return stack_flops((x, emb_act, kv_cross[None], mats[None], vecs[None], adaln_w[None],
                        adaln_b[None], heads), ff)


def layer_bwd_flops(layer_args, ff: int) -> int:
    """K6's matrix-product FLOPs on ``layer_args`` (as `layer_flops`): the
    forward it recomputes and, for each of the forward's products, the two
    that give its operands' gradients, three forwards in all.  `flops` of
    the plain backward counts what `stack_flops` says it over-counts, three
    times."""
    return 3 * layer_flops(layer_args, ff)


@torch.no_grad()
def check_stack_kernels(trainer, pro_args, cond, *, reps: int = 5, rel_tol: float = REL_TOL,
                        suffix: str = "") -> list[dict]:
    """K1 in its three modes (bf16-MMA, bf16-VPU, int8-AdaLN), each against
    its plain version on `stack_operands`, and K1's AdaLN GEMM alone on all
    the layers in bf16 and int8, as K1 launches it.  On a float32 trainer
    the float32 mode alone, with bf16 VPU and with int8 AdaLN
    (``decoder_stack_f32``, ``_f32_vpu_bf16``, ``_f32_int8``) and the
    float32 GEMM (``adaln_modulation_f32``), within F32_REL_TOL (the
    bf16-VPU mode as `_check_vpu_mode` says) and priced at the float32
    rate.  K1's bounds count `stack_flops`.  Each result also holds a
    repeat bit-identical (`_repeat`) and its launches' plan, the kernel's
    own (`_plan_check`: K1's `decoder_stack_plan_d<D>`, the GEMM's
    `adaln_gemm_plan`), both in ``ok``.  ``suffix`` is added to every name
    (a second batch size)."""
    ops = stack_operands(trainer, pro_args, cond)
    args, kw = ops["decoder_stack"]
    args8, kw8 = ops["decoder_stack_int8"]
    mxu = kw["mxu_dtype"]
    f32 = mxu == torch.float32
    pre, tol = ("decoder_stack_f32", F32_REL_TOL) if f32 else ("decoder_stack", rel_tol)
    n_flops = stack_flops(args, trainer.cfg.denoiser.ff_size)
    b, t, e = args8[1].shape
    int8_ops = 2 * b * t * e * args8[5].shape[-1] * args8[5].shape[0]
    def stack(a, k):
        return lambda: fused_decoder_stack(*a, **k)

    results = [
        _repeat(_compare(pre, stack(args, kw), lambda: decoder_stack_plain(*args, **kw), reps,
                         tol, args, n_flops=n_flops, product_dtype=mxu), stack(args, kw)),
        _check_adaln("adaln_modulation_f32" if f32 else "adaln_modulation", args[1], args[5],
                     args[6], reps, tol, **kw),
        _repeat(_check_vpu_mode(args, mxu, reps, n_flops),
                stack(args, dict(kw, vpu_dtype=torch.bfloat16))),
        _repeat(_compare(pre + "_int8", stack(args8, kw8),
                         lambda: decoder_stack_plain(*args8, **kw8), reps, tol,
                         (args8, kw8["emb_scale"], kw8["adaln_w_scale"]), n_flops=n_flops,
                         int8_ops=int8_ops, product_dtype=mxu), stack(args8, kw8)),
    ]
    if not f32:  # the int8 GEMM is the same in both modes
        results.append(_check_adaln("adaln_modulation_int8", args8[1], args8[5], args8[6], reps,
                                    rel_tol, emb_scale=kw8["emb_scale"],
                                    adaln_w_scale=kw8["adaln_w_scale"]))
    d, n_layers = args[0].shape[-1], args[5].shape[0]
    for r in results:
        r["name"] += suffix
        if r["name"].startswith("decoder_stack"):
            _plan_check(r, stack_ops.plan(d, t, f32=f32), stack_ops.kernel_plan(d, t, f32=f32))
        else:
            dtype = torch.int8 if "int8" in r["name"] else mxu
            sms = _build.sm_count(torch.cuda.current_device())
            _plan_check(r, stack_ops.adaln_plan(b * t, 6 * d, n_layers, dtype, sms),
                        stack_ops.kernel_adaln_plan(b * t, 6 * d, n_layers, dtype))
    return results


def _plan_check(r: dict, want: dict, got: dict) -> dict:
    """``r`` with ``plan`` (the Python formula's) and ``plan_ok`` (the
    kernel's own export agrees, and each launch's shared bytes fit a
    block), both in ``ok``."""
    smem = [v for k, v in want.items() if k.endswith("smem")]
    if "static_smem" in want:  # one block's dynamic and static bytes together
        smem.append(want["smem"] + want["static_smem"])
    r["plan"] = want
    r["plan_ok"] = got == want and max(smem) <= stack_ops.SMEM_LIMIT
    r["ok"] &= r["plan_ok"]
    return r


def _traced(fn, calls: int) -> list:
    """The CUDA events of ``calls`` calls of ``fn`` under one
    `torch.profiler` trace, in start order.  The trace opens with a
    lead-in, two spin kernels (`torch.cuda._sleep`) and a synchronize,
    whose events, and any recorded before them, are left out: on an H100
    the profiler was seen to miss a trace's first kernels."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(2):
            torch.cuda._sleep(SPIN_CYCLES)
        torch.cuda.synchronize()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    lead = [i for i, e in enumerate(events) if "spin" in e.name.lower()]
    return events[lead[-1] + 1:] if lead else events


def device_ms(fn, reps: int = 5, parts: dict[str, str] | None = None):
    """Device ms per call of ``fn`` from `torch.profiler` over ``reps``
    calls after a warm-up call: the sum over every kernel it launched, or
    with ``parts`` ({part: text in a kernel's name}) a dict of each part's
    sum.  A trace that holds fewer kernels than calls (the profiler can
    drop a trace's records) is taken again, up to PROFILE_TRIES traces in
    all, then the calls are traced one a trace: the sums of the traces
    that hold the most kernels, ``reps`` of them."""
    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        kernels = _traced(fn, reps)
        if len(kernels) >= reps:
            break
    else:
        ones = [_traced(fn, 1) for _ in range(PROFILE_TRIES * reps)]
        most = max(len(k) for k in ones)
        full = [k for k in ones if len(k) == most]
        if not most or len(full) < reps:
            raise RuntimeError(f"torch.profiler recorded {len(kernels)} kernels of {reps} calls")
        kernels = [e for k in full[:reps] for e in k]
    split = {part: sum(e.time_range.elapsed_us() for e in kernels if key in e.name) / 1e3 / reps
             for part, key in (parts or {"all": ""}).items()}
    return split if parts else split["all"]


def k1_launch_split(fn, reps: int = 5) -> dict[str, float]:
    """Device ms per call of ``fn`` (one or more K1 calls) by K1 launch:
    the AdaLN GEMM, pass A (``kv_partials``), pass B (``kv_combine``) and
    the row pass."""
    return device_ms(fn, reps, {p: p for p in ("adaln_gemm", "kv_partials", "kv_combine",
                                               "layer_rows")})


def vpu_mode_errors(stack_args, **kw) -> dict:
    """K1's bf16-VPU mode on ``stack_args`` (``kw``: mxu_dtype and the int8
    scales, if any), the kernel and the plain version each run with and
    without it: the kernel's largest and mean distance from its plain
    version in the mode (``max_abs_err``, ``mean_abs_err``, ``ref_max_abs``),
    how far the mode moves the plain output (``mode_gap``, largest;
    ``mean_mode_gap``) and the kernel's (``kernel_gap``, largest)."""
    vpu = dict(kw, vpu_dtype=torch.bfloat16)
    got, want = fused_decoder_stack(*stack_args, **vpu), decoder_stack_plain(*stack_args, **vpu)
    got32, want32 = fused_decoder_stack(*stack_args, **kw), decoder_stack_plain(*stack_args, **kw)
    return {"max_abs_err": float((got - want).abs().max()),
            "mean_abs_err": float((got - want).abs().mean()),
            "ref_max_abs": float(want.abs().max()),
            "mode_gap": float((want - want32).abs().max()),
            "mean_mode_gap": float((want - want32).abs().mean()),
            "kernel_gap": float((got - got32).abs().max())}


def vpu_mode_ok(r: dict, mean_share: float) -> bool:
    """Whether `vpu_mode_errors` ``r`` shows the mode in the kernel: its
    own move at least half the plain version's (a kernel that ignored the
    mode would not move at all), and its mean distance from the plain
    version at most ``mean_share`` of the mode's mean move (it would be
    the whole move)."""
    return r["kernel_gap"] >= r["mode_gap"] / 2 and r["mean_abs_err"] <= mean_share * r["mean_mode_gap"]


def _check_vpu_mode(stack_args, mxu, reps, n_flops) -> dict:
    """K1 in the bf16-VPU mode against its plain version: within
    VPU_REL_TOL of the largest value, and `vpu_mode_ok` with a mean
    distance of at most a quarter of the mode's mean move (0.04 of it
    measured on an H100 at the serving shape).  With float32 products
    (``decoder_stack_f32_vpu_bf16``) also a mean distance within
    F32_REL_TOL of the largest value: the kernel and the plain version sum
    the same float32 products in other orders, so a bf16 rounding of the
    mode's chains can fall on the other side of a tie, which moves its row
    (and, through the next layer's KV, its clip) by up to a few tenths of a
    percent, as between two float32 summation orders on the CPU
    (tests/test_torch_port_sampler_modes.py)."""
    vpu = dict(mxu_dtype=mxu, vpu_dtype=torch.bfloat16)
    f32 = mxu == torch.float32
    r = _compare("decoder_stack_f32_vpu_bf16" if f32 else "decoder_stack_vpu_bf16",
                 lambda: fused_decoder_stack(*stack_args, **vpu),
                 lambda: decoder_stack_plain(*stack_args, **vpu), reps, VPU_REL_TOL, stack_args,
                 n_flops=n_flops, product_dtype=mxu)
    r.update(vpu_mode_errors(stack_args, mxu_dtype=mxu))
    r["ok"] &= vpu_mode_ok(r, 0.25)
    if f32:
        r["ok"] &= r["mean_abs_err"] <= F32_REL_TOL * r["ref_max_abs"]
    return r


def prologue_tie_errors(pro_args, **kw) -> int:
    """K2's int8 output on exact ties, against the codes half-to-even
    rounding gives: emb rows of values (k + 0.5) / 4 for k in 68..125 and
    one 31.75, so every SiLU is exact (sigmoid rounds to 1 above 17), every
    row scale is 31.75 / 127 = 1/4 and every other code sits on a half code,
    rounded to the even one (truncation, or rounding half away from zero,
    moves half of them).  The number of codes and scales that differ."""
    x, temb, emb_base, w_joint, seq_bias = pro_args
    b, t, e = emb_base.shape
    k = 68 + (torch.arange(e, device=x.device) + torch.arange(b * t, device=x.device)[:, None]) % 58
    ties, want = (k + 0.5) / 4, k + k % 2
    ties[:, 0], want[:, 0] = 31.75, 127
    _, q, s = sampler_prologue(x, torch.zeros_like(temb), ties.reshape(b, t, e), w_joint,
                               seq_bias, quantize_emb=True, **kw)
    return int((q.long() != want.reshape(b, t, e)).sum()) + int((s != 0.25).sum())


def _check_prologue_int8(pro_args, mxu, reps, rel_tol) -> dict:
    """K2 with int8 output on the step's prologue inputs, its codes compared
    dequantized (code x row scale) within ``rel_tol`` (one code is 1/127 of
    its row); ``codes_differ`` and ``code_max_diff``
    count the codes that differ from the plain version's, at most 1 apart
    and at no more than 0.1 % of them, and ``tie_errors`` the wrong codes on
    exact ties (`prologue_tie_errors`), which must be 0.  With float32
    products (``sampler_prologue_f32_int8``) h within F32_REL_TOL."""
    kw = dict(mxu_dtype=mxu, quantize_emb=True)
    f32 = mxu == torch.float32
    pro = _compare("sampler_prologue_f32_int8" if f32 else "sampler_prologue_int8",
                   lambda: sampler_prologue(*pro_args, **kw),
                   lambda: sampler_prologue_plain(*pro_args, **kw), reps, rel_tol, pro_args,
                   view=lambda o: (o[0], o[1].float() * o[2]), product_dtype=mxu)
    if f32:
        err, ref = pro["parts"][0]
        pro["ok"] &= err <= F32_REL_TOL * ref
    _, q_got, _ = sampler_prologue(*pro_args, **kw)
    _, q_want, _ = sampler_prologue_plain(*pro_args, **kw)
    diff = (q_got.int() - q_want.int()).abs()
    pro.update(codes_differ=int((diff > 0).sum()), code_max_diff=int(diff.max()),
               n_codes=diff.numel(), tie_errors=prologue_tie_errors(pro_args, mxu_dtype=mxu))
    pro["ok"] &= (pro["code_max_diff"] <= 1 and pro["codes_differ"] <= 1e-3 * pro["n_codes"]
                  and pro["tie_errors"] == 0)
    return pro


def train_layer_args(trainer, cond, motion, *, seed: int = 0):
    """K5's and K6's arguments on layer 0 of a training forward of
    ``trainer`` on ``cond`` (mel, or features with ``cached_features``) and
    ``motion`` (B, T, J, 2): seeded t and noise, the denoiser's packed
    weights, and a seeded bf16 cotangent (zero on the pad rows, as the
    training path gives it).  Returns (args, kwargs, dy, heads)."""
    cfg, model = trainer.cfg, trainer.model
    mxu = getattr(torch, cfg.denoiser.compute_dtype)
    dev = motion.device
    b, n = motion.shape[0], motion.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, trainer.sched.num_timesteps, (b,), generator=gen, device=dev)
    x0 = motion.reshape(b, n, -1)
    x_t = q_sample(trainer.train_sched, x0, t, torch.randn(x0.shape, generator=gen, device=dev))
    encode = model.cond_from_features if cfg.train.cached_features else model.encode_music
    xf_proj, xf_out = encode(cond)
    h, emb_act, xf_o = train_layer_inputs(model, cfg, x_t, t, xf_proj, xf_out)
    kvb = cross_kv_state(model.temporal_decoder_blocks[0].ca_block, xf_o).to(mxu)
    args = (h, emb_act, kvb, *pack_layer_weights(model, 0))
    dy = torch.randn(h.shape, generator=gen, device=dev) * 1e-2
    dy[:, n:] = 0
    return args, dict(mxu_dtype=mxu, t_valid=n), dy.to(h.dtype), cfg.denoiser.num_heads


@torch.no_grad()
def check_train_kernels(trainer, cond, motion, *, batches=None, reps: int = 5,
                        rel_tol: float = REL_TOL, seed: int = 0) -> list[dict]:
    """K5 and K6 (`check_layer_bwd`) against their plain versions on
    `train_layer_args` of the first b clips of ``cond`` and ``motion``, for
    each b in ``batches`` (all of them by default); the rows of a b short
    of the whole batch end in ``_b{b}``.  On a float32 trainer their
    float32 modes (``decoder_layer_f32``, ``decoder_layer_bwd_f32``) within
    F32_REL_TOL, priced at the float32 rate.  The bounds count the products
    the kernels need (K5 `layer_flops`, K6 `layer_bwd_flops`)."""
    results = []
    for b in batches or (cond.shape[0],):
        suffix = "" if b == cond.shape[0] else f"_b{b}"
        args, kw, _, heads = train_layer_args(trainer, cond[:b], motion[:b], seed=seed)
        mxu = kw["mxu_dtype"]
        f32 = mxu == torch.float32
        n_flops = layer_flops((*args, heads), trainer.cfg.denoiser.ff_size)
        fwd = _compare("decoder_layer_f32" if f32 else "decoder_layer",
                       lambda: fused_decoder_layer(*args, heads, **kw),
                       lambda: decoder_layer_plain(*args, heads, **kw), reps,
                       F32_REL_TOL if f32 else rel_tol, args, n_flops=n_flops, product_dtype=mxu)
        _repeat(fwd, lambda: fused_decoder_layer(*args, heads, **kw))
        d, t = args[0].shape[-1], args[0].shape[1]
        _plan_check(fwd, stack_ops.plan(d, t, kw["t_valid"], f32),
                    stack_ops.kernel_plan(d, t, kw["t_valid"], f32))
        bwd = check_layer_bwd(trainer, cond[:b], motion[:b], reps=reps, rel_tol=rel_tol,
                              seed=seed)
        for r in (fwd, bwd):
            r["name"] += suffix
            r["batch"] = b
        results += [fwd, bwd]
    return results


def launch_split(fn, reps: int = 5) -> list[tuple[str, float]]:
    """Device ms per call of ``fn`` by launch, in launch order: [(kernel
    name, ms)], each launch's mean over ``reps`` calls after a warm-up
    call.  Every call must launch the same kernels: a trace that does not
    show that (the profiler can drop records) is taken again, up to
    PROFILE_TRIES traces in all.  A process that has run many traces can
    keep dropping records from traces of several calls, so then the calls
    are traced one a trace: the launches are those that most of the
    one-call traces show, and the times their mean over ``reps`` such
    traces; fewer than ``reps`` alike raises."""
    def name(e):
        return e.name.removeprefix("void ").replace("(anonymous namespace)::", "").split("(")[0]

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILE_TRIES):
        kernels = _traced(fn, reps)
        per = len(kernels) // reps
        names = [name(e) for e in kernels]
        if per and len(kernels) == reps * per and all(
                names[c * per:(c + 1) * per] == names[:per] for c in range(reps)):
            return [(names[i], sum(kernels[c * per + i].time_range.elapsed_us()
                                   for c in range(reps)) / 1e3 / reps) for i in range(per)]
    seen = {}
    for _ in range(PROFILE_TRIES * reps):
        one = _traced(fn, 1)
        seen.setdefault(tuple(name(e) for e in one), []).append(one)
    names, alike = max(seen.items(), key=lambda kv: len(kv[1]))
    if len(alike) < reps:
        raise RuntimeError(f"torch.profiler recorded {len(kernels)} kernels of {reps} calls, "
                           "not the same launches in each, nor in one-call traces")
    return [(n, sum(t[i].time_range.elapsed_us() for t in alike[:reps]) / 1e3 / reps)
            for i, n in enumerate(names)]


@torch.no_grad()
def check_layer_bwd(trainer, cond, motion, *, reps: int = 5, rel_tol: float = REL_TOL,
                    seed: int = 0) -> dict:
    """K6 against its plain version on `train_layer_args` (all seven
    gradients within ``rel_tol`` of their largest values; on a float32
    trainer its float32 mode, ``decoder_layer_bwd_f32``, within
    F32_REL_TOL, priced at the float32 rate; its bound counts
    `layer_bwd_flops`), and: whether a second call is
    bit-identical (``repeat_identical``, part of ``ok``), its device ms a
    call by launch (`launch_split`), its workspace bytes, and the
    yardsticks of its two large GEMMs, the same product in one PyTorch call
    on operands of the same shapes in device ms (never called by the port):
    d_adaln_w = emb^T dMod by `torch.mm` with float32 out, d_emb = dMod
    aw^T by `torch.mm`, in bf16 or, in the float32 mode, float32 (TF32 off:
    the callers run under `full_float32`); and the bounds of its two GEMM
    launches (``part_bounds``): the weight-gradient A^T B (its 16 distinct
    (B T, D) operands, emb and dMod read once, 9 D x D and E x 6D float32
    out) and d_emb, at the rate of the mode's products."""
    args, kw, dy, heads = train_layer_args(trainer, cond, motion, seed=seed)
    mxu = kw["mxu_dtype"]
    f32 = mxu == torch.float32
    kernel = lambda: decoder_layer_bwd(*args, dy, heads, **kw)  # noqa: E731
    r = _compare("decoder_layer_bwd_f32" if f32 else "decoder_layer_bwd", kernel,
                 lambda: decoder_layer_bwd_plain(*args, dy, heads, **kw), reps,
                 F32_REL_TOL if f32 else rel_tol, (args, dy),
                 n_flops=layer_bwd_flops((*args, heads), trainer.cfg.denoiser.ff_size),
                 product_dtype=mxu)
    _repeat(r, kernel)
    h, emb_act, adaln_w = args[0], args[1], args[5]
    b, t, e = emb_act.shape
    r["shape"] = [b, t, h.shape[-1]]
    r["launch_split"] = launch_split(kernel, reps)
    r["device_ms"] = sum(ms for _, ms in r["launch_split"])
    r["workspace_bytes"] = int(_build.width_entry("decoder_layer_backward_workspace", h.shape[-1])(
        b, t, h.shape[-1], e, heads, int(f32)))
    _plan_check(r, layer_bwd_plan(h.shape[-1], t, f32), layer_bwd_kernel_plan(h.shape[-1], t, f32))
    gen = torch.Generator(device=h.device).manual_seed(seed + 1)
    emb2 = emb_act.reshape(b * t, e).to(mxu)
    dmod = torch.randn((b * t, adaln_w.shape[-1]), generator=gen, device=h.device).to(mxu)
    aw = adaln_w.to(mxu)
    r["yardsticks"] = {
        "d_adaln_w torch.mm float32 out": device_ms(
            (lambda: torch.mm(emb2.t(), dmod)) if f32 else
            (lambda: torch.mm(emb2.t(), dmod, out_dtype=torch.float32)), reps),
        f"d_emb torch.mm {'float32' if f32 else 'bf16'}": device_ms(
            lambda: torch.mm(dmod, aw.t()), reps),
    }
    # the bounds of K6's two GEMM launches (`launch_split`'s second atb_kernel
    # and demb_kernel, or their float32 modes): operands read once, float32
    # sums out (d_emb in the operand type)
    rows, d, n6 = b * t, h.shape[-1], adaln_w.shape[-1]
    size, rate = (4, F32_FLOPS) if f32 else (2, BF16_FLOPS)
    r["part_bounds"] = {
        "atb: 9 d_mats + d_adaln_w": _bound(
            (16 * rows * d * size + rows * (e + n6) * size + (9 * d * d + e * n6) * 4)
            / HBM_BYTES_PER_S * 1e3,
            2 * rows * (9 * d * d + e * n6) / rate * 1e3),
        "demb: d_emb": _bound(
            (rows * (n6 + e) * size + e * n6 * size) / HBM_BYTES_PER_S * 1e3,
            2 * rows * n6 * e / rate * 1e3),
    }
    return r


@torch.no_grad()
def perceptual_inputs(trainer, cond, motion, *, seed: int = 0):
    """The perceptual term's inputs in one training forward of ``trainer``
    on ``cond`` and ``motion`` (B, T, J, 2), with seeded t and noise: pred
    and target (B, T, J, 2), and dy, the cotangent that the loss's L1 mean
    gives pred's latents, sign(f(pred) - f(target)) / numel, with f the
    trainer's plain module (in its compute dtype)."""
    dev = motion.device
    b, n = motion.shape[0], motion.shape[1]
    gen = torch.Generator(device=dev).manual_seed(seed)
    t = torch.randint(0, trainer.sched.num_timesteps, (b,), generator=gen, device=dev)
    noise = torch.randn((b, n, motion[0, 0].numel()), generator=gen, device=dev)
    model = trainer.model
    encode = model.cond_from_features if trainer.cfg.train.cached_features else model.encode_music
    terms = trainer.training_terms(*encode(cond), motion, t, noise)
    pred, target = terms["pred"].reshape(motion.shape), terms["target"].reshape(motion.shape)
    diff = trainer.feat_model(pred) - trainer.feat_model(target)
    return pred, target, torch.sign(diff) / diff.numel()


@torch.no_grad()
def sync_loss_inputs(trainer, mel, real, noise):
    """The SyncLoss's inputs in one step of an `M2SGANTrainer` with a frozen
    music encoder, on ``mel``, ``real`` and ``noise``: the fake of its
    generator step (train mode; the running statistics are put back),
    float32, the real motion, and dy, the cotangent that the loss's L1 mean
    gives the fake's latents, sign(f(fake) - f(real)) / numel, with f the
    trainer's plain frozen ST-GCN (in its dtype)."""
    saved = {k: v.clone() for k, v in trainer.G.state_dict().items()}
    fake = trainer.G.decode(trainer.music_features(mel), noise, train=True).float()
    trainer.G.load_state_dict(saved)
    diff = trainer.sync_encoder(fake) - trainer.sync_encoder(real)
    return fake, real, torch.sign(diff.float()) / diff.numel()


@torch.no_grad()
def check_stgcn_kernels(module, pack, mxu, pred, target, dy, *, reps: int = 5,
                        rel_tol: float = REL_TOL, suffix: str = "") -> list[dict]:
    """K7 against its plain versions on the perceptual term's inputs
    (`perceptual_inputs`) or the SyncLoss's (`sync_loss_inputs`), over a
    frozen ST-GCN ``module``, its K7 ``pack`` and the ``mxu`` dtype they
    compute in (a `DDPMTrainer`'s perceptual network or an
    `M2SGANTrainer`'s SyncLoss network); ``suffix`` ends the results'
    names.

    stgcn_forward: the latents of pred (with the ReLU masks kept for the
    backward, as the training path runs it) and of target; ms per call is
    the mean of the two (``calls_ms``: each alone).  stgcn_backward: d(pred)
    from ``dy`` and the masks of the plain forward of pred, against
    `stgcn_backward_plain` on the same masks.  Two bf16 forwards that sum in
    another order flip a few masks (``mask_flips``: bits of the kernel's
    own forward that differ from the plain one's), and a flip moves single
    elements of the gradient by several percent of its maximum; ``e2e_err``
    is the backward's difference after the kernel's own forward, reported
    and not bounded.  Both: a repeat bit-identical (part of ``ok``), the
    device ms a call by launch (`launch_split`), one launch a st_gcn block
    (part of ``ok``), and ``bar_met``, each within K7_BAR_MS by CUDA events
    (not part of ``ok``); the forward also
    ``mask_bytes``, what `save` keeps, with ``mask_flips`` within
    K7_MASK_FLIP_SHARE of the mask bits (part of ``ok``); and ``plan_ok``,
    `ops.stgcn.plan` the tiling the kernel reports (`kernel_plan`, part of
    ``ok``).  With a float32 ``mxu`` and pack, K7's float32 mode
    (``stgcn_forward_f32``, ``stgcn_backward_f32``): within F32_REL_TOL,
    priced at the float32 rate, 21 launches a call (a product and a
    temporal conv a block, and the projection or the cotangent's start);
    its tiling is its own (no ``plan_ok``) and K7_BAR_MS is the bf16
    mode's (no ``bar_met``).

    The bounds count the work of the function, whatever implements it, and
    the module's weights in place of the pack's bytes: the forward reads the
    motion and writes the latents, with the FLOPs of the ST-GCN module
    (its joint contraction is one (13, 13) matrix per
    partition where the pack holds a dense (416, 416) one); the backward
    reads the motion and dy and writes dx, with the FLOPs of the module's
    forward and its d(input), which is what the JAX backward kernel does.
    ``old_bound``: the backward's bound counted over what the kernel reads
    instead, the forward's ten float32 h and bf16 g slabs as inputs and the
    d(input) FLOPs alone: what a design that keeps those slabs would be
    held to."""
    weights = list(module.state_dict().values())
    f32 = mxu == torch.float32
    if f32:
        rel_tol, suffix = F32_REL_TOL, "_f32" + suffix
    kept = lambda: (lambda o: (o[0], *o[1]))(stgcn_forward(pred, pack, save=True))  # noqa: E731
    fwd_flops = flops(lambda: module(pred))
    fwd = _compare(
        "stgcn_forward" + suffix,
        lambda: (stgcn_forward(pred, pack, save=True)[0], stgcn_forward(target, pack)),
        lambda: (frozen_stgcn_plain(pred, pack, mxu), frozen_stgcn_plain(target, pack, mxu)),
        reps, rel_tol, (pred, target, weights, weights),
        n_flops=2 * fwd_flops, product_dtype=mxu)
    fwd.update(_bound(fwd["bytes_ms"] / 2, fwd["ops_ms"] / 2), ms=fwd["ms"] / 2,
               plain_ms=fwd["plain_ms"] / 2)
    fwd["calls_ms"] = {"forward, save": time_ms(kept, reps),
                       "forward": time_ms(lambda: stgcn_forward(target, pack), reps)}
    _repeat(fwd, kept)
    fwd["launch_split"] = launch_split(kept, reps)
    own = kept()
    fwd["mask_bytes"] = sum(m.numel() * m.element_size() for m in own[1:])
    _, masks = frozen_stgcn_plain(pred, pack, mxu, save=True)
    fwd["mask_flips"] = sum(int((unpack_relu_masks(a) != unpack_relu_masks(b)).sum())
                            for a, b in zip(own[1:], masks))
    fwd["mask_bits"] = sum(m.numel() * 32 for m in masks)
    fwd["ok"] &= fwd["mask_flips"] <= K7_MASK_FLIP_SHARE * fwd["mask_bits"]
    with torch.enable_grad():
        xm = pred.detach().requires_grad_(True)
        out_m = module(xm)
        n_dinput = flops(lambda: torch.autograd.grad(out_m, xm, dy))
    n_bwd = fwd_flops + n_dinput
    kernel = lambda: stgcn_backward(dy, masks, pack)  # noqa: E731
    bwd = _compare("stgcn_backward" + suffix, kernel, lambda: stgcn_backward_plain(dy, masks, pack, mxu),
                   reps, rel_tol, (pred, dy, weights), n_flops=n_bwd, product_dtype=mxu)
    _repeat(bwd, kernel)
    bwd["launch_split"] = launch_split(kernel, reps)
    saved_bytes = BLOCKS * pred.shape[0] * pred.shape[1] * WIDTH * (4 + (4 if f32 else 2))
    old = bound((dy, weights), own[0].new_empty(pred.shape), n_dinput, product_dtype=mxu)
    bwd["old_bound"] = _bound(old["bytes_ms"] + saved_bytes / HBM_BYTES_PER_S * 1e3, old["ops_ms"])
    bwd["e2e_err"] = _errors(stgcn_backward(dy, own[1:], pack),
                             stgcn_backward_plain(dy, masks, pack, mxu))[0][0]
    for r in (fwd, bwd):
        r["device_ms"] = sum(ms for _, ms in r["launch_split"])
        # K7's own launches, one a st_gcn block (the wrapper may first copy
        # a non-contiguous dy)
        r["launches_a_call"] = sum(name.startswith("stgcn_") for name, _ in r["launch_split"])
        r["ok"] &= r["launches_a_call"] == (2 * BLOCKS + 1 if f32 else BLOCKS)
        if f32:
            r["plan_ok"] = r["bar_met"] = None
            continue
        direction = "forward" if r is fwd else "backward"
        mine = plan(pred.shape[0], pred.shape[1], direction)
        r["plan_ok"] = {k: mine[k] for k in KERNEL_PLAN_KEYS} == kernel_plan(
            pred.shape[0], pred.shape[1], direction)
        r["ok"] &= r["plan_ok"]
        r["bar_met"] = r["ms"] <= K7_BAR_MS
    return [fwd, bwd]


def stage1_kernel_inputs(trainer, music, motion, starts) -> tuple[list, list]:
    """The inputs of the music encoder's kernels in one train-mode forward
    and backward of a stage-1 step's first pair, (m1, p1) of the "hard"
    strategy at ``starts``, under the first BCE term
    (`encoder_kernel_inputs`).  Moves the BatchNorm running statistics and
    leaves no gradients."""
    from .train.m2snet_trainer import _bce

    m1, _, p1, _ = trainer._pairs(music, motion, "hard", starts, None)
    trainer.model.train()
    inputs = encoder_kernel_inputs(_bce(trainer.model(m1, p1), 1.0))
    trainer.model.zero_grad(set_to_none=True)
    return inputs


def gan_encoder_kernel_inputs(trainer, mel, real, noise) -> tuple[list, list]:
    """The inputs of the music encoder's kernels in the generator step of an
    `M2SGANTrainer` with ``train_music_encoder`` on ``mel``, ``real`` and
    ``noise`` (`encoder_kernel_inputs` under `generator_loss`, the
    encoder in train mode).  Leaves the trainer's weights, statistics and
    gradients as they were."""
    saved = {k: v.clone() for k, v in trainer.G.state_dict().items()}
    inputs = encoder_kernel_inputs(trainer.generator_loss(mel, None, noise, real)[0])
    trainer.G.load_state_dict(saved)
    for module in (trainer.G, trainer.D):
        module.zero_grad(set_to_none=True)
    return inputs


def encoder_kernel_inputs(loss) -> tuple[list, list]:
    """Runs ``loss``'s backward and returns the inputs of the trainable
    music encoder's kernels on its graph: per 3x3 conv ``(x, kernel,
    dy)``, per pool ``(x, dy, pool)``, in backward order."""
    convs, pools, hooks = [], [], []
    seen, stack = set(), [loss.grad_fn]
    while stack:
        node = stack.pop()
        if node is None or node in seen:
            continue
        seen.add(node)
        name = type(node).__name__
        if name == "_Conv3x3TrainBackward":
            hooks.append(node.register_prehook(
                lambda g, n=node: convs.append((*n.saved_tensors, g[0]))))
        elif name == "_MaxPoolTrainBackward":
            hooks.append(node.register_prehook(
                lambda g, n=node: pools.append((*n.saved_tensors, g[0], n.pool))))
        stack.extend(fn for fn, _ in node.next_functions)
    loss.backward()
    for hook in hooks:  # a hook holds its node: left in place, the pair outlives the call
        hook.remove()
    detach = lambda items: [tuple(a.detach().contiguous() if torch.is_tensor(a) else a  # noqa: E731
                                  for a in item) for item in items]
    return detach(convs), detach(pools)


def _library_dkernel(x, dy):
    """cuDNN's weight gradient of the same conv, on the reflect-padded input
    made outside the timed call."""
    xe = F.pad(x.permute(0, 3, 1, 2), (1, 1, 1, 1), mode="reflect")
    dyn = dy.permute(0, 3, 1, 2)
    shape = (dy.shape[-1], x.shape[-1], 3, 3)
    return lambda: torch.nn.grad.conv2d_weight(xe, shape, dyn)


def _reference_pool_bwd(x, dy, pool):
    """Autograd's `max_pool2d` backward on the same x and dy in an NCHW view,
    its indices made outside the timed call.  It breaks ties its own way, so
    it computes another function than K11: a reference, not a yardstick."""
    window, strides, padding = pool
    pad = (padding[0][0], padding[1][0])
    nchw, dyn = x.permute(0, 3, 1, 2), dy.permute(0, 3, 1, 2)
    _, idx = F.max_pool2d_with_indices(nchw, window, strides, pad)
    return lambda: torch.ops.aten.max_pool2d_with_indices_backward(
        dyn, nchw, window, strides, pad, (1, 1), False, idx)


def _library_conv(x, kernel, edge):
    """cuDNN's conv of the same operands, `F.conv2d` in x's dtype (bf16, or
    float32: TF32 off where the caller turns it off, as chip_smoke does)
    channels_last: on the reflect-padded input made outside the timed call,
    or with ``padding=1`` for the zero edge."""
    w = kernel.to(x.dtype).permute(3, 2, 0, 1).contiguous(memory_format=torch.channels_last)
    xn = x.permute(0, 3, 1, 2)  # NHWC storage is channels_last
    if edge == "zero":
        return lambda: F.conv2d(xn, w, padding=1)
    xe = F.pad(xn, (1, 1, 1, 1), mode="reflect").contiguous(memory_format=torch.channels_last)
    return lambda: F.conv2d(xe, w)


@torch.no_grad()
def check_stage1_kernels(convs, pools, *, reps: int = 5, rel_tol: float | None = None,
                         seed: int = 0) -> list[dict]:
    """K9 (each conv's d(kernel)), K10 and K11 (each pool's forward and
    backward) and K4's training modes (each conv's forward, relu off and
    reflect edge, and the zero-edge interior of its transposed conv) against
    their plain versions on `stage1_kernel_inputs`, in the inputs' dtype on
    both sides: bf16 within ``rel_tol`` (REL_TOL by default), or float32
    (the float32 modes, their results named with ``_f32``, products priced
    at the float32 rate, no bars): K4 and K9 within F32_REL_TOL, K11 within
    K11_F32_REL_TOL.
    K11 is also held to the tie rule exactly (``tie_err`` must be 0): on
    each pool's input rounded to a coarse grid after a ReLU (plateaus of
    equal values, zeros included) with a cotangent of quarter-integers,
    whose sums are exact in float32 and bf16 in any order; each of its
    calls must repeat bit for bit and launch one kernel, and reports its
    device ms (``device_ms``) and autograd's `max_pool2d` backward on the
    same inputs (``reference_ms``, `_reference_pool_bwd`); ``bar_met``: the
    sums within K11_BAR_MS and K11_BAR_DEVICE_MS.  K10 is held to its plain
    version exactly (``max_abs_err`` 0); each of its calls must repeat bit
    for bit, launch one kernel and run the tiling `fwd_plan` computes
    (``plan_ok``: the kernel's `max_pool_fwd_plan`), and reports its device
    ms; ``bar_met``: the sums within K10_BAR_MS and K10_BAR_DEVICE_MS."""
    mxu = convs[0][0].dtype
    mode_f32 = mxu == torch.float32
    rel_tol = rel_tol if rel_tol is not None else F32_REL_TOL if mode_f32 else REL_TOL
    pool_tol = K11_F32_REL_TOL if mode_f32 else rel_tol
    cmp = functools.partial(_compare, product_dtype=mxu)
    dkernel, conv_fwd, conv_dx, pool_fwd, pool_bwd = [], [], [], [], []
    k4_fns, k4_libs = [], []  # K4's calls and their library calls
    for x, kernel, dy in convs:
        dkernel.append(_repeat(cmp("conv3x3_dkernel", lambda: conv3x3_dkernel(x, dy),
                                   lambda: conv3x3_dkernel_plain(x, dy), reps, rel_tol, (x, dy),
                                   _library_dkernel(x, dy)) | {"shape": list(x.shape)},
                               lambda: conv3x3_dkernel(x, dy)))
        cout, cin = kernel.shape[-1], kernel.shape[2]
        one = torch.ones(cout, device=x.device)
        fwd = (x, kernel, one, torch.zeros_like(one))
        k4 = functools.partial(fused_conv_block, *fwd, relu=False, mxu_dtype=mxu)
        lib = _library_conv(x, kernel, "reflect")
        conv_fwd.append(_repeat(cmp(
            "conv_block", k4, lambda: conv_block_plain(*fwd, relu=False, mxu_dtype=mxu), reps,
            rel_tol, fwd, lib) | {"shape": list(x.shape)}, k4))
        k4_fns.append(k4)
        k4_libs.append(lib)
        if cin > 1:  # the first block's input (the mel) takes no gradient
            wflip = kernel.flip(0, 1).transpose(2, 3).contiguous()
            one = torch.ones(cin, device=x.device)
            bwd = (dy, wflip, one, torch.zeros_like(one))
            k4 = functools.partial(fused_conv_block, *bwd, relu=False, edge="zero", mxu_dtype=mxu)
            lib = _library_conv(dy, wflip, "zero")
            conv_dx.append(_repeat(cmp(
                "conv_block", k4,
                lambda: conv_block_plain(*bwd, relu=False, edge="zero", mxu_dtype=mxu), reps,
                rel_tol, bwd, lib) | {"shape": list(dy.shape), "edge": "zero"}, k4))
            k4_fns.append(k4)
            k4_libs.append(lib)
    gen = torch.Generator(device=pools[0][0].device).manual_seed(seed)
    tie_err = 0.0
    for x, dy, pool in pools:
        window, strides, padding = pool
        nchw = x.permute(0, 3, 1, 2)
        fwd = functools.partial(fused_max_pool, x, pool)
        split = launch_split(fwd, reps)
        esize = x.element_size()
        mine = fwd_plan(tuple(x.shape), pool, sms=_build.sm_count(x.device.index), esize=esize)
        plan_ok = {k: mine[k] for k in KERNEL_FWD_PLAN_KEYS} == kernel_fwd_plan(
            tuple(x.shape), pool, mine["rows"], mine["cols"], mine["threads"], esize)
        call = _repeat(_compare(
            "max_pool", fwd, lambda: max_pool_plain(x, pool), reps, rel_tol, x,
            lambda: F.max_pool2d(nchw, window, strides, (padding[0][0], padding[1][0])))
            | {"shape": list(x.shape), "pool": pool, "launches_a_call": len(split),
               "device_ms": sum(ms for _, ms in split), "plan_ok": plan_ok,
               "plan": {k: mine[k] for k in ("rows", "cols", "threads", "blocks")}}, fwd)
        call["ok"] &= call["max_abs_err"] == 0.0 and len(split) == 1 and plan_ok
        pool_fwd.append(call)
        bwd = functools.partial(max_pool_bwd, x, dy, pool)
        split = launch_split(bwd, reps)
        call = _repeat(_compare(
            "max_pool_bwd", bwd, lambda: max_pool_bwd_plain(x, dy, pool), reps, pool_tol, (x, dy))
            | {"shape": list(x.shape), "pool": pool, "launches_a_call": len(split),
               "device_ms": sum(ms for _, ms in split),
               "reference_ms": time_ms(_reference_pool_bwd(x, dy, pool), reps)}, bwd)
        call["ok"] &= len(split) == 1
        pool_bwd.append(call)
        tied = (torch.relu(x.float()) * 2).round().div(2).to(x.dtype)
        dy_q = (torch.randint(-8, 9, dy.shape, generator=gen, device=dy.device) / 4).to(dy.dtype)
        got, want = max_pool_bwd(tied, dy_q, pool), max_pool_bwd_plain(tied, dy_q, pool)
        tie_err = max(tie_err, float((got.float() - want.float()).abs().max()))
    sfx = "_f32" if mode_f32 else ""
    k11 = _merge("max_pool_bwd" + sfx, pool_bwd) | {
        "tie_err": tie_err, "device_ms": sum(c["device_ms"] for c in pool_bwd),
        "reference_ms": sum(c["reference_ms"] for c in pool_bwd)}
    k11["ok"] &= tie_err == 0.0
    k11["bar_met"] = None if mode_f32 else (
        k11["ok"] and k11["ms"] <= K11_BAR_MS and k11["device_ms"] <= K11_BAR_DEVICE_MS)
    k10 = _merge("max_pool" + sfx, pool_fwd) | {"device_ms": sum(c["device_ms"] for c in pool_fwd)}
    k10["bar_met"] = None if mode_f32 else (
        k10["ok"] and k10["ms"] <= K10_BAR_MS and k10["device_ms"] <= K10_BAR_DEVICE_MS)
    k4 = _device_totals(_merge("conv_block", conv_fwd + conv_dx), k4_fns, k4_libs, reps)
    k9 = _merge("conv3x3_dkernel" + sfx, dkernel)
    k9["ok"] &= all(c["repeat_identical"] for c in dkernel)
    return [k9, k10, k11, k4 | {"name": "conv_block_train" + sfx}]


@torch.no_grad()
def check_attention_kernel(q, k, v, key_mask, num_heads: int, *, reps: int = 5,
                           rel_tol: float = REL_TOL, bar_device_ms: float | None = None) -> dict:
    """K8 against its plain version on q, k, v (B, T, D) and ``key_mask``
    (B, T, 1) folded into k and v as `ops.attention.fused_linear_attention`
    folds it (a float32 mask makes bf16 k and v float32); a repeat must be
    bit-identical and a call one launch (``launches_a_call``), both in
    ``ok``; ``device_ms`` a call by launch and ``bar_met``, within
    ``bar_device_ms`` (K8_BAR_DEVICE_MS) where given; ``cluster``, the
    blocks a clip and head the wrapper chose (`cluster_size`).  No single
    PyTorch call computes this function, so there is no library time."""
    k, v = fold_key_mask(k, v, key_mask)
    call = functools.partial(linear_attention_kernel, q, k, v, num_heads)
    split = launch_split(call, reps)
    r = _repeat(_compare("linear_attention", call,
                         lambda: linear_attention_plain(q, k, v, num_heads), reps, rel_tol,
                         (q, k, v)), call) | {
        "shape": list(q.shape), "kv_dtype": str(k.dtype), "launches_a_call": len(split),
        "device_ms": sum(ms for _, ms in split),
        "cluster": cluster_size(q.shape[0], num_heads, _build.sm_count(q.device.index),
                                q.shape[-1] // num_heads)}
    r["ok"] &= len(split) == 1
    dh = q.shape[-1] // num_heads
    _plan_check(r, attention_ops.plan(dh, q.dtype, k.dtype),
                attention_ops.kernel_plan(dh, q.dtype, k.dtype))
    r["bar_met"] = None if bar_device_ms is None else r["ok"] and r["device_ms"] <= bar_device_ms
    return r
