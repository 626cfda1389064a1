"""Each CUDA kernel against its plain PyTorch version, on the card, on the
inputs the main paths give it.

`check_kernels` takes a `DDPMTrainer` on the kernel path, a mel and an x_T
on the card, rebuilds the first ladder step's kernel inputs from them
(the real conditioning, the real encoder activations), and runs every
serving kernel (K1-K4) and its plain version on the same inputs.
`check_train_kernels` does the same for the training layer kernels (K5,
K6) on layer 0 of a training forward, and `check_stgcn_kernels` for K7 on
the perceptual term's inputs (`perceptual_inputs`).  For each kernel it reports the
largest absolute difference, the largest absolute plain value (for a
kernel with several outputs, those of the output worst relative to its own
scale, and every output's pair in ``parts``), whether the difference is
within ``rel_tol`` of that value, and the time per call of both (CUDA
events, after a warm-up call).  Used by ``chip_smoke.py`` at the flagship
shapes and by ``tests/test_torch_port_cuda.py`` at small ones.
"""

from __future__ import annotations

import torch

from .diffusion import q_sample
from .ops.conv_block import conv_block_plain, fused_conv_block
from .ops.decoder_layer import decoder_layer_plain, fused_decoder_layer
from .ops.decoder_layer_bwd import decoder_layer_bwd, decoder_layer_bwd_plain
from .ops.decoder_stack import decoder_stack_plain, fused_decoder_stack
from .ops.sampler_glue import (
    ddim_affine_tables,
    sampler_epilogue,
    sampler_epilogue_plain,
    sampler_prologue,
    sampler_prologue_plain,
)
from .ops.stgcn import frozen_stgcn_plain, stgcn_backward, stgcn_forward
from .train.fused_denoiser import cross_kv_state, pack_layer_weights, train_layer_inputs

REL_TOL = 0.02  # the bound the JAX package holds its reduced-precision modes to


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


def _errors(got, want) -> list[tuple[float, float]]:
    """(max |got - want|, max |want|) of each output."""
    pairs = zip(got, want) if isinstance(got, (tuple, list)) else [(got, want)]
    return [(float((g.float() - w.float()).abs().max()), float(w.float().abs().max()))
            for g, w in pairs]


def _compare(name, kernel_fn, plain_fn, reps, rel_tol):
    parts = _errors(kernel_fn(), plain_fn())
    torch.cuda.synchronize()
    err, ref = max(parts, key=lambda p: p[0] / max(p[1], 1e-30))
    return {
        "name": name, "max_abs_err": err, "ref_max_abs": ref,
        "ok": all(e <= rel_tol * r and r > 0 for e, r in parts),
        "ms": time_ms(kernel_fn, reps), "plain_ms": time_ms(plain_fn, reps),
        "parts": parts,
    }


@torch.no_grad()
def check_kernels(trainer, mel, noise, *, reps: int = 5, rel_tol: float = REL_TOL) -> list[dict]:
    fused, encoder, model = trainer.fused, trainer.fused_encoder, trainer.model
    mxu = fused.mxu_dtype
    results = []

    # K4: every encoder block on the activations the plain chain gives it
    x = mel.to(encoder.mxu_dtype)[..., None]
    conv = {"name": "conv_block", "max_abs_err": 0.0, "ref_max_abs": 1.0, "ok": True,
            "ms": 0.0, "plain_ms": 0.0, "blocks": []}
    for kw in encoder.block_args:
        r = _compare("conv_block", lambda: fused_conv_block(x, mxu_dtype=mxu, **kw),
                     lambda: conv_block_plain(x, mxu_dtype=mxu, **kw), reps, rel_tol)
        conv["blocks"].append({k: r[k] for k in ("max_abs_err", "ref_max_abs", "ms", "plain_ms")}
                              | {"shape": list(x.shape)})
        conv["ok"] &= r["ok"]
        conv["ms"] += r["ms"]
        conv["plain_ms"] += r["plain_ms"]
        if r["max_abs_err"] / r["ref_max_abs"] >= conv["max_abs_err"] / conv["ref_max_abs"]:
            conv["max_abs_err"], conv["ref_max_abs"] = r["max_abs_err"], r["ref_max_abs"]
        x = conv_block_plain(x, mxu_dtype=mxu, **kw)

    # the first ladder step's inputs, from the real conditioning
    t = x.shape[1]
    feats = encoder(mel)
    cond = fused.prepare_cond(dict(model.precompute_cond(*model.cond_from_features(feats)),
                                   temb_table=trainer.temb_table))
    step = trainer.sched.num_timesteps - 1
    temb = cond["temb_table"][int(trainer.sched.timestep_map[step])]
    seq_bias = (fused.seq_emb[:t] + fused.b_joint).contiguous()
    pro_args = (noise, temb, cond["emb_base"], fused.w_joint, seq_bias)
    pro_kw = dict(mxu_dtype=mxu, emb_dtype=mxu)
    results.append(_compare("sampler_prologue", lambda: sampler_prologue(*pro_args, **pro_kw),
                            lambda: sampler_prologue_plain(*pro_args, **pro_kw), reps, rel_tol))

    h, emb_act = sampler_prologue_plain(*pro_args, **pro_kw)
    stack_args = (h, emb_act, cond["kv_stack"], fused.mats, fused.vecs, fused.adaln_w,
                  fused.adaln_b, fused.num_heads)
    results.append(_compare("decoder_stack",
                            lambda: fused_decoder_stack(*stack_args, mxu_dtype=mxu),
                            lambda: decoder_stack_plain(*stack_args, mxu_dtype=mxu),
                            reps, rel_tol))

    h = decoder_stack_plain(*stack_args, mxu_dtype=mxu)
    alpha, beta = ddim_affine_tables(trainer.sched)
    epi_args = (h, noise, fused.w_out, fused.b_out, float(alpha[step]), float(beta[step]))
    results.append(_compare("sampler_epilogue",
                            lambda: sampler_epilogue(*epi_args, mxu_dtype=mxu),
                            lambda: sampler_epilogue_plain(*epi_args, mxu_dtype=mxu),
                            reps, rel_tol))
    results.append(conv)
    return results


@torch.no_grad()
def check_train_kernels(trainer, cond, motion, *, reps: int = 5, rel_tol: float = REL_TOL,
                        seed: int = 0) -> list[dict]:
    """K5 and K6 against their plain versions on the inputs of layer 0 of a
    training forward: ``cond`` (mel, or features with ``cached_features``)
    and ``motion`` (B, T, J, 2) on the card, seeded t and noise, the
    denoiser's packed weights, and a seeded bf16 cotangent (zero on the pad
    rows, as the training path gives it)."""
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
    kw = dict(mxu_dtype=mxu, t_valid=n)
    heads = cfg.denoiser.num_heads
    results = [_compare("decoder_layer", lambda: fused_decoder_layer(*args, heads, **kw),
                        lambda: decoder_layer_plain(*args, heads, **kw), reps, rel_tol)]
    dy = torch.randn(h.shape, generator=gen, device=dev) * 1e-2
    dy[:, n:] = 0
    dy = dy.to(h.dtype)
    results.append(_compare("decoder_layer_bwd",
                            lambda: decoder_layer_bwd(*args, dy, heads, **kw),
                            lambda: decoder_layer_bwd_plain(*args, dy, heads, **kw),
                            reps, rel_tol))
    return results


@torch.no_grad()
def perceptual_inputs(trainer, cond, motion, *, seed: int = 0):
    """The perceptual term's inputs in one training forward of ``trainer``
    on ``cond`` and ``motion`` (B, T, J, 2), with seeded t and noise: pred
    and target (B, T, J, 2), and dy, the cotangent that the loss's L1 mean
    gives pred's latents, sign(f(pred) - f(target)) / numel, with f the
    plain float32 module."""
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
def check_stgcn_kernels(trainer, pred, target, dy, *, reps: int = 5,
                        rel_tol: float = REL_TOL) -> list[dict]:
    """K7 against its plain versions on the perceptual term's inputs
    (`perceptual_inputs`), over the trainer's packed ST-GCN.

    stgcn_forward: the latents of pred (with the activations kept for the
    backward, as the training path runs it) and of target; ms per call is
    the mean of the two.  stgcn_backward: d(pred) from ``dy``, against
    autograd through the plain version, the kernel reading the plain
    forward's activations: the same ReLU masks.  Two bf16 forwards that sum
    in another order flip a few masks, and a flip moves single elements of
    the gradient by several percent of its maximum; ``e2e_err`` is the
    difference with the kernel's own forward, reported and not bounded."""
    pack, mxu = trainer.feat_pack, getattr(torch, trainer.cfg.denoiser.compute_dtype)
    fwd = _compare(
        "stgcn_forward",
        lambda: (stgcn_forward(pred, pack, save=True)[0], stgcn_forward(target, pack)),
        lambda: (frozen_stgcn_plain(pred, pack, mxu), frozen_stgcn_plain(target, pack, mxu)),
        reps, rel_tol)
    fwd["ms"], fwd["plain_ms"] = fwd["ms"] / 2, fwd["plain_ms"] / 2
    with torch.enable_grad():
        x = pred.detach().requires_grad_(True)
        out, saved = frozen_stgcn_plain(x, pack, mxu, save=True)
    saved = tuple(a.detach() for a in saved)
    bwd = _compare("stgcn_backward", lambda: stgcn_backward(dy, saved, pack),
                   lambda: torch.autograd.grad(out, x, dy, retain_graph=True)[0], reps, rel_tol)
    own = stgcn_backward(dy, stgcn_forward(pred, pack, save=True)[1], pack)
    bwd["e2e_err"] = _errors(own, torch.autograd.grad(out, x, dy)[0])[0][0]
    return [fwd, bwd]
