"""Packed-weight fused paths for the MotionTransformer: serving and training.

Port of `conductor_tpu/train/fused_denoiser.py`: `pack_layer_weights` (one
layer's weights -> the (9, D, D) matrix bank, the (24, D) vector bank and
the (E, 6D) AdaLN slice that the decoder kernels read), `expand_block_diag`,
`FusedDenoiser` (`__init__`, `prepare_cond`, `__call__`, `ddim_sample`),
`cross_kv_state` and `fused_train_denoise`.  The banks are built from the
port's `MotionTransformer`, whose per-sublayer AdaLN Linears
(`...{sa_block,ca_block,ffn}.proj_out.emb_layers.1`) are concatenated per
layer the way `conductor_tpu/interop/torch_import.py` packs them for flax.
The packing is differentiable (stack, pad and slice are linear), so the
training path's gradients reach the module's own parameters.

`ddim_sample` is the kernel path of a START_X DDIM ladder without
guidance: per step the prologue (K2), the decoder stack (K1) and the
epilogue (K3), in the int8-AdaLN and bf16-VPU modes when the config turns
them on.  `__call__` is one denoiser call, plain glue around K1 in those
modes: the ``denoise_fn`` of every other serving call (guidance, the
ancestral sampler, the other mean types), which the generic samplers
drive.
`fused_train_denoise` is the training forward: every layer through
`fused_decoder_layer_train`, K5 forward and K6 backward.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..config import Config
from ..models.precision import linear
from ..models.transformer import MotionTransformer, timestep_embedding
from ..ops.decoder_layer_bwd import fused_decoder_layer_train
from ..ops.decoder_stack import ROWS_PER_TILE, fused_decoder_stack, quantize_rows
from ..ops.sampler_glue import (
    ddim_affine_tables,
    emb_activation,
    ladder_glue,
)


def _wt(linear: torch.nn.Linear) -> torch.Tensor:
    """torch Linear weight (out, in) -> (in, out) float32."""
    return linear.weight.float().t()


def pack_layer_weights(model: MotionTransformer, layer: int):
    """Layer ``layer`` -> (mats (9, D, D), vecs (24, D), adaln_w (E, 6D),
    adaln_b (6D,)), all float32, in the bank order of
    `ops/decoder_stack.py`.  Differentiable; serving calls it under
    `torch.no_grad`."""
    d = model.latent_dim
    blk = model.temporal_decoder_blocks[layer]
    sa, ca, ff = blk.sa_block, blk.ca_block, blk.ffn
    styls = (sa.proj_out, ca.proj_out, ff.proj_out)

    def pad_to(a, shape):
        # zero-pad W1 / W2 / b1 from ff_size to D; a wider FFN does not fit
        # the (D, D) banks, and JAX's `_pad_to` raises on it too
        pads = [p for n, s in zip(reversed(a.shape), reversed(shape)) for p in (0, s - n)]
        if min(pads) < 0:
            raise ValueError(f"pack_layer_weights: the FFN's {tuple(a.shape)} does not fit the "
                             f"fused layers' {tuple(shape)} (ff_size > latent_dim)")
        return F.pad(a, pads)

    mats = torch.stack([
        _wt(sa.query), _wt(sa.key), _wt(sa.value), _wt(sa.proj_out.out_layers[2]),
        _wt(ca.query), _wt(ca.proj_out.out_layers[2]),
        pad_to(_wt(ff.linear1), (d, d)), pad_to(_wt(ff.linear2), (d, d)),
        _wt(ff.proj_out.out_layers[2]),
    ])
    rows = [
        sa.norm.weight, sa.norm.bias, sa.query.bias, sa.key.bias, sa.value.bias,
        sa.proj_out.norm.weight, sa.proj_out.norm.bias, sa.proj_out.out_layers[2].bias,
        ca.norm.weight, ca.norm.bias, ca.query.bias,
        ca.proj_out.norm.weight, ca.proj_out.norm.bias, ca.proj_out.out_layers[2].bias,
        pad_to(ff.linear1.bias, (d,)), ff.linear2.bias,
        ff.proj_out.norm.weight, ff.proj_out.norm.bias, ff.proj_out.out_layers[2].bias,
    ]
    vecs = torch.cat([torch.stack([r.float() for r in rows]),
                      torch.zeros((24 - len(rows), d), device=mats.device)])
    adaln_w = torch.cat([_wt(s.emb_layers[1]) for s in styls], dim=1)
    adaln_b = torch.cat([s.emb_layers[1].bias.float() for s in styls])
    return mats, vecs, adaln_w, adaln_b


def expand_block_diag(kv: torch.Tensor) -> torch.Tensor:
    """(B, H, Dh, Dh) cross-KV state -> (B, H*Dh, H*Dh) block diagonal."""
    b, h, dh, _ = kv.shape
    eye = torch.eye(h, dtype=kv.dtype, device=kv.device)
    return torch.einsum("bhpq,hg->bhpgq", kv, eye).reshape(b, h * dh, h * dh)


class FusedDenoiser:
    """The denoiser as packed weight banks for the decoder-stack kernel,
    built once from a loaded `MotionTransformer`.  With
    ``sampler_adaln_int8`` the AdaLN weights are int8 per column with
    float32 scales and each step's activations int8 per row; with
    ``sampler_vpu_dtype="bfloat16"`` the kernel's elementwise chains run in
    bf16 (`ops/decoder_stack.py`)."""

    def __init__(self, model: MotionTransformer, cfg: Config):
        d = cfg.denoiser
        if d.sampler_vpu_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown sampler_vpu_dtype: {d.sampler_vpu_dtype}")
        self.num_heads = d.num_heads
        self.latent_dim = d.latent_dim
        self.mxu_dtype = getattr(torch, d.compute_dtype)
        self.vpu_dtype = getattr(torch, d.sampler_vpu_dtype)
        self.adaln_int8 = d.sampler_adaln_int8
        with torch.no_grad():
            banks = [pack_layer_weights(model, i) for i in range(d.num_layers)]
            # matrices feed the matmul units only: store them at mxu_dtype
            self.mats = torch.stack([bk[0] for bk in banks]).to(self.mxu_dtype).contiguous()
            self.vecs = torch.stack([bk[1] for bk in banks]).contiguous()
            adaln_w = torch.stack([bk[2] for bk in banks])  # (L, E, 6D) float32
            self.adaln_w_scale = None
            if self.adaln_int8:
                # per column: quantize_rows over the E axis through a
                # transpose, from the float32 weights, as JAX packs them
                q, s = quantize_rows(adaln_w.transpose(1, 2))
                self.adaln_w = q.transpose(1, 2).contiguous()             # (L, E, 6D) int8
                self.adaln_w_scale = s.transpose(1, 2).contiguous()       # (L, 1, 6D)
            else:
                self.adaln_w = adaln_w.to(self.mxu_dtype).contiguous()
            self.adaln_b = torch.stack([bk[3] for bk in banks]).contiguous()
            self.w_joint = _wt(model.joint_embed).contiguous()          # (C, D)
            self.b_joint = model.joint_embed.bias.detach().float()
            self.seq_emb = model.sequence_embedding.detach().float()
            self.w_out = _wt(model.out).contiguous()                    # (D, C)
            self.b_out = model.out.bias.detach().float().contiguous()
        self.time_embed = model.time_embed

    def prepare_cond(self, cond: dict) -> dict:
        """`MotionTransformer.precompute_cond` output -> fused-path cond."""
        out = {
            "emb_base": cond["emb_base"].float().contiguous(),
            "kv_stack": torch.stack([expand_block_diag(kv) for kv in cond["cross"]])
            .to(self.mxu_dtype).contiguous(),
        }
        if "temb_table" in cond:
            out["temb_table"] = cond["temb_table"].float().contiguous()
        return out

    def _stack(self, h, emb_act, emb_scale, cond):
        return fused_decoder_stack(
            h, emb_act, cond["kv_stack"], self.mats, self.vecs, self.adaln_w, self.adaln_b,
            self.num_heads, mxu_dtype=self.mxu_dtype, vpu_dtype=self.vpu_dtype,
            emb_scale=emb_scale, adaln_w_scale=self.adaln_w_scale,
        )

    @torch.no_grad()
    def __call__(self, x: torch.Tensor, t: torch.Tensor, cond: dict) -> torch.Tensor:
        """One denoiser call on a `prepare_cond` condition at the
        original-ladder timesteps ``t`` (B,): plain glue around the
        decoder-stack kernel, one launch a call."""
        T = x.shape[1]
        if "temb_table" in cond:
            temb = cond["temb_table"][t]
        else:
            temb = self.time_embed(timestep_embedding(t, self.latent_dim))
        emb_act, emb_scale = emb_activation(temb[:, None, :] + cond["emb_base"],
                                            emb_dtype=self.mxu_dtype,
                                            quantize_emb=self.adaln_int8)
        h = x @ self.w_joint + self.b_joint + self.seq_emb[None, :T]
        h = self._stack(h.contiguous(), emb_act.contiguous(), emb_scale, cond)
        return (h @ self.w_out + self.b_out).float()

    @torch.no_grad()
    def ddim_sample(self, cond: dict, sched, noise: torch.Tensor) -> torch.Tensor:
        """The whole eta=0 DDIM ladder from x_T = ``noise`` (B, T, C), each
        step prologue -> decoder stack -> epilogue (K2 and K3 checked once a
        ladder, `ladder_glue`).  Matches
        `diffusion.sampling.ddim_sample_loop` over :meth:`__call__`."""
        T = noise.shape[1]
        alpha, beta = ddim_affine_tables(sched)
        t_model = sched.timestep_map.tolist()
        seq_bias = (self.seq_emb[:T] + self.b_joint).contiguous()
        temb_table = cond["temb_table"]
        x = noise.float().contiguous()
        prologue, epilogue = ladder_glue(x, temb_table, cond["emb_base"], self.w_joint, seq_bias,
                                         self.w_out, self.b_out, mxu_dtype=self.mxu_dtype,
                                         quantize_emb=self.adaln_int8)
        for t in range(sched.num_timesteps - 1, -1, -1):
            h, emb_act, emb_scale = prologue(x, temb_table[t_model[t]])
            h = self._stack(h, emb_act, emb_scale, cond)
            x = epilogue(h, x, alpha[t], beta[t])
        return x


def cross_kv_state(ca_block, xf_o: torch.Tensor) -> torch.Tensor:
    """One layer's cross-attention state `LinearCrossAttention.kv_state`
    in float32, as JAX `cross_kv_state` computes it whatever the model's
    dtype, as the (B, D, D) block-diagonal matrix the layer kernels read;
    plain torch and differentiable in the block's norm / key / value
    weights."""
    return expand_block_diag(ca_block.kv_state(xf_o, torch.float32))


def train_layer_inputs(model: MotionTransformer, cfg: Config, x: torch.Tensor, t: torch.Tensor,
                       xf_proj: torch.Tensor, xf_out: torch.Tensor):
    """The inputs of the training layer stack: (h, emb_act, xf_o), with
    ``h`` (B, Tp, D) and ``emb_act`` (B, Tp, E) in the compute dtype and
    padded once to the kernel's row tile (Tp = T rounded up to 64), and
    ``xf_o`` the projected music tokens of the cross-attention states.  The
    glue runs in float32 from the condition, whatever the model's dtype, as
    in JAX `fused_train_denoise`."""
    d = cfg.denoiser
    mxu = getattr(torch, d.compute_dtype)
    b, n = x.shape[0], x.shape[1]
    x = x.reshape(b, n, -1)
    emb_base = linear(model.linear, xf_proj, torch.float32)
    xf_o = linear(model.linear, xf_out, torch.float32)
    temb = model.time_embed(timestep_embedding(t, d.latent_dim))
    emb_act = F.silu(temb[:, None, :] + emb_base).to(mxu)
    h = (model.joint_embed(x) + model.sequence_embedding[None, :n]).to(mxu)
    pad = -(-n // ROWS_PER_TILE) * ROWS_PER_TILE - n
    return F.pad(h, (0, 0, 0, pad)), F.pad(emb_act, (0, 0, 0, pad)), xf_o


def fused_train_denoise(model: MotionTransformer, cfg: Config, x: torch.Tensor, t: torch.Tensor,
                        xf_proj: torch.Tensor, xf_out: torch.Tensor) -> torch.Tensor:
    """The denoiser's training forward over the packed layers, mirroring
    `MotionTransformer.forward` for the default training configuration
    (linear attention, dropout 0, full mask).  ``h`` and ``emb_act`` go to
    the compute dtype before the layers, and T is padded once to the
    kernel's row tile with ``t_valid = T``, as in JAX
    `fused_train_denoise`."""
    d = cfg.denoiser
    mxu = getattr(torch, d.compute_dtype)
    n = x.shape[1]
    h, emb_act, xf_o = train_layer_inputs(model, cfg, x, t, xf_proj, xf_out)
    for i, blk in enumerate(model.temporal_decoder_blocks):
        mats, vecs, aw, ab = pack_layer_weights(model, i)
        kvb = cross_kv_state(blk.ca_block, xf_o).to(mxu)
        h = fused_decoder_layer_train(h, emb_act, kvb, mats, vecs, aw, ab, d.num_heads,
                                      mxu_dtype=mxu, t_valid=n)
    return model.out(h[:, :n].float())
