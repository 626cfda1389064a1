"""MotionTransformer, the diffusion denoiser: the serving surface.

Port of `conductor_tpu/models/transformer.py:44-508` (`timestep_embedding`,
`StylizationBlock`, `LinearSelfAttention`, `LinearCrossAttention` with its
step-invariant `kv_state`, the quadratic blocks of ``efficient=False``
(the reference's ``--no_eff``), `FFN`, `DecoderLayer`, and
`MotionTransformer`'s `encode_music`, `cond_from_features` with the
training-time condition dropout, `encode_null`, `precompute_cond`,
`time_embed_table` and `denoise`; and `guided_denoiser`, the
classifier-free guidance of a serving call).  The music encoder is
frozen: it runs without gradients and in eval mode.

Denoiser dropout (``dropout > 0``) sits at JAX's four sites a layer
(`conductor_tpu/models/transformer.py:84-85`, `:231-232`): after the SiLU
of each of the three StylizationBlocks (index 1 of ``out_layers``, the
reference's own slot) and after the FFN's GELU (``ffn.dropout``).  It
follows flax's rule, ``select(keep, x / keep_prob, 0)`` with the division
in x's dtype (`Dropout`), and runs only when a forward is called with
``train=True``; the keep masks are handed over per site
(`dropout_keep`) or drawn from a generator.

``dtype`` is flax's ``dtype=`` (`models.precision`): parameters stay
float32; every Linear and LayerNorm returns ``dtype`` (the AdaLN projection
``silu(emb) @ W + b`` included, JAX `_adaln_mods`), the residual stream is
in ``dtype``, the query softmaxes and the cross-attention product run in
it, the cross-attention KV state takes its time softmax and contraction in
float32 and is rounded to ``dtype`` (JAX `transformer.py:147-151`), the
music encoder runs in ``dtype``, and the output is float32.  The quadratic
blocks round where JAX's do: the scores in ``dtype``, promoted to float32
by the self-attention's float32 key mask (so its softmax and its product
with v run in float32), the cross-attention's softmax and product in
``dtype``.  ``attention_impl`` picks the linear self-attention: "xla", the
module math, or "pallas", the K8 kernel (`ops.attention`); the quadratic
blocks have no kernel.

Parameter names are the reference state-dict keys
(`Diffusion_Stage/models/transformer.py`), so a reference checkpoint loads
with ``load_state_dict(strict=True)``; the quadratic and linear variants
share them.  Unlike the flax module, which packs all AdaLN projections
into one shared kernel, every StylizationBlock keeps its own
``emb_layers.1`` Linear as in the reference; the fused path packs them
into a per-layer (E, 6D) bank (`train/fused_denoiser.py`).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.linear_attention import _einsum, temporal_linear_attention
from .music_encoder import MusicEncoder
from .precision import layer_norm, linear

LN_EPS = 1e-5


def timestep_embedding(timesteps: torch.Tensor, dim: int, max_period: float = 10000.0):
    """Sinusoidal timestep embedding, [cos | sin] (the reference puts cos
    first)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=timesteps.device)
        / half
    )
    args = timesteps[:, None].float() * freqs[None]
    emb = torch.cat([torch.cos(args), torch.sin(args)], dim=-1)
    if dim % 2:
        emb = torch.cat([emb, torch.zeros_like(emb[:, :1])], dim=-1)
    return emb


def cond_keep_mask(shape, prob: float, generator: torch.Generator | None,
                   device: torch.device | str) -> torch.Tensor:
    """A float 0/1 mask that keeps each entry with probability 1 - prob."""
    gen_device = generator.device if generator is not None else device
    u = torch.rand(tuple(shape), generator=generator, device=gen_device)
    return (u >= prob).float().to(device)


class Dropout(nn.Module):
    """flax's `nn.Dropout` rule (`flax.linen.Dropout.__call__`): each
    element kept where ``keep`` is true and divided by ``keep_prob = 1 - p``
    in x's dtype (in bf16 ``keep_prob`` is rounded to bf16 first and each
    kept element after the division, as a weakly typed scalar divides in
    JAX; a float32 scale would round otherwise), the rest zero; ``p = 1``
    zeroes everything.  ``drop`` is the forward's keep-mask source,
    ``drop(site, shape) -> bool mask``, None outside training; ``site`` is
    the module's name in the `MotionTransformer`."""

    def __init__(self, p: float):
        super().__init__()
        self.p = float(p)
        self.site = ""

    def forward(self, x: torch.Tensor, drop=None) -> torch.Tensor:
        if drop is None or self.p == 0.0:
            return x
        if self.p == 1.0:
            return torch.zeros_like(x)
        keep = drop(self.site, tuple(x.shape)).to(device=x.device, dtype=torch.bool)
        return torch.where(keep, x / x.new_full((), 1.0 - self.p), x.new_zeros(()))


def name_dropout_sites(module: nn.Module) -> None:
    """Name each `Dropout`'s site after its path in ``module``."""
    for name, m in module.named_modules():
        if isinstance(m, Dropout):
            m.site = name


def dropout_sites(module: nn.Module) -> list[str]:
    """The names of ``module``'s `Dropout` modules, in registration order."""
    return [name for name, m in module.named_modules() if isinstance(m, Dropout)]


def keep_mask_source(p: float, train: bool, dropout_keep=None,
                     generator: torch.Generator | None = None, device=None):
    """The keep-mask source of a forward, ``drop(site, shape) -> bool``,
    or None where nothing drops (``train`` off or ``p == 0``).
    ``dropout_keep`` is a mapping from site names to masks (true keeps),
    or a callable ``(site, shape) -> mask``; without it each site draws
    ``uniform < 1 - p`` from ``generator`` (the default generator, on
    ``device``, if None) as the forward reaches it."""
    if not train or p == 0.0:
        return None
    if dropout_keep is None:
        def dropout_keep(site, shape):
            gen_device = generator.device if generator is not None else device
            return torch.rand(shape, generator=generator, device=gen_device) < 1.0 - p
    elif not callable(dropout_keep):
        masks = dropout_keep
        dropout_keep = lambda site, shape: masks[site]  # noqa: E731
    return dropout_keep


class StylizationBlock(nn.Module):
    """AdaLN: h -> Linear(dropout(silu(LN(h) * (1 + scale) + shift))), with
    (scale, shift) = Linear(silu(emb))."""

    def __init__(self, latent_dim: int, time_embed_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.emb_layers = nn.Sequential(nn.SiLU(), nn.Linear(time_embed_dim, 2 * latent_dim))
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        # index 1 is the reference's dropout
        self.out_layers = nn.Sequential(nn.SiLU(), Dropout(dropout), nn.Linear(latent_dim, latent_dim))

    def forward(self, h: torch.Tensor, emb: torch.Tensor, drop=None) -> torch.Tensor:
        dt = self.dtype
        scale, shift = linear(self.emb_layers[1], F.silu(emb), dt).chunk(2, dim=-1)
        h = F.silu(layer_norm(self.norm, h, dt) * (1 + scale) + shift)
        return linear(self.out_layers[2], self.out_layers[1](h, drop), dt)


class LinearSelfAttention(nn.Module):
    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "xla",
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype, self.attention_impl = num_heads, dtype, attention_impl
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dtype, dropout)

    def forward(self, x, emb, src_mask, drop=None):
        dt = self.dtype
        xn = layer_norm(self.norm, x, dt)
        y = temporal_linear_attention(
            linear(self.query, xn, dt), linear(self.key, xn, dt), linear(self.value, xn, dt),
            self.num_heads, src_mask, impl=self.attention_impl,
        )
        return x + self.proj_out(y, emb, drop)


class LinearCrossAttention(nn.Module):
    """Cross-attention over the music tokens, without a key mask.  The key
    and value path depends only on the music, so `kv_state` computes the
    time-softmaxed K^T V (B, H, Dh, Dh) once per clip."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.text_norm = nn.LayerNorm(text_latent_dim, eps=LN_EPS)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dtype, dropout)

    def kv_state(self, xf: torch.Tensor, dtype: torch.dtype | None = None) -> torch.Tensor:
        """(B, H, Dh, Dh), the time softmax and the contraction in float32
        from the projections in ``dtype`` (the block's by default), rounded
        to ``dtype``."""
        dt = dtype or self.dtype
        fn = layer_norm(self.text_norm, xf, dt)
        k, v = linear(self.key, fn, dt), linear(self.value, fn, dt)
        b, n, d = k.shape
        h = self.num_heads
        # the time softmax runs over the last dimension: PyTorch's softmax
        # over the middle dimension of (B, N, H, Dh) took ~1 ms a layer on an
        # H100 at N = 1800
        kh = torch.softmax(k.float().transpose(1, 2), dim=-1).reshape(b, h, d // h, n)
        return (kh @ v.float().reshape(b, n, h, d // h).transpose(1, 2)).to(dt)

    def forward(self, x, kv, emb, drop=None):
        q = linear(self.query, layer_norm(self.norm, x, self.dtype), self.dtype)
        b, t, d = q.shape
        h = self.num_heads
        qh = torch.softmax(q.reshape(b, t, h, d // h), dim=-1)
        y = torch.einsum("bnhd,bhdl->bnhl", qh, kv).reshape(b, t, d)
        return x + self.proj_out(y, emb, drop)


def quadratic_self_attention(q, k, v, num_heads: int, src_mask: torch.Tensor | None):
    """O(T^2) softmax attention (JAX `ops/linear_attention.py:89-115`):
    scores scaled by sqrt(D/H), the additive ``(1 - mask) * -1e5`` on KEY
    positions (JAX's deliberate fix of the reference's query-side mask,
    which is a no-op; with a full mask the two coincide), softmax over
    keys.  In the inputs' dtype with JAX's promotion: a float32 mask makes
    the scores, the softmax and the product with v float32.  The scores are
    laid out (B, H, Tq, Tk), so that the softmax runs over the last axis."""
    b, t, d = q.shape
    h = num_heads
    qh, kh, vh = q.reshape(b, t, h, d // h), k.reshape(b, -1, h, d // h), v.reshape(b, -1, h, d // h)
    scores = torch.einsum("bnhd,bmhd->bhnm", qh, kh) / math.sqrt(d / h)
    if src_mask is not None:
        scores = scores + (1.0 - src_mask[:, None, None, :, 0]) * -100000.0
    weights = torch.softmax(scores, dim=-1)
    return _einsum("bhnm,bmhd->bnhd", weights, vh).reshape(b, t, d)


class QuadraticSelfAttention(nn.Module):
    """``efficient=False`` self-attention, O(T^2) (JAX
    `QuadraticSelfAttention`, the reference's `transformer.py:198-229`),
    under `LinearSelfAttention`'s parameter names."""

    def __init__(self, latent_dim: int, num_heads: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(latent_dim, latent_dim)
        self.value = nn.Linear(latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dtype, dropout)

    def forward(self, x, emb, src_mask, drop=None):
        dt = self.dtype
        xn = layer_norm(self.norm, x, dt)
        y = quadratic_self_attention(linear(self.query, xn, dt), linear(self.key, xn, dt),
                                     linear(self.value, xn, dt), self.num_heads, src_mask)
        return x + self.proj_out(y, emb, drop)


class QuadraticCrossAttention(nn.Module):
    """``efficient=False`` cross-attention over the music tokens, O(T N),
    without a mask (JAX `QuadraticCrossAttention`, the reference's
    `transformer.py:231-264`), under `LinearCrossAttention`'s parameter
    names.  `kv_state` is the step-invariant (K, V) of the tokens."""

    def __init__(self, latent_dim: int, text_latent_dim: int, num_heads: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.norm = nn.LayerNorm(latent_dim, eps=LN_EPS)
        self.text_norm = nn.LayerNorm(text_latent_dim, eps=LN_EPS)
        self.query = nn.Linear(latent_dim, latent_dim)
        self.key = nn.Linear(text_latent_dim, latent_dim)
        self.value = nn.Linear(text_latent_dim, latent_dim)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dtype, dropout)

    def kv_state(self, xf: torch.Tensor, dtype: torch.dtype | None = None):
        """(K, V), each (B, N, D) in ``dtype`` (the block's by default)."""
        dt = dtype or self.dtype
        fn = layer_norm(self.text_norm, xf, dt)
        return linear(self.key, fn, dt), linear(self.value, fn, dt)

    def forward(self, x, kv, emb, drop=None):
        k, v = kv
        q = linear(self.query, layer_norm(self.norm, x, self.dtype), self.dtype)
        b, t, d = q.shape
        h = self.num_heads
        scores = torch.einsum("bnhd,bmhd->bhnm", q.reshape(b, t, h, d // h),
                              k.reshape(b, -1, h, d // h)) / math.sqrt(d / h)
        weights = torch.softmax(scores, dim=-1)
        y = _einsum("bhnm,bmhd->bnhd", weights, v.reshape(b, -1, h, d // h)).reshape(b, t, d)
        return x + self.proj_out(y, emb, drop)


class FFN(nn.Module):
    """tanh-GELU FFN (the JAX package's `nn.gelu` is the tanh form), with
    dropout after the GELU."""

    def __init__(self, latent_dim: int, ffn_dim: int, time_embed_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        self.dtype = dtype
        self.linear1 = nn.Linear(latent_dim, ffn_dim)
        self.linear2 = nn.Linear(ffn_dim, latent_dim)
        self.dropout = Dropout(dropout)
        self.proj_out = StylizationBlock(latent_dim, time_embed_dim, dtype, dropout)

    def forward(self, x, emb, drop=None):
        dt = self.dtype
        y = self.dropout(F.gelu(linear(self.linear1, x, dt), approximate="tanh"), drop)
        return x + self.proj_out(linear(self.linear2, y, dt), emb, drop)


class DecoderLayer(nn.Module):
    """self-attention -> cross-attention -> FFN; linear attention, or with
    ``efficient=False`` the quadratic blocks."""

    def __init__(self, latent_dim, ffn_dim, num_heads, time_embed_dim,
                 dtype: torch.dtype = torch.float32, attention_impl: str = "xla",
                 efficient: bool = True, dropout: float = 0.0):
        super().__init__()
        if efficient:
            self.sa_block = LinearSelfAttention(latent_dim, num_heads, time_embed_dim, dtype,
                                                attention_impl, dropout)
            self.ca_block = LinearCrossAttention(latent_dim, time_embed_dim, num_heads,
                                                 time_embed_dim, dtype, dropout)
        else:
            self.sa_block = QuadraticSelfAttention(latent_dim, num_heads, time_embed_dim, dtype,
                                                   dropout)
            self.ca_block = QuadraticCrossAttention(latent_dim, time_embed_dim, num_heads,
                                                    time_embed_dim, dtype, dropout)
        self.ffn = FFN(latent_dim, ffn_dim, time_embed_dim, dtype, dropout)

    def forward(self, x, cross_kv, emb, src_mask, drop=None):
        x = self.sa_block(x, emb, src_mask, drop)
        x = self.ca_block(x, cross_kv, emb, drop)
        return self.ffn(x, emb, drop)


class MotionTransformer(nn.Module):
    """The denoiser.  ``forward(x, t, xf_proj, xf_out)`` returns the x0
    prediction (B, T, input_feats) from pre-encoded music."""

    def __init__(
        self,
        input_feats: int = 26,
        num_frames: int = 1800,
        latent_dim: int = 128,
        ff_size: int = 64,
        num_layers: int = 8,
        num_heads: int = 8,
        music_latent_dim: int = 64,
        cond_mask_prob: float = 0.1,
        dtype: torch.dtype = torch.float32,
        attention_impl: str = "xla",
        efficient: bool = True,
        dropout: float = 0.0,
    ):
        super().__init__()
        if not 0.0 <= dropout <= 1.0:
            raise ValueError(f"dropout must lie in [0, 1], got {dropout}")
        self.latent_dim = latent_dim
        self.dropout = dropout
        self.music_latent_dim = music_latent_dim
        self.efficient = efficient
        self.num_heads = num_heads
        self.cond_mask_prob = cond_mask_prob
        self.dtype = dtype
        time_embed_dim = latent_dim * 4
        self.music_encoder = MusicEncoder(out_dim=music_latent_dim, dtype=dtype)
        self.proj = nn.Linear(music_latent_dim, music_latent_dim)
        # the reference hard-codes Linear(64, 512); the music tokens are added
        # to the time embedding, so the width tracks time_embed_dim
        self.linear = nn.Linear(music_latent_dim, time_embed_dim)
        self.joint_embed = nn.Linear(input_feats, latent_dim)
        self.sequence_embedding = nn.Parameter(torch.randn(num_frames, latent_dim))
        self.time_embed = nn.Sequential(
            nn.Linear(latent_dim, time_embed_dim), nn.SiLU(),
            nn.Linear(time_embed_dim, time_embed_dim),
        )
        self.temporal_decoder_blocks = nn.ModuleList(
            DecoderLayer(latent_dim, ff_size, num_heads, time_embed_dim, dtype, attention_impl,
                         efficient, dropout)
            for _ in range(num_layers)
        )
        self.out = nn.Linear(latent_dim, input_feats)
        name_dropout_sites(self)

    def dropout_sites(self) -> list[str]:
        """The names of the denoiser's dropout modules, four a layer, in the
        order a forward reaches them: each layer's self-attention, cross-
        attention, FFN (after the GELU) and FFN StylizationBlock, e.g.
        ``temporal_decoder_blocks.0.sa_block.proj_out.out_layers.1``,
        ``temporal_decoder_blocks.0.ffn.dropout``."""
        return dropout_sites(self)

    @classmethod
    def from_config(cls, d) -> "MotionTransformer":
        """Build from a `DenoiserConfig`, its compute dtype, attention impl,
        ``efficient_attention`` and ``dropout`` included; an unresolved "auto" takes the
        plain module's float32 and "xla" (the trainers resolve first,
        `config.resolve_auto`)."""
        dtype = "float32" if d.compute_dtype == "auto" else d.compute_dtype
        return cls(
            input_feats=d.input_feats, num_frames=d.num_frames, latent_dim=d.latent_dim,
            ff_size=d.ff_size, num_layers=d.num_layers, num_heads=d.num_heads,
            music_latent_dim=d.music_latent_dim, cond_mask_prob=d.cond_mask_prob,
            dtype=getattr(torch, dtype),
            attention_impl="xla" if d.attention_impl == "auto" else d.attention_impl,
            efficient=d.efficient_attention, dropout=d.dropout,
        )

    def encode_music(self, mel: torch.Tensor, train: bool = False, *,
                     keep: torch.Tensor | None = None, generator: torch.Generator | None = None):
        """mel (B, T90, 128) -> (xf_proj, xf_out), both (B, T30, 64), with
        the frozen encoder in eval mode and without gradients."""
        self.music_encoder.eval()
        with torch.no_grad():
            feats = self.music_encoder(mel)
        return self.cond_from_features(feats, train, keep=keep, generator=generator)

    def cond_from_features(self, feats: torch.Tensor, train: bool = False, *,
                           keep: torch.Tensor | None = None,
                           generator: torch.Generator | None = None):
        """Frozen-encoder features (B, T30, 64) -> (xf_proj, xf_out).  With
        ``train`` and ``cond_mask_prob > 0`` each (b, t) token is zeroed
        with probability ``cond_mask_prob`` (JAX `transformer.py:355-385`):
        by the (B, T30) 0/1 mask ``keep`` if given, else by one drawn from
        ``generator``."""
        x = feats.detach()
        if train and self.cond_mask_prob > 0:
            if keep is None:
                keep = cond_keep_mask(x.shape[:2], self.cond_mask_prob, generator, x.device)
            x = x * keep.to(x)[..., None]
        return linear(self.proj, x, self.dtype), x

    def encode_null(self, batch: int, frames: int):
        """The null condition of classifier-free guidance, as training's
        condition dropout makes it: zeroed encoder tokens (B, T30, 64)
        through ``proj`` (whose bias is not zero) -> (xf_proj, xf_out)."""
        x = torch.zeros((batch, frames, self.music_latent_dim), dtype=self.dtype,
                        device=self.sequence_embedding.device)
        return linear(self.proj, x, self.dtype), x

    def precompute_cond(self, xf_proj: torch.Tensor, xf_out: torch.Tensor) -> dict:
        """The step-invariant conditioning: the music projection added to
        the time embedding, and every layer's cross-attention state (the
        K^T V of the linear blocks, the (K, V) of the quadratic ones)."""
        xf_o = linear(self.linear, xf_out, self.dtype)
        return {
            "emb_base": linear(self.linear, xf_proj, self.dtype),
            "cross": [blk.ca_block.kv_state(xf_o) for blk in self.temporal_decoder_blocks],
        }

    def _time_embed(self, timesteps: torch.Tensor) -> torch.Tensor:
        temb = timestep_embedding(timesteps, self.latent_dim)
        first, _, second = self.time_embed
        return linear(second, F.silu(linear(first, temb, self.dtype)), self.dtype)

    def time_embed_table(self, num_timesteps: int) -> torch.Tensor:
        """All (num_timesteps, 4*latent) time embeddings in one batch."""
        return self._time_embed(torch.arange(num_timesteps, device=self.sequence_embedding.device))

    def dropper(self, train: bool, dropout_keep=None, generator: torch.Generator | None = None):
        """The keep-mask source of a forward, ``drop(site, shape) -> bool``,
        or None where nothing drops (``train`` off or ``dropout == 0``).
        ``dropout_keep`` is a mapping from `dropout_sites` names to (B, T,
        width) masks (true keeps), or a callable ``(site, shape) -> mask``;
        without it each site draws ``uniform < 1 - dropout`` from
        ``generator`` (the default generator if None) in the order of
        `dropout_sites`."""
        return keep_mask_source(self.dropout, train, dropout_keep, generator,
                                self.sequence_embedding.device)

    def denoise(self, x, timesteps, cond: dict, src_mask: torch.Tensor | None = None, *,
                train: bool = False, dropout_keep=None, generator: torch.Generator | None = None):
        """One denoiser call on a `precompute_cond` condition; ``src_mask``
        (B, T, 1) is the self-attention's key mask, all ones by default (in
        float32, as JAX makes it from the float32 x).  With ``train`` the
        dropout modules drop by `dropper`'s masks; without it nothing
        drops, as JAX's ``train=False``."""
        drop = self.dropper(train, dropout_keep, generator)
        b, t = x.shape[0], x.shape[1]
        if x.ndim == 4:  # (B, T, J, 2) -> (B, T, 26)
            x = x.reshape(b, t, -1)
        if src_mask is None:
            src_mask = torch.ones((b, t, 1), device=x.device)
        if "temb_table" in cond:
            temb = cond["temb_table"][timesteps]
        else:
            temb = self._time_embed(timesteps)
        emb = temb[:, None, :] + cond["emb_base"]
        h = linear(self.joint_embed, x, self.dtype) + self.sequence_embedding[None, :t].to(self.dtype)
        for blk, kv in zip(self.temporal_decoder_blocks, cond["cross"]):
            h = blk(h, kv, emb, src_mask, drop)
        return linear(self.out, h, self.dtype).float()

    def forward(self, x, timesteps, xf_proj, xf_out, src_mask=None, *, train: bool = False,
                dropout_keep=None, generator: torch.Generator | None = None):
        return self.denoise(x, timesteps, self.precompute_cond(xf_proj, xf_out), src_mask,
                            train=train, dropout_keep=dropout_keep, generator=generator)


def guided_denoiser(denoise_fn, cond: dict, src_mask: torch.Tensor | None,
                    guidance_scale: float = 1.0, null_cond: dict | None = None):
    """A ``model_fn(x, t)`` for the samplers, with classifier-free guidance
    when ``guidance_scale != 1`` (JAX `guided_denoiser`,
    `conductor_tpu/models/transformer.py:482-508`): ``u + s * (c - u)`` of
    two calls of ``denoise_fn(x, t, cond, src_mask)``, on ``cond`` and on
    ``null_cond`` (from `MotionTransformer.encode_null`)."""
    def cond_fn(x, t):
        return denoise_fn(x, t, cond, src_mask)

    if guidance_scale == 1.0:
        return cond_fn
    if null_cond is None:
        raise ValueError("classifier-free guidance needs the null condition")

    def guided_fn(x, t):
        c = denoise_fn(x, t, cond, src_mask)
        u = denoise_fn(x, t, null_cond, src_mask)
        return u + guidance_scale * (c - u)

    return guided_fn
