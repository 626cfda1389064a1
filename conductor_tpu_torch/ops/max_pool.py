"""The music encoder's max-pool as a kernel (K10) with a first-max backward
kernel (K11), plus their plain PyTorch versions.

Port of `conductor_tpu/ops/pallas_pool.py`: `fused_max_pool` (K10, :163)
and `max_pool_train` (:442), whose backward (`_make_pool_op`, :352, kernel
`_pool_bwd_kernel`, :260) routes each output window's cotangent to ONE input
position: the first freq tap, in ascending order, whose time-pooled column
maximum equals the window maximum, and in that column the first time tap,
in ascending order, that attains it (:219-232, :277-343).  PyTorch's
`max_pool2d` backward breaks ties its own way, and post-ReLU zero plateaus
are common, so the plain backward is written out (unfold, first argmax,
scatter) instead of autograd of `F.max_pool2d`.  Each cotangent goes to
exactly one input, so ``sum dx == sum dy``.

Layout: NHWC (B, T, F, C); ``pool`` is (window, strides, padding) as the
music encoder's `POOLS` give it, padding symmetric and -inf.  The wrappers
take the plain version for CPU tensors; on CUDA they launch the kernels
(`csrc/max_pool.cu`: `max_pool_forward`, `max_pool_backward`) and raise on
what those do not take (bf16 or float32, and only the encoder's three pools
at C = 16 or 32, the kernels' template instances).  Each is one launch a
call, tiled by `fwd_plan` / `bwd_plan` for the element size: a thread owns
16 bytes, 8 bf16 or 4 float32 channels, so float32 rows take twice the
threads and are cut into column chunks sooner.  The float32 mode's
launches are counted apart (``launches_f32``).
"""

from __future__ import annotations

import ctypes
import functools

import torch
import torch.nn.functional as F

from . import _build
from .conv_block import pooled_size

# K10's and K11's geometries, their kernels' template instances
# (`csrc/max_pool.cu` POOL_INSTANCES): C, then (wt, wf, st, sf, pt, pf) of
# the music encoder's POOLS (models/music_encoder.py)
KERNEL_CHANNELS = (16, 32)
KERNEL_POOLS = ((5, 5, 1, 2, 2, 2), (5, 5, 3, 2, 2, 2), (3, 3, 1, 2, 1, 1))
MAX_THREADS = 256      # a block's threads at most (both kernels' launch bounds)
FWD_BLOCKS_PER_SM = 4  # resident 256-thread blocks an SM K10's launch bounds ask for
BWD_BLOCKS_PER_SM = 2  # and K11's
SMEM_PER_SM = 233472   # an H100 SM's shared memory, bytes (1 KB of it reserved a block)
H100_SMS = _build.H100_SMS


def _geometry(x: torch.Tensor, pool):
    (wt, wf), (st, sf), ((pt, pt1), (pf, pf1)) = pool
    if pt != pt1 or pf != pf1 or not (0 <= pt < wt and 0 <= pf < wf):
        raise ValueError(f"max-pool takes symmetric padding below the window, got {pool}")
    _, t, f, _ = x.shape
    return wt, wf, st, sf, pt, pf, pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)


def _first(mask: torch.Tensor) -> torch.Tensor:
    """Index of the first True along the last axis."""
    n = mask.shape[-1]
    return torch.where(mask, torch.arange(n, device=mask.device), n).amin(-1)


def _column_maxima(x: torch.Tensor, pool):
    """(time windows (B, To, Fp, C, wt) of the -inf padded float32 input,
    their maxima (B, To, Fp, C), freq windows of those (B, To, Fo, C, wf),
    the window maxima (B, To, Fo, C))."""
    wt, wf, st, sf, pt, pf, _, _ = _geometry(x, pool)
    xp = F.pad(x.float(), (0, 0, pf, pf, pt, pt), value=float("-inf"))
    win_t = xp.unfold(1, wt, st)
    cols = win_t.amax(-1)
    win_f = cols.unfold(2, wf, sf)
    return win_t, cols, win_f, win_f.amax(-1)


def max_pool_plain(x: torch.Tensor, pool) -> torch.Tensor:
    """The plain version of K10: the window maxima, written out."""
    return _column_maxima(x, pool)[3].to(x.dtype)


def max_pool_bwd_plain(x: torch.Tensor, dy: torch.Tensor, pool) -> torch.Tensor:
    """The plain version of K11: d(x) of the pool for the cotangent ``dy``
    (B, To, Fo, C), by the first-max rule."""
    b, t, f, c = x.shape
    _, _, st, sf, pt, pf, to, fo = _geometry(x, pool)
    win_t, cols, win_f, y = _column_maxima(x, pool)
    first_t = _first(win_t == cols[..., None])                 # (B, To, Fp, C)
    dev = x.device
    col = torch.arange(fo, device=dev)[:, None] * sf + _first(win_f == y[..., None])
    row = torch.arange(to, device=dev)[:, None, None] * st + first_t.gather(2, col)
    idx = ((torch.arange(b, device=dev)[:, None, None, None] * t + row - pt) * f
           + col - pf) * c + torch.arange(c, device=dev)
    dx = torch.zeros(b * t * f * c, dtype=torch.float32, device=dev)
    dx.index_add_(0, idx.reshape(-1), dy.float().reshape(-1))
    return dx.reshape(x.shape).to(x.dtype)


def _blocks_per_sm(bound: int, threads: int, smem: int) -> int:
    """Resident blocks an SM of ``threads`` threads and ``smem`` shared bytes
    each: the launch bounds' ``bound`` blocks of MAX_THREADS in threads, at
    most what the SM's shared memory holds (1 KB of it reserved a block;
    a narrow float32 block's -inf pad columns can bind)."""
    return max(1, min(bound * MAX_THREADS // threads, SMEM_PER_SM // (smem + 1024)))


def _first_cover(i: int, w: int, s: int, p: int) -> int:
    """The first window (output index) covering input index ``i``."""
    n = i + p - w + 1
    return 0 if n <= 0 else -(-n // s)


def _span(lo: int, hi: int, n_in: int, n_out: int, w: int, s: int, p: int) -> tuple:
    """Owned input indices [lo, hi) of a tile along one axis: (lo, hi, the
    windows covering them [o0, o1], the input indices those windows read
    [x0, x1) within [0, n_in)), as the kernel computes them."""
    o0, o1 = _first_cover(lo, w, s, p), min(n_out - 1, (hi - 1 + p) // s)
    return lo, hi, o0, o1, max(0, o0 * s - p), min(n_in, o1 * s - p + w)


def _vectors(c: int, esize: int) -> int:
    """16-byte vectors of a (t, f) of C channels of ``esize`` bytes."""
    return c * esize // 16


def bwd_plan(shape, pool, *, rows: int | None = None, sms: int = H100_SMS,
             esize: int = 2) -> dict:
    """K11's tiling of an input of ``shape`` (B, T, F, C) of ``esize``-byte
    elements (2: bf16, 4: float32) for ``pool``: a block owns ``rows`` input
    rows of one clip (chosen here, a multiple of the time stride, unless
    given) and ``cols`` columns (all F when the row's F C esize / 16 vectors
    fit in one block), one thread a staged 16-byte column vector.
    ``row_tiles`` / ``col_chunks``: each tile's owned range, the windows
    covering it (recomputed where they reach past its edge) and the input
    range those windows read, which the block stages, per axis: (lo, hi, o0,
    o1, x0, x1).  ``halo_rows`` / ``halo_cols``: the most staged beyond the
    owned.  ``threads`` a block, ``blocks``, ``smem_bytes`` a block and
    ``smem_budget``, an SM's shared memory over ``blocks_per_sm``.  The rows
    minimise waves x windows a tile over ``sms`` SMs at ``blocks_per_sm``."""
    b, t, f, c = shape
    (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
    to, fo = pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)
    v = _vectors(c, esize)
    cols = f if f * v <= MAX_THREADS else MAX_THREADS // v - 2 * (wf - 1)
    col_chunks = [_span(q, min(f, q + cols), f, fo, wf, sf, pf) for q in range(0, f, cols)]
    threads = max(max(x1 - x0, o1 - o0 + 1) * v for _, _, o0, o1, x0, x1 in col_chunks)
    threads = min(MAX_THREADS, -(-threads // 32) * 32)
    smem = ((_ring_rows(wt, st) + 4) * threads + 2 * pf * v) * 16
    per_sm = _blocks_per_sm(BWD_BLOCKS_PER_SM, threads, smem)

    def tiles(r):
        return [_span(lo, min(t, lo + r), t, to, wt, st, pt) for lo in range(0, t, r)]

    def cost(r):  # waves of blocks x the most windows a tile walks (and its preload)
        waves = -(-b * -(-t // r) * len(col_chunks) // (sms * per_sm))
        return waves * (max(o1 - o0 + 1 for _, _, o0, o1, _, _ in tiles(r)) + 2)

    if rows is None:
        rows = min(range(st, min(t, 64) + st, st), key=lambda r: (cost(r), -r))
    row_tiles = tiles(rows)
    return {
        "rows": rows, "cols": cols, "threads": threads,
        "halo_rows": max(x1 - x0 - (hi - lo) for lo, hi, _, _, x0, x1 in row_tiles),
        "halo_cols": max(x1 - x0 - (hi - lo) for lo, hi, _, _, x0, x1 in col_chunks),
        "blocks": b * len(row_tiles) * len(col_chunks), "blocks_per_sm": per_sm,
        "smem_bytes": smem,
        "smem_budget": SMEM_PER_SM // per_sm - 1024,
        "row_tiles": row_tiles, "col_chunks": col_chunks,
    }


def _ring_rows(wt: int, st: int) -> int:
    """The x ring's rows: a window's and the next window's new ones, in
    whole strides (`csrc/max_pool.cu` ring_rows)."""
    return -(-(wt + st) // st) * st


def _fwd_span(lo: int, hi: int, n_in: int, w: int, s: int, p: int) -> tuple:
    """Owned outputs (windows) [lo, hi) of a K10 tile along one axis: (lo,
    hi, the input indices their windows read [x0, x1) within [0, n_in)), as
    the kernel's `fwd_span` computes them."""
    return lo, hi, max(0, lo * s - p), min(n_in, (hi - 1) * s - p + w)


def fwd_plan(shape, pool, *, rows: int | None = None, sms: int = H100_SMS,
             esize: int = 2) -> dict:
    """K10's tiling of an input of ``shape`` (B, T, F, C) of ``esize``-byte
    elements for ``pool``: a block owns ``rows`` output rows (windows) of
    one clip (chosen here unless given) and ``cols`` output columns (all Fo
    when the row's F C esize / 16 input vectors fit in one block), one
    thread a staged 16-byte column vector.  ``row_tiles`` / ``col_chunks``: each tile's owned outputs
    (its windows, each computed once) [lo, hi) and the input range those
    windows read [x0, x1), which the block stages, per axis: (lo, hi, x0,
    x1).  ``halo_rows`` / ``halo_cols``: the most inputs a tile stages
    beyond its own stride's share (a neighbour stages them too).
    ``threads`` a block, ``blocks``, ``smem_bytes`` a block and
    ``smem_budget``, an SM's shared memory over ``blocks_per_sm``.  The rows
    minimise waves x windows a tile over ``sms`` SMs at ``blocks_per_sm``.
    The kernel reports the same ranges (`kernel_fwd_plan`)."""
    b, t, f, c = shape
    (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
    to, fo = pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)
    v = _vectors(c, esize)
    cols = fo if f * v <= MAX_THREADS else (MAX_THREADS // v - wf) // sf + 1
    col_chunks = [_fwd_span(lo, min(fo, lo + cols), f, wf, sf, pf) for lo in range(0, fo, cols)]
    threads = max(max(x1 - x0, hi - lo) * v for lo, hi, x0, x1 in col_chunks)
    threads = min(MAX_THREADS, -(-threads // 32) * 32)
    smem = (_ring_rows(wt, st) * threads + 2 * (threads + 2 * pf * v)) * 16
    per_sm = _blocks_per_sm(FWD_BLOCKS_PER_SM, threads, smem)

    def tiles(r):
        return [_fwd_span(lo, min(to, lo + r), t, wt, st, pt) for lo in range(0, to, r)]

    def cost(r):  # waves of blocks x the windows a tile walks (and its preload)
        waves = -(-b * -(-to // r) * len(col_chunks) // (sms * per_sm))
        return waves * (r + 2)

    if rows is None:
        rows = min(range(1, min(to, 64) + 1), key=lambda r: (cost(r), -r))
    row_tiles = tiles(rows)
    return {
        "rows": rows, "cols": cols, "threads": threads,
        "halo_rows": max(x1 - x0 - (hi - lo) * st for lo, hi, x0, x1 in row_tiles),
        "halo_cols": max(x1 - x0 - (hi - lo) * sf for lo, hi, x0, x1 in col_chunks),
        "blocks": b * len(row_tiles) * len(col_chunks), "blocks_per_sm": per_sm,
        "smem_bytes": smem, "smem_budget": SMEM_PER_SM // per_sm - 1024,
        "row_tiles": row_tiles, "col_chunks": col_chunks,
    }


# what `kernel_fwd_plan` reports, under `fwd_plan`'s names
KERNEL_FWD_PLAN_KEYS = ("blocks", "smem_bytes", "row_tiles", "col_chunks")


def kernel_fwd_plan(shape, pool, rows: int, cols: int, threads: int, esize: int = 2) -> dict:
    """What K10's launch with this tiling runs on ``esize``-byte elements
    (`csrc/max_pool.cu` `max_pool_fwd_plan`, from the kernel's own span
    formula), under `fwd_plan`'s names ``KERNEL_FWD_PLAN_KEYS``; needs the
    built library."""
    b, t, f, c = shape
    (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
    to, fo = pooled_size(t, wt, st, pt), pooled_size(f, wf, sf, pf)
    n_tiles = -(-to // rows) + -(-fo // cols)
    out = (ctypes.c_int * (4 + 4 * n_tiles))()
    err = _build.library().max_pool_fwd_plan(b, t, f, c, to, fo, wt, wf, st, sf, pt, pf, rows,
                                             cols, threads, int(esize == 4), out, len(out))
    _build.check(err, "max_pool_fwd_plan")
    spans = [tuple(out[4 + 4 * i:8 + 4 * i]) for i in range(n_tiles)]
    return {"blocks": out[0], "smem_bytes": out[1], "row_tiles": spans[:out[2]],
            "col_chunks": spans[out[2]:]}


@functools.lru_cache(maxsize=64)
def _cached_plan(kind, shape, pool, sms, esize):
    plan = (fwd_plan if kind == "fwd" else bwd_plan)(shape, pool, sms=sms, esize=esize)
    return plan["rows"], plan["cols"], plan["threads"]


KERNEL_DTYPES = (torch.bfloat16, torch.float32)  # the kernels' two modes


def _kernel_geometry(x: torch.Tensor, pool, name: str) -> tuple[int, ...]:
    """`_geometry` of a pool the kernels take; raises on any other."""
    geometry = _geometry(x, pool)
    if (x.shape[-1] not in KERNEL_CHANNELS or geometry[:6] not in KERNEL_POOLS
            or x.dtype not in KERNEL_DTYPES):
        raise ValueError(f"{name} kernel takes the music encoder's pools at C in "
                         f"{KERNEL_CHANNELS}, bf16 or float32, got C={x.shape[-1]}, pool {pool}, "
                         f"{x.dtype}")
    return geometry


def _fwd_geometry(x: torch.Tensor, pool) -> tuple[int, ...]:
    """`_geometry` of a pool K10's kernel takes; raises on any other."""
    return _kernel_geometry(x, pool, "max_pool")


def _bwd_geometry(x: torch.Tensor, pool) -> tuple[int, ...]:
    """`_geometry` of a pool K11's kernel takes; raises on any other."""
    return _kernel_geometry(x, pool, "max_pool_bwd")


def _fwd_launch(x, geometry, rows, cols, threads) -> torch.Tensor:
    """K10 on ``geometry`` (`_fwd_geometry`) with a tiling of `fwd_plan`."""
    b, t, f, c = x.shape
    wt, wf, st, sf, pt, pf, to, fo = geometry
    _build.require(x, "x", x.dtype, (b, t, f, c))
    _build.require_aligned(x=x)
    mode_f32 = x.dtype == torch.float32
    out = torch.empty((b, to, fo, c), dtype=x.dtype, device=x.device)
    err = _build.library().max_pool_forward(
        x.data_ptr(), out.data_ptr(), b, t, f, c, to, fo, wt, wf, st, sf, pt, pf, rows, cols,
        threads, int(mode_f32), _build.stream())
    _build.check(err, "max_pool_forward")
    if mode_f32:
        fused_max_pool.launches_f32 += 1
    else:
        fused_max_pool.launches += 1
    return out


def fused_max_pool(x: torch.Tensor, pool) -> torch.Tensor:
    """K10: x (B, T, F, C) -> (B, To, Fo, C), one launch tiled by `fwd_plan`."""
    if not x.is_cuda:
        return max_pool_plain(x, pool)
    geometry = _fwd_geometry(x, pool)
    return _fwd_launch(x, geometry, *_cached_plan("fwd", tuple(x.shape), pool,
                                                  _build.sm_count(x.device.index),
                                                  x.element_size()))


def _bwd_launch(x, dy, geometry, rows, cols, threads) -> torch.Tensor:
    """K11 on ``geometry`` (`_bwd_geometry`) with a tiling of `bwd_plan`."""
    b, t, f, c = x.shape
    wt, wf, st, sf, pt, pf, to, fo = geometry
    _build.require(x, "x", x.dtype, (b, t, f, c))
    _build.require(dy, "dy", x.dtype, (b, to, fo, c))
    _build.require_aligned(x=x, dy=dy)
    mode_f32 = x.dtype == torch.float32
    dx = torch.empty_like(x)
    err = _build.library().max_pool_backward(
        x.data_ptr(), dy.data_ptr(), dx.data_ptr(), b, t, f, c, to, fo, wt, wf, st, sf, pt, pf,
        rows, cols, threads, int(mode_f32), _build.stream())
    _build.check(err, "max_pool_backward")
    if mode_f32:
        max_pool_bwd.launches_f32 += 1
    else:
        max_pool_bwd.launches += 1
    return dx


def max_pool_bwd(x: torch.Tensor, dy: torch.Tensor, pool) -> torch.Tensor:
    """K11: d(x) (B, T, F, C) of the pool for ``dy`` (B, To, Fo, C), one
    launch tiled by `bwd_plan`."""
    if not x.is_cuda:
        return max_pool_bwd_plain(x, dy, pool)
    geometry = _bwd_geometry(x, pool)
    return _bwd_launch(x, dy, geometry, *_cached_plan("bwd", tuple(x.shape), pool,
                                                      _build.sm_count(x.device.index),
                                                      x.element_size()))


fused_max_pool.launches = 0
fused_max_pool.launches_f32 = 0
max_pool_bwd.launches = 0
max_pool_bwd.launches_f32 = 0


class _MaxPoolTrain(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, pool):
        ctx.save_for_backward(x)
        ctx.pool = pool
        return fused_max_pool(x, pool)

    @staticmethod
    def backward(ctx, dy):
        (x,) = ctx.saved_tensors
        return max_pool_bwd(x, dy.contiguous(), ctx.pool), None


def max_pool_train(x: torch.Tensor, pool) -> torch.Tensor:
    """Trainable max-pool on NHWC ``x``: K10 forward, K11 backward."""
    return _MaxPoolTrain.apply(x, pool)
