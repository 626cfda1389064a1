"""K10's and K11's tilings, `ops.max_pool.fwd_plan` and `bwd_plan`, on the
CPU, over a grid of T, F and B for each of the music encoder's three pools
at C = 16 and 32.  K11: the tiles' owned input rows (and the blocks' owned
columns) cover the input exactly once; every output window that touches a
tile's owned rows lies in the windows the tile recomputes, and the input
rows it reads lie in the rows the tile stages (the same for columns).
K10: the tiles' owned output rows (and columns) cover the output exactly
once, each window computed by one tile, and a tile stages exactly the
input rows (columns) its windows read.  Both: a block's threads cover its
staged column vectors and its windows; the shared bytes fit the budget the
plan states.  Each at both element sizes, 2 bytes (bf16) and 4 (the
float32 mode: 4 channels a 16-byte vector, twice the vectors a row).  The
kernels (`csrc/max_pool.cu`, `pool_fwd_kernel`, `pool_bwd_kernel`) derive
each block's ranges by the same formulas from its block index."""

import pytest

from conductor_tpu_torch.models.music_encoder import POOLS
from conductor_tpu_torch.ops.conv_block import pooled_size
from conductor_tpu_torch.ops.max_pool import MAX_THREADS, bwd_plan, fwd_plan

TS = (1, 2, 3, 4, 31, 33, 37, 97, 99, 300, 900)
FS = (1, 2, 5, 16, 32, 64, 70, 128, 200)


def _check_axis(spans, n_in, window, stride, pad):
    """Owned ranges tile [0, n_in) in order; each span's windows are exactly
    those touching its owned range, and it stages exactly what they read."""
    n_out = pooled_size(n_in, window, stride, pad)
    assert spans[0][0] == 0 and spans[-1][1] == n_in
    for (lo, hi, o0, o1, x0, x1), nxt in zip(spans, spans[1:] + [None]):
        assert lo < hi and (nxt is None or nxt[0] == hi)
        touching = [o for o in range(n_out)
                    if o * stride - pad <= hi - 1 and o * stride - pad + window - 1 >= lo]
        assert touching == list(range(o0, o1 + 1)), (lo, hi, touching, o0, o1)
        read = [i for o in touching for i in range(o * stride - pad, o * stride - pad + window)
                if 0 <= i < n_in]
        assert (min(read), max(read) + 1) == (x0, x1)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("name", sorted(POOLS))
def test_bwd_plan_covers_the_input_once_and_stages_what_its_windows_read(name, c, esize):
    pool = POOLS[name]
    (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
    v = c * esize // 16
    for t in TS:
        for f in FS:
            for b in (1, 10):
                plan = bwd_plan((b, t, f, c), pool, esize=esize)
                rows, cols, threads = plan["rows"], plan["cols"], plan["threads"]
                assert rows % st == 0 and cols >= 1
                _check_axis(plan["row_tiles"], t, wt, st, pt)
                _check_axis(plan["col_chunks"], f, wf, sf, pf)
                assert all(hi - lo == rows for lo, hi, *_ in plan["row_tiles"][:-1])
                assert all(hi - lo == cols for lo, hi, *_ in plan["col_chunks"][:-1])
                assert threads % 32 == 0 and threads <= MAX_THREADS
                for _, _, o0, o1, x0, x1 in plan["col_chunks"]:
                    assert (x1 - x0) * v <= threads and (o1 - o0 + 1) * v <= threads
                assert plan["blocks"] == b * len(plan["row_tiles"]) * len(plan["col_chunks"])
                assert plan["halo_rows"] == max(x1 - x0 - (hi - lo)
                                                for lo, hi, _, _, x0, x1 in plan["row_tiles"])
                assert plan["smem_bytes"] <= plan["smem_budget"]


def test_bwd_plan_at_the_stage1_shapes():
    """The three stage-1 pools at B = 10 (10-s crops): whole rows in one
    block, one 8-channel vector a thread, at most 2 (wt - 1) staged rows
    of halo a tile (for the two 900-row pools at most a quarter of the
    owned rows), and at most one wave of blocks on an H100's 132 SMs."""
    for name, shape in (("conv1", (10, 900, 128, 16)), ("conv2", (10, 900, 64, 32)),
                        ("conv3", (10, 300, 32, 32))):
        plan = bwd_plan(shape, POOLS[name])
        (wt, _), _, _ = POOLS[name]
        assert plan["cols"] == shape[2] and plan["halo_cols"] == 0
        assert plan["threads"] == shape[2] * shape[3] // 8
        assert plan["halo_rows"] <= 2 * (wt - 1)
        assert plan["blocks"] <= 132 * plan["blocks_per_sm"]
        if name != "conv3":
            assert plan["halo_rows"] <= plan["rows"] / 4


def _check_fwd_axis(spans, per, n_in, window, stride, pad):
    """K10's owned outputs tile [0, n_out) in order, ``per`` a tile but the
    last; each tile stages exactly the inputs its windows read."""
    n_out = pooled_size(n_in, window, stride, pad)
    assert spans[0][0] == 0 and spans[-1][1] == n_out
    for (lo, hi, x0, x1), nxt in zip(spans, spans[1:] + [None]):
        assert 0 < hi - lo <= per and (nxt is None or (nxt[0] == hi and hi - lo == per))
        read = [i for o in range(lo, hi) for i in range(o * stride - pad, o * stride - pad + window)
                if 0 <= i < n_in]
        assert (min(read), max(read) + 1) == (x0, x1), (lo, hi, x0, x1)


@pytest.mark.parametrize("esize", [2, 4])
@pytest.mark.parametrize("c", [16, 32])
@pytest.mark.parametrize("name", sorted(POOLS))
def test_fwd_plan_covers_each_output_once_and_stages_what_its_windows_read(name, c, esize):
    pool = POOLS[name]
    (wt, wf), (st, sf), ((pt, _), (pf, _)) = pool
    v = c * esize // 16
    for t in TS:
        for f in FS:
            for b in (1, 10):
                plan = fwd_plan((b, t, f, c), pool, esize=esize)
                threads = plan["threads"]
                _check_fwd_axis(plan["row_tiles"], plan["rows"], t, wt, st, pt)
                _check_fwd_axis(plan["col_chunks"], plan["cols"], f, wf, sf, pf)
                assert threads % 32 == 0 and threads <= MAX_THREADS
                for lo, hi, x0, x1 in plan["col_chunks"]:
                    assert (x1 - x0) * v <= threads and (hi - lo) * v <= threads
                if f * v <= MAX_THREADS:
                    assert len(plan["col_chunks"]) == 1
                assert plan["blocks"] == b * len(plan["row_tiles"]) * len(plan["col_chunks"])
                assert plan["halo_rows"] == max(x1 - x0 - (hi - lo) * st
                                                for lo, hi, x0, x1 in plan["row_tiles"])
                assert plan["smem_bytes"] <= plan["smem_budget"]


def test_fwd_plan_at_the_stage1_shapes():
    """The three stage-1 pools at B = 10 (10-s crops): whole rows in one
    block, one 8-channel vector a thread, a tile staging wt - st input rows
    beyond its windows' own, each window once, and one wave of blocks on
    an H100's 132 SMs, the rows the fewest that keep it one wave."""
    for name, shape in (("conv1", (10, 900, 128, 16)), ("conv2", (10, 900, 64, 32)),
                        ("conv3", (10, 300, 32, 32))):
        pool = POOLS[name]
        (wt, _), (st, _), _ = pool
        plan = fwd_plan(shape, pool)
        to = pooled_size(shape[1], wt, st, pool[2][0][0])
        assert plan["cols"] == pooled_size(shape[2], 5 if name != "conv3" else 3, 2,
                                           pool[2][1][0])
        assert plan["halo_cols"] == 0 and plan["threads"] == shape[2] * shape[3] // 8
        assert plan["halo_rows"] == wt - st
        slots = 132 * plan["blocks_per_sm"]
        assert plan["blocks"] <= slots
        assert plan["rows"] == 1 or shape[0] * -(-to // (plan["rows"] - 1)) > slots
