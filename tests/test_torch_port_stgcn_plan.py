"""PyTorch port: K7's tiling, masks and plain backward, on the CPU.

`ops.stgcn.plan` (the tiling of `csrc/stgcn.cu`, from the constants in
that source; the card tests hold it against the kernel's own `stgcn_plan`)
over a grid of B and T in both directions: the tiles own each frame of a
clip once, in order; each reads its owned frames and a row of halo each
side inside the clip, within the rows its products cover; the warps cover
the 13 joints; the threads and shared memory stay within what the plan
reports and an H100 allows (one block an SM).  `pack_relu_masks` against
the blocks' activations, computed here from the pack on their own:
unpacking the masks that `frozen_stgcn_plain(save=True)` keeps gives
[g > 0] and [h > 0] of every block.  And `stgcn_backward_plain`, which
reads only those masks, against autograd through `frozen_stgcn_plain` in
float32 at T = 24 and a ragged T = 17 (the bf16 version against the JAX
kernel is in `test_torch_port_stgcn_kernel.py`)."""

import numpy as np
import pytest
import torch

from conductor_tpu_torch.interop import (
    load_motion_encoder_state_dict,
    synthetic_motion_encoder_state_dict,
)
from conductor_tpu_torch.models.stgcn import MotionEncoderSTGCN
from conductor_tpu_torch.ops.conv_block import _q
from conductor_tpu_torch.ops.stgcn import (
    BLOCKS,
    SMEM_PER_BLOCK,
    SMEM_PER_SM,
    V,
    WIDTH,
    _tconv,
    frozen_stgcn_plain,
    pack_frozen_stgcn,
    pack_relu_masks,
    plan,
    stgcn_backward_plain,
    unpack_relu_masks,
)

torch.set_num_threads(2)

TS = (1, 2, 17, 61, 62, 63, 64, 65, 96, 124, 125, 300, 900)


@pytest.fixture(scope="module")
def model():
    m = MotionEncoderSTGCN()
    load_motion_encoder_state_dict(m, synthetic_motion_encoder_state_dict(m, seed=3))
    return m.freeze()


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plan_owns_each_frame_once_and_reads_its_halo(direction):
    for t in TS:
        for b in (1, 32):
            p = plan(b, t, direction)
            rows, tile_rows, tiles = p["rows"], p["tile_rows"], p["tiles"]
            assert tiles[0][0] == 0 and tiles[-1][1] == t
            for (lo, hi, x0, x1), nxt in zip(tiles, tiles[1:] + [None]):
                assert lo < hi <= lo + rows and (nxt is None or nxt[0] == hi)
                # the temporal conv reads a frame each side; all inside the clip
                assert (x0, x1) == (max(0, lo - 1), min(t, hi + 1))
                # the products cover the staged rows: forward, the 416-wide
                # tile from frame lo - 1; backward, its dy tile of 2 more rows
                assert x1 - x0 <= (tile_rows if direction == "forward" else tile_rows + 2)
            assert all(hi - lo == rows for lo, hi, _, _ in tiles[:-1])
            assert p["blocks"] == b * len(tiles) and p["launches"] == BLOCKS


@pytest.mark.parametrize("direction", ["forward", "backward"])
def test_plan_fits_its_threads_and_shared_memory(direction):
    """A warp a joint; the shared bytes within what one block may take on
    an H100, one block an SM."""
    p = plan(32, 900, direction)
    assert p["threads"] == 32 * V
    assert p["smem_bytes"] <= p["smem_budget"] == SMEM_PER_BLOCK
    assert p["smem_bytes"] + 1024 <= SMEM_PER_SM
    rows = p["tile_rows"] - 2 if direction == "forward" else p["tile_rows"]
    assert p["rows"] == rows and p["blocks"] == 32 * -(-900 // rows)
    assert p["tile_rows"] % 16 == 0  # whole m16 fragments


def _blocks(motion, pack, mxu):
    """Each block's graph-conv activation g and output h, (B*T, 416), from
    the pack, written out here apart from `frozen_stgcn_plain`."""
    b, t = motion.shape[:2]
    h, gs, hs = motion.reshape(b, t, -1).float(), [], []
    for i in range(BLOCKS):
        mat = pack["m0"][:26] if i == 0 else pack["m"][i - 1]
        g = torch.relu(_q(h, mxu) @ _q(mat, mxu) + pack["b1"][i])
        y = _tconv(g, pack["wt"][i], mxu) + pack["b2"][i].repeat(V)
        h = torch.relu(y if i == 0 else y + h)
        gs.append(g.reshape(b * t, WIDTH))
        hs.append(h.reshape(b * t, WIDTH))
    return gs, hs


def test_relu_masks_round_trip():
    """Random masks and every word value's sign survive packing: bit c of
    word v is column 32 v + c, bit 31 included."""
    rng = np.random.RandomState(0)
    mask = torch.from_numpy(rng.uniform(size=(7, 3, WIDTH)) < 0.5)
    mask[0, 0] = True
    words = pack_relu_masks(mask)
    assert words.shape == (7, 3, V) and words.dtype == torch.int32
    assert int(words[0, 0, 0]) == -1  # all 32 bits
    assert torch.equal(unpack_relu_masks(words), mask)
    one = torch.zeros(WIDTH, dtype=torch.bool)
    one[32 * 5 + 7] = True
    assert pack_relu_masks(one).tolist() == [0] * 5 + [1 << 7] + [0] * 7


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_saved_masks_are_the_blocks_relus(model, dtype):
    motion = torch.from_numpy(np.random.RandomState(17).uniform(
        0, 1, size=(2, 17, 13, 2)).astype(np.float32))
    pack = pack_frozen_stgcn(model, dtype)
    _, (gmask, hmask) = frozen_stgcn_plain(motion, pack, dtype, save=True)
    gs, hs = _blocks(motion, pack, dtype)
    for i in range(BLOCKS):
        assert torch.equal(unpack_relu_masks(gmask[i]), gs[i] > 0)
        assert torch.equal(unpack_relu_masks(hmask[i]), hs[i] > 0)
    assert 0 < int(unpack_relu_masks(hmask).sum()) < hmask.numel() * 32


@pytest.mark.parametrize("t", [24, 17])
def test_backward_plain_from_masks_is_autograd_in_float32(model, t):
    """Reading only the masks, the plain backward is d(motion) of
    sum(out * dy) through the float32 plain forward, within 1e-5 of its
    largest value."""
    rng = np.random.RandomState(t)
    motion = torch.from_numpy(rng.uniform(0, 1, size=(2, t, 13, 2)).astype(np.float32))
    dy = torch.from_numpy(rng.normal(size=(2, t, 64)).astype(np.float32))
    pack = pack_frozen_stgcn(model, torch.float32)
    x = motion.clone().requires_grad_(True)
    out, masks = frozen_stgcn_plain(x, pack, torch.float32, save=True)
    (want,) = torch.autograd.grad(out, x, dy)
    got = stgcn_backward_plain(dy, masks, pack, torch.float32)
    assert got.shape == motion.shape and got.dtype == torch.float32
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())
