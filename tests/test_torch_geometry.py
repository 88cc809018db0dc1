"""The launch geometry of the fused mean-field kernel (`launch_geometry`),
checked on the CPU: the warps' tiles cover every row exactly once, each tile
fits what a warp loads at once, and the shared memory fits the card. The
kernel itself is tested on a card in tests/test_torch_cuda.py."""
import numpy as np
import pytest

from depth_estimation_torch.ops.cuda import meanfield as K

H100_SMS = 132
BLOCKS_PER_SM = 4  # __launch_bounds__(128, 4)
SMEM_PER_SM = 233472  # 228 KB, 1 KB of it reserved per resident block
SMEM_NO_OPT_IN = 48 * 1024  # what a block gets without cudaFuncSetAttribute
FLAGSHIP_N = 288 * 384


def _tile(L, elt):
    return K.launch_geometry(1, L, elt).tile_rows


def _rows(g, n):
    """Rows of every warp of the grid, in warp order, as the kernel takes
    them: warp w computes rows w·tile_rows to (w + 1)·tile_rows − 1 below n."""
    return np.concatenate([np.arange(w * g.tile_rows, min((w + 1) * g.tile_rows, n))
                           for w in range(g.grid * K.WARPS)])


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", K.SUPPORTED_L)
@pytest.mark.parametrize("case", ["1", "31", "tile-1", "tile", "tile+1", "110585", "110592"])
def test_every_row_is_covered_once(case, L, elt):
    tile = _tile(L, elt)
    n = {"tile-1": tile - 1, "tile": tile, "tile+1": tile + 1}.get(case) or int(case)
    g = K.launch_geometry(n, L, elt)
    assert g.tile_rows == tile  # the tile does not depend on n
    rows = _rows(g, n)
    assert np.array_equal(rows, np.arange(n))  # once each, in order
    assert g.num_tiles == -(-n // g.tile_rows)
    # every tile has a warp, and only the last block has spare warps
    assert (g.grid - 1) * K.WARPS < g.num_tiles <= g.grid * K.WARPS
    # every tile, the ragged last one too, is a whole number of 16-byte words
    last_rows = n - (g.num_tiles - 1) * g.tile_rows
    assert 1 <= last_rows <= g.tile_rows
    assert g.tile_rows * L * elt % 16 == 0 and last_rows * L * elt % 16 == 0


@pytest.mark.parametrize("elt", [4, 2], ids=["f32", "bf16"])
@pytest.mark.parametrize("L", K.SUPPORTED_L)
@pytest.mark.parametrize("n", [1, 1000, FLAGSHIP_N, 4 * FLAGSHIP_N, 10**7])
def test_shared_memory_fits_and_tiles_stay_small(n, L, elt):
    g = K.launch_geometry(n, L, elt)
    assert g.smem_bytes == K.WARPS * g.tile_rows * (L + 4) * 4  # as the C side
    assert g.smem_bytes <= SMEM_NO_OPT_IN
    assert BLOCKS_PER_SM * (g.smem_bytes + 1024) <= SMEM_PER_SM
    # a warp tile is what its 32 lanes load at once: at most 4 words of each array a lane
    assert g.tile_rows * L * elt == K.TILE_WORDS * 16 <= 32 * 4 * 16


def test_flagship_geometry_fills_the_card_evenly():
    """At (110592, 16) in bf16 the 1728 warp tiles of 64 rows are all full
    and their 432 blocks fit in one wave of an H100's 528 block slots, so no
    block waits for another to finish."""
    g = K.launch_geometry(FLAGSHIP_N, 16, 2)
    assert g.tile_rows == 64 and g.num_tiles == 1728 and FLAGSHIP_N % g.tile_rows == 0
    assert g.grid == 432 <= H100_SMS * BLOCKS_PER_SM


def test_geometry_refuses_empty_input():
    with pytest.raises(ValueError, match="at least one row"):
        K.launch_geometry(0, 16, 2)
