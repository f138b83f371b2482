"""The layout of K1's and K3's tile kernels (ops.smalllu.tile_geometry), on
the CPU: pure arithmetic, no card, no jax.

For each (D, dtype, K1 or K3): a block's dynamic shared memory is D rows of
``row_stride`` values and stays under the 227 KB a block may have; the
blocks a SM, each rounded up to 128 bytes plus the 1 KB the system reserves
a block, stay under the SM's 228 KB; whole warps of at most 512 threads a
block and 1,024 a SM at 2 rows a thread (the register budget of
__launch_bounds__(512, 2)), 512 and 512 at 4, 128 and 256 at 8; at most 8
rows a thread. The row stride puts the rows a warp's threads own
at one column on distinct banks (a half-warp's 16 doubles, a warp's 32
floats), as csrc/smalllu_tile.cu's header states. A D whose single lane does
not fit is refused by name. The launch checks the same invariants on the
card and refuses any other geometry (tests/test_torch_kernels_gpu.py).
"""

import math

import numpy as np
import pytest
import torch

from janus_tpu_torch.bench.lu_tile import tile_geometries
from janus_tpu_torch.ops import smalllu
from janus_tpu_torch.ops._build import TILE_BOUNDS

DIMS = [1, 9, 12, 16, 17, 24, 28, 32, 48, 56, 64, 100, 169]
DTYPES = [torch.float64, torch.float32]


def _fits_the_card(geo, d, dtype, fused):
    itemsize = torch.finfo(dtype).bits // 8
    g, lanes = geo.threads_per_lane, geo.lanes_per_block
    assert g in (8, 16, 32) and 32 % g == 0
    assert geo.rows_per_thread == math.ceil(d / g) <= max(TILE_BOUNDS)
    q = min(q for q in TILE_BOUNDS if q >= geo.rows_per_thread)
    block_max, min_blocks = TILE_BOUNDS[q]
    assert geo.threads_per_block % 32 == 0
    assert geo.threads_per_block <= block_max
    assert geo.blocks_per_sm * geo.threads_per_block <= block_max * min_blocks
    assert geo.row_stride >= (d + fused) * lanes
    assert geo.smem_bytes == d * geo.row_stride * itemsize
    assert geo.smem_bytes <= smalllu.SMEM_PER_BLOCK == 227 * 1024
    held = (math.ceil(geo.smem_bytes / smalllu.SMEM_GRANULE)
            * smalllu.SMEM_GRANULE + smalllu.SMEM_RESERVED)
    assert geo.blocks_per_sm * held <= smalllu.SMEM_PER_SM == 228 * 1024


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("d", DIMS)
def test_tile_geometry_fits_the_card(d, dtype, fused):
    _fits_the_card(smalllu.tile_geometry(d, dtype, fused), d, dtype, fused)


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("d", [17, 24, 56, 100])
def test_every_swept_geometry_fits_the_card(d, dtype, fused):
    """bench.lu_tile's sweep launches only tiles the card takes, the
    rule's pick among them."""
    geos = tile_geometries(d, dtype, fused)
    assert smalllu.tile_geometry(d, dtype, fused) in geos
    for geo in geos:
        _fits_the_card(geo, d, dtype, fused)


@pytest.mark.parametrize("fused", [False, True], ids=["K1", "K3"])
@pytest.mark.parametrize("dtype", DTYPES, ids=["f64", "f32"])
@pytest.mark.parametrize("d", DIMS)
def test_tile_rows_of_a_warp_fall_on_distinct_banks(d, dtype, fused):
    """Thread t of a block works lane t // g, rows t % g + g q; at one
    column the words (t % g) * row_stride + t // g of a bank span (16
    threads in f64, where a warp's 8-byte accesses go in two halves; 32 in
    f32) lie in distinct banks."""
    geo = smalllu.tile_geometry(d, dtype, fused)
    span = 16 if dtype == torch.float64 else 32
    t = np.arange(min(32, geo.threads_per_block))
    lane, row = t // geo.threads_per_lane, t % geo.threads_per_lane
    word = row * geo.row_stride + lane
    for half in word.reshape(-1, span):
        assert len(set(half % span)) == span


@pytest.mark.parametrize("dtype,d_max", [(torch.float64, 169),
                                         (torch.float32, 241)])
def test_tile_geometry_refuses_by_name_what_does_not_fit(dtype, d_max):
    smalllu.tile_geometry(d_max, dtype)             # one lane still fits
    with pytest.raises(ValueError, match=f"D={d_max + 1} .*one lane needs"):
        smalllu.tile_geometry(d_max + 1, dtype)
    with pytest.raises(ValueError, match=r"linsolve_fused \(K3\): D=250"):
        smalllu.tile_geometry(250, dtype, True)


def test_tile_geometry_at_the_pleiades_blocks():
    """Radau5 on Pleiades factors blocks of 28 and 56 (bench.lu_tile): 16
    and 32 threads a lane, 2 rows a thread; in f64 12 lanes (three 32-byte
    sectors of a row) in 3 blocks a SM, and 4 (one sector) in 2."""
    g28 = smalllu.tile_geometry(28, torch.float64)
    g56 = smalllu.tile_geometry(56, torch.float64)
    assert (g28.threads_per_lane, g28.rows_per_thread) == (16, 2)
    assert (g56.threads_per_lane, g56.rows_per_thread) == (32, 2)
    assert (g28.lanes_per_block, g28.blocks_per_sm) == (12, 3)
    assert (g56.lanes_per_block, g56.blocks_per_sm) == (4, 2)
