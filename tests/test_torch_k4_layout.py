"""K4's launch geometry on the CPU (``ops.radau_fused.geometry``): the one
place that chooses, by (D, dtype), the lane layout, one lane a thread
(D <= 4, and D = 5, 6 in float, where the factors fit shared memory), or
the group layout, a lane over 8 threads with the factors in shared memory
(D = 5..8 in double, 7..8 in float). The generated unit is built with it and the
wrapper passes it to the launch; the card tests
(``test_torch_kernels_gpu.py``) hold the built unit's attributes to it.

- every lane is worked by exactly one group, of threads of one warp, and
  no block lies wholly past the last lane, for M in {1, 127, 128, 4,099,
  65,536, 65,539};
- the group layout's shared memory holds the factors (5 D values a thread)
  and a scratch for the Jacobian and the stages, and fits 227 KB at the
  blocks a SM it asks for, at D = 5..8 in double and 7..8 in float;
- D <= 4, and D = 5, 6 in float, keep the lane layout's geometry: 128
  threads, one lane a thread;
- the generated source carries the geometry the function gives;
- ``bench.k4_layout``'s variants of a unit (the clock marks, other blocks
  a SM) are the unit's text with only that changed, under another name.
"""

import dataclasses
import os
import sys

import numpy as np
import pytest
import torch

from janus_tpu_torch.ops import radau_fused as k4
from janus_tpu_torch.ops import rhs_codegen

sys.path.insert(0, os.path.dirname(__file__))
from torch_rhs_cases import ring_rhs  # noqa: E402

DTYPES = [torch.float64, torch.float32]
SMEM_PER_SM = 228 * 1024        # H100: shared memory of an SM
SMEM_RESERVED = 1024            # of it reserved for each resident block


@pytest.mark.parametrize("d", [4, 6, 8])
@pytest.mark.parametrize("m", [1, 127, 128, 4099, 65536, 65539])
def test_geometry_covers_every_lane_once(m, d):
    geo = k4.geometry(d, torch.float64)
    blocks = geo.blocks(m)
    threads = np.arange(geo.threads_per_block)
    lane, rank = np.broadcast_arrays(*geo.lane_of(np.arange(blocks)[:, None],
                                                  threads[None, :]))
    work = lane < m
    pairs = lane[work] * geo.threads_per_lane + rank[work]
    want = np.arange(m * geo.threads_per_lane)
    assert np.array_equal(np.sort(pairs), want)
    assert (blocks - 1) * geo.lanes_per_block < m <= \
        blocks * geo.lanes_per_block
    # a group's threads lie in one warp
    warp = np.broadcast_to(threads // 32, lane.shape)
    for b in range(min(blocks, 2)):
        for ln in np.unique(lane[b]):
            assert len(np.unique(warp[b][lane[b] == ln])) == 1


GROUP = [(d, torch.float64) for d in (5, 6, 7, 8)] + [
    (d, torch.float32) for d in (7, 8)]
PR3 = [(d, dt) for d in (1, 2, 3, 4) for dt in DTYPES] + [
    (d, torch.float32) for d in (5, 6)]


@pytest.mark.parametrize("d,dtype", GROUP)
def test_group_scratch_fits_the_sm(d, dtype):
    geo = k4.geometry(d, dtype)
    g = geo.threads_per_lane
    assert g >= d and 32 % g == 0 and geo.threads_per_block % 32 == 0
    assert geo.threads_per_block <= 1024
    assert geo.scratch_per_lane >= max(d * d, 6 * d)
    itemsize = torch.finfo(dtype).bits // 8
    assert geo.smem_bytes == (5 * d * geo.threads_per_block
                              + geo.lanes_per_block * geo.scratch_per_lane
                              ) * itemsize
    assert geo.blocks_per_sm >= 1
    assert geo.blocks_per_sm * (geo.smem_bytes + SMEM_RESERVED) \
        <= SMEM_PER_SM
    assert geo.smem_bytes <= 227 * 1024


@pytest.mark.parametrize("d,dtype", PR3)
def test_pr3_geometry_where_the_factors_fit(d, dtype):
    geo = k4.geometry(d, dtype)
    assert (geo.threads_per_lane, geo.lanes_per_block,
            geo.threads_per_block) == (1, 128, 128)
    assert (geo.scratch_per_lane, geo.smem_bytes) == (0, 0)
    assert geo.blocks(65536) == 512


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("d", [3, 5, 8])
def test_generated_source_carries_the_geometry(d, dtype, monkeypatch):
    unit = rhs_codegen.lower(ring_rhs, None, d, dtype)
    geo = k4.geometry(d, dtype)
    if d < k4.GROUP_MIN_DIM[dtype]:
        assert "launch_lanes<" in unit.source
        assert "GroupGeometry<" not in unit.source
        return
    assert (f"GroupGeometry<{geo.threads_per_lane}, {geo.lanes_per_block}, "
            f"{geo.blocks_per_sm}, {geo.scratch_per_lane}>") in unit.source
    assert "launch_group<" in unit.source
    # another geometry is another unit
    monkeypatch.setitem(k4.GROUP_BLOCKS, dtype, geo.blocks_per_sm + 1)
    assert rhs_codegen.lower(ring_rhs, None, d, dtype).name != unit.name


@pytest.mark.parametrize("dtype", DTYPES)
def test_layout_probe_variants_change_only_their_line(dtype):
    from janus_tpu_torch.bench import k4_layout
    from janus_tpu_torch.ops import _build
    unit = rhs_codegen.lower(ring_rhs, None, 8, dtype)
    geo = k4.geometry(8, dtype)
    text = unit.source.replace(unit.name, "@NAME@")
    blocks = k4_layout.variant(unit, geo.blocks_per_sm - 1)
    assert blocks.name != unit.name
    assert blocks.source.replace(blocks.name, "@NAME@") == text.replace(
        rhs_codegen.geometry_decl(geo), rhs_codegen.geometry_decl(
            dataclasses.replace(geo, blocks_per_sm=geo.blocks_per_sm - 1)))
    clocks = k4_layout.variant(unit, clocks=True)
    assert clocks.name not in (unit.name, blocks.name)
    assert clocks.source.replace(clocks.name, "@NAME@") == \
        "#define JANUS_K4_CLOCKS\n" + text
    # the header's marks: every phase charged in group_attempts, the
    # counters and their reader compiled only under the macro
    header = (_build.CSRC / "radau5_step.cuh").read_text()
    body = header[header.index("void group_attempts("):]
    for i in range(len(k4_layout.PHASES)):
        assert f"K4_TICK({i});" in body
    guarded = header[header.index("#ifdef JANUS_K4_CLOCKS"):]
    assert "janus_k4_clocks[16]" in guarded.split("#else")[0]
    assert "janus_k4_clocks_read" in header[header.rindex(
        "#ifdef JANUS_K4_CLOCKS"):]
    lane = rhs_codegen.lower(ring_rhs, None, 3, dtype)
    with pytest.raises(ValueError):
        k4_layout.variant(lane, 2)
    assert geo.blocks_per_sm in k4_layout.blocks_range(8, dtype)
