"""The launch plans of the port's K3 and K1/K2 wrappers (`ops/kernels.py`),
on the CPU: each plan covers every cell, group, gene and basis column
exactly once, in the order the kernels walk them, and fits the card's
shared memory."""

import numpy as np
import pytest

from legume_tpu_torch.ops import kernels

# (cells, genes, groups): the main path's planes (topic group, batch and
# matched; bge group), the production shape, and edge cases
COLLAPSE_SHAPES = [
    (8192, 2000, 1024), (8192, 2000, 2), (10240, 2000, 1024), (8192, 2000, 256),
    (8192, 34008, 607), (300, 400, 7), (50, 60000, 3), (8192, 2000, 1), (1, 1, 1),
    (130, 33, 130), (5000, 100, 5), (50, 60000, 20),
]


def _walk(plan, seg, num_groups):
    """The cells each warp of K3 walks, in its order. Few groups: per
    (chunk, group, replica), the chunk's cells of that group whose offset
    in the chunk is the replica modulo `replicas`, ascending. Many groups:
    per item, up to `cap` consecutive cells of its group in index order."""
    ncols = seg.shape[0]
    if plan.cap:
        walks = {}
        for s in range(num_groups):
            cells = np.flatnonzero(seg == s).tolist()
            for j in range(0, len(cells), plan.cap):
                walks[(s, j // plan.cap)] = cells[j:j + plan.cap]
        return walks
    walks = {}
    for ch in range(plan.chunks):
        c0 = ch * plan.chunk_cells
        c1 = min(c0 + plan.chunk_cells, ncols)
        for gt in range(plan.group_tiles):
            for warp in range(kernels.COLLAPSE_WARPS):
                s = gt * plan.slots + warp % plan.slots
                r = warp // plan.slots
                if s >= num_groups:
                    continue
                cells = [c for c in range(c0, c1)
                         if seg[c] == s and (c - c0) % plan.replicas == r]
                walks[(ch, s, r)] = cells
    return walks


@pytest.mark.parametrize("skewed", [False, True])
@pytest.mark.parametrize("ncols,genes,groups", COLLAPSE_SHAPES)
def test_collapse_plan_covers_each_kept_cell_once(ncols, genes, groups, skewed):
    plan = kernels.collapse_plan(ncols, genes, groups)
    assert plan.gene_tile % 32 == 0
    assert (plan.gene_tiles - 1) * plan.gene_tile < genes <= plan.gene_tiles * plan.gene_tile
    assert kernels.COLLAPSE_WARPS * (plan.gene_tile + 4) * 4 <= kernels.COLLAPSE_SMEM
    if plan.cap:  # many groups: items of at most `cap` cells, in one chunk
        assert groups >= kernels.COLLAPSE_WARPS and plan.chunks == 1
        assert 2 <= plan.cap <= kernels.COLLAPSE_MAX_CAP
    else:  # few groups: chunks tile the cells in order, none empty
        assert groups < kernels.COLLAPSE_WARPS
        assert plan.chunk_cells * plan.chunks >= ncols
        assert (plan.chunks - 1) * plan.chunk_cells < ncols
        if plan.chunks > 1:
            assert plan.chunks * genes * groups * 4 <= kernels.COLLAPSE_PARTIAL_BYTES
        assert plan.replicas * plan.slots == kernels.COLLAPSE_WARPS
        assert plan.replicas & (plan.replicas - 1) == 0
        assert (plan.group_tiles - 1) * plan.slots < groups <= plan.group_tiles * plan.slots
        assert plan.slots < 2 * groups  # the idle slots are fewer than the groups

    rng = np.random.default_rng(ncols + groups)
    if skewed:  # a Zipf law over the groups, as binary-sort codes fall
        p = 1.0 / np.arange(1, groups + 3) ** 1.2
        seg = rng.choice(np.arange(-1, groups + 1), ncols, p=p / p.sum())
    else:
        seg = rng.integers(-1, groups + 2, ncols)  # < 0 and >= groups are dropped
    seen = np.zeros(ncols, int)
    for cells in _walk(plan, seg, groups).values():
        assert cells == sorted(cells)
        if plan.cap:
            assert 1 <= len(cells) <= plan.cap
        np.add.at(seen, np.asarray(cells, int), 1)
    kept = (seg >= 0) & (seg < groups)
    np.testing.assert_array_equal(seen, kept.astype(int))


def test_collapse_plan_regimes():
    """Few groups split each group's cells over the CTA's warps and over
    chunks; many groups cut each group's cells into items; a gene column
    past the shared-memory budget is tiled, and there items grow so that
    the partial slots stay within their budget."""
    batch = kernels.collapse_plan(8192, 2000, 2)
    assert (batch.replicas, batch.gene_tiles, batch.cap) == (4, 1, 0) and batch.chunks > 1
    group = kernels.collapse_plan(8192, 2000, 1024)
    assert group.cap == 4 and group.chunks == 1
    prod = kernels.collapse_plan(8192, 34008, 607)
    assert prod.gene_tiles > 1 and prod.cap == kernels.COLLAPSE_MAX_CAP
    with pytest.raises(ValueError):
        kernels.collapse_plan(0, 10, 2)


@pytest.mark.parametrize("ncols,genes,k", [
    (8192, 2000, 50), (8192, 34008, 64), (8192, 2000, 200), (300, 500, 7), (100, 5000, 150),
    (1, 1, 1), (257, 3632, 16), (257, 3633, 17),
])
def test_project_plan_covers_each_column_and_gene_once(ncols, genes, k):
    plan = kernels.project_plan(ncols, genes, k)
    assert (plan.slices - 1) * kernels.PROJECT_SLICE < k <= plan.slices * kernels.PROJECT_SLICE
    assert (plan.gene_tiles - 1) * plan.gene_tile < genes <= plan.gene_tiles * plan.gene_tile
    cta = kernels.PROJECT_CELLS_PER_CTA
    assert (plan.cell_tiles - 1) * cta < ncols <= plan.cell_tiles * cta
    buffers = 2 if plan.gene_tiles > 1 else 1
    assert buffers * plan.gene_tile * kernels.PROJECT_SLICE * 4 <= kernels.SMEM_BYTES
    # one tile whenever the whole basis slice fits shared memory
    assert (plan.gene_tiles == 1) == (genes * kernels.PROJECT_SLICE * 4 <= kernels.SMEM_BYTES)
