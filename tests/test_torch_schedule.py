"""The launch plans of the port's K3, K1/K2 and K4 wrappers
(`ops/kernels.py`), on the CPU: each plan covers every cell, group, gene,
basis column and (row, gene) pair exactly once, in the order the kernels
walk them, and fits the card's shared memory. Also K4's split-TF32
arithmetic, emulated in torch."""

import numpy as np
import pytest
import torch

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


# (P, D, H) of K4: odd shapes around the 64-row chunk and 64-gene tile,
# one row and one gene, the e2e planes (bge's phase-1 plane, a phase-2
# block) and the NCE anchor
NCE_SHAPES = [
    (p, d, h) for p in (1, 37, 2627) for d in (1, 200, 1001, 34008) for h in (1, 16, 17, 128)
] + [(256, 2000, 16), (2048, 2000, 16), (100_000, 2000, 16)]


def _nce_walk(plan):
    """The (chunk, tile) pairs each CTA of K4 walks, in its order: chunks
    of its band, and within each the tiles of its range."""
    walks = {}
    for b in range(plan.bands):
        chunks = range(b * plan.band_chunks, min(plan.chunks, (b + 1) * plan.band_chunks))
        for r in range(plan.ranges):
            tiles = range(r * plan.range_tiles, min(plan.tiles, (r + 1) * plan.range_tiles))
            walks[(b, r)] = [(c, t) for c in chunks for t in tiles]
    return walks


@pytest.mark.parametrize("p,d,h", NCE_SHAPES)
def test_nce_plan_covers_each_row_and_gene_once(p, d, h):
    plan = kernels.nce_plan(p, d, h)
    seen = np.zeros((plan.chunks * kernels.NCE_ROWS, plan.tiles * kernels.NCE_GENES), np.int8)
    for pairs in _nce_walk(plan).values():
        assert pairs  # no CTA of the grid is empty
        for c, t in pairs:
            seen[c * kernels.NCE_ROWS:(c + 1) * kernels.NCE_ROWS,
                 t * kernels.NCE_GENES:(t + 1) * kernels.NCE_GENES] += 1
    np.testing.assert_array_equal(seen[:p, :d], 1)
    assert plan.chunks * kernels.NCE_ROWS - p < kernels.NCE_ROWS
    assert plan.tiles * kernels.NCE_GENES - d < kernels.NCE_GENES
    for count_bytes in (4, 2):
        for need_feat in (True, False):
            assert kernels.nce_smem_bytes(h, plan.range_tiles, count_bytes, need_feat) <= kernels.SMEM_BYTES
    if h <= 16:  # three CTAs share an SM
        assert kernels.nce_smem_bytes(h, plan.range_tiles, 4, True) <= kernels.NCE_SMEM_SLOT
    # one plan for both forms: the scratch differs by the feature side only
    hs = h + 1
    assert plan.scratch_floats(True) - plan.scratch_floats(False) == plan.bands * d * hs


@pytest.mark.parametrize("p,d", [(2627, 34008), (2048, 2000)])
def test_nce_plan_fills_the_card(p, d):
    """The anchor and a phase-2 block give at least about two CTAs per SM
    of an H100, and the anchor's partial planes stay under the 47.5 MB of
    g_ea partials that one 128-gene tile a CTA wrote."""
    plan = kernels.nce_plan(p, d, 16)
    assert plan.bands * plan.ranges >= 2 * kernels.NCE_SMS
    if d == 34008:
        assert plan.scratch_floats(True) * 4 < 47.5e6


def _tf32(x):
    """`cvt.rna.tf32.f32`: 10 explicit mantissa bits, to nearest, ties
    away from zero (the float's magnitude bits rounded half up), as
    csrc/nce_epoch.cu's `to_tf32` computes it."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def _mm(a, b, form):
    """a @ b in f32 (`"f32"`), with TF32 operands in one pass (`"one"`),
    or in the split form a_big.b_big + a_big.b_small + a_small.b_big
    (`"split"`, f32 sums)."""
    if form == "f32":
        return a @ b
    ab, bb = _tf32(a), _tf32(b)
    if form == "one":
        return ab @ bb
    as_, bs = _tf32(a - ab), _tf32(b - bb)
    return as_ @ bb + ab @ bs + ab @ bb


def _nce_tf32(c, q, e_f, b_f, e_a, b_a, m, k_neg, *, score="f32", backward="split"):
    """K4's arithmetic with its score product and its two backward
    products (g_ef, g_ea) each in the given form; the defaults are the
    kernel as built: the score in f32 on the CUDA cores, the backward
    products in split TF32 on the tensor cores."""
    s = _mm(e_a, e_f.T, score) + b_f[None, :] + b_a[:, None]
    a = c + k_neg * (m[:, None] * q[None, :])
    softplus = torch.clamp_min(s, 0.0) + torch.log1p(torch.exp(-s.abs()))
    g_s = c - a * torch.sigmoid(s)
    return ((c * s - a * softplus).sum(), _mm(g_s.T, e_a, backward), g_s.sum(0),
            _mm(g_s, e_f, backward), g_s.sum(1))


def _worst(got, want):
    """Each gradient's normwise error against the plain version."""
    return [float((g - w).abs().max()) / float(w.abs().max()) for g, w in zip(got[1:], want[1:])]


def _tensors(*xs):
    return [torch.from_numpy(np.asarray(x, np.float32)) for x in xs]


def test_split_tf32_keeps_the_gradient_bar_and_one_pass_does_not():
    """On a seeded anchor-like plane (3% Poisson(2) + 1, H = 16,
    embeddings of std 0.5, biases near -2), the kernel as built (f32
    score, split-TF32 backward products) stays within the 1e-4 normwise
    gradient bar of tests/test_nce_pallas.py against the f32 plain
    version, and a single TF32 pass in the backward products does not:
    the reason csrc/nce_epoch.cu runs three products per product."""
    rng = np.random.default_rng(7)
    p, d, h = 512, 2048, 16
    counts = np.zeros(p * d, np.float32)
    nnz = int(0.03 * counts.size)
    counts[rng.integers(0, counts.size, nnz)] = rng.poisson(2.0, nnz) + 1.0
    counts = counts.reshape(p, d)
    q = counts.sum(0) ** 0.75
    q = q / q.sum()
    args = _tensors(counts, q, 0.5 * rng.standard_normal((d, h)), -2.0 + 0.1 * rng.standard_normal(d),
                    0.5 * rng.standard_normal((p, h)), -2.0 + 0.1 * rng.standard_normal(p), counts.sum(1))
    want = kernels.nce_epoch_plain(*args, 5.0)
    built = _nce_tf32(*args, 5.0)
    assert abs(float(built[0]) - float(want[0])) <= 2e-5 * abs(float(want[0]))
    assert max(_worst(built, want)) < 1e-5
    assert max(_worst(_nce_tf32(*args, 5.0, backward="one"), want)) > 1e-4


def test_split_tf32_score_misses_the_bar_on_a_trained_pseudobulk_plane():
    """A pseudobulk plane near its optimum (256 x 2,000, H = 16; masses of
    3e5-9e5 as ~400 summed cells give, so a = c + w runs to ~1e5; counts
    the rounded w * exp(s), so g_s = c - a*sigmoid(s) is a small
    difference of large terms): the score in split TF32 puts the bias
    gradients, sums of g_s along columns and rows, past the 1e-4 bar,
    where the kernel as built (f32 score) stays within it. The reason
    csrc/nce_epoch.cu scores on the CUDA cores."""
    rng = np.random.default_rng(0)
    p, d, h = 256, 2000, 16
    e_a, e_f = 0.5 * rng.standard_normal((p, h)), 0.5 * rng.standard_normal((d, h))
    b_a, b_f = -1.0 + 0.1 * rng.standard_normal(p), -1.0 + 0.5 * rng.standard_normal(d)
    q = rng.gamma(1.0, 1.0, d)
    q /= q.sum()
    m = rng.uniform(3e5, 9e5, p)
    w = 5.0 * m[:, None] * q[None, :]
    counts = np.round(w * np.exp(e_a @ e_f.T + b_f[None, :] + b_a[:, None]))
    args = _tensors(counts, q, e_f, b_f, e_a, b_a, m)
    want = kernels.nce_epoch_plain(*args, 5.0)
    assert max(_worst(_nce_tf32(*args, 5.0), want)) < 1e-5
    _, g_bf, _, g_ba = _worst(_nce_tf32(*args, 5.0, score="split"), want)
    assert g_bf > 1e-4 and g_ba > 1e-4
