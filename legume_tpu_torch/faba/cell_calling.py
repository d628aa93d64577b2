"""Barcode QC / cell calling (`faba/src/cell_qc/mod.rs` equivalent).

Separates real cells from empty/ambient droplets on the gene-count
matrix, CellRanger-style:

- **ord-mag**: knee cutoff — baseline = the `ordmag_quantile` total
  within the top `expected_cells` barcodes, cutoff =
  `ordmag_fraction * baseline` (cell_qc/mod.rs:306-318);
- **empty-drops**: the knee UNION barcodes below it whose expression
  profile rejects the ambient multinomial (Lun et al. / DropletUtils):
  ambient profile from a low-rank window, Simple Good-Turing smoothed,
  Monte-Carlo null of the ambient log-likelihood at every candidate
  total, BH FDR (cell_qc/mod.rs:326-499);
- **min-counts** / **nnz**: threshold / keep-everything.

The port of the JAX package's `faba/cell_calling.py`. The reference
walks `n_sims` categorical paths of length `max_total` serially per
path; here the null runs on the device, sims in chunks of a [chunk,
max_total] categorical draw + cumulative sum of gene log-probs,
snapshotted at the candidate totals. The draws are JAX's bit for bit:
`jax.random.categorical` takes the Gumbel-max form (argmax over genes of
`gumbel(key, (n, T, G)) + logits`), drawn from the port's threefry, and
the cumulative sums round as XLA's CPU cumsum does
(`utils/prng.py::cumsum_rows_f32`). p-values and the BH pass are host
math.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..utils import prng

log = logging.getLogger(__name__)


@dataclass
class CellCallParams:
    """Defaults track CellRanger (cell_qc/mod.rs:76-94)."""

    filter: str = "empty-drops"  # empty-drops | ord-mag | min-counts | nnz
    min_counts: int = 500
    expected_cells: int = 3000
    ordmag_quantile: float = 0.99
    ordmag_fraction: float = 0.10
    ed_fdr: float = 0.01
    ed_n_sims: int = 10_000
    ed_ambient_lo: int = 45_000
    ed_ambient_hi: int = 90_000
    ed_min_umis: int = 500
    seed: int = 42


def simple_good_turing(counts: np.ndarray) -> np.ndarray:
    """Gale & Sampson (1995) smoothing of the ambient gene profile:
    observed genes get Good-Turing mass via the Turing -> linear-GT
    switch rule, unseen genes share the N1/N reserve; add-one fallback
    when the log-log fit degenerates (cell_qc/mod.rs:502-629)."""
    counts = np.asarray(counts, np.int64)
    n_genes = len(counts)
    n_total = int(counts.sum())
    if n_total == 0:
        return np.full(n_genes, 1.0 / max(n_genes, 1))

    r, nr = np.unique(counts[counts > 0], return_counts=True)
    n_zero = int((counts == 0).sum())
    n1 = float(nr[r == 1][0]) if (r == 1).any() else 0.0
    p0 = n1 / n_total if n_zero > 0 else 0.0

    # averaging transform Z_r + log-log fit (vectorized)
    rf = r.astype(np.float64)
    prev = np.concatenate([[0.0], rf[:-1]])
    nxt = np.concatenate([rf[1:], [2.0 * rf[-1] - (rf[-2] if len(rf) > 1 else 0.0)]])
    z = nr / (0.5 * (nxt - prev))
    lx, ly = np.log(rf), np.log(z)
    m = float(len(rf))
    denom = m * (lx * lx).sum() - lx.sum() ** 2
    if abs(denom) < 1e-12:
        slope, intercept = -1.5, 0.0
    else:
        slope = (m * (lx * ly).sum() - lx.sum() * ly.sum()) / denom
        intercept = (ly.sum() - slope * lx.sum()) / m
    s_smooth = lambda rv: np.exp(intercept + slope * np.log(rv))  # noqa: E731

    nr_of = dict(zip(r.tolist(), nr.astype(np.float64).tolist()))
    rstar: dict[int, float] = {}
    use_lgt = False
    for ri in r.tolist():
        lgt = (ri + 1.0) * s_smooth(ri + 1.0) / s_smooth(float(ri))
        if not use_lgt:
            nr1 = nr_of.get(ri + 1, 0.0)
            nri = nr_of[ri]
            if nr1 == 0.0:
                use_lgt = True
            else:
                turing = (ri + 1.0) * nr1 / nri
                se = np.sqrt((ri + 1.0) ** 2 * nr1 / (nri * nri) * (1.0 + nr1 / nri))
                if abs(turing - lgt) <= 1.96 * se:
                    use_lgt = True
                else:
                    rstar[ri] = turing
                    continue
        rstar[ri] = float(lgt)

    mass = sum(nr_of[ri] * rstar[ri] for ri in r.tolist())
    valid = np.isfinite(mass) and mass > 0 and all(
        np.isfinite(v) and v > 0 for v in rstar.values()
    )
    probs = np.zeros(n_genes)
    if valid:
        zero_share = p0 / n_zero if n_zero > 0 else 0.0
        scale = (1.0 - p0) / mass
        lut = np.zeros(int(r.max()) + 1)
        for ri, v in rstar.items():
            lut[ri] = scale * v
        probs = np.where(counts == 0, zero_share, lut[np.minimum(counts, len(lut) - 1)])
    else:
        probs = (counts + 1.0) / (n_total + n_genes)

    floor = 1e-12 / n_genes
    probs = np.where(np.isfinite(probs) & (probs > 0), probs, floor)
    return probs / probs.sum()


def ordmag_cutoff(totals: np.ndarray, p: CellCallParams) -> float:
    """OrdMag knee (cell_qc/mod.rs:306-318)."""
    if len(totals) == 0:
        return np.inf
    desc = np.sort(np.asarray(totals, np.float64))[::-1]
    top = min(p.expected_cells, len(desc))
    idx = min(int(np.floor(p.expected_cells * (1.0 - p.ordmag_quantile))), top - 1)
    return max(round(p.ordmag_fraction * desc[idx]), 1.0)


_DRAW_ELEMS = 1 << 24  # gumbel values formed at once


def categorical_draws(key: np.ndarray, logits: torch.Tensor, n: int, t: int) -> torch.Tensor:
    """`jax.random.categorical(key, logits, shape=(n, t))` for 1-D
    `logits [G]`: the argmax over genes of `gumbel(key, (n, t, G)) +
    logits` (the first index among ties, as `jnp.argmax`), formed in
    slabs of draw positions. `[n, t]` int64 on the logits' device."""
    g = logits.shape[0]
    dev = logits.device
    total = n * t * g
    krow = prng.key_rows(np.asarray(key)[None], dev)
    tiny = float(np.finfo(np.float32).tiny)
    out = torch.empty(n * t, dtype=torch.int64, device=dev)
    step = max(_DRAW_ELEMS // g, 1)
    gi = torch.arange(g, dtype=torch.int64, device=dev)
    for lb in range(0, n * t, step):
        ub = min(lb + step, n * t)
        flat = (torch.arange(lb, ub, dtype=torch.int64, device=dev)[:, None] * g + gi).reshape(1, -1)
        hi = (flat >> 32) if total > 1 << 32 else torch.zeros_like(flat)
        b1, b2 = prng._threefry_rows(krow, hi, flat & 0xFFFFFFFF)
        mant = ((b1 ^ b2) >> 9) | 0x3F800000
        fl = mant.to(torch.int32).view(torch.float32) - 1.0
        u = torch.clamp_min(fl * 1.0 + tiny, tiny)
        gum = -torch.log(-torch.log(u))
        out[lb:ub] = torch.argmax(gum.reshape(ub - lb, g) + logits[None, :], dim=1)
    return out.reshape(n, t)


def _null_snapshots(
    log_p: np.ndarray,
    probs: np.ndarray,
    uniq_totals: np.ndarray,
    n_sims: int,
    seed: int,
    *,
    sim_chunk: int = 256,
    device="cuda",
) -> np.ndarray:
    """[n_sims, U] null ambient log-likelihoods: each sim walks ONE
    categorical path of length max(uniq_totals), snapshotting the
    running LL at every candidate total (the reference's nested
    cumulative Monte-Carlo, cell_qc/mod.rs:424-457), chunk keys split as
    the JAX package splits them."""
    max_total = int(uniq_totals[-1])
    logits = torch.from_numpy(np.log(probs).astype(np.float32)).to(device)
    lp = torch.from_numpy(np.asarray(log_p, np.float32)).to(device)
    snap_at = torch.from_numpy(uniq_totals.astype(np.int64) - 1).to(device)  # cumsum index

    out = []
    key = prng.key(seed)
    done = 0
    while done < n_sims:
        n = min(sim_chunk, n_sims - done)
        key, sub = prng.split(key)
        g = categorical_draws(sub, logits, n, max_total)
        run = prng.cumsum_rows_f32(lp[g])  # [n, T]
        out.append(run[:, snap_at].cpu().numpy())
        done += n
    return np.concatenate(out, axis=0)


def empty_drops_pvalues(
    counts: sp.spmatrix,  # [G, C] gene x barcode
    candidates: np.ndarray,  # candidate barcode indices
    ambient_probs: np.ndarray,  # [G]
    p: CellCallParams,
    *,
    device="cuda",
) -> np.ndarray:
    """Per-candidate Monte-Carlo p-value of the ambient multinomial:
    a real cell's profile is UNLIKE ambient, so its observed LL falls
    in the lower tail; p = (1 + #{null <= obs}) / (n_sims + 1)."""
    csc = counts.tocsc()
    log_p = np.log(ambient_probs)
    sub = csc[:, candidates]
    obs_ll = np.asarray(sub.T @ log_p).ravel()
    totals = np.asarray(sub.sum(axis=0)).ravel().round().astype(np.int64)

    uniq = np.unique(totals)
    null = _null_snapshots(log_p, ambient_probs, uniq, p.ed_n_sims, p.seed, device=device)
    null_sorted = np.sort(null, axis=0)  # [S, U]
    slot = np.searchsorted(uniq, totals)
    le = np.zeros(len(candidates), np.int64)
    for u in range(len(uniq)):
        sel = slot == u
        if sel.any():
            le[sel] = np.searchsorted(null_sorted[:, u], obs_ll[sel], side="right")
    return (1.0 + le) / (p.ed_n_sims + 1.0)


def mito_elbow_cutoff(sorted_fracs: np.ndarray) -> float | None:
    """Data-driven MT%% cutoff: the point of the ascending per-cell
    MT-fraction curve farthest from its chord (quant/mod.rs:1040-1076).
    None when the distribution can't support one (<50 cells, flat, or
    an elbow in the lower half — over-filtering guard)."""
    f = np.asarray(sorted_fracs, np.float64)
    n = len(f)
    if n < 50:
        return None
    span = f[-1] - f[0]
    if span <= 1e-9:
        return None
    x = np.arange(n) / (n - 1)
    y = (f - f[0]) / span
    best_i = int(np.argmax(np.abs(x - y)))
    if best_i < n // 2:
        return None
    return float(f[best_i])


def gene_qc_masks(
    counts: sp.spmatrix,  # [G, C]
    *,
    gene_min_cells: int = 10,
    gene_min_counts: int = 0,
    cell_min_genes: int = 10,
) -> tuple[np.ndarray, np.ndarray]:
    """(gene_keep [G], cell_keep [C]) expression-QC masks
    (quant/mod.rs passing_genes_from_stats:416-428 + the cell
    nnz floor:386-391)."""
    csc = counts.tocsc()
    nnz_per_gene = np.asarray((csc > 0).sum(axis=1)).ravel()
    total_per_gene = np.asarray(csc.sum(axis=1)).ravel()
    gene_keep = nnz_per_gene >= gene_min_cells
    if gene_min_counts > 0:
        gene_keep &= total_per_gene >= gene_min_counts
    genes_per_cell = np.asarray((csc > 0).sum(axis=0)).ravel()
    cell_keep = genes_per_cell >= cell_min_genes
    return gene_keep, cell_keep


def mito_qc(
    counts: sp.spmatrix,  # [G, C]
    gene_chroms: list[str],  # chromosome name per gene
    *,
    mito_chr: str = "chrM,chrMT,MT,M",
    keep_mito: bool = False,
    max_mito_frac: float = 0.0,
    no_mito_cell_qc: bool = False,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(mito_gene_mask [G], mt_frac [C], cell_keep [C]) — genes on the
    mito chromosomes drop from the quantified set unless `keep_mito`;
    cells above the MT-fraction cutoff (fixed when `max_mito_frac` > 0,
    else the elbow) drop unless `no_mito_cell_qc`
    (quant/mod.rs MitoQcArgs:781-830, case-insensitive seqname match)."""
    chrs = {c.strip().lower() for c in mito_chr.split(",") if c.strip()}
    is_mito = np.asarray([str(c).lower() in chrs for c in gene_chroms])
    csc = counts.tocsc()
    totals = np.asarray(csc.sum(axis=0)).ravel()
    mt = np.asarray(csc[is_mito].sum(axis=0)).ravel() if is_mito.any() else np.zeros_like(totals)
    frac = np.where(totals > 0, mt / np.maximum(totals, 1e-12), 0.0)
    cell_keep = np.ones(csc.shape[1], bool)
    if not no_mito_cell_qc:
        cutoff = max_mito_frac if max_mito_frac > 0 else mito_elbow_cutoff(np.sort(frac))
        if cutoff is not None and cutoff > 0:
            cell_keep = frac <= cutoff
    gene_mask = np.ones(csc.shape[0], bool) if keep_mito else ~is_mito
    return gene_mask, frac, cell_keep


def load_cell_membership(
    path: str, *, barcode_col: int = 0, celltype_col: int = 1
) -> dict[str, str]:
    """Barcode -> cell-type lookup from a TSV/CSV membership file
    (data/cell_membership.rs; column indices are 0-based)."""
    import gzip

    lut: dict[str, str] = {}
    opener = gzip.open if str(path).endswith(".gz") else open
    with opener(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t" if "\t" in line else ",")
            if len(parts) <= max(barcode_col, celltype_col):
                continue
            lut[parts[barcode_col].strip()] = parts[celltype_col].strip()
    return lut


def match_barcode(lut: dict[str, str], cb: str, *, exact: bool = False) -> str | None:
    """Suffix-tolerant barcode matching (handles 10x '-1' suffixes)
    unless `exact` (DartSeqCountArgs exact_barcode_match)."""
    hit = lut.get(cb)
    if hit is not None or exact:
        return hit
    stem = cb.rsplit("-", 1)[0] if "-" in cb else cb
    hit = lut.get(stem)
    if hit is not None:
        return hit
    return lut.get(cb + "-1")


def call_cells(counts: sp.spmatrix, p: CellCallParams, *, device="cuda") -> np.ndarray:
    """Boolean keep mask over barcodes (cell_qc/mod.rs:261-297); the
    EmptyDrops null runs on `device`."""
    csc = counts.tocsc()
    totals = np.asarray(csc.sum(axis=0)).ravel()
    n = csc.shape[1]
    if p.filter == "nnz":
        return np.ones(n, bool)
    if p.filter == "min-counts":
        return totals >= p.min_counts
    cutoff = ordmag_cutoff(totals, p)
    keep = totals >= cutoff
    log.info("OrdMag cutoff: total >= %.0f (%d cells)", cutoff, int(keep.sum()))
    if p.filter == "ord-mag":
        return keep

    # EmptyDrops extension below the knee
    order = np.argsort(-totals, kind="stable")
    lo, hi = min(p.ed_ambient_lo, n), min(p.ed_ambient_hi, n)
    if hi <= lo:
        log.info(
            "EmptyDrops: too few barcodes (%d) for ambient window [%d, %d); skipping",
            n, p.ed_ambient_lo, p.ed_ambient_hi,
        )
        return keep
    ambient = np.asarray(
        csc[:, order[lo:hi]].sum(axis=1)
    ).ravel().round().astype(np.int64)
    if ambient.sum() == 0:
        log.info("EmptyDrops: empty ambient profile; skipping")
        return keep
    probs = simple_good_turing(ambient)

    cand = np.nonzero((totals >= p.ed_min_umis) & (totals < cutoff))[0]
    if len(cand) == 0:
        log.info("EmptyDrops: no candidates in [%d, %.0f)", p.ed_min_umis, cutoff)
        return keep
    pvals = empty_drops_pvalues(csc, cand, probs, p, device=device)
    from ..ops.enrichment import bh_fdr

    q = bh_fdr(pvals)
    rescued = cand[q < p.ed_fdr]
    keep[rescued] = True
    log.info("EmptyDrops: rescued %d additional cells (FDR < %g)", len(rescued), p.ed_fdr)
    return keep
