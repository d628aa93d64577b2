"""Per-gene 1D Gaussian mixture clustering of modification sites.

The reference's bandwidth-first component calling for m6A / A-to-I
(`faba/src/editing/mixture.rs:13-31`, `mixture_pipeline.rs:18-24`,
`bandwidth.rs:1-27`, `mixture/em.rs:135`, `mixture/kernel_smooth.rs:13`):

1. Resolve ONE per-modality bandwidth from the signal-weighted median of
   within-gene nearest-neighbour site gaps (m6A: tight, scale 1, clamp
   [10, 200] nt; A-to-I: cluster-aware, scale 3, clamp [30, 600] nt so
   Alu hyper-editing islands merge into one component).
2. Per gene: Gaussian-smooth the signal-weighted site pileup at that
   bandwidth, read off interior modes as component centres (cap to
   `max_k` by density), then fit ONLY the mixing weights with a
   weighted fixed-component EM over {uniform noise over the gene body,
   N(centre, bandwidth) per mode}.
3. Hard-assign each (cell, site) observation to its argmax component
   and accumulate weighted counts -> a sparse (cells x components)
   matrix with `GENE/m6A/j` (or `GENE/A2I/j`) feature names, plus a
   component annotation table (mu, sigma, pi, gene_length).

Observation positions are strand-aware transcript-relative (spliced
exon offsets; genomic-span fallback only for genes with no exon model;
intronic observations are DROPPED, not nudged —
`mixture_pipeline.rs:120-144`). Observation weights are either the raw
converted count c (`converted`) or the Beta-posterior regularized
effective count n*(c+a)/(n+a+b) (`posterior`, the reference default —
`m6a/run.rs:420-432`).

Host numpy by design: per-gene problems are KB-scale (tens of sites,
hundreds of observations), so a device dispatch per gene would be pure
launch overhead; the EM itself is fully vectorized.

The port's copy of the JAX package's `faba/mixture.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

log = logging.getLogger(__name__)


@dataclass
class MixtureParams:
    """`mixture.rs:13-46` defaults."""

    min_sites: int = 3
    max_k: int = 5
    bandwidth: float = 0.0  # 0 = resolve globally / per-gene fallback
    drop_single_component: bool = False
    max_iter: int = 200
    tol: float = 1e-6
    min_weight: float = 0.01


# per-modality bandwidth tuning (`bandwidth.rs:29-49`)
BANDWIDTH_PRESETS = {
    "m6a": dict(min_sites=2, scale=1.0, min_bandwidth=10.0, max_bandwidth=200.0),
    "atoi": dict(min_sites=2, scale=3.0, min_bandwidth=30.0, max_bandwidth=600.0),
}


def _weighted_median(values: np.ndarray, weights: np.ndarray) -> float:
    """Value at which cumulative weight first reaches half the total;
    unweighted middle when all weights are zero (`bandwidth.rs:118`)."""
    order = np.argsort(values, kind="stable")
    v, w = values[order], weights[order]
    total = float(w.sum())
    if total <= 0.0:
        return float(v[len(v) // 2])
    cum = np.cumsum(w)
    return float(v[np.searchsorted(cum, total / 2.0)])


def estimate_bandwidth(
    per_gene: list[tuple[np.ndarray, np.ndarray]],
    *,
    min_sites: int = 2,
    scale: float = 1.0,
    min_bandwidth: float = 10.0,
    max_bandwidth: float = 200.0,
) -> tuple[float, int]:
    """Global per-modality bandwidth: `scale x` the signal-weighted
    median within-gene nearest-neighbour gap, clamped
    (`bandwidth.rs:60-116`). Each gap is weighted by the geometric mean
    of its endpoints' signal so marginal 1-read sites do not set the
    scale. Returns (bandwidth, n_gaps); n_gaps == 0 means the floor."""
    gaps, gws = [], []
    for pos, w in per_gene:
        if len(pos) < min_sites:
            continue
        key = np.round(np.asarray(pos, np.float64)).astype(np.int64)
        uniq, inv = np.unique(key, return_inverse=True)
        if len(uniq) < min_sites:
            continue
        wsum = np.bincount(inv, weights=np.maximum(np.asarray(w, np.float64), 0.0))
        g = np.diff(uniq).astype(np.float64)
        gw = np.sqrt(wsum[:-1] * wsum[1:])
        keep = g > 0
        gaps.append(g[keep])
        gws.append(gw[keep])
    if not gaps:
        return float(min_bandwidth), 0
    gaps_all = np.concatenate(gaps)
    gws_all = np.concatenate(gws)
    med = _weighted_median(gaps_all, gws_all)
    bw = float(np.clip(scale * med, min_bandwidth, max_bandwidth))
    return bw, int(len(gaps_all))


def _fallback_bandwidth(sorted_positions: np.ndarray) -> float:
    """Per-gene fallback: median NN gap clamped to [10, 200] nt
    (`mixture.rs:244-255`); 25 when fewer than two sites."""
    if len(sorted_positions) < 2:
        return 25.0
    g = np.sort(np.diff(sorted_positions))
    return float(np.clip(g[len(g) // 2], 10.0, 200.0))


def gaussian_kernel_smooth(
    x: np.ndarray, y: np.ndarray, x_out: np.ndarray, bandwidth: float
) -> np.ndarray:
    """Nadaraya-Watson with a Gaussian kernel (`kernel_smooth.rs:13`)."""
    d = np.asarray(x_out, np.float64)[:, None] - np.asarray(x, np.float64)[None, :]
    w = np.exp(-(d * d) / (2.0 * bandwidth * bandwidth))
    ws = w.sum(1)
    vs = w @ np.asarray(y, np.float64)
    out = np.zeros(len(x_out))
    nz = ws > 0
    out[nz] = vs[nz] / ws[nz]
    return out


def find_modes(y: np.ndarray) -> np.ndarray:
    """Indices of strict interior maxima (`kernel_smooth.rs:40-53`)."""
    y = np.asarray(y, np.float64)
    if len(y) < 3:
        return np.zeros(0, np.int64)
    mid = y[1:-1]
    return np.nonzero((mid > y[:-2]) & (mid > y[2:]))[0] + 1


def fixed_em_weighted(
    cll: np.ndarray,
    obs_weights: np.ndarray | None,
    *,
    n_free_params: int,
    n_for_bic: int | None = None,
    max_iter: int = 200,
    tol: float = 1e-6,
    min_weight: float = 0.01,
) -> dict:
    """Mixing-weight-only EM over precomputed per-observation component
    log-likelihoods (`mixture/em.rs:135-285`). Column 0 is the uniform
    noise catch-all: it is never pruned and is the sole survivor if all
    signal components fall below `min_weight` in one iteration.
    Observation weights c_m enter the log-likelihood and the M-step
    gamma accumulator linearly."""
    cll = np.asarray(cll, np.float64)
    n_obs, n_total = cll.shape
    w_obs = (
        np.ones(n_obs) if obs_weights is None else np.asarray(obs_weights, np.float64)
    )
    total_weight = float(w_obs.sum()) if n_obs else 0.0
    n_bic = n_for_bic if n_for_bic is not None else n_obs
    if n_obs == 0:
        return dict(weights=np.zeros(0), gamma=np.zeros((0, n_total)), log_lik=0.0,
                    bic=0.0, n_iter=0)

    pis = np.full(n_total, 1.0 / n_total)
    prev_ll = -np.inf
    it = 0
    while True:
        with np.errstate(divide="ignore"):
            log_pi = np.where(pis > 0, np.log(np.maximum(pis, 1e-300)), -np.inf)
        a = cll + log_pi[None, :]
        amax = a.max(1)
        # all-(-inf) rows (noise pruned impossible, but guard anyway)
        amax = np.where(np.isfinite(amax), amax, 0.0)
        ez = np.exp(a - amax[:, None])
        norm = ez.sum(1)
        log_norm = amax + np.log(np.maximum(norm, 1e-300))
        gamma = ez / np.maximum(norm, 1e-300)[:, None]
        total_ll = float((w_obs * log_norm).sum())
        it += 1
        if it > 1 and (abs(total_ll - prev_ll) < tol or it >= max_iter):
            bic = -2.0 * total_ll + n_free_params * np.log(max(n_bic, 1))
            return dict(weights=pis, gamma=gamma, log_lik=total_ll, bic=float(bic),
                        n_iter=it)
        prev_ll = total_ll
        pis = (w_obs[:, None] * gamma).sum(0) / max(total_weight, 1e-300)
        pis[1:] = np.where(pis[1:] < min_weight, 0.0, pis[1:])
        s = pis.sum()
        if s > 0:
            pis = pis / s
        else:
            pis = np.zeros(n_total)
            pis[0] = 1.0


def fit_gene_mixture(
    cell_idx: np.ndarray,
    positions: np.ndarray,
    counts: np.ndarray,
    gene_length: float,
    params: MixtureParams,
) -> dict | None:
    """Bandwidth-first per-gene fit (`mixture.rs:97-230`). Returns None
    below `min_sites` distinct positions; otherwise a dict with the
    component centres/sigma/pis, BIC, and hard-assigned per-(cell,
    component) weighted counts (component 0 = noise)."""
    positions = np.asarray(positions, np.float64)
    counts = np.asarray(counts, np.float64)
    if len(positions) == 0:
        return None
    key = np.round(positions).astype(np.int64)
    uniq, inv = np.unique(key, return_inverse=True)
    if len(uniq) < params.min_sites:
        return None
    ys = np.bincount(inv, weights=np.maximum(counts, 0.0))
    xs = uniq.astype(np.float64)

    bw = params.bandwidth if params.bandwidth > 0 else _fallback_bandwidth(xs)

    smoothed = gaussian_kernel_smooth(xs, ys, xs, bw)
    padded = np.concatenate([[0.0], smoothed, [0.0]])
    mode_idx = find_modes(padded) - 1
    centers = xs[mode_idx]
    density = smoothed[mode_idx]
    if len(centers) == 0:
        # flat profile: single signal-weighted centroid (`mixture.rs:146`)
        wsum = float(ys.sum())
        c = float((xs * ys).sum() / wsum) if wsum > 0 else float(xs[len(xs) // 2])
        centers = np.asarray([c])
        density = np.asarray([wsum])
    if params.max_k > 0 and len(centers) > params.max_k:
        top = np.argsort(-density, kind="stable")[: params.max_k]
        centers = np.sort(centers[top])
    k = len(centers)

    noise_ll = -np.log(gene_length) if gene_length > 0 else -np.inf
    z = (positions[:, None] - centers[None, :]) / bw
    gauss_ll = -0.5 * z * z - np.log(bw) - 0.5 * np.log(2.0 * np.pi)
    cll = np.concatenate([np.full((len(positions), 1), noise_ll), gauss_ll], axis=1)

    em = fixed_em_weighted(
        cll, counts, n_free_params=k, n_for_bic=len(positions),
        max_iter=params.max_iter, tol=params.tol, min_weight=params.min_weight,
    )

    best = np.argmax(em["gamma"], axis=1)
    comp_counts: dict[tuple[int, int], float] = {}
    for ci, comp, cnt in zip(np.asarray(cell_idx, np.int64), best, counts):
        key2 = (int(ci), int(comp))
        comp_counts[key2] = comp_counts.get(key2, 0.0) + float(cnt)

    return dict(
        weights=em["weights"],
        mus=centers,
        sigma=float(bw),
        bic=em["bic"],
        cell_component_counts=comp_counts,
    )


def assign_sites_to_genes(
    model,
    exons: dict[int, np.ndarray],
    ref_names: list[str],
    site_rid: np.ndarray,
    site_pos: np.ndarray,
    site_strand: np.ndarray,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Map called sites to (gene index, strand-aware transcript-relative
    position, spliced gene length). gene -1 = unassigned (no overlapping
    same-strand gene, or intronic — dropped per `mixture_pipeline.rs:124`).

    Positions run 5'->3' along the mature transcript: merged-exon
    cumulative offsets, reversed for minus-strand genes. `parse_gff_exons`
    gives the full genomic span to genes with no exon rows, which is
    exactly the reference's genomic fallback."""
    cmap = {c: i for i, c in enumerate(model.chrom_names)}
    n = len(site_pos)
    gene_of = np.full(n, -1, np.int64)
    rel = np.zeros(n, np.float64)
    glen = np.zeros(n, np.float64)

    by_chrom: dict[int, list[int]] = {}
    for g in range(len(model.names)):
        by_chrom.setdefault(int(model.chrom[g]), []).append(g)

    lens_cache: dict[int, tuple[np.ndarray, np.ndarray, float]] = {}

    def _exon_view(g: int):
        if g not in lens_cache:
            ivs = exons[g]
            lens = (ivs[:, 1] - ivs[:, 0]).astype(np.float64)
            offs = np.concatenate([[0.0], np.cumsum(lens)[:-1]])
            lens_cache[g] = (ivs, offs, float(lens.sum()))
        return lens_cache[g]

    for s in range(n):
        name = ref_names[int(site_rid[s])]
        ci = cmap.get(name)
        if ci is None:
            continue
        want = 1 if str(site_strand[s]) == "+" else -1
        pos = int(site_pos[s])
        for g in by_chrom.get(ci, []):
            if int(model.strand[g]) != want:
                continue
            if not (model.start[g] <= pos < model.end[g]):
                continue
            ivs, offs, total = _exon_view(g)
            j = np.searchsorted(ivs[:, 0], pos, side="right") - 1
            if j < 0 or pos >= ivs[j, 1]:
                # intronic in THIS gene: keep scanning — the site may be
                # exonic in another overlapping same-strand gene (the
                # reference keys observations by the discovery-time gene,
                # so such sites survive there); drop only when no
                # overlapping gene yields a transcript position
                continue
            r = offs[j] + (pos - ivs[j, 0])
            if want == -1:
                r = total - 1 - r
            gene_of[s] = g
            rel[s] = r
            glen[s] = total
            break
    return gene_of, rel, glen


def run_mixture(
    cell_counts: sp.spmatrix,
    site_rid: np.ndarray,
    site_pos: np.ndarray,
    site_strand: np.ndarray,
    ref_names: list[str],
    model,
    exons: dict[int, np.ndarray],
    *,
    modality: str = "m6a",
    params: MixtureParams | None = None,
    weight_mode: str = "posterior",
    prior_alpha: float = 1.0,
    prior_beta: float = 1.0,
    cell_coverage: sp.spmatrix | None = None,
):
    """Orchestrate the per-gene mixture over called sites
    (`mixture_pipeline.rs:28`). `cell_counts` is the [sites, cells]
    converted-count matrix from site quantification; `cell_coverage`
    (same shape, required for `posterior` weighting) holds total
    per-(cell, site) read coverage.

    Returns (matrix [components, cells] csc, feature_names,
    components_df, bandwidth) — None matrix when nothing fit."""
    import pandas as pd

    params = params or MixtureParams()
    n_cells = cell_counts.shape[1]
    gene_of, rel, glen = assign_sites_to_genes(
        model, exons, ref_names, site_rid, site_pos, site_strand
    )

    coo = cell_counts.tocoo()
    if weight_mode == "posterior":
        if cell_coverage is None:
            raise ValueError("posterior weighting needs per-cell coverage")
        cov = np.asarray(cell_coverage.tocsr()[coo.row, coo.col]).ravel()
        c = coo.data.astype(np.float64)
        nn = np.maximum(cov, c)
        w = nn * (c + prior_alpha) / (nn + prior_alpha + prior_beta)
    elif weight_mode == "converted":
        w = coo.data.astype(np.float64)
    else:
        raise ValueError(f"unknown mixture weight mode: {weight_mode}")

    obs_gene = gene_of[coo.row]
    keep = obs_gene >= 0
    obs_gene = obs_gene[keep]
    obs_cell = coo.col[keep]
    obs_pos = rel[coo.row[keep]]
    obs_w = w[keep]
    obs_glen = glen[coo.row[keep]]
    n_dropped = int((~keep).sum())
    if n_dropped:
        log.info("mixture: dropped %d observation(s) outside gene/exon models",
                 n_dropped)
    if len(obs_gene) == 0:
        return None, [], pd.DataFrame(), 0.0

    order = np.argsort(obs_gene, kind="stable")
    obs_gene, obs_cell = obs_gene[order], obs_cell[order]
    obs_pos, obs_w, obs_glen = obs_pos[order], obs_w[order], obs_glen[order]
    genes, starts = np.unique(obs_gene, return_index=True)
    bounds = np.concatenate([starts, [len(obs_gene)]])

    # resolve the per-modality bandwidth once (explicit > 0 wins)
    resolved = MixtureParams(**{**params.__dict__})
    if resolved.bandwidth <= 0:
        preset = BANDWIDTH_PRESETS.get(modality, BANDWIDTH_PRESETS["m6a"])
        per_gene = [
            (obs_pos[bounds[i]:bounds[i + 1]], obs_w[bounds[i]:bounds[i + 1]])
            for i in range(len(genes))
        ]
        bw, n_gaps = estimate_bandwidth(per_gene, **preset)
        log.info("mixture: auto bandwidth = %.1f nt (%d gaps pooled, %s)",
                 bw, n_gaps, modality)
        resolved.bandwidth = bw
    else:
        log.info("mixture: bandwidth = %.1f nt (user-specified)", resolved.bandwidth)

    mod_suffix = "A2I" if modality == "atoi" else "m6A"
    rows_out: list[int] = []
    cols_out: list[int] = []
    vals_out: list[float] = []
    names: list[str] = []
    ann: list[dict] = []
    # gene order fixed by sorted gene NAME, matching the reference's
    # gene_entries sort on GeneId (`mixture_pipeline.rs:180-186`) —
    # numeric GFF index order differs whenever the GFF isn't
    # name-sorted, and row order is part of the output format
    name_order = sorted(
        range(len(genes)), key=lambda i: str(model.names[int(genes[i])])
    )
    for i in name_order:
        g = genes[i]
        lo, hi = bounds[i], bounds[i + 1]
        gene_length = float(obs_glen[lo])  # constant within a gene
        fit = fit_gene_mixture(
            obs_cell[lo:hi], obs_pos[lo:hi], obs_w[lo:hi], gene_length, resolved
        )
        if fit is None:
            continue
        pis = fit["weights"]
        # renumber active (pi > 0) components, skipping noise at 0
        old_to_new: dict[int, int] = {}
        local = []
        for j, mu in enumerate(fit["mus"]):
            pi = float(pis[j + 1])
            if pi > 0:
                old_to_new[j] = len(local)
                local.append(dict(
                    gene=str(model.names[int(g)]), component=len(local),
                    mu=float(mu), sigma=fit["sigma"], pi=pi,
                    gene_length=gene_length if gene_length > 0 else np.nan,
                ))
        if resolved.drop_single_component and len(local) < 2:
            continue
        if not local:
            continue
        base = len(names)
        for row in local:
            names.append(f"{row['gene']}/{mod_suffix}/{row['component']}")
            ann.append(row)
        for (ci, comp), cnt in fit["cell_component_counts"].items():
            if comp == 0:
                continue  # noise
            new = old_to_new.get(comp - 1)
            if new is not None:
                rows_out.append(base + new)
                cols_out.append(ci)
                vals_out.append(cnt)

    components = pd.DataFrame(ann)
    if not names:
        return None, [], components, resolved.bandwidth
    mat = sp.coo_matrix(
        (np.asarray(vals_out, np.float32), (rows_out, cols_out)),
        shape=(len(names), n_cells),
    ).tocsc()
    return mat, names, components, resolved.bandwidth
