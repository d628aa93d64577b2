"""CNV calling on cocoa residuals (the port of the JAX package's
`cocoa/cnv_call.py`).

Per individual: genome-ordered per-gene residual log-ratios (observed
individual-level expression vs the shared component) smoothed into
segments and run through the CNV Gaussian HMM (`ops/cnv_hmm.py`) —
copy-number states per (individual, genomic bin). The HMM runs on the
device (`ops/cnv_hmm.py`); the rest is numpy. `genome_order_from_gff`
needs faba's GFF gene reader, which the port does not carry yet.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np

from ..ops.cnv_hmm import CnvHmmParams, fit_em, viterbi_batch

log = logging.getLogger(__name__)


@dataclass
class CnvCallResult:
    log_ratio: np.ndarray  # [I, B] binned residual log-ratios
    states: np.ndarray  # [I, B] argmax CN state
    posteriors: np.ndarray  # [I, B, K]
    alpha: np.ndarray
    bin_of_gene: np.ndarray


def genome_bins(
    gene_order: np.ndarray, n_genes: int, genes_per_bin: int = 25
) -> np.ndarray:
    """bin index per gene given a genome ordering (cnv genome_order.rs)."""
    bins = np.zeros(n_genes, np.int64)
    for rank, g in enumerate(gene_order):
        bins[g] = rank // genes_per_bin
    return bins


def call_cnv_on_residuals(
    indv_expr_di: np.ndarray,  # [D, I] per-(gene, individual) expression (tau or residual means)
    shared_d: np.ndarray,  # [D] shared component
    *,
    gene_order: np.ndarray | None = None,
    genes_per_bin: int = 25,
    n_iter: int = 20,
    device="cuda",
) -> CnvCallResult:
    d, i = indv_expr_di.shape
    order = np.arange(d) if gene_order is None else np.asarray(gene_order)
    bins = genome_bins(order, d, genes_per_bin)
    n_bins = int(bins.max()) + 1

    lr = np.log(np.maximum(indv_expr_di, 1e-8)) - np.log(
        np.maximum(shared_d, 1e-8)
    )[:, None]
    # bin medians per individual (robust to single-gene spikes)
    binned = np.zeros((i, n_bins))
    for b in range(n_bins):
        sel = bins == b
        if sel.any():
            binned[:, b] = np.median(lr[sel], axis=0)
    binned -= np.median(binned, axis=1, keepdims=True)

    params = CnvHmmParams.default_3state()
    alpha, sigma, post = fit_em(params, binned.astype(np.float32), n_iter=n_iter, device=device)
    return CnvCallResult(
        log_ratio=binned,
        states=post.argmax(-1),
        posteriors=post,
        alpha=alpha,
        bin_of_gene=bins,
    )


# ---------------------------------------------------------------------------
# Per-(individual x topic) CNV calling on cocoa-adjusted parameters
# (cocoa/src/cnv_call.rs + cnv/src/per_sample.rs). Sample = indv@topic.
# ---------------------------------------------------------------------------


@dataclass
class GenomeOrder:
    """Genes matched to coordinates, sorted by (chrom, position)
    (cnv/src/genome_order.rs)."""

    ordered: np.ndarray  # gene indices in genome order
    chrom: np.ndarray  # chrom index per ordered gene
    pos: np.ndarray  # position per ordered gene
    chrom_names: list


def genome_order_from_gff(gene_names: list, gff_path: str) -> GenomeOrder:
    """Genes matched to a GFF by name, at their TSS: needs faba's GFF gene
    reader (`faba/genes.py::parse_gff_genes`), not ported yet."""
    raise NotImplementedError("cocoa diff --gff needs faba's GFF gene reader, not ported yet")


def genome_order_from_truth_tsv(n_genes: int, path: str) -> GenomeOrder:
    """`.cnv_ground_truth.tsv[.gz]` alternative (gene_idx, chr, pos, ...)
    for simulation studies (cnv_call.rs load_gene_positions)."""
    import csv
    import gzip

    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt", newline="") as f:
        rows = list(csv.DictReader(f, delimiter="\t"))
    gi = np.asarray([int(r["gene_idx"]) for r in rows], np.int64)
    keep = (gi >= 0) & (gi < n_genes)
    chrom_names, chrom = np.unique(
        np.asarray([str(r["chr"]) for r in rows])[keep], return_inverse=True)
    pos = np.asarray([int(r["pos"]) for r in rows], np.int64)[keep]
    order = np.lexsort((pos, chrom))
    return GenomeOrder(gi[keep][order], chrom[order], pos[order], [str(c) for c in chrom_names])


def detect_normal_samples(log_tau: np.ndarray, frac: float = 0.34) -> np.ndarray:
    """Reference samples = lowest genome-wide mean |deviation| from the
    per-gene cross-sample median (per_sample.rs detect_normal_samples)."""
    med = np.median(log_tau, axis=1, keepdims=True)  # [G, 1]
    score = np.abs(log_tau - med).mean(axis=0)  # [S]
    k = int(np.clip(round(log_tau.shape[1] * frac), 2, log_tau.shape[1]))
    return np.sort(np.argsort(score, kind="stable")[:k])


def cluster_reference_from_cn_score(
    cn_topic: np.ndarray, frac: float = 0.34, seed: int = 0
) -> np.ndarray:
    """kmeans(K=2) over samples on their cn_score rows; the lower-burden
    cluster becomes the new reference set (per_sample.rs
    cluster_reference_from_cn_score). cn_topic is [G, I]."""
    n = cn_topic.shape[1]
    if n < 4:
        return np.arange(n)
    feat = cn_topic.T  # samples x genes
    rng = np.random.default_rng(seed)
    centers = feat[rng.choice(n, 2, replace=False)]
    for _ in range(25):
        d = ((feat[:, None, :] - centers[None]) ** 2).sum(-1)
        lab = d.argmin(1)
        if len(np.unique(lab)) < 2:
            break
        new = np.stack([feat[lab == c].mean(0) for c in (0, 1)])
        if np.allclose(new, centers):
            centers = new
            break
        centers = new
    burden = np.abs(cn_topic).mean(0)  # per sample
    if len(np.unique(lab)) < 2:
        return detect_normal_samples(cn_topic, frac)
    mean_burden = [burden[lab == c].mean() for c in (0, 1)]
    ref = int(np.argmin(mean_burden))
    idx = np.flatnonzero(lab == ref)
    cap = int(np.clip(round(n * max(frac, 0.2)), 2, n))
    if len(idx) > cap:  # keep the lowest-burden members
        idx = idx[np.argsort(burden[idx], kind="stable")[:cap]]
    return np.sort(idx)


@dataclass
class PerSampleCnv:
    order: GenomeOrder
    cn_score: np.ndarray  # [G_ord, K*I] in [-1, 1]
    states: np.ndarray  # [G_ord, K*I] Viterbi state
    signal: np.ndarray  # [G_ord, K*I] normalized log-ratio
    sample_names: list
    refs_per_topic: list  # list of index arrays (topic-local)
    neutral_idx: int


def call_per_sample_cnv(
    log_tau_kdi: np.ndarray,  # [K, D, I] exposure posterior log-means
    order: GenomeOrder,
    indv_names: list,
    topic_names: list,
    *,
    n_states: int = 3,
    gmm_k_max: int = 0,  # >0: kmeans-BIC selects K in 3..k_max
    ref_iters: int = 2,
    ref_frac: float = 0.34,
    n_iter: int = 20,
    seed: int = 0,
    device="cuda",
) -> PerSampleCnv:
    """Per-topic HMM CNV over genome-ordered genes. The reference set is
    auto-detected from raw deviation, then refined `ref_iters-1` times by
    re-clustering samples on cn_score. The EM and Viterbi of all topics
    run as one batch of K x I samples (each sample's fit is its own)."""
    k_topics, _, n_indv = log_tau_kdi.shape
    tau_ord = log_tau_kdi[:, order.ordered, :]  # [K, G, I]
    g = tau_ord.shape[1]
    if gmm_k_max >= 3:
        # kmeans+BIC state-count selection on the centered deviations
        # (cnv/src/kmeans_init.rs via CnvArgs cnv_gmm_k_max)
        dev = tau_ord - tau_ord.mean(axis=2, keepdims=True)
        params = CnvHmmParams.from_kmeans_bic(
            dev.reshape(-1), k_range=tuple(range(3, gmm_k_max + 1)), seed=seed, device=device
        )
    elif n_states == 3:
        params = CnvHmmParams.default_3state()
    else:
        span = np.linspace(-1.0, 1.0, n_states)
        params = CnvHmmParams.new(span * 0.7, neutral_idx=n_states // 2)
    em = np.asarray(params.emission_means)
    em_norm = em / max(np.abs(em).max(), 1e-6)
    neutral = int(np.argmin(np.abs(em)))

    refs = [detect_normal_samples(tau_ord[k], ref_frac) for k in range(k_topics)]
    cn = np.zeros((g, k_topics * n_indv), np.float32)
    st = np.zeros((g, k_topics * n_indv), np.int32)
    sig = np.zeros((g, k_topics * n_indv), np.float32)
    for it in range(max(ref_iters, 1)):
        sigs = []
        for k in range(k_topics):
            ref_mean = tau_ord[k][:, refs[k]].mean(axis=1, keepdims=True)
            s = tau_ord[k] - ref_mean  # [G, I]
            sigs.append(s - np.median(s, axis=0, keepdims=True))
        y = np.concatenate([s.T for s in sigs]).astype(np.float32)  # [K*I, G]
        alpha, sigma, post = fit_em(params, y, n_iter=n_iter, device=device)
        cn[:] = (post @ em_norm).T  # post [K*I, G, Kst] -> [G, K*I]
        st[:] = viterbi_batch(params, y, alpha, sigma, device=device).T
        sig[:] = y.T
        if it + 1 < ref_iters:
            refs = [
                cluster_reference_from_cn_score(
                    cn[:, k * n_indv:(k + 1) * n_indv], ref_frac, seed + it
                )
                for k in range(k_topics)
            ]
    names = [
        f"{indv_names[i]}@{topic_names[k]}"
        for k in range(k_topics) for i in range(n_indv)
    ]
    return PerSampleCnv(
        order=order, cn_score=cn, states=st, signal=sig,
        sample_names=names, refs_per_topic=refs, neutral_idx=neutral,
    )


def segments_bed_rows(res: PerSampleCnv) -> list:
    """Per-sample non-neutral runs as BED6 rows (chrom, start, end,
    sample|state, score, strand) — cnv_call.rs write_segments_bed."""
    rows = []
    chrom = res.order.chrom
    pos = res.order.pos
    for s, name in enumerate(res.sample_names):
        path = res.states[:, s]
        g = 0
        n = len(path)
        while g < n:
            if path[g] == res.neutral_idx:
                g += 1
                continue
            h = g
            while (
                h + 1 < n
                and path[h + 1] == path[g]
                and chrom[h + 1] == chrom[g]
            ):
                h += 1
            score = float(np.abs(res.cn_score[g:h + 1, s]).mean())
            rows.append((
                res.order.chrom_names[chrom[g]], int(pos[g]), int(pos[h]) + 1,
                f"{name}|state{int(path[g])}", min(int(round(1000 * score)), 1000),
                ".",
            ))
            g = h + 1
    rows.sort(key=lambda r: (r[0], r[1], r[2]))
    return rows


def deg_concordance(res: PerSampleCnv, n_genes: int) -> tuple:
    """Per-gene Pearson r of its signal row vs its own cn_score row
    across samples, + two-sided p (cnv_call.rs compute_deg_concordance).
    Genes outside the genome order get NaN."""
    from scipy import stats as sps

    s = res.signal - res.signal.mean(axis=1, keepdims=True)
    c = res.cn_score - res.cn_score.mean(axis=1, keepdims=True)
    num = (s * c).sum(axis=1)
    den = np.sqrt((s**2).sum(axis=1) * (c**2).sum(axis=1))
    r_ord = np.where(den > 1e-12, num / np.maximum(den, 1e-12), 0.0)
    n = res.cn_score.shape[1]
    t = r_ord * np.sqrt(max(n - 2, 1) / np.maximum(1 - r_ord**2, 1e-12))
    p_ord = 2 * sps.t.sf(np.abs(t), df=max(n - 2, 1))
    r = np.full(n_genes, np.nan, np.float32)
    p = np.full(n_genes, np.nan, np.float32)
    state = np.full(n_genes, -1, np.int32)
    # modal non-neutral state per gene across samples (modal_state_at)
    for gi, gene in enumerate(res.order.ordered):
        r[gene] = r_ord[gi]
        p[gene] = p_ord[gi]
        row = res.states[gi]
        nn = row[row != res.neutral_idx]
        state[gene] = (
            res.neutral_idx if nn.size == 0
            else int(np.bincount(nn).argmax())
        )
    return r, p, state
