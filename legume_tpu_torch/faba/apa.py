"""`faba apa` — alternative polyadenylation site usage
(`faba/src/apa/` equivalent, 5.8k LoC in the reference).

Pipeline: per gene, histogram deduped read 3'-end positions, call PAS
peaks by 1-D density clustering (merge ends within `peak_window`),
keep peaks above `min_reads`, then count per-(cell, peak) usage and a
per-gene distal-usage index (distal reads / all PAS reads). Features
follow the `gene/apa/site` row-name convention (feature_name.rs).

The port's copy of the JAX package's `faba/apa.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .bam import read_bam
from .genes import GeneModel, assign_reads_to_genes, parse_gff_genes

log = logging.getLogger(__name__)


def call_pas_peaks(
    ends: np.ndarray, *, peak_window: int = 30, min_reads: int = 5
) -> list[tuple[int, int, int]]:
    """1-D cluster of end positions -> [(center, start, end)] peaks."""
    if len(ends) == 0:
        return []
    ends = np.sort(ends)
    peaks = []
    start = 0
    for i in range(1, len(ends) + 1):
        if i == len(ends) or ends[i] - ends[i - 1] > peak_window:
            group = ends[start:i]
            if len(group) >= min_reads:
                peaks.append((int(np.median(group)), int(group[0]), int(group[-1])))
            start = i
    return peaks


@dataclass
class ApaResult:
    counts: sp.csc_matrix  # [n_sites, n_cells]
    site_names: list
    barcodes: list
    distal_index: dict  # gene -> mean distal usage in [0, 1]


def run_apa(
    bam_path: str,
    gff_path: str,
    *,
    min_mapq: int = 20,
    peak_window: int = 30,
    min_reads: int = 5,
    # polyA-tail gate (CountApaArgs polya_min_tail_length /
    # polya_max_non_a_or_t): keep only reads whose terminal soft clip
    # carries an untemplated A/T run of at least this length with at
    # most `max_non_at` non-A/T bases. 0 = no gating (every read).
    polya_min_tail_length: int = 0,
    polya_max_non_at: int = 2,
    # BED of 3'UTR intervals: molecules whose 3' end falls outside any
    # UTR drop before peak calling (CountApaArgs utr_bed)
    utr_bed: "str | None" = None,
    # cap called PAS sites per gene, keeping the highest-coverage peaks
    # (PipelineArgs apa_max_sites: bounds downstream cost on long UTRs)
    max_sites: int = 0,
) -> ApaResult:
    recs = read_bam(bam_path)
    model = parse_gff_genes(gff_path)
    keep = (recs.mapq >= min_mapq) & (recs.cb_id >= 0) & ((recs.flag & 0x904) == 0)
    if polya_min_tail_length > 0 and recs.tail_len is not None:
        t_len = recs.tail_len.astype(np.int64)
        hits = np.round(recs.tail_frac.astype(np.float64) / 255.0 * t_len)
        polya = (t_len >= polya_min_tail_length) & (
            (t_len - hits) <= polya_max_non_at
        )
        keep &= polya
    gene = assign_reads_to_genes(
        recs.ref_id[keep], recs.pos[keep], recs.end_pos[keep], recs.ref_names, model
    )
    end = recs.end_pos[keep]
    start = recs.pos[keep]
    cb = recs.cb_id[keep]
    umi = recs.umi_id[keep]
    ok = gene >= 0
    gene, end, start, cb, umi = gene[ok], end[ok], start[ok], cb[ok], umi[ok]

    if utr_bed:
        utr = {}
        with open(utr_bed) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 3:
                    utr.setdefault(parts[0], []).append(
                        (int(parts[1]), int(parts[2]))
                    )
        rid_kept = recs.ref_id[keep][ok]
        tp_all = np.where(
            np.asarray([model.strand[g] > 0 for g in gene]), end, start
        )
        in_utr = np.zeros(len(gene), bool)
        for chrom, ivs in utr.items():
            try:
                rid = recs.ref_names.index(chrom)
            except ValueError:
                continue
            m_c = rid_kept == rid
            if not m_c.any():
                continue
            # merge overlapping intervals first: the largest-start-<=pos
            # candidate alone misses positions inside an earlier
            # containing interval
            merged = []
            for s0, e0 in sorted(ivs):
                if merged and s0 <= merged[-1][1]:
                    merged[-1] = (merged[-1][0], max(merged[-1][1], e0))
                else:
                    merged.append((s0, e0))
            ivs_arr = np.asarray(merged)
            pos_c = tp_all[m_c]
            j = np.searchsorted(ivs_arr[:, 0], pos_c, side="right") - 1
            ok_iv = (j >= 0) & (pos_c <= ivs_arr[np.maximum(j, 0), 1])
            in_utr[np.nonzero(m_c)[0][ok_iv]] = True
        gene, end, start, cb, umi = (
            gene[in_utr], end[in_utr], start[in_utr], cb[in_utr], umi[in_utr]
        )
        log.info("utr filter: %d/%d molecules inside 3'UTRs",
                 int(in_utr.sum()), len(in_utr))

    # (cell, umi, gene) dedup keeps ONE 3' end per molecule
    tbl = np.stack([cb, umi, gene])
    _, first = np.unique(tbl, axis=1, return_index=True)
    gene, end, start, cb = gene[first], end[first], start[first], cb[first]

    n_cells = len(recs.barcodes)
    rows, cols = [], []
    site_names = []
    distal_index: dict = {}
    for g in np.unique(gene):
        m = gene == g
        # 3' end respects strand: + genes end at read end, - at read start
        three_prime = end[m] if model.strand[g] > 0 else start[m]
        peaks = call_pas_peaks(three_prime, peak_window=peak_window, min_reads=min_reads)
        if not peaks:
            continue
        if max_sites > 0 and len(peaks) > max_sites:
            # keep the highest-coverage peaks (apa_max_sites bound)
            def _cov(p):
                return int(((three_prime >= p[1]) & (three_prime <= p[2])).sum())

            peaks = sorted(peaks, key=_cov, reverse=True)[:max_sites]
        # order proximal -> distal along the gene's strand
        peaks.sort(key=lambda p: p[0] * int(model.strand[g]))
        base = len(site_names)
        for si, (center, lo, hi) in enumerate(peaks):
            site_names.append(f"{model.names[g]}/apa/pas{si}@{center}")
        # assign molecules to peaks
        assigned = np.full(m.sum(), -1)
        tp = three_prime
        for si, (center, lo, hi) in enumerate(peaks):
            assigned[(tp >= lo - peak_window) & (tp <= hi + peak_window)] = si
        used = assigned >= 0
        rows.extend((base + assigned[used]).tolist())
        cols.extend(cb[m][used].tolist())
        if len(peaks) > 1 and used.any():
            distal_index[model.names[g]] = float(
                np.mean(assigned[used] == len(peaks) - 1)
            )

    counts = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(len(site_names), n_cells),
    ).tocsc()
    log.info("apa: %d PAS sites across %d genes", len(site_names), len(np.unique(gene)))
    return ApaResult(
        counts=counts,
        site_names=site_names,
        barcodes=recs.barcodes,
        distal_index=distal_index,
    )


def compute_pdui(apa: "ApaResult") -> "tuple[list, list, np.ndarray]":
    """Per-(gene, cell) PDUI = distal / (proximal + distal) over the
    called PAS sites (CountApaArgs compute_pdui / apa_em_pdui role):
    the most distal site's molecules over the covered total. Returns
    (genes, cells, pdui) triplets for pairs with any APA coverage."""
    import re

    gene_of = [re.split(r"/apa/", s)[0] for s in apa.site_names]
    order_of = [int(re.search(r"pas(\d+)@", s).group(1)) for s in apa.site_names]
    csr = apa.counts.tocsr()
    genes_out, cells_out, vals_out = [], [], []
    import collections

    sites_by_gene = collections.defaultdict(list)
    for si, (g, o) in enumerate(zip(gene_of, order_of)):
        sites_by_gene[g].append((o, si))
    for g, site_list in sites_by_gene.items():
        if len(site_list) < 2:
            continue
        site_list.sort()
        idx = [si for _, si in site_list]
        block = np.asarray(csr[idx].todense())  # [S_g, n_cells]
        tot = block.sum(0)
        covered = np.nonzero(tot > 0)[0]
        if not len(covered):
            continue
        pdui = block[-1, covered] / tot[covered]
        genes_out.extend([g] * len(covered))
        cells_out.extend(apa.barcodes[j] for j in covered)
        vals_out.extend(pdui.tolist())
    return genes_out, cells_out, np.asarray(vals_out, np.float32)
