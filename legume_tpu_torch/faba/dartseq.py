"""`faba dartseq` — m6A site discovery from DART-seq C->T conversions
(`faba/src/m6a/run.rs:608` pipeline; SURVEY.md section 3.5).

WT (APOBEC1-YTH) vs control (APOBEC1-only) contrast:
1. per-site alt and ref coverage from the native BAM mismatch stream
   ((cell, UMI) dedup, `DnaBaseFreqMap` parity). Both strand channels
   are extracted: C->T in reference space for plus-strand genes and
   its complement G->A for minus-strand genes (whose conversions
   appear complemented in reference coordinates); the two site tables
   merge before testing, with the observed channel recording strand;
2. site tests: single-sample beta-binomial in WT + one-sided Fisher
   against control (NOT BH — reads are shared across sites,
   SURVEY.md section 3.5 note);
3. per-cell quantification at called sites -> sparse backend with the
   faba `gene/modality` row-name convention.

The port's copy of the JAX package's `faba/dartseq.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .bam import read_bam
from .site_tests import contrast_sites

log = logging.getLogger(__name__)

C, T, G, A = (ord(x) for x in "CTGA")


@dataclass
class SiteTable:
    ref_id: np.ndarray
    pos: np.ndarray
    alt: np.ndarray  # converted reads (deduped)
    cov: np.ndarray  # total reads covering (deduped)


def _dedup(keys: list[np.ndarray]) -> np.ndarray:
    """Indices of unique rows across parallel key arrays."""
    stack = np.stack(keys)
    _, first = np.unique(stack, axis=1, return_index=True)
    return first


def _multi_arange(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Concatenated arange(lo[i], hi[i]) for all i, vectorized."""
    counts = (hi - lo).astype(np.int64)
    tot = int(counts.sum())
    if tot == 0:
        return np.empty(0, np.int64)
    offsets = np.cumsum(counts) - counts
    return np.arange(tot) - np.repeat(offsets, counts) + np.repeat(lo, counts)


def _site_coverage(
    r_rid: np.ndarray,
    r_pos: np.ndarray,
    r_end: np.ndarray,
    site_rid: np.ndarray,
    site_pos: np.ndarray,
) -> np.ndarray:
    """Interval-stabbing count per site: reads with start <= pos < end,
    per contig. cov(p) = #(start <= p) - #(end <= p) via two sorted
    searchsorted passes — O((R+S) log R), no per-site scan."""
    cov = np.zeros(len(site_pos), np.float64)
    if not len(r_rid) or not len(site_pos):
        return cov
    for rid in np.unique(site_rid):
        rsel = r_rid == rid
        if not rsel.any():
            continue
        starts = np.sort(r_pos[rsel])
        ends = np.sort(r_end[rsel])
        ssel = site_rid == rid
        p = site_pos[ssel]
        cov[ssel] = np.searchsorted(starts, p, side="right") - np.searchsorted(
            ends, p, side="right"
        )
    return cov


def conversion_counts(
    recs, *, ref_base: int = C, alt_base: int = T, min_mapq: int = 20,
    min_baseq: int = 0,
) -> tuple[SiteTable, dict]:
    """Per-site converted/coverage counts with (cell, UMI, site) dedup.
    `min_baseq` drops conversions whose read base is below the phred
    floor (sequencing errors mimic conversions; `dna_stat_map.rs:71`
    defaults this to 20)."""
    conv = (recs.mm_ref_base == ref_base) & (recs.mm_read_base == alt_base)
    lowq = np.zeros(len(conv), bool)
    if min_baseq > 0 and recs.mm_base_qual is not None and len(recs.mm_base_qual):
        lowq = conv & (recs.mm_base_qual < min_baseq)
    mm_keep = conv & ~lowq
    rid = recs.mm_ref_id[mm_keep]
    pos = recs.mm_pos[mm_keep]
    cb = recs.mm_cb_id[mm_keep]
    umi = recs.mm_umi_id[mm_keep]
    if len(rid):
        first = _dedup([rid, pos, cb, umi])
        rid, pos, cb, umi = rid[first], pos[first], cb[first], umi[first]

    # site registry from observed conversions
    site_keys, site_inv = np.unique(np.stack([rid, pos]), axis=1, return_inverse=True)
    n_sites = site_keys.shape[1]
    alt = np.bincount(site_inv, minlength=n_sites).astype(np.float64)

    # coverage: deduped reads overlapping each site
    keep = (recs.mapq >= min_mapq) & ((recs.flag & 0x904) == 0)
    r_rid = recs.ref_id[keep]
    r_pos = recs.pos[keep]
    r_end = recs.end_pos[keep]
    r_cb = recs.cb_id[keep]
    r_umi = recs.umi_id[keep]
    if len(r_rid):
        first = _dedup([r_rid, r_pos, r_cb, r_umi])
        r_rid, r_pos, r_end = r_rid[first], r_pos[first], r_end[first]
    cov = _site_coverage(r_rid, r_pos, r_end, site_keys[0], site_keys[1])

    # low-qual conversion bases are excluded from the coverage
    # denominator too, matching the reference's per-base phred gating
    # (`dna_stat_map.rs:272` skips the base entirely, so it neither
    # converts nor counts as unconverted coverage)
    if lowq.any() and n_sites:
        lq_rid = recs.mm_ref_id[lowq]
        lq_pos = recs.mm_pos[lowq]
        lq_cb = recs.mm_cb_id[lowq]
        lq_umi = recs.mm_umi_id[lowq]
        first = _dedup([lq_rid, lq_pos, lq_cb, lq_umi])
        lq_rid, lq_pos = lq_rid[first], lq_pos[first]
        lut = {
            (int(r), int(p)): i
            for i, (r, p) in enumerate(zip(site_keys[0], site_keys[1]))
        }
        lq_count = np.zeros(n_sites, np.float64)
        for r, p in zip(lq_rid, lq_pos):
            i = lut.get((int(r), int(p)))
            if i is not None:
                lq_count[i] += 1.0
        cov = np.maximum(cov - lq_count, alt)

    table = SiteTable(ref_id=site_keys[0], pos=site_keys[1], alt=alt, cov=cov)
    per_cell = {"rid": rid, "pos": pos, "cb": cb}
    return table, per_cell


def coverage_at_sites(
    recs, site_rid: np.ndarray, site_pos: np.ndarray, *, min_mapq: int = 20
) -> np.ndarray:
    """Deduped read coverage at arbitrary sites (control-side coverage
    must come from the reads, not from the control's own conversion
    table — a clean control has conversions nowhere)."""
    keep = (recs.mapq >= min_mapq) & ((recs.flag & 0x904) == 0)
    r_rid = recs.ref_id[keep]
    r_pos = recs.pos[keep]
    r_end = recs.end_pos[keep]
    r_cb = recs.cb_id[keep]
    r_umi = recs.umi_id[keep]
    if len(r_rid):
        first = _dedup([r_rid, r_pos, r_cb, r_umi])
        r_rid, r_pos, r_end = r_rid[first], r_pos[first], r_end[first]
    return _site_coverage(r_rid, r_pos, r_end, site_rid, site_pos)


def editing_activity_tallies(
    wt, ctrl, *, ref_base: int, alt_base: int,
    min_mapq: int = 20, min_baseq: int = 20,
) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Per-cell genome-wide editing activity for the null-cell scan
    (`--cell-scan`; editing/cell_activity.rs CellActivity): for each
    arm, (edited, covered) per cell aggregated over the UNION of both
    arms' candidate conversion positions, both strand channels —
    the shared candidate set keeps the two arms' rates comparable."""
    nw, nc = len(wt.barcodes), len(ctrl.barcodes)
    wt_e, wt_n = np.zeros(nw), np.zeros(nw)
    ct_e, ct_n = np.zeros(nc), np.zeros(nc)
    channels = [
        (ref_base, alt_base),
        (_COMPLEMENT[ref_base], _COMPLEMENT[alt_base]),
    ]
    for rb, ab in channels:
        tw, cw = conversion_counts(
            wt, ref_base=rb, alt_base=ab, min_mapq=min_mapq, min_baseq=min_baseq
        )
        tc, cc = conversion_counts(
            ctrl, ref_base=rb, alt_base=ab, min_mapq=min_mapq, min_baseq=min_baseq
        )
        rid = np.concatenate([tw.ref_id, tc.ref_id])
        pos = np.concatenate([tw.pos, tc.pos])
        if not len(rid):
            continue
        uniq = np.unique(np.stack([rid, pos]), axis=1)
        for recs, e_acc, n_acc, cells, n_cells in (
            (wt, wt_e, wt_n, cw, nw),
            (ctrl, ct_e, ct_n, cc, nc),
        ):
            cb = np.asarray(cells["cb"])
            ok = cb >= 0
            np.add.at(e_acc, cb[ok].astype(np.int64), 1.0)
            cov = per_cell_coverage_at_sites(
                recs, uniq[0], uniq[1], n_cells, min_mapq=min_mapq
            )
            n_acc += np.asarray(cov.sum(axis=0)).ravel()
    return wt_e, wt_n, ct_e, ct_n


def atoi_confounder_mask(
    site_rid: np.ndarray,
    site_pos: np.ndarray,
    site_strand: np.ndarray,
    ref_names: list[str],
    atoi_sites: "set[tuple[str, int]]",
) -> np.ndarray:
    """True where an m6A candidate is CLEAR of A-to-I editing
    (`--detect-atoi` / `--atoi-mask`, m6a/run.rs:321-360): a candidate
    is masked when any A-to-I site overlaps its RAC/GTY triplet —
    [pos-2, pos] on the forward strand (R A C, conversion at the C),
    [pos, pos+2] on the reverse (G T Y, conversion at the G)."""
    keep = np.ones(len(site_pos), bool)
    for s in range(len(site_pos)):
        chrom = ref_names[int(site_rid[s])]
        p = int(site_pos[s])
        span = range(p - 2, p + 1) if str(site_strand[s]) == "+" else range(p, p + 3)
        if any((chrom, q) in atoi_sites for q in span):
            keep[s] = False
    return keep


def filter_gene_tag(recs, model, *, include_missing: bool = False):
    """Read-level gene-consistency filter (`--gene-barcode-tag`;
    bam_io.rs record_matches_gene): a read contributes only where its
    aligner gene tag names a model gene whose interval covers the read
    — the reference iterates per gene and keeps a read under the gene
    its tag names, so at overlapping loci the tag may disagree with
    the single GFF-overlap winner and the read still passes (ADVICE
    r4). UNTAGGED reads pass only with `include_missing`
    (`--include-missing-barcode`); reads tagged with a value the model
    lacks are ambient under every model gene and always drop (the
    reference's per-gene equality can never match them). Applies to
    reads AND their extracted mismatches, so conversions, coverage,
    and activity tallies all see the filtered evidence."""
    import dataclasses

    if recs.gene_id is None:
        return recs
    gidx = {n: i for i, n in enumerate(model.names)}
    tag_to_model = np.asarray(
        [gidx.get(nm, -1) for nm in (recs.gene_names or [])], np.int64
    )
    # read ref ids -> model chromosome ids (absent contigs -> -1)
    cidx = {n: i for i, n in enumerate(model.chrom_names)}
    ref_to_chrom = np.asarray(
        [cidx.get(n, -1) for n in recs.ref_names], np.int64
    )

    def _mask(gene_tag_ids, rid, pos, end):
        tagged = gene_tag_ids >= 0
        tag_model = np.where(
            tagged,
            tag_to_model[np.maximum(gene_tag_ids, 0)]
            if len(tag_to_model) else -1,
            -1,
        )
        known = tag_model >= 0
        tm = np.maximum(tag_model, 0)
        # the read overlaps the interval of the gene its tag names
        agree = (
            known
            & (model.chrom[tm] == ref_to_chrom[rid])
            & (pos < model.end[tm])
            & (end > model.start[tm])
        )
        # tagged-but-unknown values stay dropped (agree is False there);
        # only genuinely untagged reads ride include_missing
        return np.where(tagged, agree, bool(include_missing))

    read_keep = _mask(recs.gene_id, recs.ref_id, recs.pos, recs.end_pos)
    mm_keep = (
        _mask(recs.mm_gene_id, recs.mm_ref_id, recs.mm_pos, recs.mm_pos + 1)
        if recs.mm_gene_id is not None and len(recs.mm_gene_id)
        else np.zeros(0 if recs.mm_cb_id is None else len(recs.mm_cb_id), bool)
    )
    n_drop = int((~read_keep).sum())
    if n_drop:
        log.info(
            "gene-tag filter: %d/%d reads dropped (tag/locus disagreement "
            "or untagged)", n_drop, len(read_keep),
        )
    fields = {}
    for f in dataclasses.fields(recs):
        v = getattr(recs, f.name)
        if not isinstance(v, np.ndarray):
            fields[f.name] = v
        elif f.name.startswith("mm_"):
            fields[f.name] = v[mm_keep] if len(v) == len(mm_keep) else v
        else:
            fields[f.name] = v[read_keep] if len(v) == len(read_keep) else v
    return type(recs)(**fields)


def filter_cells(recs, valid: "set[str]"):
    """Restrict a BamRecords to reads/mismatches from the given cell
    barcodes (`--valid-cells`, m6a/run.rs): everything outside the
    called-cell set is ambient and must not enter site tests or
    quantification."""
    import dataclasses

    keep_id = np.asarray([b in valid for b in recs.barcodes], bool)
    if keep_id.size == 0:
        read_keep = np.zeros(len(recs.cb_id), bool)
        mm_keep = np.zeros(len(recs.mm_cb_id), bool)
    else:
        read_keep = (recs.cb_id >= 0) & keep_id[np.maximum(recs.cb_id, 0)]
        mm_keep = (recs.mm_cb_id >= 0) & keep_id[np.maximum(recs.mm_cb_id, 0)]
    fields = {}
    for f in dataclasses.fields(recs):
        v = getattr(recs, f.name)
        if not isinstance(v, np.ndarray):
            fields[f.name] = v
        elif f.name.startswith("mm_"):
            fields[f.name] = v[mm_keep]
        else:
            fields[f.name] = v[read_keep]
    return type(recs)(**fields)


def m6a_motif_mask(
    seqs: dict[str, str],
    ref_names: list[str],
    site_rid: np.ndarray,
    site_pos: np.ndarray,
    site_strand: np.ndarray,
    *,
    check_r_site: bool = True,
) -> np.ndarray:
    """DART m6A motif rule (`editing/sifter.rs:51-83`): the conversion C
    sits in RAC on the forward strand ([AG] A C), observed as GTY on the
    reverse (G T [CT]); `check_r_site=False` relaxes both to `.AC` /
    `GT.`. Positions off the contig or non-ACGT fail the match."""
    keep = np.zeros(len(site_pos), bool)
    for s in range(len(site_pos)):
        seq = seqs.get(ref_names[int(site_rid[s])])
        if seq is None:
            continue
        p = int(site_pos[s])
        at = lambda k: seq[p + k] if 0 <= p + k < len(seq) else "N"  # noqa: E731
        if str(site_strand[s]) == "+":
            keep[s] = (
                at(0) == "C"
                and at(-1) == "A"
                and (not check_r_site or at(-2) in "AG")
            )
        else:
            keep[s] = (
                at(0) == "G"
                and at(1) == "T"
                and (not check_r_site or at(2) in "CT")
            )
    return keep


def filter_sites(res: "DartseqResult", mask: np.ndarray) -> "DartseqResult":
    """Row-filter a result (site axis) — used by the motif gate."""
    idx = np.nonzero(mask)[0]
    return DartseqResult(
        sites=res.sites[idx],
        stats={k: v[idx] for k, v in res.stats.items()},
        cell_counts=res.cell_counts[idx],
        site_names=[res.site_names[i] for i in idx],
        barcodes=res.barcodes,
        strand=None if res.strand is None else res.strand[idx],
    )


def per_cell_coverage_at_sites(
    recs, site_rid: np.ndarray, site_pos: np.ndarray, n_cells: int,
    *, min_mapq: int = 20,
) -> sp.csc_matrix:
    """Deduped per-(site, cell) read coverage [S, cells] — the binomial
    denominator n for the mixture's Beta-posterior observation weights
    (`editing/pipeline.rs` ConversionData converted+unconverted)."""
    keep = (recs.mapq >= min_mapq) & ((recs.flag & 0x904) == 0)
    r_rid = recs.ref_id[keep]
    r_pos = recs.pos[keep]
    r_end = recs.end_pos[keep]
    r_cb = recs.cb_id[keep]
    r_umi = recs.umi_id[keep]
    if len(r_rid):
        first = _dedup([r_rid, r_pos, r_cb, r_umi])
        r_rid, r_pos, r_end, r_cb = (
            r_rid[first], r_pos[first], r_end[first], r_cb[first]
        )
    # vectorized interval join: sites sorted per contig; each read's
    # covered sites form a contiguous [lo, hi) range in that order, so
    # (site, cell) pairs come from one searchsorted pair + multi-arange
    # (no per-site scan). Duplicate pairs are summed by coo_matrix.
    has_cb = r_cb >= 0
    r_rid, r_pos, r_end, r_cb = (
        r_rid[has_cb], r_pos[has_cb], r_end[has_cb], r_cb[has_cb]
    )
    rows_parts: list[np.ndarray] = []
    cols_parts: list[np.ndarray] = []
    if len(r_rid) and len(site_pos):
        for rid in np.unique(site_rid):
            ssel = np.nonzero(site_rid == rid)[0]
            order = np.argsort(site_pos[ssel], kind="stable")
            s_idx = ssel[order]
            s_pos = site_pos[s_idx]
            rsel = r_rid == rid
            if not rsel.any():
                continue
            starts, ends, cbs = r_pos[rsel], r_end[rsel], r_cb[rsel]
            lo = np.searchsorted(s_pos, starts, side="left")
            hi = np.searchsorted(s_pos, ends, side="left")
            hi = np.maximum(hi, lo)
            rows_parts.append(s_idx[_multi_arange(lo, hi)])
            cols_parts.append(np.repeat(cbs, hi - lo))
    rows = np.concatenate(rows_parts) if rows_parts else np.empty(0, np.int64)
    cols = np.concatenate(cols_parts) if cols_parts else np.empty(0, np.int64)
    return sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(len(site_pos), n_cells),
    ).tocsc()


@dataclass
class DartseqResult:
    sites: "np.ndarray"  # [S, 2] (ref_id, pos) of called sites
    stats: dict
    cell_counts: sp.csc_matrix  # [S, n_cells] per-cell conversions at called sites
    site_names: list
    barcodes: list
    strand: "np.ndarray | None" = None  # '+'/'-' per called site


_COMPLEMENT = {C: G, G: C, A: T, T: A}


def run_dartseq(
    wt_bam: str,
    control_bam: str,
    *,
    eps: float = 0.01,  # base error rate (DartSeqCountArgs error_rate)
    rho: float = 0.05,  # beta-binomial overdispersion
    max_p: float = 0.05,
    min_alt: int = 3,
    min_coverage: int = 0,  # WT coverage floor per site
    min_mapq: int = 20,
    min_baseq: int = 20,  # phred floor at the conversion base
    valid_cells: "set[str] | None" = None,  # called-cell allow-list
    wt_cells: "set[str] | None" = None,  # WT-ONLY gate (the --cell-scan
    # competent set: control barcodes are a different library, so the
    # scan's selection must not empty the control arm)
    snp_mask: "set[tuple[str, int]] | None" = None,  # (chrom, pos) to skip
    ref_base: int = C,
    alt_base: int = T,
    modality: str = "m6a",
    cb_tag: str = "CB",  # DartSeqCountArgs cell_barcode_tag
    umi_tag: str = "UB",
    # read-level gene-consistency filter (DartSeqCountArgs
    # gene_barcode_tag / include_missing_barcode; needs `gff`)
    gene_barcode_tag: "str | None" = None,
    include_missing_barcode: bool = False,
    gff: "str | None" = None,
) -> DartseqResult:
    """C->T by default (dartseq m6A); `faba atoi` calls this with
    A->G (`ref_base=A, alt_base=G, modality="atoi"`) — the editing
    machinery (`faba/src/editing/`) shares the same contrast.

    Minus-strand genes produce the complementary channel in reference
    space (G->A for dartseq, T->C for atoi); both channels are scanned
    and the merged table is tested site-by-site, so minus-strand sites
    are called rather than silently discarded."""
    wt = read_bam(wt_bam, cb_tag=cb_tag, umi_tag=umi_tag,
                  gene_tag=gene_barcode_tag)
    ctrl = read_bam(control_bam, cb_tag=cb_tag, umi_tag=umi_tag,
                    gene_tag=gene_barcode_tag)
    if gene_barcode_tag:
        if not gff:
            raise ValueError("gene_barcode_tag filtering needs the GFF")
        from .genes import parse_gff_genes

        model = parse_gff_genes(gff)
        wt = filter_gene_tag(wt, model, include_missing=include_missing_barcode)
        ctrl = filter_gene_tag(
            ctrl, model, include_missing=include_missing_barcode
        )
    if valid_cells is not None:
        wt = filter_cells(wt, valid_cells)
        ctrl = filter_cells(ctrl, valid_cells)
    if wt_cells is not None:
        wt = filter_cells(wt, wt_cells)
    # plus-strand channel as given; minus-strand conversions appear
    # complemented in reference space
    channels = [
        (ref_base, alt_base, "+"),
        (_COMPLEMENT[ref_base], _COMPLEMENT[alt_base], "-"),
    ]
    tabs, cells_per_ch, strands = [], [], []
    ct_alt_parts = []
    for rb, ab, strand in channels:
        tab, cells = conversion_counts(
            wt, ref_base=rb, alt_base=ab, min_mapq=min_mapq, min_baseq=min_baseq
        )
        ct_tab, _ = conversion_counts(
            ctrl, ref_base=rb, alt_base=ab, min_mapq=min_mapq, min_baseq=min_baseq
        )
        # align control conversions onto this channel's WT sites
        ct_map = {
            (int(r), int(p)): i
            for i, (r, p) in enumerate(zip(ct_tab.ref_id, ct_tab.pos))
        }
        alt_c = np.zeros(len(tab.pos))
        for i, (r, p) in enumerate(zip(tab.ref_id, tab.pos)):
            j = ct_map.get((int(r), int(p)))
            if j is not None:
                alt_c[i] = ct_tab.alt[j]
        tabs.append(tab)
        cells_per_ch.append(cells)
        strands.append(np.full(len(tab.pos), strand, dtype="U1"))
        ct_alt_parts.append(alt_c)

    wt_tab = SiteTable(
        ref_id=np.concatenate([t.ref_id for t in tabs]),
        pos=np.concatenate([t.pos for t in tabs]),
        alt=np.concatenate([t.alt for t in tabs]),
        cov=np.concatenate([t.cov for t in tabs]),
    )
    strand_arr = np.concatenate(strands)
    alt_c = np.concatenate(ct_alt_parts)
    # control-side coverage comes from the control READS (sites clean
    # in control still have coverage there) — channel-agnostic
    cov_c = coverage_at_sites(ctrl, wt_tab.ref_id, wt_tab.pos)

    stats = contrast_sites(
        wt_tab.alt, np.maximum(wt_tab.cov - wt_tab.alt, 0),
        alt_c, np.maximum(cov_c - alt_c, 0), eps=eps, rho=rho,
    )
    called = (
        (stats["pvalue_betabinom"] < max_p)
        & (stats["pvalue_fisher"] < max_p)
        & (wt_tab.alt >= min_alt)
        & (wt_tab.cov >= min_coverage)
    )
    if snp_mask:
        # known-SNP exclusion (DartSeqCountArgs snp_mask_file): a
        # genomic variant mimics a conversion at its own position
        masked = np.asarray(
            [
                (wt.ref_names[int(r)], int(p)) in snp_mask
                for r, p in zip(wt_tab.ref_id, wt_tab.pos)
            ],
            dtype=bool,
        )
        called &= ~masked
        log.info("snp mask: %d candidate sites excluded", int(masked.sum()))
    log.info("dartseq: %d candidate sites -> %d called", len(called), called.sum())

    # per-cell quantification at called sites (strand in the key: the
    # two channels of one genomic position are distinct sites)
    called_idx = np.nonzero(called)[0]
    site_lut = {
        (int(wt_tab.ref_id[s]), int(wt_tab.pos[s]), str(strand_arr[s])): i
        for i, s in enumerate(called_idx)
    }
    rows, cols = [], []
    for (rb, ab, strand), cells in zip(channels, cells_per_ch):
        for r, p, cb in zip(cells["rid"], cells["pos"], cells["cb"]):
            s = site_lut.get((int(r), int(p), strand))
            if s is not None and cb >= 0:
                rows.append(s)
                cols.append(cb)
    counts = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(len(called_idx), len(wt.barcodes)),
    ).tocsc()

    # gene/modality/channel convention (faba feature_name.rs): channel
    # is the OBSERVED reference-space pair, so "CT" marks plus strand
    # and "GA" marks minus strand for dartseq
    def _channel(s):
        rb, ab, _ = channels[0] if strand_arr[s] == "+" else channels[1]
        return chr(rb) + chr(ab)

    site_names = [
        f"{wt.ref_names[wt_tab.ref_id[s]]}:{wt_tab.pos[s]}/{modality}/{_channel(s)}"
        for s in called_idx
    ]
    return DartseqResult(
        sites=np.stack([wt_tab.ref_id[called_idx], wt_tab.pos[called_idx]], 1),
        stats={k: v[called_idx] for k, v in stats.items()},
        cell_counts=counts,
        site_names=site_names,
        barcodes=wt.barcodes,
        strand=strand_arr[called_idx],
    )


def run_atoi(wt_bam: str, control_bam: str, **kwargs) -> DartseqResult:
    """`faba atoi` — A-to-I (read as A->G) editing sites
    (`faba/src/editing/`, 6.8k LoC in the reference; shares the WT/
    control contrast machinery with dartseq)."""
    kwargs.setdefault("eps", 0.005)
    return run_dartseq(
        wt_bam, control_bam, ref_base=A, alt_base=G, modality="atoi", **kwargs
    )
