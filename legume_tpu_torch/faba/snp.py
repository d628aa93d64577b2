"""`faba snp` — cellSNP-lite-style pileup genotyper
(`faba/src/snp/` equivalent: `genotyper.rs` likelihood/MAP math,
`pipeline.rs` discovery + known-site force-calling + per-cell BAF,
`io.rs` parquet/VCF/mask writers).

Modes (matching `snp/pipeline.rs run_snp_pipeline`):
  - known_snps + skip_discovery: genotype at known VCF/parquet
    positions only
  - no known_snps: de novo discovery from the mismatch stream
  - both: discover + force-call, merged by locus (discovery wins ties)

Model (`genotyper.rs:52-105`, cellSNP-lite / Vartrix): for genotype G
in {0/0, 0/1, 1/1}, with n_ref/n_alt allele counts and error rate eps,
  log P(data|0/0) = n_alt ln(eps)   + n_ref ln(1-eps)
  log P(data|0/1) = (n_ref + n_alt) ln(1/2)
  log P(data|1/1) = n_ref ln(eps)   + n_alt ln(1-eps)
MAP with priors (het 1e-3, hom-alt 1e-4); GQ = -10 log10 P(error)
via log-sum-exp over the three posteriors (`genotyper.rs:110-140`).

With `use_base_quality` (the reference default; Li 2011 model,
`data/dna.rs DnaBaseQual`), per-base observations contribute
quality-resolved terms: ln(1-e_i) when the base matches the
hypothesis, ln(e_i/3) when it contradicts it, and
ln((1-e_i)/2 + e_i/6) under the het. DIVERGENCE: the columnar reader
streams per-base qualities only for MISMATCH bases (MD tag); ref-
matching bases enter with the constant `base_error_rate` — a hybrid
of the reference's two models. Terms shared by all three hypotheses
(non-ref non-alt bases) cancel in both the MAP and the GQ and are
omitted.

Further declared divergences (MIGRATION.md):
  - `--genome` is OPTIONAL here: the MD-tag mismatch stream carries
    the reference base, so discovery needs no FASTA; when given, it
    validates ref alleles and supplies VCF contig lengths.
  - MAPQ gates read-span coverage (the depth denominator) but not
    individual mismatch records (the native reader's mismatch stream
    carries base quality, not MAPQ) — same convention as dartseq/atoi.
  - UMI dedup is position-scoped (rid, pos, cell, UMI), not
    gene-fetch-scoped.

The port's copy of the JAX package's `faba/snp.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import gzip
import logging
import os
from dataclasses import dataclass, field

import numpy as np

from .bam import read_bam
from .dartseq import _dedup, coverage_at_sites, per_cell_coverage_at_sites

log = logging.getLogger(__name__)

GENOTYPES = ("0/0", "0/1", "1/1", "./.")
_BASES = np.frombuffer(b"ATGC", np.uint8)  # parquet column order (io.rs:157)
_HOM_REF, _HET, _HOM_ALT, _NO_CALL = 0, 1, 2, 3


@dataclass
class GenotypeParams:
    """`genotyper.rs:15-47` defaults, field for field."""

    min_depth: int = 5
    min_gq: float = 20.0
    het_prior: float = 0.001
    hom_alt_prior: float = 0.0001
    base_error_rate: float = 0.01
    min_coverage: int = 10
    min_alt_count: int = 3
    min_alt_freq: float = 0.1


@dataclass
class SnpSites:
    """Vectorized call set (one row per locus, sorted by chrom, pos)."""

    chrom: np.ndarray  # object (str)
    pos: np.ndarray  # int64 0-based
    ref_allele: np.ndarray  # uint8 ASCII
    alt_allele: np.ndarray  # uint8 ASCII
    rsid: np.ndarray  # object ("." = none)
    genotype: np.ndarray  # int8 index into GENOTYPES
    gq: np.ndarray  # float32
    base_counts: np.ndarray  # [S, 4] uint64 in A/T/G/C order
    # internal: BAM rid (for per-cell pass; -1 = contig absent)
    rid: np.ndarray = field(default=None)

    def __len__(self):
        return len(self.pos)

    def depth(self) -> np.ndarray:
        return self.base_counts.sum(axis=1)

    def counts_of(self, alleles: np.ndarray) -> np.ndarray:
        """Per-site count of the given allele byte (vectorized
        `SnpSite::{ref,alt}_count`)."""
        idx = np.full(len(alleles), -1)
        for j, b in enumerate(_BASES):
            idx[alleles == b] = j
        out = np.zeros(len(alleles), np.int64)
        ok = idx >= 0
        out[ok] = self.base_counts[np.nonzero(ok)[0], idx[ok]]
        return out


def genotype_log_likelihoods(
    n_ref: np.ndarray, n_alt: np.ndarray, error_rate: float
) -> np.ndarray:
    """[S, 3] log-likelihoods, constant-error model
    (`genotyper.rs compute_genotype_likelihoods`; binomial coefficient
    omitted — it cancels across genotypes)."""
    eps = float(np.clip(error_rate, 1e-10, 1 - 1e-10))
    n_ref = np.asarray(n_ref, np.float64)
    n_alt = np.asarray(n_alt, np.float64)
    depth = n_ref + n_alt
    ll = np.stack(
        [
            n_alt * np.log(eps) + n_ref * np.log1p(-eps),
            depth * np.log(0.5),
            n_ref * np.log(eps) + n_alt * np.log1p(-eps),
        ],
        axis=1,
    )
    ll[depth == 0] = 0.0
    return ll


def genotype_log_likelihoods_qual(
    n_ref: np.ndarray,
    sum_alt_log_correct: np.ndarray,
    sum_alt_log_error3: np.ndarray,
    sum_alt_log_het: np.ndarray,
    error_rate: float,
) -> np.ndarray:
    """[S, 3] hybrid Li-2011 likelihoods: alt observations carry
    per-base quality sums; ref-matching bases use the constant rate
    (see module docstring divergence note; `data/dna.rs DnaBaseQual`)."""
    e0 = float(np.clip(error_rate, 1e-10, 0.75))
    n_ref = np.asarray(n_ref, np.float64)
    ll_ref = n_ref * np.log1p(-e0) + sum_alt_log_error3
    ll_het = n_ref * np.log(0.5 * (1 - e0) + e0 / 6.0) + sum_alt_log_het
    ll_alt = n_ref * np.log(e0 / 3.0) + sum_alt_log_correct
    return np.stack([ll_ref, ll_het, ll_alt], axis=1)


def call_genotypes(
    ll: np.ndarray, params: GenotypeParams
) -> tuple[np.ndarray, np.ndarray]:
    """MAP genotype + Phred GQ from [S, 3] log-likelihoods
    (`genotyper.rs call_genotype`): posterior with (1-het-homalt,
    het, homalt) priors; GQ = -10 log10(1 - P(best))."""
    ref_prior = 1.0 - params.het_prior - params.hom_alt_prior
    lp = ll + np.log([ref_prior, params.het_prior, params.hom_alt_prior])
    gt = np.argmax(lp, axis=1).astype(np.int8)
    mx = lp.max(axis=1, keepdims=True)
    log_total = mx[:, 0] + np.log(np.exp(lp - mx).sum(axis=1))
    p_best = np.exp(lp[np.arange(len(gt)), gt] - log_total)
    gq = -10.0 * np.log10(np.maximum(1.0 - p_best, 1e-300))
    return gt, np.maximum(gq, 0.0).astype(np.float32)


# ---------------------------------------------------------------- #
# Known-SNP loading (`io.rs load_known_snps_auto`)                  #
# ---------------------------------------------------------------- #


def load_known_snps(path: str) -> "pd.DataFrame":
    """Biallelic SNPs from VCF(.gz) or a previous run's
    snp_sites.parquet. Columns: chrom, pos (0-based), ref, alt, rsid.
    Indels and multi-allelic records are skipped (`io.rs:49-107`)."""
    import pandas as pd

    p = str(path)
    if p.endswith(".parquet"):
        df = pd.read_parquet(p)
        chrom = df["chr" if "chr" in df.columns else "chrom"].astype(str)
        return pd.DataFrame(
            {
                "chrom": chrom,
                "pos": df["pos"].astype(np.int64),
                "ref": df["ref_allele" if "ref_allele" in df.columns else "ref"]
                .astype(str),
                "alt": df["alt_allele" if "alt_allele" in df.columns else "alt"]
                .astype(str),
                "rsid": df["rsid"].astype(str) if "rsid" in df.columns else ".",
            }
        )
    opener = gzip.open if p.endswith(".gz") else open
    rows = []
    with opener(p, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            chrom, pos1, rsid, ref, alt = parts[:5]
            if len(ref) != 1 or "," in alt or len(alt) != 1:
                continue  # biallelic SNPs only
            if ref.upper() not in "ACGT" or alt.upper() not in "ACGT":
                continue
            rows.append((chrom, int(pos1) - 1, ref.upper(), alt.upper(), rsid))
    df = pd.DataFrame(rows, columns=["chrom", "pos", "ref", "alt", "rsid"])
    df = df.drop_duplicates(subset=["chrom", "pos"], keep="first")
    log.info("loaded %d known biallelic SNPs from %s", len(df), p)
    return df


# ---------------------------------------------------------------- #
# Mismatch accumulation                                             #
# ---------------------------------------------------------------- #


def _merged_reads(
    bam_files: list[str],
    *,
    cb_tag: str,
    umi_tag: str,
) -> tuple[list, list[str]]:
    """Parse every BAM; assert one shared contig dictionary (merged
    pileup is only meaningful against one reference)."""
    all_recs = [
        read_bam(b, cb_tag=cb_tag, umi_tag=umi_tag) for b in bam_files
    ]
    names = all_recs[0].ref_names
    for b, r in zip(bam_files[1:], all_recs[1:]):
        if r.ref_names != names:
            raise ValueError(
                f"contig dictionary of {b} differs from {bam_files[0]}"
            )
    return all_recs, names


@dataclass
class _MismatchTable:
    """Deduped, quality-gated mismatch stream concatenated over BAMs."""

    rid: np.ndarray
    pos: np.ndarray
    ref_base: np.ndarray
    read_base: np.ndarray
    base_qual: np.ndarray
    # low-quality mismatch tallies per (rid, pos): subtracted from the
    # span-based depth so a baseq-failed base leaves the denominator
    # too (dna_stat_map.rs:272 parity, same fix as dartseq)
    lowq_rid: np.ndarray
    lowq_pos: np.ndarray


def _collect_mismatches(
    all_recs: list, *, min_base_quality: int, dedup: bool
) -> _MismatchTable:
    cat = lambda k: np.concatenate(  # noqa: E731
        [getattr(r, k) for r in all_recs if getattr(r, k) is not None]
        or [np.empty(0, np.int64)]
    )
    # offset cb/umi interning per file so dedup never merges molecules
    # across batches
    cbs, umis = [], []
    off_c = off_u = 1
    for r in all_recs:
        if r.mm_cb_id is None:
            continue
        c = r.mm_cb_id.copy()
        u = r.mm_umi_id.copy()
        c[c >= 0] += off_c
        u[u >= 0] += off_u
        off_c += len(r.barcodes) + 1
        off_u += int(u.max() + 2) if len(u) else 1
        cbs.append(c)
        umis.append(u)
    rid = cat("mm_ref_id")
    pos = cat("mm_pos")
    rb = cat("mm_ref_base")
    ab = cat("mm_read_base")
    bq = cat("mm_base_qual")
    cb = np.concatenate(cbs) if cbs else np.empty(0, np.int64)
    umi = np.concatenate(umis) if umis else np.empty(0, np.int64)
    if dedup and len(rid):
        first = _dedup([rid.astype(np.int64), pos.astype(np.int64), cb, umi])
        rid, pos, rb, ab, bq = (
            rid[first], pos[first], rb[first], ab[first], bq[first]
        )
    ok = (bq >= min_base_quality) | (bq == 0xFF)
    return _MismatchTable(
        rid=rid[ok], pos=pos[ok], ref_base=rb[ok], read_base=ab[ok],
        base_qual=bq[ok], lowq_rid=rid[~ok], lowq_pos=pos[~ok],
    )


def _counts_at(rid_q, pos_q, rid, pos, weights=None) -> np.ndarray:
    """Per-query tallies of (rid, pos) events, vectorized: events and
    queries share one (rid << 32 | pos) key space."""
    if not len(rid):
        return np.zeros(len(rid_q), np.float64 if weights is not None else np.int64)
    key_e = rid.astype(np.int64) * (1 << 40) + pos.astype(np.int64)
    key_q = rid_q.astype(np.int64) * (1 << 40) + pos_q.astype(np.int64)
    order = np.argsort(key_e, kind="stable")
    key_e = key_e[order]
    lo = np.searchsorted(key_e, key_q, side="left")
    hi = np.searchsorted(key_e, key_q, side="right")
    if weights is None:
        return (hi - lo).astype(np.int64)
    csum = np.concatenate([[0.0], np.cumsum(np.asarray(weights, np.float64)[order])])
    return csum[hi] - csum[lo]


# ---------------------------------------------------------------- #
# The pipeline                                                      #
# ---------------------------------------------------------------- #


def run_snp(
    bam_files: list[str],
    output: str,
    *,
    genome: str | None = None,
    known_snps: str | None = None,
    gff: str | None = None,
    params: GenotypeParams | None = None,
    cell_barcode_tag: str = "CB",
    umi_tag: str = "UB",
    no_umi_dedup: bool = False,
    use_base_quality: bool = True,
    min_base_quality: int = 20,
    min_mapping_quality: int = 20,
    bulk: bool = False,
    skip_discovery: bool = False,
    min_vaf: float | None = None,
    gene_type: str | None = None,
    backend: str = "zarr",
    zip_output: bool = False,
) -> SnpSites:
    """Full `faba snp` pipeline (`pipeline.rs run_snp_pipeline`).

    Writes under the `output` directory:
      - snp_sites.parquet (reference schema: chr, pos, ref_allele,
        alt_allele, rsid, genotype, gq, count_a/t/g/c)
      - snp_sites.vcf.gz (GT/GQ/AD/DP, one SAMPLE column)
      - snp_mask.parquet (chrom, pos) — the het/hom-alt mask the
        reference builds in-process for `faba all` (`io.rs
        build_snp_mask`), persisted so `--snp-mask` flags can consume it
      - {batch}_baf.zarr per input BAM (single-cell mode with --gff):
        rows `{chr}:{pos}/baf/{alt,depth}` — alt NESTS inside depth
        (feature_name.rs BAF note), never sum the channels.
    """
    import pandas as pd

    params = params or GenotypeParams()
    os.makedirs(output, exist_ok=True)
    all_recs, ref_names = _merged_reads(
        bam_files, cb_tag=cell_barcode_tag, umi_tag=umi_tag
    )
    mm = _collect_mismatches(
        all_recs, min_base_quality=min_base_quality, dedup=not no_umi_dedup
    )

    fasta = None
    if genome:
        from .context import read_fasta

        fasta = read_fasta(genome)

    gene_spans = None
    if gff:
        from .genes import parse_gff_genes

        model = parse_gff_genes(gff, gene_type=gene_type)
        gene_spans = {}
        for gi in range(len(model.start)):
            cname = model.chrom_names[int(model.chrom[gi])]
            gene_spans.setdefault(cname, []).append(
                (int(model.start[gi]), int(model.end[gi]))
            )
        for c in gene_spans:
            gene_spans[c] = np.array(sorted(gene_spans[c]), np.int64).reshape(-1, 2)

    sites: list[SnpSites] = []
    if not skip_discovery:
        sites.append(
            _discover(mm, all_recs, ref_names, params, fasta,
                      min_mapping_quality, use_base_quality, gene_spans)
        )
    if known_snps:
        known = load_known_snps(known_snps)
        sites.append(
            _force_call(known, mm, all_recs, ref_names, params,
                        min_mapping_quality, use_base_quality, gene_spans)
        )
    if not sites:
        raise ValueError("nothing to do: discovery skipped and no --known-snps")

    merged = _merge_sites(sites)
    n_called = int((merged.genotype != _NO_CALL).sum())
    log.info(
        "total %d sites: %d called (%d het, %d hom-alt), %d no-call",
        len(merged), n_called,
        int((merged.genotype == _HET).sum()),
        int((merged.genotype == _HOM_ALT).sum()),
        int((merged.genotype == _NO_CALL).sum()),
    )

    write_snp_sites_parquet(merged, os.path.join(output, "snp_sites.parquet"))
    contigs = _contig_lengths(genome, bam_files[0])
    write_snp_sites_vcf(
        merged, os.path.join(output, "snp_sites.vcf.gz"), contigs
    )
    mask = build_snp_mask(merged, params.min_gq, min_vaf)
    pd.DataFrame(
        {"chrom": [c for c, _ in mask], "pos": [p for _, p in mask]}
    ).to_parquet(os.path.join(output, "snp_mask.parquet"))
    log.info("SNP mask: %d variant positions", len(mask))

    if not bulk:
        if gff is None:
            log.info("skipping per-cell allele counts (no GFF provided)")
        else:
            suffix = ".h5" if backend == "hdf5" else (
                ".zarr.zip" if zip_output else ".zarr"
            )
            _write_baf_matrices(
                merged, bam_files, all_recs, output,
                min_base_quality=min_base_quality,
                min_mapping_quality=min_mapping_quality,
                dedup=not no_umi_dedup, suffix=suffix,
            )
    return merged


def _in_gene_spans(gene_spans, chroms, pos) -> np.ndarray:
    """Gene-centric site filter: the reference only piles up within
    gene boundaries when --gff is given (`pipeline.rs
    pileup_known_snps_by_gene`). Spans are start-sorted; overlap is
    tested against the running max of span ends so overlapping genes
    behave like their union."""
    keep = np.zeros(len(pos), bool)
    for c in np.unique(chroms):
        spans = gene_spans.get(str(c))
        sel = chroms == c
        if spans is None or not len(spans):
            continue
        p = pos[sel]
        idx = np.searchsorted(spans[:, 0], p, side="right") - 1
        run_end = np.maximum.accumulate(spans[:, 1])
        ok = idx >= 0
        ok[ok] &= p[ok] < run_end[idx[ok]]
        keep[np.nonzero(sel)[0]] = ok
    return keep


def _qual_sums(mm, site_rid, site_pos, alt_bytes):
    """Per-site Li-2011 quality sums over alt-supporting mismatches."""
    bq = np.where(mm.base_qual == 0xFF, 30, mm.base_qual).astype(np.float64)
    e = np.clip(10.0 ** (-bq / 10.0), 1e-10, 0.75)
    is_alt = np.zeros(len(mm.rid), bool)
    # match each mismatch to its site's alt byte
    key_site = site_rid.astype(np.int64) * (1 << 40) + site_pos.astype(np.int64)
    order = np.argsort(key_site, kind="stable")
    key_mm = mm.rid.astype(np.int64) * (1 << 40) + mm.pos.astype(np.int64)
    loc = np.searchsorted(key_site[order], key_mm)
    loc = np.clip(loc, 0, len(order) - 1)
    hit = key_site[order][loc] == key_mm
    site_of_mm = np.where(hit, order[loc], -1)
    is_alt = hit & (mm.read_base == alt_bytes[np.maximum(site_of_mm, 0)])
    sums = np.zeros((len(site_rid), 3))
    for j, w in enumerate(
        [np.log1p(-e), np.log(e / 3.0), np.log(0.5 * (1 - e) + e / 6.0)]
    ):
        np.add.at(sums[:, j], site_of_mm[is_alt], w[is_alt])
    return sums  # columns: log_correct, log_error3, log_het


def _base_count_matrix(mm, site_rid, site_pos, depth, ref_bytes) -> np.ndarray:
    """[S, 4] A/T/G/C counts: mismatch bases tallied per site; the ref
    base receives depth minus all mismatch observations."""
    counts = np.zeros((len(site_rid), 4), np.int64)
    for j, b in enumerate(_BASES):
        sel = mm.read_base == b
        counts[:, j] = _counts_at(
            site_rid, site_pos, mm.rid[sel], mm.pos[sel]
        )
    total_mm = counts.sum(axis=1)
    ref_extra = np.maximum(np.asarray(depth, np.int64) - total_mm, 0)
    for j, b in enumerate(_BASES):
        sel = ref_bytes == b
        counts[sel, j] += ref_extra[sel]
    return counts


def _site_depth(all_recs, site_rid, site_pos, mm, min_mapping_quality):
    """Span coverage minus the baseq-failed bases at each site."""
    depth = np.zeros(len(site_rid), np.int64)
    for r in all_recs:
        depth += coverage_at_sites(
            r, site_rid, site_pos, min_mapq=min_mapping_quality
        ).astype(np.int64)
    depth -= _counts_at(site_rid, site_pos, mm.lowq_rid, mm.lowq_pos)
    return np.maximum(depth, 0)


def _genotype(
    site_rid, site_pos, ref_bytes, alt_bytes, depth, mm,
    params, use_base_quality, *, force_call: bool
):
    """Shared GL + MAP block for discovery and known-site modes."""
    # per-site alt count: tally only mismatches whose base equals the
    # site's alt allele
    n_alt = np.zeros(len(site_rid), np.int64)
    for b in np.unique(alt_bytes):
        sel_site = alt_bytes == b
        sel_mm = mm.read_base == b
        n_alt[sel_site] = _counts_at(
            site_rid[sel_site], site_pos[sel_site],
            mm.rid[sel_mm], mm.pos[sel_mm],
        )
    n_ref = np.maximum(depth - _counts_at(site_rid, site_pos, mm.rid, mm.pos), 0)
    if use_base_quality:
        sums = _qual_sums(mm, site_rid, site_pos, alt_bytes)
        ll = genotype_log_likelihoods_qual(
            n_ref, sums[:, 0], sums[:, 1], sums[:, 2], params.base_error_rate
        )
    else:
        ll = genotype_log_likelihoods(n_ref, n_alt, params.base_error_rate)
    gt, gq = call_genotypes(ll, params)
    nocall = depth < params.min_depth
    nocall |= gq < params.min_gq
    gt = np.where(nocall, _NO_CALL, gt).astype(np.int8)
    gq = np.where(depth < params.min_depth, 0.0, gq).astype(np.float32)
    return gt, gq, n_alt


def _discover(
    mm, all_recs, ref_names, params, fasta,
    min_mapping_quality, use_base_quality, gene_spans,
) -> SnpSites:
    """De novo discovery from the mismatch stream
    (`pipeline.rs discover_snps_by_region/_by_gene`): candidate = any
    locus with mismatch evidence passing the coverage/count/frequency
    gates; the alt allele is the most frequent non-ref base."""
    if not len(mm.rid):
        return _empty_sites()
    # per (rid, pos, base) tallies
    sorted_bases = np.sort(_BASES)
    base_idx_of = np.zeros(256, np.int64)
    for j, b in enumerate(sorted_bases):
        base_idx_of[b] = j
    key = (
        mm.rid.astype(np.int64) * (1 << 42)
        + mm.pos.astype(np.int64) * 4
        + base_idx_of[mm.read_base]
    )
    uk, inv = np.unique(key, return_inverse=True)
    cnt = np.bincount(inv, minlength=len(uk))
    u_rid = (uk >> 42).astype(np.int32)
    u_posb = uk & ((1 << 42) - 1)
    u_pos = (u_posb >> 2).astype(np.int64)
    u_base = sorted_bases[(u_posb & 3).astype(np.int64)]

    site_key, site_inv = np.unique(uk >> 2, return_inverse=True)
    n_sites = len(site_key)
    site_rid = (site_key >> 40).astype(np.int32)
    site_pos = (site_key & ((1 << 40) - 1)).astype(np.int64)
    # ref base per site (MD tag; consistent across records)
    first_at = np.unique(
        mm.rid.astype(np.int64) * (1 << 40) + mm.pos.astype(np.int64),
        return_index=True,
    )[1]
    ref_bytes = mm.ref_base[first_at]
    if fasta is not None:
        for s in range(n_sites):
            seq = fasta.get(ref_names[int(site_rid[s])])
            if seq is not None and 0 <= site_pos[s] < len(seq):
                ref_bytes[s] = ord(seq[int(site_pos[s])].upper())
    # top non-ref base per site
    alt_bytes = np.zeros(n_sites, np.uint8)
    alt_count = np.zeros(n_sites, np.int64)
    is_ref = u_base == ref_bytes[site_inv]
    for k in np.argsort(cnt, kind="stable"):  # ascending: last write wins
        if is_ref[k]:
            continue
        s = site_inv[k]
        alt_bytes[s] = u_base[k]
        alt_count[s] = cnt[k]

    depth = _site_depth(all_recs, site_rid, site_pos, mm, min_mapping_quality)
    keep = (
        (depth >= params.min_coverage)
        & (alt_count >= params.min_alt_count)
        & (alt_bytes > 0)
        & (alt_count.astype(np.float64) >= params.min_alt_freq * depth)
        & (depth > 0)
    )
    if gene_spans is not None:
        chroms = np.array([ref_names[int(r)] for r in site_rid], object)
        keep &= _in_gene_spans(gene_spans, chroms, site_pos)
    site_rid, site_pos = site_rid[keep], site_pos[keep]
    ref_bytes, alt_bytes, depth = ref_bytes[keep], alt_bytes[keep], depth[keep]
    gt, gq, n_alt = _genotype(
        site_rid, site_pos, ref_bytes, alt_bytes, depth, mm,
        params, use_base_quality, force_call=False,
    )
    counts = _base_count_matrix(mm, site_rid, site_pos, depth, ref_bytes)
    return SnpSites(
        chrom=np.array([ref_names[int(r)] for r in site_rid], object),
        pos=site_pos.astype(np.int64),
        ref_allele=ref_bytes,
        alt_allele=alt_bytes,
        rsid=np.array(["."] * len(site_pos), object),
        genotype=gt,
        gq=gq,
        base_counts=counts.astype(np.uint64),
        rid=site_rid,
    )


def _force_call(
    known, mm, all_recs, ref_names, params,
    min_mapping_quality, use_base_quality, gene_spans,
) -> SnpSites:
    """Genotype at known positions regardless of alt evidence
    (`pipeline.rs pileup_known_snps_by_*`). Sites on contigs absent
    from the BAM header get depth 0 -> no-call."""
    chroms = known["chrom"].to_numpy(object)
    pos = known["pos"].to_numpy(np.int64)
    ref_bytes = np.frombuffer(
        "".join(known["ref"]).encode(), np.uint8
    ) if len(known) else np.empty(0, np.uint8)
    alt_bytes = np.frombuffer(
        "".join(known["alt"]).encode(), np.uint8
    ) if len(known) else np.empty(0, np.uint8)
    rsid = known["rsid"].to_numpy(object)
    name_to_rid = {n: i for i, n in enumerate(ref_names)}
    rid = np.array([name_to_rid.get(str(c), -1) for c in chroms], np.int32)
    if gene_spans is not None and len(pos):
        keep = _in_gene_spans(gene_spans, chroms, pos)
        chroms, pos, ref_bytes, alt_bytes, rsid, rid = (
            chroms[keep], pos[keep], ref_bytes[keep],
            alt_bytes[keep], rsid[keep], rid[keep],
        )
    present = rid >= 0
    depth = np.zeros(len(pos), np.int64)
    if present.any():
        depth[present] = _site_depth(
            all_recs, rid[present], pos[present], mm, min_mapping_quality
        )
    gt = np.full(len(pos), _NO_CALL, np.int8)
    gq = np.zeros(len(pos), np.float32)
    counts = np.zeros((len(pos), 4), np.int64)
    if present.any():
        gt_p, gq_p, _ = _genotype(
            rid[present], pos[present], ref_bytes[present],
            alt_bytes[present], depth[present], mm,
            params, use_base_quality, force_call=True,
        )
        gt[present] = gt_p
        gq[present] = gq_p
        counts[present] = _base_count_matrix(
            mm, rid[present], pos[present], depth[present], ref_bytes[present]
        )
    return SnpSites(
        chrom=chroms, pos=pos, ref_allele=ref_bytes, alt_allele=alt_bytes,
        rsid=rsid, genotype=gt, gq=gq,
        base_counts=counts.astype(np.uint64), rid=rid,
    )


def _empty_sites() -> SnpSites:
    z = np.empty(0)
    return SnpSites(
        chrom=np.empty(0, object), pos=np.empty(0, np.int64),
        ref_allele=np.empty(0, np.uint8), alt_allele=np.empty(0, np.uint8),
        rsid=np.empty(0, object), genotype=np.empty(0, np.int8),
        gq=np.empty(0, np.float32), base_counts=np.zeros((0, 4), np.uint64),
        rid=np.empty(0, np.int32),
    )


def _merge_sites(parts: list[SnpSites]) -> SnpSites:
    """Sort by (chrom, pos), dedup keeping the FIRST record at each
    locus — discovery entries precede known-site entries, matching the
    reference's stable sort + dedup_by (`pipeline.rs:720-724`)."""
    cat = lambda k: np.concatenate([getattr(p, k) for p in parts])  # noqa
    chrom = cat("chrom")
    pos = cat("pos")
    order = np.lexsort((np.arange(len(pos)), pos, chrom.astype(str)))
    chrom, pos = chrom[order], pos[order]
    keep = np.ones(len(pos), bool)
    keep[1:] = (chrom[1:] != chrom[:-1]) | (pos[1:] != pos[:-1])
    sel = order[keep]
    return SnpSites(
        chrom=chrom[keep], pos=pos[keep],
        ref_allele=cat("ref_allele")[sel], alt_allele=cat("alt_allele")[sel],
        rsid=cat("rsid")[sel], genotype=cat("genotype")[sel],
        gq=cat("gq")[sel], base_counts=cat("base_counts")[sel],
        rid=cat("rid")[sel],
    )


# ---------------------------------------------------------------- #
# Outputs (`io.rs`)                                                 #
# ---------------------------------------------------------------- #


def write_snp_sites_parquet(sites: SnpSites, path: str) -> None:
    """Reference schema (`io.rs write_snp_sites_parquet`)."""
    import pandas as pd

    pd.DataFrame(
        {
            "chr": sites.chrom.astype(str),
            "pos": sites.pos.astype(np.int64),
            "ref_allele": [chr(b) for b in sites.ref_allele],
            "alt_allele": [chr(b) for b in sites.alt_allele],
            "rsid": sites.rsid.astype(str),
            "genotype": [GENOTYPES[g] for g in sites.genotype],
            "gq": sites.gq.astype(np.float32),
            "count_a": sites.base_counts[:, 0],
            "count_t": sites.base_counts[:, 1],
            "count_g": sites.base_counts[:, 2],
            "count_c": sites.base_counts[:, 3],
        }
    ).to_parquet(path)


def write_snp_sites_vcf(
    sites: SnpSites, path: str, contigs: list[tuple[str, int]]
) -> None:
    """VCF 4.2 with GT/GQ/AD/DP (`io.rs write_snp_sites_vcf`).
    Plain gzip, not BGZF (readable by every standard tool)."""
    with gzip.open(path, "wt") as f:
        f.write("##fileformat=VCFv4.2\n")
        for name, length in contigs:
            if length > 0:
                f.write(f"##contig=<ID={name},length={length}>\n")
            else:
                f.write(f"##contig=<ID={name}>\n")
        f.write('##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n')
        f.write(
            '##FORMAT=<ID=GQ,Number=1,Type=Integer,'
            'Description="Genotype Quality (Phred)">\n'
        )
        f.write(
            '##FORMAT=<ID=AD,Number=R,Type=Integer,'
            'Description="Allelic depths (ref, alt)">\n'
        )
        f.write(
            '##FORMAT=<ID=DP,Number=1,Type=Integer,'
            'Description="Total read depth">\n'
        )
        f.write(
            "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\tSAMPLE\n"
        )
        ref_cnt = sites.counts_of(sites.ref_allele)
        alt_cnt = sites.counts_of(sites.alt_allele)
        depth = sites.depth()
        for i in range(len(sites)):
            gt = GENOTYPES[sites.genotype[i]]
            f.write(
                f"{sites.chrom[i]}\t{int(sites.pos[i]) + 1}\t{sites.rsid[i]}\t"
                f"{chr(sites.ref_allele[i])}\t{chr(sites.alt_allele[i])}\t.\t.\t.\t"
                f"GT:GQ:AD:DP\t{gt}:{int(sites.gq[i])}:"
                f"{int(ref_cnt[i])},{int(alt_cnt[i])}:{int(depth[i])}\n"
            )


def build_snp_mask(
    sites: SnpSites, min_gq: float, min_vaf: float | None
) -> list[tuple[str, int]]:
    """Het/hom-alt loci above the GQ threshold (`io.rs
    build_snp_mask`). With min_vaf, only germline-like allele
    fractions enter: het needs VAF in [v, 1-v], hom-alt VAF >= 1-v —
    keeps true RNA-editing sites (low/variable VAF) out of the mask."""
    depth = sites.depth().astype(np.float64)
    vaf = np.divide(
        sites.counts_of(sites.alt_allele), np.maximum(depth, 1),
        dtype=np.float64,
    )
    ok = (sites.gq >= min_gq) & (depth > 0)
    het = sites.genotype == _HET
    hom = sites.genotype == _HOM_ALT
    if min_vaf is not None:
        het &= (vaf >= min_vaf) & (vaf <= 1 - min_vaf)
        hom &= vaf >= 1 - min_vaf
    ok &= het | hom
    return [
        (str(sites.chrom[i]), int(sites.pos[i])) for i in np.nonzero(ok)[0]
    ]


def _contig_lengths(genome: str | None, bam: str) -> list[tuple[str, int]]:
    """Contigs for the VCF header: genome .fai when present, else the
    BAM header dictionary (the reference can only use .fai —
    `io.rs load_contigs_from_fai`)."""
    if genome and os.path.exists(genome + ".fai"):
        out = []
        with open(genome + ".fai") as f:
            for line in f:
                parts = line.split("\t")
                if len(parts) >= 2:
                    out.append((parts[0], int(parts[1])))
        return out
    from .bam import read_bam_contigs

    return read_bam_contigs(bam)


def _write_baf_matrices(
    sites: SnpSites, bam_files, all_recs, output, *,
    min_base_quality: int, min_mapping_quality: int, dedup: bool,
    suffix: str = ".zarr",
) -> None:
    """Pass 2 (`pipeline.rs gather_snp_allele_counts_by_gene`): per
    input BAM, one channelized matrix `{batch}_baf.zarr` with rows
    `{chr}:{pos}/baf/alt` and `{chr}:{pos}/baf/depth`."""
    import scipy.sparse as sp

    from ..data.sparse_io import create_sparse_from_csc

    called = sites.genotype != _NO_CALL
    called &= sites.rid >= 0
    s_rid = sites.rid[called].astype(np.int32)
    s_pos = sites.pos[called].astype(np.int64)
    s_alt = sites.alt_allele[called]
    loci = [
        f"{sites.chrom[i]}:{int(sites.pos[i])}"
        for i in np.nonzero(called)[0]
    ]
    if not len(s_pos):
        log.info("no called sites; skipping per-cell BAF matrices")
        return
    seen = set()
    for bam_path, recs in zip(bam_files, all_recs):
        batch = os.path.splitext(os.path.basename(bam_path))[0]
        if batch in seen:  # uniq_batch_names equivalent
            k = 2
            while f"{batch}_{k}" in seen:
                k += 1
            batch = f"{batch}_{k}"
        seen.add(batch)
        n_cells = len(recs.barcodes)
        if n_cells == 0:
            log.info("no cell barcodes in %s; skipping BAF matrix", bam_path)
            continue
        depth_mat = per_cell_coverage_at_sites(
            recs, s_rid, s_pos.astype(np.int32), n_cells,
            min_mapq=min_mapping_quality,
        ).tocsr()
        # per-cell alt counts from this file's own mismatch stream
        cb = recs.mm_cb_id
        if cb is not None and len(cb):
            first = (
                _dedup([
                    recs.mm_ref_id.astype(np.int64),
                    recs.mm_pos.astype(np.int64),
                    recs.mm_cb_id, recs.mm_umi_id,
                ]) if dedup else np.arange(len(cb))
            )
            ok = (
                (recs.mm_base_qual[first] >= min_base_quality)
                | (recs.mm_base_qual[first] == 0xFF)
            ) & (recs.mm_cb_id[first] >= 0)
            f_rid = recs.mm_ref_id[first][ok]
            f_pos = recs.mm_pos[first][ok]
            f_base = recs.mm_read_base[first][ok]
            f_cb = recs.mm_cb_id[first][ok]
        else:
            f_rid = f_pos = f_base = f_cb = np.empty(0, np.int64)
        key_site = s_rid.astype(np.int64) * (1 << 40) + s_pos
        order = np.argsort(key_site, kind="stable")
        key_mm = f_rid.astype(np.int64) * (1 << 40) + f_pos.astype(np.int64)
        loc = np.searchsorted(key_site[order], key_mm)
        loc = np.clip(loc, 0, max(len(order) - 1, 0))
        hit = (
            (key_site[order][loc] == key_mm)
            if len(order) else np.zeros(0, bool)
        )
        site_of = np.where(hit, order[np.minimum(loc, len(order) - 1)], -1)
        is_alt = hit & (f_base == s_alt[np.maximum(site_of, 0)])
        alt_mat = sp.coo_matrix(
            (
                np.ones(int(is_alt.sum()), np.float32),
                (site_of[is_alt], f_cb[is_alt]),
            ),
            shape=(len(s_pos), n_cells),
        ).tocsr()
        # interleave alt/depth rows per locus via one permutation
        # (alt ≤ depth nests; depth==0 cells are structurally zero in
        # both channels already)
        S = len(s_pos)
        perm = np.arange(2 * S).reshape(2, S).T.ravel()
        mat = sp.vstack([alt_mat, depth_mat]).tocsr()[perm].tocsc()
        names = [
            f"{locus}/baf/{channel}"
            for locus in loci
            for channel in ("alt", "depth")
        ]
        out = os.path.join(output, f"{batch}_baf{suffix}")
        create_sparse_from_csc(mat, out, names, list(recs.barcodes))
        log.info("wrote allele frequency matrix: %s", out)


# ---------------------------------------------------------------- #
# Back-compat shim (round-2 surface)                                #
# ---------------------------------------------------------------- #


def call_snps(
    bam_path: str,
    *,
    min_depth: int = 8,
    min_alt: int = 2,
    min_qual: float = 20.0,
):
    """Round-2 convenience API: discovery-only calls on one BAM,
    returned as a flat record (kept for tests and `faba all`)."""
    from dataclasses import dataclass as _dc

    recs = read_bam(bam_path)
    params = GenotypeParams(
        min_depth=min_depth, min_gq=min_qual,
        min_coverage=min_depth, min_alt_count=min_alt, min_alt_freq=0.0,
    )
    mm = _collect_mismatches([recs], min_base_quality=0, dedup=True)
    sites = _discover(
        mm, [recs], recs.ref_names, params, None, 20, False, None
    )
    keep = (sites.genotype != _NO_CALL) & (sites.genotype != _HOM_REF)

    @_dc
    class SnpCalls:
        ref_id: np.ndarray
        pos: np.ndarray
        ref_base: list
        alt_base: list
        depth: np.ndarray
        alt_depth: np.ndarray
        genotype: list
        qual: np.ndarray
        ref_names: list

    return SnpCalls(
        ref_id=sites.rid[keep],
        pos=sites.pos[keep],
        ref_base=[chr(b) for b in sites.ref_allele[keep]],
        alt_base=[chr(b) for b in sites.alt_allele[keep]],
        depth=sites.depth()[keep],
        alt_depth=sites.counts_of(sites.alt_allele)[keep],
        genotype=[GENOTYPES[g] for g in sites.genotype[keep]],
        qual=sites.gq[keep].astype(np.float64),
        ref_names=recs.ref_names,
    )
