"""`faba metagene` — MetaPlotR-style tripartite metagene profiles
(`faba/src/site_analysis/metagene.rs` equivalent; the port's copy of the
JAX package's `faba/metagene.py`, numpy on the host).

Follows MetaPlotR (Olarerin-George & Jaffrey, Bioinformatics 2017), the
pipeline the published m6A metagenes were made with, so a difference
between our profile and theirs is a difference in the DATA:
  - sites are placed on SPLICED 5'UTR / CDS / 3'UTR coordinates of one
    transcript per gene (the longest spliced coding isoform; `--isoform
    all` counts a site once per isoform carrying it),
  - the rescaled axis keeps the CDS at width 1 ([1, 2)) and scales each
    UTR by its site-weighted median size relative to the CDS median
    (`metagene.rs ScaleFactors::rescale`),
  - bins split between the regions in proportion to the medians, each
    represented region floored at one bin,
  - non-coding genes profile on their own [0, 1] ncRNA track.
"""

from __future__ import annotations

import gzip
import logging
import re
from dataclasses import dataclass, field

import numpy as np

log = logging.getLogger(__name__)

FEATURE_LABELS = ["5UTR", "CDS", "3UTR", "ncRNA"]
UTR5, CDS, UTR3, NCRNA = 0, 1, 2, 3


@dataclass
class TranscriptModel:
    """Spliced region intervals of one coding transcript (sorted,
    genomic, half-open [start, end))."""

    gene: str
    tx_id: str
    chrom: str
    strand: int  # +1 / -1
    utr5: list = field(default_factory=list)
    cds: list = field(default_factory=list)
    utr3: list = field(default_factory=list)

    def region_size(self, region):
        ivs = (self.utr5, self.cds, self.utr3)[region]
        return int(sum(e - s for s, e in ivs))

    def spliced_len(self):
        return sum(self.region_size(r) for r in range(3))


@dataclass
class NonCodingBody:
    gene: str
    chrom: str
    strand: int
    exons: list  # [(start, end)) sorted


_ID_RE = re.compile(r"ID=([^;]+)")
_PARENT_RE = re.compile(r"Parent=([^;]+)")
_GTF_TX_RE = re.compile(r'transcript_id[= "]+([\w.\-]+)')
_GTF_GENE_RE = re.compile(r'(?:gene_name|gene_id)[= "]+([\w.\-]+)')

_TX_TYPES = {"mRNA", "transcript", "mrna"}
_CDS_TYPES = {"CDS", "cds"}
_UTR5_TYPES = {"five_prime_UTR", "5UTR", "five_prime_utr"}
_UTR3_TYPES = {"three_prime_UTR", "3UTR", "three_prime_utr"}


def parse_gff_transcripts(
    path: str, *, gene_type: str | None = None
) -> tuple[list, list]:
    """(coding TranscriptModels, NonCodingBodies) from GFF3/GTF.
    Explicit five/three_prime_UTR rows are used when present; otherwise
    UTRs derive from exons minus the CDS span (strand-aware). A
    transcript with exons but no CDS is a non-coding body."""
    opener = gzip.open if str(path).endswith(".gz") else open
    tx_meta: dict = {}  # tx -> (gene, chrom, strand)
    parts_of: dict = {}  # tx -> {"exon": [...], "cds": [...], ...}
    type_re = re.compile(
        r'(?:gene_biotype|gene_type|biotype)[= "]+([\w.\-]+)'
    )
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 9:
                continue
            ftype, attr = cols[2], cols[8]
            start, end = int(cols[3]) - 1, int(cols[4])
            strand = -1 if cols[6] == "-" else 1
            if ftype in _TX_TYPES:
                if gene_type is not None:
                    tm = type_re.search(attr)
                    if tm is None or tm.group(1) != gene_type:
                        continue
                m = _ID_RE.search(attr) or _GTF_TX_RE.search(attr)
                if not m:
                    continue
                tx = m.group(1)
                gm = (_PARENT_RE.search(attr) or _GTF_GENE_RE.search(attr))
                gene = gm.group(1) if gm else tx
                gene = gene.removeprefix("gene:")
                tx_meta[tx.removeprefix("transcript:")] = (
                    gene, cols[0], strand)
            elif ftype in _CDS_TYPES | _UTR5_TYPES | _UTR3_TYPES | {
                "exon"
            }:
                m = _PARENT_RE.search(attr) or _GTF_TX_RE.search(attr)
                if not m:
                    continue
                gm = _GTF_GENE_RE.search(attr)
                for tx in m.group(1).split(","):
                    tx = tx.removeprefix("transcript:")
                    d = parts_of.setdefault(tx, {})
                    key = (
                        "cds" if ftype in _CDS_TYPES
                        else "utr5" if ftype in _UTR5_TYPES
                        else "utr3" if ftype in _UTR3_TYPES
                        else "exon"
                    )
                    d.setdefault(key, []).append((start, end))
                    # fallback meta (GTF fixtures with no transcript row)
                    d.setdefault("_meta", (
                        gm.group(1) if gm else tx, cols[0], strand))

    models, ncrna = [], []
    for tx, parts in parts_of.items():
        gene, chrom, strand = tx_meta.get(tx) or parts["_meta"]
        exons = sorted(parts.get("exon", []))
        cds = sorted(parts.get("cds", []))
        if not cds:
            if exons:
                ncrna.append(NonCodingBody(
                    gene=gene, chrom=chrom, strand=strand, exons=exons))
            continue
        utr5 = sorted(parts.get("utr5", []))
        utr3 = sorted(parts.get("utr3", []))
        if not utr5 and not utr3 and exons:
            # derive UTRs: exon stretches outside the CDS genomic span
            cds_lo = min(s for s, _ in cds)
            cds_hi = max(e for _, e in cds)
            lo_side, hi_side = [], []
            for s, e in exons:
                if s < cds_lo:
                    lo_side.append((s, min(e, cds_lo)))
                if e > cds_hi:
                    hi_side.append((max(s, cds_hi), e))
            utr5, utr3 = (
                (lo_side, hi_side) if strand > 0 else (hi_side, lo_side)
            )
        models.append(TranscriptModel(
            gene=gene, tx_id=tx, chrom=chrom, strand=strand,
            utr5=utr5, cds=cds, utr3=utr3,
        ))
    return models, ncrna


def elect_longest_isoform(models: list) -> list:
    """One transcript per gene: the longest SPLICED coding isoform
    (MetaPlotR's procedure; `transcript.rs elect_longest_isoform`).
    Ties resolve to the lexicographically-first transcript id."""
    best: dict = {}
    for m in models:
        key = (m.chrom, m.gene)
        cur = best.get(key)
        if (cur is None
                or m.spliced_len() > cur.spliced_len()
                or (m.spliced_len() == cur.spliced_len()
                    and m.tx_id < cur.tx_id)):
            best[key] = m
    return list(best.values())


def _twice_median(values: np.ndarray) -> int:
    """Median doubled, in integer arithmetic (metagene.rs
    twice_median): keeps the bin allocation reproducible."""
    if len(values) == 0:
        return 0
    v = np.sort(np.asarray(values, np.int64))
    n = len(v)
    return int(2 * v[n // 2]) if n % 2 else int(v[n // 2] + v[n // 2 - 1])


def _allocate_bins(n: int, m: list) -> list:
    """Split n bins ∝ the three medians, largest remainder first,
    each represented region floored at one bin (metagene.rs
    allocate_bins)."""
    total = sum(m)
    if total <= 0 or n == 0:
        return [0, n, 0]
    exact = [mi * n for mi in m]
    out = [e // total for e in exact]
    rem = sorted(
        range(3), key=lambda r: (-(exact[r] % total), -m[r], r)
    )
    for r in rem[: n - sum(out)]:
        out[r] += 1
    # floor represented regions at one bin, taken from the widest
    for r in range(3):
        if m[r] > 0 and out[r] == 0:
            donor = int(np.argmax(out))
            out[donor] -= 1
            out[r] += 1
    return out


def metagene_metaplotr(
    models: list,
    ncrna: list,
    site_chrom: np.ndarray,  # object array of chromosome names
    site_pos: np.ndarray,
    *,
    bins: int = 200,
    isoform: str = "longest",
    include_ncrna: bool = False,
) -> dict:
    """Place every site on the tripartite spliced transcript, rescale
    onto the MetaPlotR axis, and bin. Returns the per-region histogram
    rows plus the per-site distance table (`--distances`)."""
    if isoform == "longest":
        models = elect_longest_isoform(models)
    # interval index: (chrom) -> list of (start, end, region, model_i,
    # cum_before, total_len, strand)
    index: dict = {}
    for mi, m in enumerate(models):
        for region, ivs in ((UTR5, m.utr5), (CDS, m.cds), (UTR3, m.utr3)):
            total = m.region_size(region)
            cum = 0
            for s, e in ivs:
                index.setdefault(m.chrom, []).append(
                    (s, e, region, mi, cum, total, m.strand))
                cum += e - s
    if include_ncrna:
        for body in ncrna:
            total = sum(e - s for s, e in body.exons)
            cum = 0
            for s, e in sorted(body.exons):
                index.setdefault(body.chrom, []).append(
                    (s, e, NCRNA, -1, cum, total, body.strand))
                cum += e - s

    # assignments: (site_i, region, model_i, rel, total_len)
    assignments = []
    for i, (c, p) in enumerate(zip(site_chrom, site_pos)):
        for (s, e, region, mi, cum, total, strand) in index.get(
            str(c), ()
        ):
            if not (s <= p < e):
                continue
            rel = cum + (int(p) - s)
            if strand < 0:
                rel = total - 1 - rel
            assignments.append(
                (i, region, mi, int(np.clip(rel, 0, max(total - 1, 0))),
                 max(total, 1))
            )

    # site-weighted median region sizes (metagene.rs scale_factors)
    sizes = [[], [], []]
    for _, region, mi, _, _ in assignments:
        if mi >= 0:
            for r in range(3):
                sizes[r].append(models[mi].region_size(r))
    med2 = [_twice_median(np.asarray(s)) for s in sizes]
    have_coding = med2[CDS] > 0
    sf5 = med2[UTR5] / med2[CDS] if have_coding else 1.0
    sf3 = med2[UTR3] / med2[CDS] if have_coding else 1.0

    def rescale(region, within):
        if region == UTR5:
            return 1.0 - sf5 * (1.0 - within)
        if region == CDS:
            return 1.0 + within
        if region == UTR3:
            return 2.0 + sf3 * within
        return within  # ncRNA: its own [0, 1] axis

    region_bins = (
        _allocate_bins(bins, [m // 2 for m in med2]) if have_coding
        else [0, bins, 0]
    )
    hist = {r: np.zeros(max(region_bins[r], 1))
            for r in range(3)} | {NCRNA: np.zeros(bins)}
    dist_rows = []
    for site_i, region, mi, rel, total in assignments:
        within = (rel + 0.5) / total
        loc = rescale(region, within)
        nb = region_bins[region] if region != NCRNA else bins
        if nb > 0:
            hist[region][min(int(within * nb), nb - 1)] += 1
        if mi >= 0:
            m = models[mi]
            dist_rows.append({
                "site": site_i, "gene": m.gene, "tx_id": m.tx_id,
                "region": FEATURE_LABELS[region], "rel_pos": rel,
                "utr5_size": m.region_size(UTR5),
                "cds_size": m.region_size(CDS),
                "utr3_size": m.region_size(UTR3),
                "strand": "+" if m.strand > 0 else "-",
                "rescaled_location": loc,
            })
        else:
            dist_rows.append({
                "site": site_i, "gene": ".", "tx_id": ".",
                "region": "ncRNA", "rel_pos": rel,
                "utr5_size": 0, "cds_size": 0, "utr3_size": 0,
                "strand": ".", "rescaled_location": loc,
            })

    # per-region TSV rows on the rescaled axis
    rows = []
    for region in range(3):
        nb = region_bins[region]
        for b in range(nb):
            lo = rescale(region, b / nb)
            hi = rescale(region, (b + 1) / nb)
            rows.append({
                "feature": FEATURE_LABELS[region],
                "bin": b, "lo": lo, "hi": hi,
                "count": float(hist[region][b]),
            })
    if include_ncrna:
        for b in range(bins):
            rows.append({
                "feature": "ncRNA", "bin": b,
                "lo": b / bins, "hi": (b + 1) / bins,
                "count": float(hist[NCRNA][b]),
            })
    total_count = sum(r["count"] for r in rows) or 1.0
    for r in rows:
        r["frac"] = r["count"] / total_count
        r["density"] = r["count"] / max(r["hi"] - r["lo"], 1e-12) \
            / total_count
    n_placed = len({a[0] for a in assignments})
    return {
        "rows": rows, "distances": dist_rows,
        "median_sizes": [m / 2.0 for m in med2],
        "region_bins": region_bins,
        "n_assigned": len(assignments), "n_sites_placed": n_placed,
        "scale_factors": (sf5, sf3),
    }


def ascii_histogram(rows: list, *, max_width: int = 60) -> str:
    """Terminal histogram of the binned profile (`--print`)."""
    if not rows:
        return "(no assignments)"
    peak = max(r["count"] for r in rows) or 1.0
    out = []
    last_feature = None
    for r in rows:
        if r["feature"] != last_feature:
            out.append(f"# {r['feature']}")
            last_feature = r["feature"]
        n = int(r["count"] / peak * max_width)
        out.append(f"{r['lo']:7.3f} {'#' * n} {int(r['count'])}")
    return "\n".join(out)
