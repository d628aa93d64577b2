"""`faba apa --method mixture` — SCAPE-style poly(A)-site mixture model
(reference `faba/src/apa/{likelihood,em,fragment,site_discovery,
utr_region,cell_assign,pdui,pipeline}.rs`, ~3.4k LoC; the model follows
Zhou et al., "SCAPE", NAR 2022).

Per spliced 3'UTR:
1. extract fragments (x = spliced 5' offset, l = covered spliced
   length, r = poly(A) tail length, junction flag + cleavage point)
   with poly-A tail gating and optional internal-priming rejection;
2. candidate pA sites from junction pileups (coverage-KDE fallback),
   merged within `merge_distance`, masked against A-to-I/SNP tables;
3. SCAPE per-fragment theta likelihood (`likelihood.rs:80-160`:
   junction reads collapse the poly-A marginal, SE reads enumerate s),
   clustered on the sufficient statistic (x, l, r, junction)
   (`fragment.rs:17-33` — exact, multiplicities re-enter the EM);
4. BIC site selection: greedy coverage-ranked candidate addition,
   mixing-weight-only EM per K (reuses `mixture.fixed_em_weighted`),
   2-consecutive-worse early stop, post-EM close-site merge
   (`em.rs:197-330`);
5. hard-assign fragments to argmax-gamma components, dedup
   (batch, cell, UMI, component), emit per-cell counts + annotations
   (`cell_assign.rs:47-120`).

The default (no `--mixture`, no `--apa-em-pdui`) is the reference's
fast-PDUI path (`pipeline.rs:752-797`): recursive largest-gap bisection
of read positions, top-2 clusters, nearest-site hard assignment.

Numpy on host: each UTR's EM is a tiny irregular problem (M clusters x
T theta x K sites, all < a few hundred) — the wrong shape for a device;
the per-UTR loop is embarrassingly parallel and bounded by BAM decode.

The port's copy of the JAX package's `faba/apa_mixture.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field

import numpy as np
import scipy.sparse as sp

from .mixture import find_modes, fixed_em_weighted, gaussian_kernel_smooth

log = logging.getLogger(__name__)


# ---------------------------------------------------------------------------
# Likelihood / EM parameters (run.rs CountApaArgs defaults)
# ---------------------------------------------------------------------------


@dataclass
class ScapeParams:
    """`LikelihoodParams` + `EmParams` + pipeline gates, one bundle."""

    mu_f: float = 300.0
    sigma_f: float = 50.0
    theta_step: int = 10
    max_polya: float = 150.0
    min_polya: float = 20.0
    # EM (em.rs EmParams)
    max_iter: int = 40
    tol: float = 1e-4
    min_ws: float = 0.01
    skirt_eta: float = 0.05
    skirt_mult: float = 3.0
    merge_beta_mult: float = 2.0
    apa_max_sites: int = 20
    # site discovery + gates
    min_coverage: int = 10
    merge_distance: float = 50.0
    min_beta: float = 10.0
    max_beta: float = 70.0
    min_fragments: int = 50
    min_utr_length: int = 200
    # poly-A tail gating (PolyASiteArgs, data/poly_a_stat_map.rs:18)
    polya_min_tail_length: int = 10
    polya_max_non_at: int = 3
    internal_prime_window: int = 10
    internal_prime_count: int = 7
    min_mapq: int = 20
    # runner-up mass gate on the fast-PDUI path (pipeline.rs:678)
    min_runnerup_mass_frac: float = 0.02


# ---------------------------------------------------------------------------
# Spliced 3'UTR regions (utr_region.rs)
# ---------------------------------------------------------------------------


@dataclass
class UtrRegion:
    """Spliced 3'UTR: merged disjoint exons, transcript-oriented
    offsets (`utr_region.rs:16-38`). `exons` are 0-based half-open
    [(start, end)), genomic order; offsets are 1-based along the mature
    transcript (reverse-strand offsets count from the genomic right)."""

    chrom: str
    strand: int  # +1 / -1
    name: str
    exons: np.ndarray  # [E, 2] int64, 0-based half-open, sorted, disjoint

    @property
    def utr_length(self) -> int:
        return int((self.exons[:, 1] - self.exons[:, 0]).sum())

    @property
    def fetch_start(self) -> int:
        return int(self.exons[0, 0])

    @property
    def fetch_end(self) -> int:
        return int(self.exons[-1, 1])

    def off_left(self, gpos: np.ndarray) -> np.ndarray:
        """Exonic bases strictly left of each 0-based genomic position
        (positions assumed exonic); vectorized (`spliced_offset`
        utr_region.rs:100-113 modulo the strand mirror)."""
        starts = self.exons[:, 0]
        lens = self.exons[:, 1] - self.exons[:, 0]
        before = np.concatenate([[0], np.cumsum(lens)[:-1]])
        j = np.searchsorted(starts, gpos, side="right") - 1
        j = np.maximum(j, 0)
        return before[j] + (gpos - starts[j])

    def spliced_offset(self, gpos: np.ndarray) -> np.ndarray:
        """1-based transcript offset of 0-based genomic positions."""
        fwd = self.off_left(gpos)
        return fwd + 1 if self.strand > 0 else self.utr_length - fwd

    def genomic_from_spliced(self, offset: int) -> int:
        """Inverse map: 1-based transcript offset -> 0-based genomic
        (`utr_region.rs:117-136`)."""
        L = self.utr_length
        fwd = offset - 1 if self.strand > 0 else L - offset
        lens = self.exons[:, 1] - self.exons[:, 0]
        for (s, _e), ln in zip(self.exons, lens):
            if fwd < ln:
                return int(s + fwd)
            fwd -= int(ln)
        return int(self.exons[0, 0] if self.strand > 0 else self.exons[-1, 1] - 1)

    def alpha_to_genomic(self, alpha: float) -> int:
        """EM alpha (may drift past the ends) -> clamped 0-based genomic
        position (`utr_region.rs:230-244`)."""
        off = int(np.clip(int(alpha), 1, max(self.utr_length, 1)))
        return self.genomic_from_spliced(off)


def _merge_intervals(ivs: list[tuple[int, int]]) -> np.ndarray:
    merged: list[list[int]] = []
    for s, e in sorted(ivs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return np.asarray(merged, np.int64).reshape(-1, 2)


def build_utr_regions_from_gff(path: str) -> list[UtrRegion]:
    """3'UTR regions pooled per (gene, seqname) with merged exons
    (`utr_region.rs:366-408`). Explicit `three_prime_UTR` rows win;
    genes without them derive the UTR from CDS: the exonic bases
    strictly downstream (transcript orientation) of the last coding
    base (the reference's `build_codon_map` route). Genes with neither
    contribute no region — span-based fallbacks measure the wrong
    coordinate (run.rs min_utr_length long_help)."""
    import re

    def gene_of(attrs: str, fallback: str) -> str:
        m = (
            re.search(r'gene_id[ =]"?([^";]+)"?', attrs)
            or re.search(r"gene[:=]([^;]+)", attrs)
            or re.search(r"Parent=(?:transcript:)?([^;]+)", attrs)
            or re.search(r"ID=(?:gene:)?([^;]+)", attrs)
        )
        gid = m.group(1).strip() if m else fallback
        return gid.split(".")[0]  # drop version (parse_ensembl_id parity)

    utr_loci: dict[tuple[str, str], dict] = {}
    exon_loci: dict[tuple[str, str], dict] = {}
    cds_loci: dict[tuple[str, str], list] = {}
    with open(path) as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9:
                continue
            feat = parts[2].lower()
            iv = (int(parts[3]) - 1, int(parts[4]))  # -> 0-based half-open
            if feat in ("three_prime_utr", "3utr", "three_prime_utr_variant"):
                gid = gene_of(parts[8], f"{parts[0]}:{parts[3]}")
                ent = utr_loci.setdefault(
                    (gid, parts[0]), {"strand": parts[6], "ivs": []}
                )
                ent["ivs"].append(iv)
            elif feat == "exon":
                gid = gene_of(parts[8], f"{parts[0]}:{parts[3]}")
                ent = exon_loci.setdefault(
                    (gid, parts[0]), {"strand": parts[6], "ivs": []}
                )
                ent["ivs"].append(iv)
            elif feat in ("cds", "stop_codon"):
                gid = gene_of(parts[8], f"{parts[0]}:{parts[3]}")
                cds_loci.setdefault((gid, parts[0]), []).append(iv)

    loci: dict[tuple[str, str], dict] = dict(utr_loci)
    # CDS-derived fallback for genes with no explicit UTR rows
    for key, ent in exon_loci.items():
        if key in loci or key not in cds_loci:
            continue
        exons = _merge_intervals(ent["ivs"])
        cds = cds_loci[key]
        if ent["strand"] == "-":
            cds_edge = min(s for s, _ in cds)  # last coding base 5'-ward
            ivs = [(s, min(e, cds_edge)) for s, e in exons if s < cds_edge]
        else:
            cds_edge = max(e for _, e in cds)
            ivs = [(max(s, cds_edge), e) for s, e in exons if e > cds_edge]
        ivs = [(s, e) for s, e in ivs if e > s]
        if ivs:
            loci[key] = {"strand": ent["strand"], "ivs": ivs}

    # pseudoautosomal disambiguation: same gene on >1 seqname
    per_gene: dict[str, int] = {}
    for gid, _sq in loci:
        per_gene[gid] = per_gene.get(gid, 0) + 1
    regions = []
    for (gid, seqname), ent in loci.items():
        name = gid if per_gene[gid] == 1 else f"{gid}_{seqname}"
        regions.append(
            UtrRegion(
                chrom=seqname,
                strand=-1 if ent["strand"] == "-" else 1,
                name=name,
                exons=_merge_intervals(ent["ivs"]),
            )
        )
    regions.sort(key=lambda r: (r.chrom, r.fetch_start, r.name))
    return regions


def load_utr_regions_from_bed(path: str) -> list[UtrRegion]:
    """BED UTRs: 3-col (forward), SCAPE 4-col (strand col 4), 6-col
    standard (`utr_region.rs:415-470`); one contiguous block per row."""
    regions = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t = line.split("\t")
            if len(t) < 3:
                continue
            chrom, start, end = t[0], int(t[1]), int(t[2])
            if len(t) >= 6:
                name, strand = t[3], (-1 if t[5] == "-" else 1)
            elif len(t) == 4:
                if t[3] in ("+", "-"):
                    name, strand = f"{chrom}:{start}-{end}", (-1 if t[3] == "-" else 1)
                else:
                    name, strand = t[3], 1
            else:
                name, strand = f"{chrom}:{start}-{end}", 1
            regions.append(
                UtrRegion(
                    chrom=chrom, strand=strand, name=name,
                    exons=np.asarray([[start, end]], np.int64),
                )
            )
    regions.sort(key=lambda r: (r.chrom, r.fetch_start, r.name))
    return regions


# ---------------------------------------------------------------------------
# Fragment extraction (fragment.rs)
# ---------------------------------------------------------------------------


@dataclass
class FragArrays:
    """Columnar FragmentRecord set for one UTR (`fragment.rs:153-168`)."""

    x: np.ndarray  # [N] f32, 1-based spliced start (transcript orientation)
    l: np.ndarray  # [N] f32, covered spliced length
    r: np.ndarray  # [N] f32, poly(A) tail length (0 = none)
    is_junction: np.ndarray  # [N] bool
    pa_site: np.ndarray  # [N] f32, cleavage offset (nan when not a junction)
    cb: np.ndarray  # [N] int64 cell ids
    umi: np.ndarray  # [N] int64
    batch: np.ndarray  # [N] int32 replicate index

    def __len__(self):
        return len(self.x)


def extract_fragments(
    recs,
    rid: int,
    utr: UtrRegion,
    params: ScapeParams,
    *,
    batch: int = 0,
    genome_seq: "str | None" = None,
) -> FragArrays:
    """Reads overlapping the UTR -> spliced fragment features.

    Covered length charges only exonic bases (interval intersection of
    the read span with the merged exons — `overlap_spliced_blocks`
    utr_region.rs:152-200, with the read treated as one aligned block;
    per-block N-skip structure is not exported by the columnar reader,
    a documented divergence that only affects reads whose skips land on
    exonic sequence). A read qualifies as a junction read when its
    terminal soft-clip passes the poly-A gate; its cleavage point is
    its spliced 3' end and `r` its tail length."""
    keep = (
        (recs.ref_id == rid)
        & (recs.mapq >= params.min_mapq)
        & ((recs.flag & 0x904) == 0)
        & (recs.end_pos > utr.fetch_start)
        & (recs.pos < utr.fetch_end)
    )
    pos = recs.pos[keep].astype(np.int64)
    end = recs.end_pos[keep].astype(np.int64)
    cb = recs.cb_id[keep].astype(np.int64)
    umi = recs.umi_id[keep].astype(np.int64)

    # spliced covered length: sum of per-exon overlaps
    l_cov = np.zeros(len(pos), np.int64)
    for s, e in utr.exons:
        l_cov += np.maximum(
            0, np.minimum(end, int(e)) - np.maximum(pos, int(s))
        )
    ok = l_cov > 0
    pos, end, cb, umi, l_cov = pos[ok], end[ok], cb[ok], umi[ok], l_cov[ok]
    if not len(pos):
        z = np.zeros(0)
        return FragArrays(z, z, z, np.zeros(0, bool), z,
                          np.zeros(0, np.int64), np.zeros(0, np.int64),
                          np.zeros(0, np.int32))

    # clamp read ends into the exon span, then take the covered
    # genomic extremes (first/last exonic base the read touches)
    starts, ends_ex = utr.exons[:, 0], utr.exons[:, 1]

    def _snap_left(g):
        # smallest exonic base >= g
        j = np.searchsorted(ends_ex, g, side="right")
        j = np.minimum(j, len(starts) - 1)
        return np.maximum(g, starts[j])

    def _snap_right(g):
        # largest exonic base <= g
        j = np.searchsorted(starts, g, side="right") - 1
        j = np.maximum(j, 0)
        return np.minimum(g, ends_ex[j] - 1)

    g_left = _snap_left(pos)
    g_right = _snap_right(end - 1)
    # 5'-most covered base in transcript orientation
    g5 = g_left if utr.strand > 0 else g_right
    x = utr.spliced_offset(g5).astype(np.float64)
    three_prime = x + l_cov - 1

    # poly-A junction gate (PolyAFilterParams; tail stats from the
    # columnar reader: terminal soft-clip length + A/T fraction)
    if recs.tail_len is not None and len(recs.tail_len):
        t_len = recs.tail_len[keep][ok].astype(np.int64)
        t_hits = np.round(
            recs.tail_frac[keep][ok].astype(np.float64) / 255.0 * t_len
        )
        is_j = (t_len >= params.polya_min_tail_length) & (
            (t_len - t_hits) <= params.polya_max_non_at
        )
        r = np.where(is_j, np.minimum(t_len, params.max_polya), 0.0)
    else:
        is_j = np.zeros(len(pos), bool)
        r = np.zeros(len(pos))

    # internal-priming rejection (run.rs polya_internal_prime_*): a
    # genomic A/T-rich window around the cleavage site means the tail
    # was likely template-primed, not a real poly(A) junction
    if genome_seq is not None and is_j.any():
        w = params.internal_prime_window
        g3 = g_right if utr.strand > 0 else g_left
        for i in np.nonzero(is_j)[0]:
            c = int(g3[i])
            win = genome_seq[max(0, c - w // 2): c + w - w // 2].upper()
            if sum(b in "AT" for b in win) >= params.internal_prime_count:
                is_j[i] = False
                r[i] = 0.0

    pa = np.where(is_j, three_prime, np.nan)
    return FragArrays(
        x=x, l=l_cov.astype(np.float64), r=r, is_junction=is_j, pa_site=pa,
        cb=cb, umi=umi, batch=np.full(len(pos), batch, np.int32),
    )


def concat_fragments(parts: list[FragArrays]) -> FragArrays:
    return FragArrays(
        *[np.concatenate([getattr(p, f) for p in parts])
          for f in ("x", "l", "r", "is_junction", "pa_site", "cb", "umi", "batch")]
    )


# ---------------------------------------------------------------------------
# SCAPE likelihood (likelihood.rs), vectorized
# ---------------------------------------------------------------------------


def _log_normal_pdf(x, mu, sigma):
    z = (x - mu) / sigma
    return -0.5 * z * z - np.log(sigma) - 0.5 * np.log(2 * np.pi)


def theta_lik_matrix(
    frags: FragArrays, utr_length: float, params: ScapeParams
) -> tuple[np.ndarray, np.ndarray]:
    """[M, T] log p(x,l,r | theta_t) over the theta grid
    (`likelihood.rs:80-160` + `precompute_theta_lik_matrix`).
    Junction reads: p = 1/(theta - x + 1) on the valid support.
    SE reads marginalize s over [min_polya, max_polya] with
    p(s) uniform, p(r|s)=1/s (r observed) or 1, x ~ N(theta+s+1-mu_f,
    sigma_f^2), p(l|x,theta)=1/(theta-x+1)."""
    theta = np.arange(1, int(utr_length) + 1, params.theta_step, dtype=np.float64)
    x = frags.x[:, None]  # [M, 1]
    l = frags.l[:, None]
    r = frags.r[:, None]
    max_l = theta[None, :] - x + 1.0  # [M, T]

    # junction branch
    j_ok = (l >= 1.0) & (l <= max_l) & (max_l > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        lik_j = np.where(j_ok, -np.log(np.maximum(max_l, 1e-300)), -np.inf)

    # SE branch: [M, T, S]
    s = np.arange(params.min_polya, params.max_polya + 1e-6, params.theta_step)
    s_range = params.max_polya - params.min_polya
    log_ps = -np.log(max(s_range, 1e-300))
    r_mt1 = r[:, :, None]
    with np.errstate(divide="ignore", invalid="ignore"):
        log_pr_s = np.where(
            r_mt1 > 0,
            np.where(
                (r_mt1 >= 1.0) & (r_mt1 <= s[None, None, :]),
                -np.log(s)[None, None, :],
                -np.inf,
            ),
            0.0,
        )
        mean_x = theta[None, :, None] + s[None, None, :] + 1.0 - params.mu_f
        log_px = _log_normal_pdf(x[:, :, None], mean_x, params.sigma_f)
        log_pl = np.where(
            j_ok[:, :, None], -np.log(np.maximum(max_l, 1e-300))[:, :, None], -np.inf
        )
        f = log_ps + log_pr_s + log_px + log_pl
    # logsumexp over s
    fmax = f.max(-1)
    safe = np.isfinite(fmax)
    lik_se = np.full(fmax.shape, -np.inf)
    if safe.any():
        lik_se[safe] = fmax[safe] + np.log(
            np.exp(f[safe] - fmax[safe][:, None]).sum(-1)
        )

    use_j = (frags.is_junction & (frags.r > 0))[:, None]
    return np.where(use_j, lik_j, lik_se), theta


def site_emission(
    tl: np.ndarray, theta: np.ndarray, alpha: float, beta: float,
    eta: float, skirt_mult: float,
) -> np.ndarray:
    """[M] log p(frag | alpha, beta): theta marginalized under
    (1-eta) N(alpha, beta^2) + eta Uniform(alpha +- skirt_mult*beta)
    (`likelihood.rs:log_lik_fragment_given_site_robust`)."""
    log_gauss = _log_normal_pdf(theta, alpha, beta)  # [T]
    w = skirt_mult * beta
    if eta > 0 and w > 0 and np.isfinite(w):
        with np.errstate(divide="ignore"):
            log_u = np.where(
                (theta >= alpha - w) & (theta <= alpha + w),
                -np.log(2 * w), -np.inf,
            )
            m = np.maximum(np.log1p(-eta) + log_gauss, np.log(eta) + log_u)
            log_prior = m + np.log(
                np.exp(np.log1p(-eta) + log_gauss - m) + np.exp(np.log(eta) + log_u - m)
            )
    else:
        log_prior = log_gauss
    a = tl + log_prior[None, :]  # [M, T]
    amax = a.max(1)
    out = np.full(len(a), -np.inf)
    ok = np.isfinite(amax)
    if ok.any():
        out[ok] = amax[ok] + np.log(np.exp(a[ok] - amax[ok][:, None]).sum(1))
    return out


def log_lik_noise(utr_length: float, max_polya: float) -> float:
    """Uniform noise component, SCAPE eq 13 (`likelihood.rs:163-165`)."""
    return float(-2.0 * np.log(utr_length) - np.log(max_polya))


# ---------------------------------------------------------------------------
# Fragment clustering on the sufficient statistic (fragment.rs:76-150)
# ---------------------------------------------------------------------------


def cluster_fragments(
    frags: FragArrays, *, bin_x=5.0, bin_l=10.0, bin_r=10.0, bin_pa=5.0
) -> tuple[FragArrays, np.ndarray, np.ndarray]:
    """Quantize (x, l, r, junction, pa) and pool identical tuples:
    returns (representatives w/ mean features, counts, cluster_idx).
    Exact for the EM — the likelihood depends only on this tuple."""
    qx = np.round(frags.x / bin_x).astype(np.int64)
    ql = np.round(frags.l / bin_l).astype(np.int64)
    qr = np.round(frags.r / bin_r).astype(np.int64)
    qp = np.where(
        np.isnan(frags.pa_site), np.int64(-(2**40)),
        np.round(np.nan_to_num(frags.pa_site) / bin_pa).astype(np.int64),
    )
    keys = np.stack([qx, ql, qr, frags.is_junction.astype(np.int64), qp])
    _, first, inv, counts = np.unique(
        keys, axis=1, return_index=True, return_inverse=True, return_counts=True
    )
    m = len(first)

    def mean_by(v):
        return np.bincount(inv, weights=v, minlength=m) / counts

    reps = FragArrays(
        x=mean_by(frags.x),
        l=mean_by(frags.l),
        r=mean_by(frags.r),
        is_junction=frags.is_junction[first],
        pa_site=np.where(
            frags.is_junction[first],
            mean_by(np.nan_to_num(frags.pa_site)), np.nan,
        ),
        cb=frags.cb[first],
        umi=frags.umi[first],
        batch=frags.batch[first],
    )
    return reps, counts.astype(np.float64), inv.astype(np.int64)


# ---------------------------------------------------------------------------
# Site discovery (site_discovery.rs)
# ---------------------------------------------------------------------------


def discover_sites_from_junctions(frags: FragArrays, min_coverage: int) -> np.ndarray:
    pa = frags.pa_site[~np.isnan(frags.pa_site)]
    if not len(pa):
        return np.zeros(0)
    vals, counts = np.unique(np.round(pa).astype(np.int64), return_counts=True)
    return np.sort(vals[counts >= min_coverage].astype(np.float64))


def discover_sites_from_coverage(
    frags: FragArrays, utr_length: float, bandwidth: float = 100.0
) -> np.ndarray:
    """KDE fallback over fragment 3' ends (`site_discovery.rs:33-65`)."""
    if not len(frags) or utr_length <= 0:
        return np.zeros(0)
    ends = frags.x + frags.l
    resolution = 10.0
    grid = np.arange(0.0, utr_length + resolution, resolution)
    hist, _ = np.histogram(ends, bins=len(grid), range=(0, utr_length + resolution))
    smoothed = gaussian_kernel_smooth(grid, hist.astype(np.float64), grid, bandwidth)
    modes = find_modes(smoothed)
    sites = grid[modes][smoothed[modes] > 0]
    return np.sort(sites)


def merge_nearby_sites(
    sites: np.ndarray, frags: FragArrays, merge_dist: float
) -> np.ndarray:
    """Collapse sites within `merge_dist`, keeping the highest-count
    representative (`site_discovery.rs:68-118`)."""
    if not len(sites):
        return sites
    pos = np.where(np.isnan(frags.pa_site), frags.x + frags.l, frags.pa_site)
    binned = np.round(pos).astype(np.int64)
    counts = {int(s): 0 for s in np.round(sites)}
    vals, cnts = np.unique(binned, return_counts=True)
    lut = dict(zip(vals.tolist(), cnts.tolist()))
    score = np.asarray([lut.get(int(round(s)), 0) for s in sites], np.float64)
    merged, merged_score = [], []
    for s, c in zip(np.sort(sites), score[np.argsort(sites)]):
        if merged and s - merged[-1] < merge_dist:
            if c > merged_score[-1]:
                merged[-1], merged_score[-1] = s, c
        else:
            merged.append(float(s))
            merged_score.append(float(c))
    return np.asarray(merged)


def discover_sites_bisect(
    sorted_pos: np.ndarray, min_gap: float, min_count: int
) -> list[tuple[float, int]]:
    """Recursive largest-gap bisection for the fast-PDUI path
    (`site_discovery.rs:123-165`): split at the widest interior gap
    > min_gap keeping >= min_count reads on each side; leaves report
    (median, count)."""
    floor = max(min_count, 1)
    if len(sorted_pos) < floor:
        return []
    leaves = []
    stack = [sorted_pos]
    while stack:
        seg = stack.pop()
        n = len(seg)
        lo, hi = floor - 1, n - floor
        best_i, best_gap = None, min_gap
        if hi > lo:
            gaps = seg[lo + 1: hi + 1] - seg[lo:hi]
            k = int(np.argmax(gaps))
            if gaps[k] > best_gap:
                best_i = lo + k
        if best_i is None:
            leaves.append((float(seg[n // 2]), n))
        else:
            stack.append(seg[best_i + 1:])
            stack.append(seg[: best_i + 1])
    leaves.sort(key=lambda t: t[0])
    return leaves


# ---------------------------------------------------------------------------
# BIC site selection (em.rs:197-330)
# ---------------------------------------------------------------------------


@dataclass
class EmFit:
    weights: np.ndarray  # [K+1] incl. noise at 0
    alphas: np.ndarray
    betas: np.ndarray
    gamma: np.ndarray  # [M, K+1]
    log_lik: float
    bic: float


def _run_fixed_em(cll, alphas, betas, counts, n_for_bic, params: ScapeParams) -> EmFit:
    res = fixed_em_weighted(
        cll, counts, n_free_params=len(alphas), n_for_bic=n_for_bic,
        max_iter=params.max_iter, tol=params.tol, min_weight=params.min_ws,
    )
    return EmFit(
        weights=np.asarray(res["weights"]), alphas=np.asarray(alphas),
        betas=np.asarray(betas), gamma=np.asarray(res["gamma"]),
        log_lik=res["log_lik"], bic=res["bic"],
    )


def rank_candidates_by_mass(
    candidates: np.ndarray,
    reps: FragArrays,
    cl_counts: np.ndarray,
    merge_distance: float,
) -> np.ndarray:
    """Greedy add order for BIC selection: candidates ranked by the
    junction-cluster multiplicity within `merge_distance` of each
    (`pipeline.rs:887-910` sorted-candidate sweep)."""
    score = np.zeros(len(candidates))
    pa = reps.pa_site
    ok = ~np.isnan(pa)
    if ok.any():
        for p, c in zip(pa[ok], cl_counts[ok]):
            score[np.abs(candidates - p) < merge_distance] += c
    return np.argsort(-score, kind="stable")


def select_sites_by_bic(
    tl: np.ndarray,
    theta: np.ndarray,
    counts: np.ndarray,
    n_for_bic: int,
    candidates: np.ndarray,
    utr_length: float,
    params: ScapeParams,
    *,
    order: np.ndarray | None = None,
) -> EmFit:
    """Greedy K-selection over coverage-ranked candidates with lazy
    column materialization, 2-consecutive-worse early stop, and the
    post-EM close-site merge (`em.rs:206-330`)."""
    m = tl.shape[0]
    noise = log_lik_noise(utr_length, params.max_polya)
    beta0 = (params.min_beta + params.max_beta) / 2.0
    if order is None:
        order = np.arange(len(candidates))

    n_cand = len(candidates)
    if params.apa_max_sites > 0:
        n_cand = min(n_cand, params.apa_max_sites)
    if n_cand <= 1:
        cll = np.concatenate(
            [np.full((m, 1), noise)]
            + [
                site_emission(tl, theta, float(candidates[j]), beta0,
                              params.skirt_eta, params.skirt_mult)[:, None]
                for j in range(len(candidates))
            ],
            axis=1,
        )
        return _run_fixed_em(cll, candidates, np.full(len(candidates), beta0),
                             counts, n_for_bic, params)

    cols = np.zeros((m, n_cand))
    filled = 0
    best: EmFit | None = None
    n_worse = 0
    sel_a: list[float] = []
    for k in range(1, n_cand + 1):
        j = order[k - 1]
        sel_a.append(float(candidates[j]))
        while filled < k:
            jj = order[filled]
            cols[:, filled] = site_emission(
                tl, theta, float(candidates[jj]), beta0,
                params.skirt_eta, params.skirt_mult,
            )
            filled += 1
        cll = np.concatenate([np.full((m, 1), noise), cols[:, :k]], axis=1)
        fit = _run_fixed_em(cll, np.asarray(sel_a), np.full(k, beta0),
                            counts, n_for_bic, params)
        if best is None or fit.bic < best.bic:
            best, n_worse = fit, 0
        else:
            n_worse += 1
            if n_worse >= 2:
                break

    return _merge_close_sites(best, cols, noise, counts, n_for_bic, params)


def _merge_close_sites(
    fit: EmFit, cols: np.ndarray, noise: float, counts, n_for_bic,
    params: ScapeParams,
) -> EmFit:
    """Collapse live sites with |a_i - a_j| < merge_beta_mult * max(b),
    keep higher-pi, refit, accept only on strict BIC improvement
    (`em.rs:337-430`)."""
    k = len(fit.alphas)
    if params.merge_beta_mult <= 0 or k < 2:
        return fit
    live = [i for i in range(k) if fit.weights[i + 1] > 0]
    if len(live) < 2:
        return fit
    order = sorted(live, key=lambda i: (-fit.weights[i + 1], fit.alphas[i]))
    keep: list[int] = []
    for i in order:
        if not any(abs(fit.alphas[i] - fit.alphas[j])
                   < params.merge_beta_mult * max(fit.betas[i], fit.betas[j])
                   for j in keep):
            keep.append(i)
    if len(keep) == len(live):
        return fit
    keep.sort(key=lambda i: fit.alphas[i])
    cll = np.concatenate(
        [np.full((cols.shape[0], 1), noise), cols[:, keep]], axis=1
    )
    merged = _run_fixed_em(
        cll, fit.alphas[keep], fit.betas[keep], counts, n_for_bic, params
    )
    return merged if np.isfinite(merged.bic) and merged.bic < fit.bic else fit


# ---------------------------------------------------------------------------
# Cell assignment (cell_assign.rs) + per-UTR driver (pipeline.rs:682-945)
# ---------------------------------------------------------------------------


@dataclass
class SiteAnnotation:
    site_id: str
    gene_name: str
    chrom: str
    genomic_alpha: int
    beta: float
    pi_weight: float
    utr_length: int
    strand: int


@dataclass
class UtrResult:
    # (batch, cell, site_local_idx) -> deduped count
    counts: dict
    annotations: list


def assign_fragments_to_sites(
    frags: FragArrays, cluster_idx: np.ndarray, fit: EmFit, utr: UtrRegion
) -> UtrResult:
    """Hard argmax-gamma assignment, (batch, cell, UMI, component)
    dedup, per-cell counts (`cell_assign.rs:47-120`)."""
    best_k = np.argmax(fit.gamma, axis=1)  # [M], 0 = noise
    frag_k = best_k[cluster_idx]
    keep = frag_k > 0
    # live components (pi > 0), renumbered 0..n_live-1 in alpha order —
    # the per-gene 0-indexed component of `site_id()` (cell_assign.rs:104)
    live = [k for k in range(len(fit.alphas)) if fit.weights[k + 1] > 0]
    live.sort(key=lambda k: fit.alphas[k])
    remap = {k + 1: i for i, k in enumerate(live)}  # gamma col -> local id
    counts: dict = {}
    if keep.any():
        b, c, u, kk = (
            frags.batch[keep], frags.cb[keep], frags.umi[keep], frag_k[keep]
        )
        tbl = np.stack([b.astype(np.int64), c, u, kk.astype(np.int64)])
        for b_, c_, _u, k_ in np.unique(tbl, axis=1).T:
            if int(k_) not in remap or c_ < 0:
                continue
            key = (int(b_), int(c_), remap[int(k_)])
            counts[key] = counts.get(key, 0) + 1
    ann = [
        SiteAnnotation(
            site_id=f"{utr.name}/apa/{i}",
            gene_name=utr.name,
            chrom=utr.chrom,
            genomic_alpha=utr.alpha_to_genomic(float(fit.alphas[k])),
            beta=float(fit.betas[k]),
            pi_weight=float(fit.weights[k + 1]),
            utr_length=utr.utr_length,
            strand=utr.strand,
        )
        for i, k in enumerate(live)
    ]
    return UtrResult(counts=counts, annotations=ann)


def assign_two_site_fast(
    frags: FragArrays, sites: tuple[float, float], utr: UtrRegion, beta: float
) -> UtrResult:
    """Fast-PDUI nearest-site hard assignment
    (`cell_assign.rs assign_fragments_two_site_fast`). Sites are
    ordered by transcript alpha so component 0 is PROXIMAL (smaller
    5'->3' offset = closer to the stop codon — pdui.rs:34-50)."""
    sites = tuple(sorted(sites))
    pos = np.where(np.isnan(frags.pa_site), frags.x + frags.l, frags.pa_site)
    k = (np.abs(pos - sites[1]) < np.abs(pos - sites[0])).astype(np.int64)
    counts: dict = {}
    ok = frags.cb >= 0
    tbl = np.stack([
        frags.batch[ok].astype(np.int64), frags.cb[ok], frags.umi[ok], k[ok]
    ])
    for b_, c_, _u, k_ in np.unique(tbl, axis=1).T:
        key = (int(b_), int(c_), int(k_))
        counts[key] = counts.get(key, 0) + 1
    ann = [
        SiteAnnotation(
            site_id=f"{utr.name}/apa/{i}",
            gene_name=utr.name,
            chrom=utr.chrom,
            genomic_alpha=utr.alpha_to_genomic(float(s)),
            beta=beta,
            pi_weight=float(np.mean(k == i)),
            utr_length=utr.utr_length,
            strand=utr.strand,
        )
        for i, s in enumerate(sites)
    ]
    return UtrResult(counts=counts, annotations=ann)


def process_utr(
    frags: FragArrays,
    utr: UtrRegion,
    params: ScapeParams,
    *,
    site_mask: "set[int] | None" = None,
    pre_sites: "np.ndarray | None" = None,
    fast_pdui: bool = True,
    no_umi_dedup: bool = False,
) -> UtrResult | None:
    """One UTR through the mixture (or fast-PDUI) flow
    (`pipeline.rs:682-945`)."""
    if len(frags) < params.min_fragments:
        return None
    if no_umi_dedup:
        frags.umi = np.arange(len(frags), dtype=np.int64)

    if fast_pdui:
        pos = np.sort(np.where(np.isnan(frags.pa_site),
                               frags.x + frags.l, frags.pa_site))
        clusters = discover_sites_bisect(
            pos, params.merge_distance, params.min_coverage
        )
        if site_mask:
            clusters = [
                (a, c) for a, c in clusters
                if utr.alpha_to_genomic(a) not in site_mask
            ]
        if len(clusters) < 2:
            return None
        clusters.sort(key=lambda t: -t[1])
        if clusters[1][1] < params.min_runnerup_mass_frac * clusters[0][1]:
            return None
        beta = (params.min_beta + params.max_beta) / 2.0
        return assign_two_site_fast(
            frags, (clusters[0][0], clusters[1][0]), utr, beta
        )

    if pre_sites is not None and len(pre_sites):
        candidates = np.asarray(pre_sites, np.float64)
    else:
        raw = discover_sites_from_junctions(frags, params.min_coverage)
        if len(raw):
            candidates = merge_nearby_sites(raw, frags, params.merge_distance)
        else:
            cov_sites = discover_sites_from_coverage(
                frags, float(utr.utr_length)
            )
            candidates = merge_nearby_sites(cov_sites, frags, params.merge_distance)
    if site_mask:
        candidates = np.asarray(
            [a for a in candidates if utr.alpha_to_genomic(float(a)) not in site_mask]
        )
    if not len(candidates):
        return None

    reps, cl_counts, cluster_idx = cluster_fragments(frags)
    tl, theta = theta_lik_matrix(reps, float(utr.utr_length), params)
    order = rank_candidates_by_mass(
        candidates, reps, cl_counts, params.merge_distance
    )
    fit = select_sites_by_bic(
        tl, theta, cl_counts, len(frags), candidates,
        float(utr.utr_length), params, order=order,
    )
    return assign_fragments_to_sites(frags, cluster_idx, fit, utr)


# ---------------------------------------------------------------------------
# Masks + gene QC gates (run.rs:482-700, quant::resolve_gene_qc)
# ---------------------------------------------------------------------------


def load_position_mask(path: str) -> "set[tuple[str, int]]":
    """(chrom, 0-based pos) pairs from an A-to-I / SNP sites parquet
    (`run.rs --atoi-mask / --snp-mask`; pos columns are 0-based
    everywhere in faba — alpha_to_genomic docstring)."""
    import pandas as pd

    df = pd.read_parquet(path)
    chrom_col = next(c for c in df.columns if c.lower() in ("chrom", "chr", "seqname"))
    pos_col = next(c for c in df.columns if c.lower() in ("pos", "position", "primary_pos"))
    return set(zip(df[chrom_col].astype(str), df[pos_col].astype(int)))


def load_valid_set(path: str) -> "set[str]":
    """Newline-separated allow-list (plain, .gz, or first column of a
    TSV — the `{batch}_cells.tsv.gz` / `genes_kept.tsv.gz` formats)."""
    import gzip

    opener = gzip.open if str(path).endswith(".gz") else open
    out = set()
    with opener(path, "rt") as f:
        for line in f:
            tok = line.strip().split("\t")[0]
            if tok and not tok.startswith("#"):
                out.add(tok)
    return out


def gene_expression_qc(
    bam_path: str,
    gff_path: str,
    *,
    gene_min_cells: int = 10,
    gene_min_counts: int = 0,
    cell_min_genes: int = 10,
    min_mapq: int = 20,
) -> tuple["set[str]", "set[str]"]:
    """Gene/cell expression gates before the mixture (run.rs:628-662
    resolve_gene_qc): genes must appear in >= gene_min_cells cells (and
    carry >= gene_min_counts UMIs); cells must detect >= cell_min_genes
    genes. Returns (valid_genes, valid_cells)."""
    from .genes import count_genes

    counts, gene_names, barcodes = count_genes(
        bam_path, gff_path, min_mapq=min_mapq
    )
    csr = counts.tocsr()
    cells_per_gene = np.diff(csr.indptr)
    umis_per_gene = np.asarray(csr.sum(axis=1)).ravel()
    keep_g = cells_per_gene >= gene_min_cells
    if gene_min_counts > 0:
        keep_g &= umis_per_gene >= gene_min_counts
    csc = counts.tocsc()
    genes_per_cell = np.diff(csc.indptr)
    keep_c = genes_per_cell >= cell_min_genes
    valid_genes = {gene_names[i] for i in np.nonzero(keep_g)[0]}
    valid_cells = {barcodes[i] for i in np.nonzero(keep_c)[0]}
    log.info(
        "apa gene QC: %d/%d genes, %d/%d cells retained",
        len(valid_genes), len(gene_names), len(valid_cells), len(barcodes),
    )
    return valid_genes, valid_cells


# ---------------------------------------------------------------------------
# Top-level mixture driver (pipeline.rs run_mixture)
# ---------------------------------------------------------------------------


@dataclass
class ApaMixtureResult:
    """Per-batch sparse outputs + pooled site annotations."""

    # component matrix [sites, cells] per batch (None unless write_mixture)
    mixture: "list[sp.csc_matrix] | None"
    mixture_names: list
    # PDUI channels [2*genes, cells] per batch: {gene}/apa/{proximal,distal}
    pdui: list
    pdui_names: list
    barcodes: list  # per batch
    annotations: "object"  # pandas DataFrame


def run_apa_mixture(
    bam_paths: "list[str]",
    gff_path: "str | None" = None,
    *,
    utr_bed: "str | None" = None,
    params: ScapeParams | None = None,
    pre_sites: "dict[str, np.ndarray] | None" = None,
    atoi_mask: "str | None" = None,
    snp_mask: "str | None" = None,
    valid_cells: "set[str] | None" = None,
    valid_genes: "set[str] | None" = None,
    skip_gene_qc: bool = False,
    gene_min_cells: int = 10,
    gene_min_counts: int = 0,
    cell_min_genes: int = 10,
    no_umi_dedup: bool = False,
    write_mixture: bool = False,
    apa_em_pdui: bool = False,
    compute_pdui: bool = True,
    drop_single_component: bool = False,
    genome_seqs: "dict[str, str] | None" = None,
) -> ApaMixtureResult:
    """`run_mixture` (pipeline.rs:354-575): pooled site fit across
    batches, per-batch count emission. The default path (no
    `write_mixture` / `apa_em_pdui`) is the fast PDUI; either flag
    switches to the full SCAPE EM."""
    import pandas as pd

    from .bam import read_bam

    params = params or ScapeParams()
    fast_pdui = compute_pdui and not write_mixture and not apa_em_pdui

    # UTR regions
    if utr_bed:
        utrs = load_utr_regions_from_bed(utr_bed)
    elif gff_path:
        utrs = build_utr_regions_from_gff(gff_path)
    else:
        raise ValueError("apa mixture needs --gff or --utr-bed")
    utrs = [u for u in utrs if u.utr_length >= params.min_utr_length]

    # gene QC (mixture mode only, run.rs:628-662); explicit allow-lists
    # override the recompute
    if not skip_gene_qc and gff_path and (valid_genes is None or valid_cells is None):
        vg, vc = gene_expression_qc(
            bam_paths[0], gff_path,
            gene_min_cells=gene_min_cells, gene_min_counts=gene_min_counts,
            cell_min_genes=cell_min_genes, min_mapq=params.min_mapq,
        )
        if valid_genes is None and vg:
            valid_genes = vg
        if valid_cells is None and vc:
            valid_cells = vc
    if valid_genes:
        # UTR names are gene ids (optionally _seqname suffixed)
        utrs = [
            u for u in utrs
            if u.name in valid_genes or u.name.split("_")[0] in valid_genes
        ]
    log.info("apa mixture: %d UTR regions", len(utrs))

    site_mask_pairs: "set[tuple[str, int]]" = set()
    for p in (atoi_mask, snp_mask):
        if p:
            site_mask_pairs |= load_position_mask(p)

    # read BAMs once; per-batch barcode spaces stay separate
    batches = [read_bam(p) for p in bam_paths]
    if valid_cells is not None:
        from .dartseq import filter_cells

        batches = [filter_cells(b, valid_cells) for b in batches]

    all_results: list[tuple[UtrRegion, UtrResult]] = []
    for utr in utrs:
        parts = []
        for bi, recs in enumerate(batches):
            try:
                rid = recs.ref_names.index(utr.chrom)
            except ValueError:
                continue
            seq = genome_seqs.get(utr.chrom) if genome_seqs else None
            parts.append(
                extract_fragments(recs, rid, utr, params, batch=bi, genome_seq=seq)
            )
        if not parts:
            continue
        frags = concat_fragments(parts)
        mask = (
            {p for c, p in site_mask_pairs if c == utr.chrom}
            if site_mask_pairs else None
        )
        res = process_utr(
            frags, utr, params,
            site_mask=mask, fast_pdui=fast_pdui, no_umi_dedup=no_umi_dedup,
            pre_sites=None if pre_sites is None else pre_sites.get(utr.name),
        )
        if res is None or not res.annotations:
            continue
        if drop_single_component and len(res.annotations) < 2:
            continue
        all_results.append((utr, res))

    # ---- assemble outputs ----------------------------------------------
    n_batches = len(batches)
    barcodes = [b.barcodes for b in batches]

    # component (mixture) matrices
    mixture = None
    mixture_names: list[str] = []
    if write_mixture:
        rows = {b: [] for b in range(n_batches)}
        cols = {b: [] for b in range(n_batches)}
        vals = {b: [] for b in range(n_batches)}
        for utr, res in all_results:
            base = len(mixture_names)
            mixture_names += [a.site_id for a in res.annotations]
            for (b, c, k), v in res.counts.items():
                rows[b].append(base + k)
                cols[b].append(c)
                vals[b].append(v)
        mixture = [
            sp.coo_matrix(
                (np.asarray(vals[b], np.float32), (rows[b], cols[b])),
                shape=(len(mixture_names), len(barcodes[b])),
            ).tocsc()
            for b in range(n_batches)
        ]

    # PDUI channels for exactly-2-site genes (pdui.rs:23-90): proximal =
    # smaller transcript alpha = closer to the stop codon; with our
    # annotations ordered by transcript alpha, component 0 is proximal
    pdui_names: list[str] = []
    p_rows = {b: [] for b in range(n_batches)}
    p_cols = {b: [] for b in range(n_batches)}
    p_vals = {b: [] for b in range(n_batches)}
    if compute_pdui:
        for utr, res in all_results:
            if len(res.annotations) != 2:
                continue
            base = len(pdui_names)
            pdui_names += [f"{utr.name}/apa/proximal", f"{utr.name}/apa/distal"]
            for (b, c, k), v in res.counts.items():
                if k in (0, 1):
                    p_rows[b].append(base + k)
                    p_cols[b].append(c)
                    p_vals[b].append(v)
    pdui = [
        sp.coo_matrix(
            (np.asarray(p_vals[b], np.float32), (p_rows[b], p_cols[b])),
            shape=(len(pdui_names), len(barcodes[b])),
        ).tocsc()
        for b in range(n_batches)
    ]

    ann_df = pd.DataFrame(
        [
            dict(
                site_id=a.site_id, gene=a.gene_name, chrom=a.chrom,
                genomic_alpha=a.genomic_alpha, beta=a.beta,
                pi_weight=a.pi_weight, utr_length=a.utr_length,
                strand="+" if a.strand > 0 else "-",
            )
            for _u, res in all_results
            for a in res.annotations
        ]
    )
    log.info(
        "apa mixture: %d genes fit, %d PDUI genes, %d component sites",
        len(all_results), len(pdui_names) // 2, len(mixture_names),
    )
    return ApaMixtureResult(
        mixture=mixture, mixture_names=mixture_names,
        pdui=pdui, pdui_names=pdui_names,
        barcodes=barcodes, annotations=ann_df,
    )
