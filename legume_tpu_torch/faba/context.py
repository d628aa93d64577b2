"""Site-context summaries: pileup / metagene / PWM
(`faba` `pwm`/`pileup`/`metagene` subcommands; faba/README.md:120-150).

All three consume a called-site table (chrom, pos) — the dartseq/atoi
output convention — and produce aggregate views:

- ``pileup_at_sites``: per-offset base composition around each site
  from the BAM mismatch stream + coverage (matches count toward the
  reference base when a FASTA is given).
- ``metagene_profile``: site density / mean signal over normalized,
  strand-aware gene coordinates (the m6A-near-stop-codon picture).
- ``pwm_at_sites``: position weight matrix of the reference sequence
  context around sites + per-position information content (bits).

The port's copy of the JAX package's `faba/context.py` (numpy and scipy
on the host, as there). `pileup_at_sites` counts each position's coverage
from the reads' sorted starts and ends, not base by base: the same
counts, in seconds for a BAM of millions of reads.
"""

from __future__ import annotations

import gzip
import logging
from dataclasses import dataclass

import numpy as np

from .bam import BamRecords
from .genes import GeneModel

log = logging.getLogger(__name__)

BASES = "ACGT"
_BASE_IDX = {ord(b): i for i, b in enumerate(BASES)}
_COMP = str.maketrans("ACGTacgt", "TGCAtgca")


def read_fasta(path: str) -> dict[str, str]:
    """Minimal FASTA reader (no htslib in this image); sequences are
    uppercased, names truncated at the first whitespace."""
    opener = gzip.open if str(path).endswith(".gz") else open
    seqs: dict[str, list[str]] = {}
    name = None
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                name = line[1:].split()[0]
                seqs[name] = []
            elif name is not None:
                seqs[name].append(line.upper())
    return {k: "".join(v) for k, v in seqs.items()}


@dataclass
class Pwm:
    counts: np.ndarray  # [2*flank+1, 4]
    freqs: np.ndarray  # [2*flank+1, 4]
    info_bits: np.ndarray  # [2*flank+1]
    consensus: str
    n_sites: int


def pwm_at_sites(
    fasta: dict[str, str],
    chrom: list[str] | np.ndarray,
    pos: np.ndarray,
    *,
    flank: int = 5,
    strand: np.ndarray | None = None,
    pseudocount: float = 0.5,
) -> Pwm:
    """PWM of the +/-flank reference context; minus-strand sites are
    reverse-complemented so the motif reads 5'->3'."""
    w = 2 * flank + 1
    counts = np.full((w, 4), pseudocount)
    n = 0
    for i, (c, p) in enumerate(zip(chrom, pos)):
        seq = fasta.get(str(c))
        if seq is None:
            continue
        lo, hi = int(p) - flank, int(p) + flank + 1
        if lo < 0 or hi > len(seq):
            continue
        ctx = seq[lo:hi]
        if strand is not None and strand[i] < 0:
            ctx = ctx.translate(_COMP)[::-1]
        ok = True
        for j, b in enumerate(ctx):
            if ord(b) not in _BASE_IDX:
                ok = False
                break
        if not ok:
            continue
        for j, b in enumerate(ctx):
            counts[j, _BASE_IDX[ord(b)]] += 1
        n += 1
    freqs = counts / counts.sum(1, keepdims=True)
    info = np.log2(4.0) + (freqs * np.log2(np.maximum(freqs, 1e-12))).sum(1)
    consensus = "".join(BASES[j] for j in freqs.argmax(1))
    return Pwm(counts=counts, freqs=freqs, info_bits=info, consensus=consensus, n_sites=n)


def pileup_at_sites(
    reads: BamRecords,
    site_ref_id: np.ndarray,
    site_pos: np.ndarray,
    *,
    flank: int = 0,
    fasta: dict[str, str] | None = None,
) -> dict:
    """Aggregate base composition at each offset in [-flank, flank]
    around the sites. Mismatching reads contribute their read base
    (from the MD-tag mismatch stream); matching coverage contributes
    to the reference base when ``fasta`` resolves it, else to a
    separate 'ref' channel."""
    w = 2 * flank + 1
    # channels: A C G T ref
    out = np.zeros((w, 5), np.int64)
    site_set = {}
    for r, p in zip(site_ref_id, site_pos):
        for off in range(-flank, flank + 1):
            site_set.setdefault((int(r), int(p) + off), []).append(off + flank)

    # coverage per (site, offset): reads spanning the position, counted as
    # #(start <= p) - #(end <= p) over each reference's sorted read starts
    # and ends (the JAX package walks every aligned base of every read)
    cov = np.zeros(w, np.int64)
    keys = np.asarray(list(site_set), np.int64).reshape(-1, 2)
    ref_ids = np.asarray(reads.ref_id, np.int64)
    for r in np.unique(keys[:, 0]):
        mine = ref_ids == r
        starts, ends = np.sort(reads.pos[mine]), np.sort(reads.end_pos[mine])
        sel = np.nonzero(keys[:, 0] == r)[0]
        depth = (np.searchsorted(starts, keys[sel, 1], "right")
                 - np.searchsorted(ends, keys[sel, 1], "right"))
        for k, n in zip(sel, depth):
            for sl in site_set[(int(r), int(keys[k, 1]))]:
                cov[sl] += n
    # mismatches: subtract from ref coverage, add to the read base
    mm_n = 0
    if reads.mm_pos is not None:
        for r, p, rb in zip(reads.mm_ref_id, reads.mm_pos, reads.mm_read_base):
            slots = site_set.get((int(r), int(p)))
            if slots:
                b = _BASE_IDX.get(int(rb))
                for sl in slots:
                    if b is not None:
                        out[sl, b] += 1
                    mm_n += 1
                    cov[sl] -= 1
    out[:, 4] = np.maximum(cov, 0)
    if fasta is not None:
        # fold matching coverage into the actual reference base per
        # offset, averaged over sites (aggregate view): distribute the
        # 'ref' channel by the majority reference base at each offset
        ref_counts = np.zeros((w, 4), np.int64)
        # reconstruct ref base composition across sites
        names = reads.ref_names
        for r, p in zip(site_ref_id, site_pos):
            seq = fasta.get(names[int(r)])
            if seq is None:
                continue
            for off in range(-flank, flank + 1):
                q = int(p) + off
                if 0 <= q < len(seq):
                    b = _BASE_IDX.get(ord(seq[q]))
                    if b is not None:
                        ref_counts[off + flank, b] += 1
        dom = ref_counts.argmax(1)
        for sl in range(w):
            out[sl, dom[sl]] += out[sl, 4]
        out[:, 4] = 0
    return {
        "offsets": np.arange(-flank, flank + 1),
        "counts": out,
        "channels": ["A", "C", "G", "T", "ref_match"],
        "n_mismatch": mm_n,
    }


def metagene_profile(
    model: GeneModel,
    ref_names: list[str],
    site_ref_id: np.ndarray,
    site_pos: np.ndarray,
    *,
    value: np.ndarray | None = None,
    bins: int = 50,
) -> dict:
    """Histogram of sites over normalized strand-aware gene coordinates
    (0 = TSS, 1 = TES). Sites outside every gene are dropped; a site in
    k overlapping genes contributes to each."""
    cmap = {c: i for i, c in enumerate(model.chrom_names)}
    chrom_of_ref = np.asarray([cmap.get(r, -1) for r in ref_names], np.int64)
    hist = np.zeros(bins, np.float64)
    vsum = np.zeros(bins, np.float64)
    n_assigned = 0
    for i, (r, p) in enumerate(zip(site_ref_id, site_pos)):
        c = chrom_of_ref[int(r)]
        if c < 0:
            continue
        gm = (model.chrom == c) & (model.start <= p) & (p < model.end)
        for g in np.nonzero(gm)[0]:
            span = max(int(model.end[g] - model.start[g]), 1)
            frac = (int(p) - int(model.start[g])) / span
            if model.strand[g] < 0:
                frac = 1.0 - frac
            b = min(int(frac * bins), bins - 1)
            hist[b] += 1
            if value is not None:
                vsum[b] += float(value[i])
            n_assigned += 1
    out = {
        "bin_centers": (np.arange(bins) + 0.5) / bins,
        "density": hist / max(hist.sum(), 1.0),
        "counts": hist,
        "n_assigned": n_assigned,
    }
    if value is not None:
        out["mean_value"] = vsum / np.maximum(hist, 1.0)
    return out


def pwm_from_reads(
    bam_paths: list,
    fasta: dict,
    chrom,
    pos: np.ndarray,
    *,
    flank: int = 5,
    strand: np.ndarray | None = None,
    min_mapq: int = 20,
    pseudocount: float = 0.5,
) -> Pwm:
    """PWM from READ evidence around each site (`scan_pwm.rs
    FreqSource::Reads`): at every (site, offset) position, mismatching
    reads contribute their read base (MD-tag stream) and matching
    coverage contributes the reference base. DIVERGENCE: the columnar
    reader streams read bases only at mismatches, so the FASTA is
    required here to attribute the matching coverage (the reference
    reads it back from each alignment)."""
    from .bam import read_bam
    from .dartseq import coverage_at_sites

    w = 2 * flank + 1
    counts = np.full((w, 4), pseudocount)
    offsets = np.arange(-flank, flank + 1)
    strand = (
        np.ones(len(pos), np.int8) if strand is None
        else np.asarray(strand)
    )
    # window slot per (site, offset), mirrored on the minus strand
    n_sites_used = 0
    for bam in bam_paths:
        recs = read_bam(bam)
        name_to_rid = {n: i for i, n in enumerate(recs.ref_names)}
        rid = np.asarray(
            [name_to_rid.get(str(c), -1) for c in chrom], np.int64
        )
        ok = rid >= 0
        if not ok.any():
            continue
        n_sites_used = max(n_sites_used, int(ok.sum()))
        # [S, W] query positions
        q_pos = pos[ok, None] + offsets[None, :]
        q_rid = np.repeat(rid[ok], w)
        q_flat = q_pos.ravel()
        cov = coverage_at_sites(
            recs, q_rid, q_flat, min_mapq=min_mapq
        ).astype(np.int64).reshape(-1, w)
        # mismatch tallies per base at each (site, offset)
        mm_counts = np.zeros((cov.shape[0], w, 4), np.int64)
        if recs.mm_pos is not None and len(recs.mm_pos):
            key_mm = recs.mm_ref_id.astype(np.int64) * (1 << 40) \
                + recs.mm_pos.astype(np.int64)
            order = np.argsort(key_mm, kind="stable")
            key_q = q_rid * (1 << 40) + q_flat
            for bi, b in enumerate(b"ACGT"):
                sel = recs.mm_read_base[order] == b
                ks = key_mm[order][sel]
                lo = np.searchsorted(ks, key_q)
                hi = np.searchsorted(ks, key_q, side="right")
                mm_counts[:, :, bi] = (hi - lo).reshape(-1, w)
        ref_extra = np.maximum(cov - mm_counts.sum(-1), 0)
        # attribute matching coverage to the FASTA reference base
        site_idx = np.nonzero(ok)[0]
        for si, gi in enumerate(site_idx):
            seq = fasta.get(str(chrom[gi]))
            rev = strand[gi] < 0
            for oi, off in enumerate(offsets):
                p = int(pos[gi]) + int(off)
                col = np.array(
                    [mm_counts[si, oi, 0], mm_counts[si, oi, 1],
                     mm_counts[si, oi, 2], mm_counts[si, oi, 3]],
                    np.float64,
                )
                if seq is not None and 0 <= p < len(seq):
                    bi = _BASE_IDX.get(ord(seq[p].upper()))
                    if bi is not None:
                        col[bi] += ref_extra[si, oi]
                if rev:
                    col = col[::-1]  # A<->T, C<->G complement
                    slot = w - 1 - oi
                else:
                    slot = oi
                counts[slot] += col
    freqs = counts / np.maximum(counts.sum(1, keepdims=True), 1e-12)
    info = np.log2(4.0) + (
        freqs * np.log2(np.maximum(freqs, 1e-12))
    ).sum(1)
    consensus = "".join(BASES[j] for j in freqs.argmax(1))
    return Pwm(counts=counts, freqs=freqs, info_bits=info,
               consensus=consensus, n_sites=n_sites_used)
