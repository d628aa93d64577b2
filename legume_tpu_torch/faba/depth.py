"""`faba depth` — per-cell coverage features and BED utilities
(`faba depth` + `genomic-data/src/bed.rs` equivalents).

The port's copy of the JAX package's `faba/depth.py` (numpy and scipy
on the host, as there).
"""

from __future__ import annotations

import gzip
import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .bam import read_bam

log = logging.getLogger(__name__)


@dataclass
class BedIntervals:
    chrom: list
    start: np.ndarray
    end: np.ndarray
    name: list


def read_bed(path: str) -> BedIntervals:
    """BED3/BED4+ reader (bed.rs)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    chrom, start, end, name = [], [], [], []
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith(("#", "track", "browser")):
                continue
            p = line.split()
            if len(p) < 3:
                continue
            chrom.append(p[0])
            start.append(int(p[1]))
            end.append(int(p[2]))
            name.append(p[3] if len(p) > 3 else f"{p[0]}:{p[1]}-{p[2]}")
    return BedIntervals(
        chrom=chrom,
        start=np.asarray(start, np.int64),
        end=np.asarray(end, np.int64),
        name=name,
    )


def depth_per_region(
    bam_path: str,
    bed: BedIntervals,
    *,
    min_mapq: int = 20,
    use_index: bool = False,
) -> tuple[sp.csc_matrix, list, list]:
    """(coverage [n_regions, n_cells], region names, barcodes):
    deduped read counts overlapping each region.

    `use_index=True` fetches only the BED windows via the `.bai`
    (built on first use) instead of streaming the whole file — the
    reference's per-region rust-htslib fetch loop. The barcode axis
    then covers only in-region cells (the fetch-loop semantics);
    whole-file streaming keeps every barcode in the file as a
    (possibly all-zero) column."""
    if use_index:
        from .bam import read_bam_regions

        recs = read_bam_regions(
            bam_path,
            [(c, int(s), int(e)) for c, s, e in
             zip(bed.chrom, bed.start, bed.end)],
        )
    else:
        recs = read_bam(bam_path)
    keep = (recs.mapq >= min_mapq) & (recs.cb_id >= 0) & ((recs.flag & 0x904) == 0)
    rid = recs.ref_id[keep]
    pos = recs.pos[keep]
    end = recs.end_pos[keep]
    cb = recs.cb_id[keep]
    umi = recs.umi_id[keep]
    # (cell, umi, position) dedup
    tbl = np.stack([rid, pos, cb, umi])
    _, first = np.unique(tbl, axis=1, return_index=True)
    rid, pos, end, cb = rid[first], pos[first], end[first], cb[first]

    ref_idx = {n: i for i, n in enumerate(recs.ref_names)}
    rows, cols = [], []
    for r, (c, s, e) in enumerate(zip(bed.chrom, bed.start, bed.end)):
        ci = ref_idx.get(c)
        if ci is None:
            continue
        hit = (rid == ci) & (pos < e) & (end > s)
        rows.extend([r] * int(hit.sum()))
        cols.extend(cb[hit].tolist())
    counts = sp.coo_matrix(
        (np.ones(len(rows), np.float32), (rows, cols)),
        shape=(len(bed.name), len(recs.barcodes)),
    ).tocsc()
    return counts, list(bed.name), recs.barcodes


def depth_matrix_uniform(
    bam_path: str,
    *,
    resolution_bp: int,
    min_mapq: int = 20,
    cb_tag: str = "CB",
) -> tuple[sp.csc_matrix, list, list]:
    """Per-cell depth over UNIFORM genome tiles (PipelineArgs
    depth_resolution_kb, read_depth/run.rs role): contigs come from
    the BAM header, rows are `{chr}:{start}-{end}` tiles, entries are
    deduped molecule counts whose alignment start falls in the tile."""
    from .bam import read_bam, read_bam_contigs

    recs = read_bam(bam_path, cb_tag=cb_tag)
    contigs = read_bam_contigs(bam_path)
    keep = (
        (recs.mapq >= min_mapq) & (recs.cb_id >= 0)
        & ((recs.flag & 0x904) == 0)
    )
    rid = recs.ref_id[keep]
    pos = recs.pos[keep]
    cb = recs.cb_id[keep]
    umi = recs.umi_id[keep]
    tbl = np.stack([rid, pos, cb, umi])
    _, first = np.unique(tbl, axis=1, return_index=True)
    rid, pos, cb = rid[first], pos[first], cb[first]

    # global tile index: per-contig offsets into one row axis
    n_tiles = [max((ln + resolution_bp - 1) // resolution_bp, 1)
               for _, ln in contigs]
    offset = np.concatenate([[0], np.cumsum(n_tiles)])
    names = [
        f"{name}:{t * resolution_bp}-{min((t + 1) * resolution_bp, ln)}"
        for (name, ln), nt in zip(contigs, n_tiles)
        for t in range(nt)
    ]
    tile = offset[rid] + np.minimum(
        pos // resolution_bp, np.asarray(n_tiles)[rid] - 1
    )
    counts = sp.coo_matrix(
        (np.ones(len(tile), np.float32), (tile, cb)),
        shape=(int(offset[-1]), len(recs.barcodes)),
    ).tocsc()
    return counts, names, recs.barcodes
