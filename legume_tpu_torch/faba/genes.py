"""`faba genes`: per-cell gene counting from BAM, and gene models from
GFF3 / GTF (the port's copy of the JAX package's `faba/genes.py`; GFF
handling after `genomic-data/src/gff.rs`).

Reads stream from the native BAM layer (`faba/bam.py`); a read takes the
gene whose interval holds its midpoint, and (cell, UMI, gene) dedup
collapses PCR duplicates. The counts are a genes x cells CSC matrix.
"""

from __future__ import annotations

import gzip
import logging
import re
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from .bam import read_bam

log = logging.getLogger(__name__)



@dataclass
class GeneModel:
    names: list[str]  # gene names
    chrom: np.ndarray  # chromosome name index per gene
    start: np.ndarray  # int64, 0-based
    end: np.ndarray
    strand: np.ndarray  # +1 / -1
    chrom_names: list[str]


def parse_gff_genes(
    path: str, *, feature: str = "gene", gene_type: str | None = None
) -> GeneModel:
    """Minimal GFF3/GTF gene extractor (gff.rs parity for the gene map).
    `gene_type` filters on the biotype attribute
    (gene_biotype/gene_type/biotype — gff.rs GeneType matching)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    names, chroms, starts, ends, strands = [], [], [], [], []
    name_re = re.compile(r'(?:gene_name[= "]+|Name=)([\w.\-]+)')
    id_re = re.compile(r'(?:gene_id[= "]+|ID=(?:gene:)?)([\w.\-]+)')
    type_re = re.compile(r'(?:gene_biotype|gene_type|biotype)[= "]+([\w.\-]+)')
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9 or parts[2] != feature:
                continue
            attr = parts[8]
            if gene_type is not None:
                tm = type_re.search(attr)
                if tm is None or tm.group(1) != gene_type:
                    continue
            m = name_re.search(attr) or id_re.search(attr)
            if not m:
                continue
            names.append(m.group(1))
            chroms.append(parts[0])
            starts.append(int(parts[3]) - 1)
            ends.append(int(parts[4]))
            strands.append(1 if parts[6] != "-" else -1)
    chrom_names = sorted(set(chroms))
    cidx = {c: i for i, c in enumerate(chrom_names)}
    return GeneModel(
        names=names,
        chrom=np.asarray([cidx[c] for c in chroms], np.int64),
        start=np.asarray(starts, np.int64),
        end=np.asarray(ends, np.int64),
        strand=np.asarray(strands, np.int8),
        chrom_names=chrom_names,
    )


def assign_reads_to_genes(
    ref_id: np.ndarray,
    pos: np.ndarray,
    end_pos: np.ndarray,
    ref_names: list[str],
    model: GeneModel,
) -> np.ndarray:
    """Gene index per read (-1 = intergenic/ambiguous-none). A read is
    assigned to the gene whose interval contains its start (midpoint
    rule falls back to overlap-any)."""
    chrom_of_ref = np.asarray(
        [model.chrom_names.index(r) if r in model.chrom_names else -1 for r in ref_names],
        np.int64,
    )
    out = np.full(len(ref_id), -1, np.int64)
    for c in range(len(model.chrom_names)):
        gmask = model.chrom == c
        if not gmask.any():
            continue
        g_start = model.start[gmask]
        g_end = model.end[gmask]
        g_ids = np.nonzero(gmask)[0]
        order = np.argsort(g_start)
        g_start, g_end, g_ids = g_start[order], g_end[order], g_ids[order]

        rmask = chrom_of_ref[ref_id] == c
        if not rmask.any():
            continue
        mid = (pos[rmask] + end_pos[rmask]) // 2
        slot = np.searchsorted(g_start, mid, side="right") - 1
        ok = slot >= 0
        # check containment (non-overlapping gene models assumption;
        # nested/overlapping genes resolve to the nearest-start gene)
        ok &= mid < g_end[np.clip(slot, 0, len(g_end) - 1)]
        res = np.full(rmask.sum(), -1, np.int64)
        res[ok] = g_ids[slot[ok]]
        out[np.nonzero(rmask)[0]] = res
    return out


def parse_gff_exons(path: str, model: GeneModel) -> dict[int, np.ndarray]:
    """Merged exon intervals per gene index (feature=exon rows matched
    to the gene map by gene_id/Parent; gene_count/splice.rs gene view).
    Genes with no exon rows get their full span (single-exon model)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    gidx = {n: i for i, n in enumerate(model.names)}
    name_re = re.compile(r'(?:gene_name[= "]+|Name=)([\w.\-]+)')
    id_re = re.compile(r'(?:gene_id[= "]+|Parent=(?:gene:)?|ID=(?:gene:)?)([\w.\-]+)')
    raw: dict[int, list] = {}
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("#"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 9 or parts[2] != "exon":
                continue
            m = name_re.search(parts[8]) or id_re.search(parts[8])
            if not m or m.group(1) not in gidx:
                continue
            raw.setdefault(gidx[m.group(1)], []).append(
                (int(parts[3]) - 1, int(parts[4]))
            )
    out: dict[int, np.ndarray] = {}
    for g in range(len(model.names)):
        if g not in raw:
            out[g] = np.asarray([[model.start[g], model.end[g]]], np.int64)
            continue
        ivs = sorted(raw[g])
        merged = [list(ivs[0])]
        for s, e in ivs[1:]:
            if s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        out[g] = np.asarray(merged, np.int64)
    return out


def _inside_one_exon(exons: dict[int, np.ndarray], gene: np.ndarray, pos: np.ndarray,
                     end: np.ndarray) -> np.ndarray:
    """Whether each read lies inside one merged exon of its gene: the
    last exon of the gene starting at or before the read's start must
    also hold its end. One search over all genes' exons keyed by (gene,
    start), as the JAX package's per-read search within each gene."""
    n_g = len(exons)
    lens = np.asarray([len(exons[g]) for g in range(n_g)], np.int64)
    first = np.concatenate([[0], np.cumsum(lens)])
    ivs = np.concatenate([exons[g] for g in range(n_g)]) if n_g else np.zeros((0, 2), np.int64)
    owner = np.repeat(np.arange(n_g, dtype=np.int64), lens)
    keys = (owner << 32) + ivs[:, 0]
    gene = gene.astype(np.int64)
    j = np.searchsorted(keys, (gene << 32) + pos.astype(np.int64), side="right") - 1
    ok = j >= first[gene]
    jj = np.clip(j, 0, max(len(ivs) - 1, 0))
    return ok & (pos >= ivs[jj, 0]) & (end <= ivs[jj, 1])


def count_genes_spliced(
    bam_path: str,
    gff_path: str,
    *,
    min_mapq: int = 20,
    dedup_umi: bool = True,
    gene_barcode_tag: "str | None" = None,
) -> tuple[sp.csc_matrix, sp.csc_matrix, list[str], list[str]]:
    """(spliced, unspliced, gene_names, barcodes) — the velocity input
    (`faba genes --splice`; gene_count/splice.rs, velocyto convention):

    - CIGAR carries an N op (junction-spanning) -> SPLICED
    - else read lies fully inside the gene's exon union -> SPLICED
    - else (overlaps intronic sequence) -> UNSPLICED
    """
    recs = read_bam(bam_path, gene_tag=gene_barcode_tag)
    model = parse_gff_genes(gff_path)
    exons = parse_gff_exons(gff_path, model)
    keep = (recs.mapq >= min_mapq) & (recs.cb_id >= 0) & ((recs.flag & 0x904) == 0)
    idx = np.nonzero(keep)[0]
    gene = assign_reads_to_genes(
        recs.ref_id[keep], recs.pos[keep], recs.end_pos[keep], recs.ref_names, model
    )
    if gene_barcode_tag:
        gene = _apply_gene_tag_keying(gene, recs, keep, model)
    ok = gene >= 0
    idx, gene = idx[ok], gene[ok]
    cb = recs.cb_id[idx]
    umi = recs.umi_id[idx]
    pos = recs.pos[idx]
    end = recs.end_pos[idx]
    skip = (
        recs.has_skip[idx].astype(bool)
        if recs.has_skip is not None
        else np.zeros(len(idx), bool)
    )

    spliced_mask = skip | _inside_one_exon(exons, gene, pos, end)

    def tally(sel):
        g, c, u = gene[sel], cb[sel], umi[sel]
        if dedup_umi and len(u) and u.max() >= 0:
            _, first = np.unique(np.stack([c, u, g]), axis=1, return_index=True)
            g, c = g[first], c[first]
        return sp.coo_matrix(
            (np.ones(len(g), np.float32), (g, c)),
            shape=(len(model.names), len(recs.barcodes)),
        ).tocsc()

    spliced = tally(spliced_mask)
    unspliced = tally(~spliced_mask)
    log.info(
        "faba genes --splice: %d spliced / %d unspliced UMIs",
        spliced.nnz, unspliced.nnz,
    )
    return spliced, unspliced, list(model.names), list(recs.barcodes)


def _apply_gene_tag_keying(
    gene: np.ndarray,  # [n_keep] GFF-overlap gene indices
    recs,
    keep: np.ndarray,
    model: GeneModel,
) -> np.ndarray:
    """Aligner-assigned gene keying (`--gene-barcode-tag`, CellRanger
    GX; faba/src/m6a/run.rs DartSeqCountArgs): where a read carries the
    gene tag, the TAG decides the gene — GFF overlap keeps only the
    untagged reads (multi-overlap reads disagree between the two
    keyings; CellRanger-aligned BAMs must follow the aligner). Tag
    values match the model by gene name/id; tagged reads whose value is
    absent from the model drop (-1)."""
    if recs.gene_id is None:
        return gene
    gidx = {n: i for i, n in enumerate(model.names)}
    tag_to_model = np.asarray(
        [gidx.get(nm, -1) for nm in (recs.gene_names or [])], np.int64
    )
    tagged = recs.gene_id[keep]
    has_tag = tagged >= 0
    g_tag = np.where(
        has_tag, tag_to_model[np.maximum(tagged, 0)] if len(tag_to_model) else -1, -1
    )
    n_flip = int((has_tag & (g_tag != gene)).sum())
    if n_flip:
        log.info(
            "gene-tag keying: %d/%d tagged reads re-keyed vs GFF overlap",
            n_flip, int(has_tag.sum()),
        )
    return np.where(has_tag, g_tag, gene)


def count_genes(
    bam_path: str,
    gff_path: str,
    *,
    min_mapq: int = 20,
    dedup_umi: bool = True,
    cb_tag: str = "CB",
    umi_tag: str = "UB",
    gene_type: "str | None" = None,
    gene_barcode_tag: "str | None" = None,
) -> tuple[sp.csc_matrix, list[str], list[str]]:
    """(counts [genes x cells], gene_names, barcodes)."""
    recs = read_bam(
        bam_path, cb_tag=cb_tag, umi_tag=umi_tag, gene_tag=gene_barcode_tag
    )
    model = parse_gff_genes(gff_path, gene_type=gene_type)
    keep = (recs.mapq >= min_mapq) & (recs.cb_id >= 0) & ((recs.flag & 0x904) == 0)
    gene = assign_reads_to_genes(
        recs.ref_id[keep], recs.pos[keep], recs.end_pos[keep], recs.ref_names, model
    )
    if gene_barcode_tag:
        gene = _apply_gene_tag_keying(gene, recs, keep, model)
    cb = recs.cb_id[keep]
    umi = recs.umi_id[keep]
    ok = gene >= 0
    gene, cb, umi = gene[ok], cb[ok], umi[ok]

    if dedup_umi and len(umi) and umi.max() >= 0:
        # unique (cell, umi, gene) triples count once (dna_stat_map dedup)
        tbl = np.stack([cb, umi, gene])
        _, first = np.unique(tbl, axis=1, return_index=True)
        gene, cb = gene[first], cb[first]

    n_cells = len(recs.barcodes)
    n_genes = len(model.names)
    counts = sp.coo_matrix(
        (np.ones(len(gene), np.float32), (gene, cb)), shape=(n_genes, n_cells)
    ).tocsc()
    log.info(
        "faba genes: %d reads -> %d UMIs, %d genes x %d cells",
        int(keep.sum()), counts.nnz, n_genes, n_cells,
    )
    return counts, list(model.names), list(recs.barcodes)
