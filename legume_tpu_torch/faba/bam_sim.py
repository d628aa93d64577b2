"""A coordinate-sorted, 10x-style BAM with planted gene counts, and the
GFF of its genes: the input `faba genes` reads, made from a seed.

Each gene spans 3,000 bp with three 300-bp exons (at 0, 1,200 and 2,700
of its span) and lies on a 5,000-bp stride of its chromosome; a few
genes sit on `chrM`. Every cell draws its UMIs over the genes from a
per-cell profile; each UMI is a read class of its gene:

- a junction read, `50M900N50M` from exon 1 into exon 2 (spliced);
- an exonic read, `100M` inside one exon (spliced);
- an intronic read, `100M` inside the first intron (unspliced);

and is sequenced 1-3 times (PCR duplicates that UMI dedup collapses).
Reads carry CB, UB and GX tags. `simulate_10x_bam` returns the planted
spliced and unspliced UMI counts (genes x cells, CSC), which
`count_genes_spliced` must give back exactly, and `count_genes` their
sum.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from .bam import write_bam

GENE_LEN, GENE_STRIDE, N_CHROMS = 3000, 5000, 4
SPLICED_FRAC, EXONIC_FRAC, MAX_COPIES = 0.2, 0.4, 3  # of the UMIs; PCR copies a UMI
EXONS = ((0, 300), (1200, 1500), (2700, 3000))
READ_LEN = 100
_SEQ = "ACGT" * (READ_LEN // 4)
_CIGARS = ("50M900N50M", f"{READ_LEN}M", f"{READ_LEN}M")  # junction, exonic, intronic


def write_gff(path: str, genes: list[str], chroms: list[str], starts: np.ndarray):
    """GFF3 gene + exon rows (1-based inclusive) for the simulated genes."""
    with open(path, "w") as f:
        for g, c, s in zip(genes, chroms, starts):
            s = int(s)
            f.write(f"{c}\tsim\tgene\t{s + 1}\t{s + GENE_LEN}\t.\t+\t.\tID=gene:{g};Name={g}\n")
            for a, b in EXONS:
                f.write(f"{c}\tsim\texon\t{s + a + 1}\t{s + b}\t.\t+\t.\tParent=gene:{g};Name={g}\n")


def simulate_10x_bam(
    bam_path: str,
    gff_path: str,
    *,
    n_cells: int = 200,
    n_genes: int = 100,
    umis_per_cell: int = 50,
    n_mito: int = 0,
    seed: int = 0,
) -> dict:
    """Write the BAM and GFF; returns `spliced`, `unspliced` (planted
    UMI counts, genes x cells CSC float32), `genes`, `barcodes` (in the
    order of first appearance in the BAM, the order the reader interns
    them), `n_reads` and `n_umis`. SPLICED_FRAC of the UMIs are junction
    reads, EXONIC_FRAC exonic, the rest intronic; the last `n_mito` genes
    lie on `chrM`."""
    rng = np.random.default_rng(seed)
    n_nuc = n_genes - n_mito
    per_chrom = -(-max(n_nuc, 1) // N_CHROMS)
    gene_chrom = np.concatenate([np.minimum(np.arange(n_nuc) // per_chrom, N_CHROMS - 1),
                                 np.full(n_mito, N_CHROMS)]).astype(np.int64)
    gene_slot = np.concatenate([np.arange(n_nuc) - (np.minimum(np.arange(n_nuc) // per_chrom,
                                                               N_CHROMS - 1) * per_chrom),
                                np.arange(n_mito)])
    starts = 1000 + gene_slot * GENE_STRIDE
    chrom_names = [f"chr{i + 1}" for i in range(N_CHROMS)] + ["chrM"]
    refs = [(c, int(1000 + (max(per_chrom, n_mito) + 1) * GENE_STRIDE)) for c in chrom_names]
    genes = [f"G{i:05d}" for i in range(n_genes)]
    write_gff(gff_path, genes, [chrom_names[c] for c in gene_chrom], starts)

    # per-cell UMIs: gene from a per-cell Dirichlet profile, a read class
    base = rng.gamma(0.6, 1.0, n_genes) + 1e-3
    sizes = rng.poisson(umis_per_cell, n_cells).clip(1)
    cell = np.repeat(np.arange(n_cells), sizes)
    gene = np.empty(len(cell), np.int64)
    off = 0
    for c in range(n_cells):
        prof = rng.dirichlet(base * 5.0)
        gene[off : off + sizes[c]] = rng.choice(n_genes, sizes[c], p=prof)
        off += sizes[c]
    umi = np.arange(len(cell)) - np.repeat(np.cumsum(sizes) - sizes, sizes)  # unique in a cell
    u = rng.random(len(cell))
    kind = np.where(u < SPLICED_FRAC, 0, np.where(u < SPLICED_FRAC + EXONIC_FRAC, 1, 2))
    exon = rng.integers(0, len(EXONS), len(cell))
    ex_lo = np.asarray([a for a, _ in EXONS])[exon]
    ex_hi = np.asarray([b for _, b in EXONS])[exon] - READ_LEN
    rel = np.where(kind == 0, EXONS[0][1] - 50,
                   np.where(kind == 1, ex_lo + (rng.random(len(cell)) * (ex_hi - ex_lo + 1)).astype(np.int64),
                            400 + rng.integers(0, 600, len(cell))))
    pos = starts[gene] + rel
    copies = rng.integers(1, MAX_COPIES + 1, len(cell))
    r = np.repeat(np.arange(len(cell)), copies)
    order = np.lexsort((r, pos[r], gene_chrom[gene[r]]))
    r = r[order]

    barcodes_all = [f"CELL{c:06d}-1" for c in range(n_cells)]
    first_seen = np.unique(cell[r], return_index=True)[1]
    seen_order = cell[r][np.sort(first_seen)]

    def reads():
        chrom_r, pos_r, cell_r = gene_chrom[gene[r]], pos[r], cell[r]
        umi_r, gene_r, kind_r = umi[r], gene[r], kind[r]
        for i in range(len(r)):
            yield {
                "name": f"r{i}", "ref_id": int(chrom_r[i]), "pos": int(pos_r[i]),
                "seq": _SEQ, "cigar": _CIGARS[kind_r[i]], "cb": barcodes_all[cell_r[i]],
                "ub": f"{umi_r[i]:010d}", "gx": genes[gene_r[i]],
            }

    write_bam(bam_path, refs, reads())

    # planted counts, barcodes in the reader's interning order
    col = np.empty(n_cells, np.int64)
    col[seen_order] = np.arange(len(seen_order))
    spliced_m = kind < 2
    shape = (n_genes, len(seen_order))

    def tally(sel):
        return sp.coo_matrix((np.ones(int(sel.sum()), np.float32),
                              (gene[sel], col[cell[sel]])), shape=shape).tocsc()

    return {
        "spliced": tally(spliced_m),
        "unspliced": tally(~spliced_m),
        "genes": genes,
        "barcodes": [barcodes_all[c] for c in seen_order],
        "n_reads": int(len(r)),
        "n_umis": int(len(cell)),
    }
