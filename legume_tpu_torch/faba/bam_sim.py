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


# ---- a wild-type / control pair with planted edits, SNPs and poly(A) sites ----

EDIT_READ_LEN = 91  # 10x 3' v3 read 2
EDIT_GENE_LEN, EDIT_GENE_STRIDE = 2000, 3000
PAS_GAP, PAS_JITTER, UTR_LEN = 250, 8, 600  # proximal to distal; read-end scatter; GFF UTR
SITE_STEP = 4  # planted sites lie at least this far apart (a RAC motif spans 3 bases)
_BASES = np.frombuffer(b"ACGT", np.uint8)
_OTHER = {b: np.asarray([c for c in b"ACGT" if c != b], np.uint8) for b in b"ACGT"}


def _edit_layout(n_genes: int):
    """Genes alternate + / - strand, N_CHROMS contigs; returns the gene
    contig, start, strand and its proximal and distal poly(A) sites."""
    per_chrom = -(-max(n_genes, 1) // N_CHROMS)
    g = np.arange(n_genes)
    chrom = np.minimum(g // per_chrom, N_CHROMS - 1)
    start = 1000 + (g - chrom * per_chrom) * EDIT_GENE_STRIDE
    strand = np.where(g % 2 == 0, 1, -1)
    distal = np.where(strand > 0, start + EDIT_GENE_LEN - 20, start + 20)
    proximal = distal - strand * PAS_GAP
    length = int(1000 + (per_chrom + 1) * EDIT_GENE_STRIDE)
    return chrom, start, strand, np.stack([proximal, distal], 1), length


def _write_edit_gff(path, genes, chrom_names, chrom, start, strand, pas):
    """gene, exon (the gene's span) and three_prime_UTR rows, 1-based."""
    with open(path, "w") as f:
        for i, name in enumerate(genes):
            c, s, sd = chrom_names[chrom[i]], int(start[i]), "+" if strand[i] > 0 else "-"
            d = int(pas[i, 1])
            lo, hi = (d - UTR_LEN, d) if strand[i] > 0 else (d, d + UTR_LEN)
            f.write(f"{c}\tsim\tgene\t{s + 1}\t{s + EDIT_GENE_LEN}\t.\t{sd}\t.\t"
                    f"ID=gene:{name};Name={name}\n")
            f.write(f"{c}\tsim\texon\t{s + 1}\t{s + EDIT_GENE_LEN}\t.\t{sd}\t.\t"
                    f"Parent=gene:{name};Name={name}\n")
            f.write(f"{c}\tsim\tthree_prime_UTR\t{lo + 1}\t{hi}\t.\t{sd}\t.\t"
                    f"Parent=gene:{name};Name={name}\n")


def simulate_edit_pair(
    wt_bam: str,
    control_bam: str,
    gff_path: str,
    fasta_path: str,
    *,
    n_cells: int = 200,
    n_genes: int = 40,
    umis_per_cell: int = 60,
    atoi_sites: int = 20,
    m6a_sites: int = 20,
    snps: int = 20,
    edit_rate: tuple[float, float] = (0.1, 0.3),
    error_rate: float = 1e-3,
    seed: int = 0,
) -> dict:
    """Write a wild-type and a control 10x-style BAM (CB / UB tags, MD
    tags, reads of EDIT_READ_LEN bases), their GFF (genes, exons, 3'
    UTRs) and the reference FASTA, with planted truth:

    - two poly(A) sites per gene, PAS_GAP apart in its 3' UTR; a
      molecule ends at one of them (the distal one with the gene's
      `usage`), PAS_JITTER bases of scatter upstream, and its read is
      the last EDIT_READ_LEN aligned bases before it;
    - `atoi_sites` A-to-G sites and `m6a_sites` C-to-T sites in a RAC
      motif (GTY on minus-strand genes, where the reference shows T-to-C
      and G-to-A), each edited in the wild type only at a rate drawn
      from `edit_rate`;
    - `snps` heterozygous germline SNPs, each molecule of either arm
      carrying the alternative allele with probability 0.5;
    - sequencing errors at `error_rate` a base, independent per read.

    Sites lie where every read of their poly(A) site covers them. Each
    UMI is read 1-3 times (PCR duplicates). Returns per arm (`wt`,
    `control`) the planted gene counts after UMI dedup (genes x cells
    CSC, the barcodes in the reader's order), `barcodes`, the molecules'
    `mol_ref`, `mol_start` and `mol_cell` and `n_reads`; and `genes`,
    `atoi` / `m6a` (chrom, 0-based pos, strand, rate), `snps` (chrom,
    pos, ref, alt) and `pas` (gene, proximal, distal, usage)."""
    rng = np.random.default_rng(seed)
    chrom, start, strand, pas, length = _edit_layout(n_genes)
    chrom_names = [f"chr{i + 1}" for i in range(N_CHROMS)]
    genes = [f"E{i:05d}" for i in range(n_genes)]
    genome = [_BASES[rng.integers(0, 4, length)].copy() for _ in chrom_names]

    # planted sites: positions every reads of a window covers, SITE_STEP apart
    lo = np.where(strand[:, None] > 0, pas - EDIT_READ_LEN, pas + PAS_JITTER) + 2
    hi = np.where(strand[:, None] > 0, pas - PAS_JITTER, pas + EDIT_READ_LEN) - 2
    slots = [(g, w, p) for g in range(n_genes) for w in range(2)
             for p in range(int(lo[g, w]), int(hi[g, w]), SITE_STEP)]
    need = atoi_sites + m6a_sites + snps
    if need > len(slots):
        raise ValueError(f"{need} sites do not fit in {len(slots)} slots")
    pick = rng.choice(len(slots), need, replace=False)
    kinds = np.repeat([0, 1, 2], [atoi_sites, m6a_sites, snps])  # atoi, m6a, snp
    sites = []  # (gene, window, pos, kind, ref base, read base, rate)
    for (g, w, p), kind in zip((slots[i] for i in pick), kinds):
        seq, plus = genome[chrom[g]], strand[g] > 0
        if kind == 0:
            seq[p] = ord("A") if plus else ord("T")
            alt, rate = (ord("G") if plus else ord("C")), rng.uniform(*edit_rate)
        elif kind == 1:
            if plus:
                seq[p - 2], seq[p - 1], seq[p] = rng.choice(list(b"AG")), ord("A"), ord("C")
            else:
                seq[p], seq[p + 1], seq[p + 2] = ord("G"), ord("T"), rng.choice(list(b"CT"))
            alt, rate = (ord("T") if plus else ord("A")), rng.uniform(*edit_rate)
        else:
            alt, rate = int(rng.choice(_OTHER[int(seq[p])])), 0.5
        sites.append((g, w, p, kind, int(seq[p]), alt, rate))
    with open(fasta_path, "w") as f:
        for name, seq in zip(chrom_names, genome):
            f.write(f">{name}\n")
            text = seq.tobytes().decode()
            f.write("\n".join(text[i:i + 60] for i in range(0, len(text), 60)) + "\n")
    _write_edit_gff(gff_path, genes, chrom_names, chrom, start, strand, pas)
    by_window: dict = {}
    for s in sites:
        by_window.setdefault((s[0], s[1]), []).append(s)

    usage = rng.uniform(0.2, 0.8, n_genes)
    base = rng.gamma(0.6, 1.0, n_genes) + 1e-3
    refs = [(c, length) for c in chrom_names]
    out = {"genes": genes, "pas": [(genes[g], int(pas[g, 0]), int(pas[g, 1]), float(usage[g]))
                                   for g in range(n_genes)]}
    for kind, name in ((0, "atoi"), (1, "m6a")):
        out[name] = [(chrom_names[chrom[g]], p, "+" if strand[g] > 0 else "-", rate)
                     for g, w, p, k, _, _, rate in sites if k == kind]
    out["snps"] = [(chrom_names[chrom[g]], p, chr(ref), chr(alt))
                   for g, w, p, k, ref, alt, _ in sites if k == 2]
    for arm, path, prefix in (("wt", wt_bam, "W"), ("control", control_bam, "C")):
        out[arm] = _write_edit_arm(path, refs, genome, rng, arm == "wt", prefix, genes, chrom,
                                   strand, pas, usage, base, by_window, n_cells, umis_per_cell,
                                   error_rate)
    return out


def _write_edit_arm(path, refs, genome, rng, wild_type, prefix, genes, chrom, strand, pas, usage,
                    base, by_window, n_cells, umis_per_cell, error_rate) -> dict:
    n_genes = len(genes)
    sizes = rng.poisson(umis_per_cell, n_cells).clip(1)
    cell = np.repeat(np.arange(n_cells), sizes)
    gene = np.empty(len(cell), np.int64)
    off = 0
    for c in range(n_cells):
        gene[off: off + sizes[c]] = rng.choice(n_genes, sizes[c], p=rng.dirichlet(base * 5.0))
        off += sizes[c]
    umi = np.arange(len(cell)) - np.repeat(np.cumsum(sizes) - sizes, sizes)
    window = (rng.random(len(cell)) < usage[gene]).astype(np.int64)  # 1 = distal
    jitter = rng.integers(0, PAS_JITTER, len(cell))
    site_pas = pas[gene, window]
    mol_start = np.where(strand[gene] > 0, site_pas - jitter - EDIT_READ_LEN, site_pas + jitter)
    # each molecule's alleles at the planted sites of its window
    events: dict = {}
    for (g, w), ws in by_window.items():
        mols = np.nonzero((gene == g) & (window == w))[0]
        for _, _, p, kind, _, alt, rate in ws:
            if kind < 2 and not wild_type:
                continue
            for m in mols[rng.random(len(mols)) < rate]:
                events.setdefault(int(m), []).append((p, alt))
    copies = rng.integers(1, MAX_COPIES + 1, len(cell))
    r = np.repeat(np.arange(len(cell)), copies)
    r = r[np.lexsort((r, mol_start[r], chrom[gene[r]]))]
    first_seen = np.unique(cell[r], return_index=True)[1]
    seen_order = cell[r][np.sort(first_seen)]
    col = np.empty(n_cells, np.int64)
    col[seen_order] = np.arange(len(seen_order))
    barcodes_all = [f"{prefix}{c:06d}-1" for c in range(n_cells)]
    n_err = rng.binomial(EDIT_READ_LEN, error_rate, len(r))
    err_draw = rng.random((len(r), 2))

    def reads():
        for i, m in enumerate(r):
            m = int(m)
            seq0 = genome[chrom[gene[m]]]
            s = int(mol_start[m])
            read = seq0[s: s + EDIT_READ_LEN].copy()
            subs = {p - s: (int(seq0[p]), a) for p, a in events.get(m, ())}
            for k in range(n_err[i]):
                o = int(err_draw[i, 0] * EDIT_READ_LEN + 37 * k) % EDIT_READ_LEN
                if o not in subs:
                    ref = int(read[o])
                    subs[o] = (ref, int(_OTHER[ref][int(err_draw[i, 1] * 3)]))
            md, last = [], 0
            for o in sorted(subs):
                read[o] = subs[o][1]
                md.append(f"{o - last}{chr(subs[o][0])}")
                last = o + 1
            md.append(str(EDIT_READ_LEN - last))
            yield {"name": f"{prefix}r{i}", "ref_id": int(chrom[gene[m]]), "pos": s,
                   "seq": read.tobytes().decode(), "cigar": f"{EDIT_READ_LEN}M",
                   "cb": barcodes_all[cell[m]], "ub": f"{umi[m]:010d}", "md": "".join(md)}

    write_bam(path, refs, reads())
    counts = sp.coo_matrix((np.ones(len(cell), np.float32), (gene, col[cell])),
                           shape=(n_genes, len(seen_order))).tocsc()
    counts.sum_duplicates()
    return {"genes": counts, "barcodes": [barcodes_all[c] for c in seen_order],
            "mol_ref": chrom[gene], "mol_start": mol_start, "mol_cell": col[cell],
            "n_reads": int(len(r))}
