"""Gene models from GFF3 / GTF (the port's copy of `GeneModel` and
`parse_gff_genes` from the JAX package's `faba/genes.py`; GFF handling
after `genomic-data/src/gff.rs`).

The read-counting functions of that module (`assign_reads_to_genes`,
`count_genes*`, `parse_gff_exons`) read BAM files and come with the
port's BAM reader.
"""

from __future__ import annotations

import gzip
import re
from dataclasses import dataclass

import numpy as np



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
