"""`faba docs` — method write-ups embedded in the package (the port's
copy of the JAX package's `faba/docs.py`: the same index and texts, save
where a text describes how the JAX package runs).

Reference role: `faba/src/docs.rs` — the reference compiles its method docs
into the binary (`include_str!`) so the installed tool can always explain
itself, even on a machine with no checkout beside it.  Same contract here:
the texts live in this module as literals, the index and the texts come from
ONE table, so `faba docs` can never advertise a topic it cannot print.

The write-ups below document this codebase's methods, not the
reference's. They are the JAX package's texts; the posterior write-up says
how the port runs a sweep (a loop over device tensors) where the JAX
package's says how it compiles one.
"""

from __future__ import annotations

_ANNOTATION = """\
MARKER CELL-TYPE ANNOTATION, END TO END
=======================================

Inputs: a fitted latent (cells x topics parquet), a marker panel (GMT: one
gene set per candidate type; a bundled blood panel ships with the package),
and the count backend the latent was fitted on.

1. Cells are pooled into clusters (kmeans or Leiden over the latent;
   `senna clustering`).  Annotation happens at cluster resolution because a
   per-cell marker vote is dominated by sampling noise at typical depths —
   pooling ~100+ cells gives each marker a stable rate estimate.
2. For each (cluster, type) pair we score the panel genes' pooled expression
   against a size-matched permutation null drawn from non-panel genes with a
   similar abundance profile (the GOseq-style stratified null in
   `ops/enrichment.py` removes the detection-rate bias that otherwise favors
   big panels of highly expressed genes).
3. TreeBH (family-wise descent with per-family alpha*gamma budgets) controls
   the selective FDR over the ontology when the panel is hierarchical
   (`senna annotate-ontology`); flat panels use plain BH
   (`senna annotate-by-enrichment`).
4. Clusters whose best call does not beat the null keep the UNASSIGNED
   label rather than inheriting the least-bad type; downstream commands
   treat UNASSIGNED as missing, not as a type.

Outputs: per-cluster label table + per-(cluster, type) score/q parquet.
For embedding-space annotation over a frozen feature embedding (marker
centroids + permutation-z calibration, two-layer fine/coarse merge, ontology
hub calls) see `embedding/type_annotation.py` (`senna bge` models).
"""

_PROFILING = """\
BAM TO PER-CELL FEATURES: m6A, A-to-I, APA, GENE COUNTS, SNPs
=============================================================

All profiling commands share one native reader (`native/bamreader.cpp`, a
from-scratch BGZF/BAM decoder exposed over ctypes): records are decoded into
columnar chunks (positions, CIGAR-aware reference offsets, mismatch channel,
cell barcode + UMI ids), bounds-validated against the declared block size so
corrupt input fails the parse instead of reading out of bounds.

- `faba genes`: per-cell gene counts from exon-model overlap; with
  `--splice`, reads with an N CIGAR op over an exon junction are counted
  into the spliced track, contained reads into the unspliced track
  (spliced/unspliced backends feed `faba gem`).
- `faba dartseq` (m6A): WT-vs-control C->T conversion contrast.  Both strand
  channels are extracted (C->T in reference orientation, G->A for
  minus-strand genes) and merged with a strand column.  Site calls use a
  beta-binomial contrast test; reads are shared across nearby sites, so
  p-values are reported without BH (the reference's convention) and
  downstream commands threshold on effect + coverage.
- `faba atoi`: same machinery on the A->G / T->C channels.
- `faba apa`: 3' peak usage shifts between conditions over annotated
  terminal exons.
- `faba snp`: pileup genotyper on mismatch columns (min base quality,
  strand-balance filter).
- (cell, UMI) pairs are deduplicated inside the frequency map before any
  counting, so PCR duplicates never inflate a conversion rate.

Outputs are sparse count backends in the `gene/modality/subunit/channel`
row-name convention, so every downstream embedding command consumes them
unchanged.
"""

_GROUPING = """\
WHY ANNOTATION POOLS CELLS INTO COARSE CLUSTERS
===============================================

A single cell at 1-5k UMIs carries a handful of reads per marker gene; the
per-cell marker score is a ratio of tiny counts and its permutation null is
nearly as wide as the statistic's range.  Pooling cells into clusters sized
~100+ multiplies the effective depth by the pool size, which narrows the
null enough that real types separate.

The cost is resolution: a cluster that mixes two types gets the majority
label.  The two-layer scheme (`annotate_two_layer`) addresses this by
calling coarse labels on communities first, then re-scoring fine types
within each community, merging a fine type upward only when its peak
community agrees — so rare subtypes survive when they dominate at least one
community, and noise calls do not.

Practical guidance: cluster at the finest resolution where the smallest
cluster still has >=50 cells; annotation quality degrades gracefully with
over-clustering (labels repeat) but sharply with under-clustering (labels
mix).
"""

_LINEAGE = """\
VELOCITY-ORIENTED LINEAGE AND BETWEEN-BRANCH CONTRASTS
======================================================

`faba gem` fits a joint spliced/unspliced embedding (two-phase count-NCE)
and a per-gene velocity shift delta as a Poisson-MAP estimate; `faba
lineage` then fits a principal tree (SimplePPT) over the cell latent,
orients every edge by the average projection of cell velocity onto the edge
direction, and picks the root as the node with the largest net outflow.
Per-cell pseudotime is graph distance from the root; a per-cell consistency
score (cosine of velocity vs local tree direction) flags regions where the
orientation is unreliable.

`faba plot` renders the result: cells in a 2D layout, the tree's nodes and
edges projected into the same layout, the root starred, colored by label or
pseudotime.

`faba dyn-assoc` tests whether a modality (m6A/APA/A-to-I rate) diverges
between branches: cells are pooled into pseudotime bins, and each branch is
tested against the rest with a binomial GLM whose per-bin baseline
conditions out pseudotime — the same matched-null idea as cocoa's
counterfactual contrast, applied along the tree.
"""

_POSTERIOR = """\
POSTERIOR SPARSIFICATION OF EMBEDDING MODELS (--posterior)
==========================================================

Phase-1 NCE point estimates load every gene on every dimension; the
posterior pass asks which loadings are real.  `senna bge --posterior` runs
an alternating pb-level Gibbs sampler (pb_gibbs): per-dimension spike-slab
gates on the gene side sampled by lockstep elliptical-slice chains, a
Gaussian block on the pseudobulk side, a truncated-IBP ladder prior on gate
probabilities and half-Cauchy scale-mixture hyperpriors — each sweep a
plain loop over tensors on the card (PyTorch, CUDA).  Outputs per-gene
posterior inclusion probabilities (pips) and split-Rhat/ESS diagnostics for
every anchor.

`faba gem --posterior` extends this with the two-gate splice model: a beta
gate (does the gene load at all) nests a delta gate (does its velocity
shift), with a per-gene identifiability flag for genes whose spliced and
unspliced tracks carry no independent information.
"""


DOCS: list[tuple[str, str, str]] = [
    ("annotation", "METHOD  marker cell-type annotation, end to end", _ANNOTATION),
    ("profiling", "METHOD  BAM to per-cell features: m6A, A-to-I, APA, genes, SNPs", _PROFILING),
    ("grouping", "METHOD  why annotation pools cells into coarse clusters", _GROUPING),
    ("lineage", "METHOD  velocity-oriented lineage + between-branch contrasts", _LINEAGE),
    ("posterior", "METHOD  posterior sparsification of embedding models", _POSTERIOR),
]


def topics() -> list[str]:
    return [t for t, _, _ in DOCS]


def index_lines() -> list[str]:
    return [f"{t:<12} {blurb}" for t, blurb, _ in DOCS]


def text(topic: str) -> str:
    for t, _, body in DOCS:
        if t == topic:
            return body
    raise KeyError(f"unknown docs topic: {topic} (have: {', '.join(topics())})")
