"""Shared faba CLI helpers (the port's copy of the JAX package's
`cli/faba_cmds/_common.py`)."""

from __future__ import annotations


def _add_gene_qc_args(p):
    """Gene-expression + mitochondrial QC knobs, flattened into every
    subcommand that quantifies genes (m6a/run.rs:450-489 +
    quant/mod.rs MitoQcArgs). The reference runs gene QC BY DEFAULT;
    here it is opt-in via --gene-qc (tiny fixtures would otherwise be
    emptied by the 10-cell floors) — a declared divergence."""
    p.add_argument("--gene-qc", action="store_true",
                   help="run gene/cell expression QC before downstream "
                        "steps (the reference's default; see "
                        "--skip-gene-qc)")
    p.add_argument("--skip-gene-qc", action="store_true",
                   help="explicitly skip gene expression QC "
                        "(reference-compatible no-op when --gene-qc "
                        "is absent)")
    p.add_argument("--gene-min-cells", type=int, default=10,
                   help="min cells with nonzero expression per gene")
    p.add_argument("--gene-min-counts", type=int, default=0,
                   help="min total UMI per gene (0 disables)")
    p.add_argument("--cell-min-genes", type=int, default=10,
                   help="min genes detected per cell")
    p.add_argument("--mito-chr", default="chrM,chrMT,MT,M",
                   help="mitochondrial chromosome names (comma-separated, "
                        "case-insensitive GFF seqname match)")
    p.add_argument("--keep-mito", action="store_true",
                   help="keep mitochondrial genes in the quantified set")
    p.add_argument("--max-mito-frac", type=float, default=0.0,
                   help="max MT fraction per cell (>0 fixed; 0 = elbow)")
    p.add_argument("--no-mito-cell-qc", action="store_true",
                   help="report MT%% only, drop no cells")

