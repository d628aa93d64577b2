"""faba `atoi, dartseq`: the JAX package's parsers (its
`cli/faba_cmds/editing_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import _add_gene_qc_args, not_ported


def add_parsers(sub):
    for _name, _help in [
        ("dartseq", "m6A C->T WT-vs-control site calling"),
        ("atoi", "A-to-I (A->G) editing site calling"),
    ]:  # gene-QC args join below (after the shared editing flags)
        p = sub.add_parser(_name, help=_help)
        p.add_argument("--bam", required=True, help="WT/DART BAM")
        p.add_argument("--control-bam", required=True)
        p.add_argument("--output", required=True)
        p.add_argument("--max-p", "--pvalue-cutoff", dest="max_p",
                       type=float, default=0.05)
        p.add_argument("--min-alt", "--min-conversion", dest="min_alt",
                       type=int, default=3)
        p.add_argument("--min-coverage", type=int, default=0)
        p.add_argument("--min-mapq", "--min-mapping-quality", dest="min_mapq",
                       type=int, default=20)
        p.add_argument("--min-base-quality", type=int, default=20,
                       help="phred floor at the conversion base "
                            "(dna_stat_map.rs default 20)")
        p.add_argument("--error-rate", type=float, default=0.01,
                       help="base conversion error rate eps")
        p.add_argument("--overdispersion", type=float, default=0.05,
                       help="beta-binomial rho")
        p.add_argument("--snp-mask-file", default=None,
                       help="TSV chrom<TAB>pos of known SNPs to exclude")
        p.add_argument("--valid-cells", default=None,
                       help="file of called cell barcodes (one per line): "
                            "reads from other cells are ambient and excluded")
        # per-gene 1D Gaussian mixture of sites (editing/mixture.rs;
        # default ON in the reference when a gene model is available)
        p.add_argument("--gff", default=None,
                       help="gene model for the per-gene site mixture "
                            "(components on transcript-relative positions)")
        p.add_argument("--no-mixture", action="store_true",
                       help="disable mixture component calling even with --gff")
        p.add_argument("--mixture-min-sites", type=int, default=3)
        p.add_argument("--mixture-max-k", type=int, default=5)
        p.add_argument("--mixture-bandwidth", "--mixture-initial-sigma",
                       dest="mixture_bandwidth", type=float, default=0.0,
                       help="component-calling bandwidth in nt; 0 = estimate "
                            "from within-gene site spacing (cluster-aware for "
                            "atoi)")
        p.add_argument("--mixture-weight", choices=["posterior", "converted"],
                       default="posterior",
                       help="observation weight: Beta-posterior effective "
                            "count n*(c+a)/(n+a+b) (default) or raw converted "
                            "count")
        p.add_argument("--mixture-prior-alpha", type=float, default=1.0)
        p.add_argument("--mixture-prior-beta", type=float, default=1.0)
        p.add_argument("--gene-barcode-tag", default=None,
                       help="read-level gene-consistency filter: keep "
                            "reads whose aligner gene tag (CellRanger "
                            "GX) matches the GFF gene at their locus")
        p.add_argument("--include-missing-barcode", action="store_true",
                       help="[--gene-barcode-tag] keep reads that lack "
                            "the gene tag (default: drop)")
        p.add_argument("--cell-barcode-tag", default="CB",
                       help="BAM Z tag carrying the cell barcode "
                            "(DartSeqCountArgs cell_barcode_tag)")
        p.add_argument("--umi-tag", default="UB",
                       help="BAM Z tag carrying the UMI")
        p.add_argument("--site-min-cells", type=int, default=0,
                       help="called sites detected in fewer cells drop "
                            "from the site matrix; the gene-level outputs "
                            "are unaffected (run.rs site_min_cells)")
        p.add_argument("--output-bed-file", action="store_true",
                       help="also write per-(site, cell) conversion rows "
                            "as {output}.bed.gz (editing/bed_output.rs)")
        p.add_argument("--cell-membership", default=None,
                       help="TSV mapping barcodes to cell types")
        p.add_argument("--membership-barcode-col", type=int, default=0,
                       help="0-based barcode column in --cell-membership")
        p.add_argument("--membership-celltype-col", type=int, default=1,
                       help="0-based cell-type column in --cell-membership")
        p.add_argument("--exact-barcode-match", action="store_true",
                       help="disable suffix-tolerant ('-1') barcode matching")
        p.add_argument("--output-cell-types", action="store_true",
                       help="append the matched cell type to BED rows "
                            "(needs --cell-membership)")
        # barcode QC / cell calling (cell_qc/mod.rs CellQcArgs); needs
        # --gff for the gene-count matrix the caller runs on
        p.add_argument("--cell-filter",
                       choices=["empty-drops", "ord-mag", "min-counts", "nnz"],
                       default="nnz",
                       help="cell-calling method on the gene counts "
                            "(reference default: empty-drops; nnz here "
                            "keeps the raw superset unless asked)")
        p.add_argument("--expected-cells", type=int, default=3000,
                       help="OrdMag recovered-cell estimate")
        p.add_argument("--cell-min-umis", type=int, default=500,
                       help="min-counts threshold / EmptyDrops candidate floor")
        p.add_argument("--cell-fdr", type=float, default=0.01,
                       help="EmptyDrops BH FDR cutoff")
        p.add_argument("--cell-sims", type=int, default=10_000,
                       help="EmptyDrops Monte-Carlo iterations")
        p.add_argument("--ambient-lo", type=int, default=45_000,
                       help="EmptyDrops ambient window lower rank bound")
        p.add_argument("--ambient-hi", type=int, default=90_000,
                       help="EmptyDrops ambient window upper rank bound")
        _add_gene_qc_args(p)
        # null-cell scan (editing/cell_activity.rs CellScanArgs):
        # expression QC can't see the fusion enzyme, so this scores
        # each WT cell's editing activity against depth-matched control
        # cells and keeps the competent ones
        p.add_argument("--cell-scan", action="store_true",
                       help="call editing-competent cells against the "
                            "control arm before site discovery; the kept "
                            "set gates the matrices too (the reference "
                            "quantifies null cells unless "
                            "--quantify-competent-only — declared "
                            "divergence)")
        p.add_argument("--cell-scan-tolerance", type=float, default=None,
                       help="how much the DISCARDED pool may still edit, "
                            "as a multiple of the control (default 1.0 = "
                            "the parameter-free cut)")
        p.add_argument("--cell-scan-control-tail", type=float, default=0.0,
                       help="cut on the control's own scale instead: keep "
                            "cells above this upper-tail fraction of "
                            "depth-matched control cells")
        p.add_argument("--cell-scan-min-coverage", type=int, default=50,
                       help="min candidate-site coverage to score a cell")
        p.add_argument("--reader-genes", default=None,
                       help="diagnostic: comma-separated m6A reader genes "
                            "summarized per kept/dropped cell (needs --gff)")
        p.add_argument("--writer-genes", default=None,
                       help="diagnostic: m6A writer/eraser genes, same")
        p.add_argument("--drop-single-component", action="store_true",
                       help="drop genes whose fit keeps one component (no "
                            "relative signal)")
        if _name == "dartseq":
            p.add_argument("--detect-atoi", action="store_true",
                           help="run the A-to-I contrast first and mask m6A "
                                "candidates whose RAC/GTY triplet overlaps an "
                                "edited site (writes {out}.atoi_mask.sites."
                                "parquet)")
            p.add_argument("--atoi-pvalue", type=float, default=0.05,
                           help="p-value cutoff for the A-to-I mask pass "
                                "(separate from the m6A --max-p)")
            p.add_argument("--atoi-min-conversion", type=int, default=5)
            p.add_argument("--atoi-min-coverage", type=int, default=10)
            p.add_argument("--atoi-mask", default=None,
                           help="pre-computed A-to-I sites parquet (from "
                                "`faba atoi` or --detect-atoi) used as the "
                                "confounder mask")
            p.add_argument("--genome", default=None,
                           help="genome FASTA: restrict called sites to the "
                                "DART RAC motif ([AG]AC forward / GTY "
                                "reverse; editing/sifter.rs)")
            p.add_argument("--no-check-r-site", action="store_true",
                           help="relax the motif to .AC / GT. (drop the "
                                "[AG] R-site requirement)")


def _cmd_editing(args):
    not_ported(args.cmd)
