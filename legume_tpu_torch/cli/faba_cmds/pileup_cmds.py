"""faba `inspect, pileup`: the JAX package's parsers (its
`cli/faba_cmds/pileup_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "pileup", aliases=["inspect"],
        help="gene/region pileup of faba matrices (PileupArgs); "
             "--bam+--sites = base composition; --miami = figure mode",
    )
    p.add_argument("--bam", default=None,
                   help="BAM(s): base-composition mode, or the "
                        "read-depth track of --miami")
    p.add_argument("--sites", default=None,
                   help="site-level parquet (composition mode, or the "
                        "second track of the matrix mode)")
    p.add_argument("--output", default=None,
                   help="TSV path (matrix mode) / parquet prefix "
                        "(composition mode)")
    p.add_argument("--flank", type=int, default=2)
    p.add_argument("--fasta", default=None)
    # matrix-track mode (the reference's original ASCII/TSV pileup)
    p.add_argument("--data", default=None,
                   help="sparse matrix backend(s) from faba output, "
                        "comma-separated (matrix-track mode)")
    p.add_argument("--genes", default=None,
                   help="comma-separated gene symbols (needs --gff to "
                        "resolve spans — row names key by locus here)")
    p.add_argument("--regions", default=None,
                   help="comma-separated chr:lb-ub regions")
    p.add_argument("--signal", choices=["sum", "nnz", "log10-sum"],
                   default="sum",
                   help="per-position aggregation over cells")
    p.add_argument("--site-signal",
                   choices=["count", "wt-coverage", "mut-coverage",
                            "neglog10pv"],
                   default="count",
                   help="signal for the --sites second track")
    p.add_argument("--bins", type=int, default=80,
                   help="bins along the selected span")
    p.add_argument("--plot-height", type=int, default=12,
                   help="ASCII plot height in rows (per track)")
    p.add_argument("--quiet", "--no-plot", dest="quiet",
                   action="store_true", help="suppress the ASCII plot")
    p.add_argument("--modalities", default=None,
                   help="restrict matrix rows to these modalities "
                        "(e.g. m6a,atoi)")
    # figure (miami) mode
    p.add_argument("--miami", default=None,
                   help="figure out-path (.pdf/.svg/.png): sites up, gene "
                        "model middle, mirrored depth down")
    p.add_argument("--region", default=None, help="chr:lb-ub (miami mode)")
    p.add_argument("--gff", default=None,
                   help="gene model (miami track; resolves --genes)")
    p.add_argument("--cell-membership", default=None,
                   help="TSV cell TAB type: one depth panel per cell type")
    p.add_argument("--membership-barcode-col", type=int, default=0)
    p.add_argument("--membership-celltype-col", type=int, default=1)
    p.add_argument("--exact-barcode-match", action="store_true",
                   help="require exact membership-barcode matches "
                        "(default: membership barcodes match as "
                        "prefixes, handling '-1' suffixes)")
    p.add_argument("--cell-barcode-tag", default="CB",
                   help="BAM tag holding the cell barcode "
                        "(read-depth track)")
    p.add_argument("--fig-width", type=float, default=8.0)
    p.add_argument("--dpi", type=int, default=300)
    p.add_argument("--palette", default="auto",
                   help="matplotlib qualitative palette for cell-type "
                        "panels (e.g. tab10); 'auto' = single hue")
    p.add_argument("--raster-threshold", type=int, default=300,
                   help="rasterize the per-site dot layer past this "
                        "many sites (bounds SVG/PDF size)")
    p.add_argument("--out", default=None,
                   help="figure PREFIX: writes {out}.miami.{svg,pdf} "
                        "(reference layout; --miami with an extension "
                        "writes that single file)")
    p.add_argument("--format", choices=["svg", "pdf", "png"], default=None,
                   help="emit ONLY this format (prefix mode)")
    p.add_argument("--svg", action="store_true",
                   help="also write SVG when --format selects another "
                        "single format (on by default otherwise)")
    p.add_argument("--png", action="store_true",
                   help="(prefix mode) also write a flattened PNG")
    p.add_argument("--no-pdf", action="store_true",
                   help="(prefix mode) skip the PDF")


def _cmd_pileup(args):
    not_ported(args.cmd)
