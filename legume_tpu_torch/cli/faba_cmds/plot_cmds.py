"""faba `plot`: the JAX package's parsers (its
`cli/faba_cmds/plot_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "plot", help="render a lineage fit: annotated trajectory over a 2D layout"
    )
    p.add_argument("-f", "--from", dest="frm", required=True,
                   help="lineage output prefix ({from}.pseudotime/... parquet)")
    p.add_argument("--latent", required=True,
                   help="cell latent parquet (the gem fit the lineage used)")
    p.add_argument("-o", "--out", default=None,
                   help="figure path (default {from}.plot.pdf)")
    p.add_argument("--color-by",
                   choices=["pseudotime", "label", "celltype"],
                   default="pseudotime",
                   help="celltype reads the lineage's own node calls "
                        "({from}.trajectory_annotation.parquet)")
    p.add_argument("--annot", default=None,
                   help="cell,label parquet (required for --color-by label)")
    p.add_argument("--pt-ramp", choices=["sqrt", "linear", "rank"],
                   default="sqrt",
                   help="non-linear remap of the pseudotime ramp")
    p.add_argument("--width", type=float, default=9.0)
    p.add_argument("--height", type=float, default=8.0)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--point-size", type=float, default=3.0)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--label-font-size", type=float, default=8.0)
    p.add_argument("--velocity-scale", type=float, default=0.5,
                   help="scale on the velocity-field arrow length")
    p.add_argument("--no-velocity-field", action="store_true")
    p.add_argument("--backbone", choices=["auto", "curves", "tree"],
                   default="auto",
                   help="auto draws the Slingshot curves when "
                        "{from}.curves_2d.parquet exists, else the tree")
    p.add_argument("--no-type-labels", action="store_true",
                   help="skip the node cell-type annotations")
    p.add_argument("--show-unassigned", action="store_true")
    p.add_argument("--svg", action="store_true",
                   help="also emit the SVG next to the main output")
    p.add_argument("--layout",
                   choices=["auto", "phate", "umap", "tumap", "tsne"],
                   default="auto",
                   help="auto reuses {from}.cells_2d.parquet when the "
                        "lineage run already laid out (else tumap)")
    p.add_argument("--layout-pcs", type=int, default=50,
                   help="PCs carrying the umap/tumap kNN graph + SGD init, "
                        "leading (mean) axis dropped; 0 = raw latent + "
                        "random init (lineage/args.rs layout_pcs)")
    p.add_argument("--seed", type=int, default=0)


def _run_faba_plot(args):
    not_ported(args.cmd)
