"""faba `annotate`: the JAX package's parsers (its
`cli/faba_cmds/annotate_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "annotate",
        help="marker cell-type annotation of a gem run "
             "(annotate/run.rs AnnotateArgs)",
    )
    p.add_argument("-f", "--from", dest="frm", default=None,
                   help="gem / gem-encoder / topic output prefix")
    p.add_argument("--markers", required=True,
                   help="gene<TAB>celltype TSV (or GMT) marker panels")
    p.add_argument("-o", "--out", default=None,
                   help="output prefix (default: the gem prefix)")
    p.add_argument("--mode", choices=["projection", "enrichment"],
                   default=None,
                   help="how markers become a call (default: from "
                        "{from}.gem.json — topic -> enrichment, "
                        "embedding -> projection)")
    p.add_argument("--track",
                   choices=["spliced", "velocity", "nascent", "both"],
                   default="both",
                   help="spliced/velocity are projection tracks; "
                        "spliced/nascent are enrichment tracks")
    p.add_argument("--knn", type=int, default=15,
                   help="k for the cosine cell kNN graph fed to Leiden")
    p.add_argument("--resolution", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-perm", type=int, default=200,
                   help="permutation draws calibrating the "
                        "over-representation statistic")
    p.add_argument("--min-markers", type=int, default=3)
    p.add_argument("--no-assign-qc", action="store_true")
    p.add_argument("--assign-mad", type=float, default=3.0)
    p.add_argument("--fdr-alpha", type=float, default=0.05)
    p.add_argument("--q-temperature", type=float, default=1.0)
    p.add_argument("--no-idf", action="store_true")
    p.add_argument("--obo", default=None,
                   help="Cell Ontology OBO: TreeBH layer (needs "
                        "--label-cl)")
    p.add_argument("--label-cl", default=None)
    p.add_argument("--ontology-fdr-q", type=float, default=0.05)
    p.add_argument("--ontology-by", action="store_true")
    p.add_argument("--panel-perm", type=int, default=0,
                   help="marker-panel permutation null (bias guard); "
                        "0 = off, try 200")
    p.add_argument("--support-perm", type=int, default=0,
                   help="support permutation null calibrating "
                        "label_support; 0 = off")
    p.add_argument("--no-bootstrap-markers", action="store_true")
    p.add_argument("--n-boot", type=int, default=100)
    p.add_argument("--no-recluster", action="store_true",
                   help="hold the clustering fixed across resamples "
                        "(weakens the bootstrap)")
    p.add_argument("--min-support", type=float, default=0.5)
    p.add_argument("--abstain-separable", action="store_true",
                   help="abstain by a top-vs-runner-up sign test "
                        "instead of the --min-support threshold")
    p.add_argument("--abstain-alpha", type=float, default=0.05)
    p.add_argument("--set-coverage", type=float, default=0.8,
                   help="coverage of the reported label_set")
    p.add_argument("--max-set-size", type=int, default=3)
    p.add_argument("--min-panel-coverage", type=float, default=0.0)
    # legacy round-2 surface (site-track cluster labelling) stays:
    p.add_argument("--backend", default=None,
                   help="LEGACY: site x cell counts backend (with "
                        "--clusters; pre-r3 surface)")
    p.add_argument("--clusters", default=None, help="LEGACY clusters parquet")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--output", default=None, help="LEGACY output prefix")


def _cmd_annotate(args):
    not_ported(args.cmd)
