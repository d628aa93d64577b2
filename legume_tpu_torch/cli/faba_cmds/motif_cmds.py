"""faba `metagene, pwm`: the JAX package's parsers (its
`cli/faba_cmds/motif_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "pwm",
        help="sequence-context PWM around called sites "
             "(site_analysis/scan_pwm.rs ScanPwmArgs)",
    )
    p.add_argument("-s", "--sites", required=True,
                   help="parquet with chrom,pos[,strand]")
    p.add_argument("-f", "--fasta", "--genome", dest="fasta",
                   required=True)
    p.add_argument("-o", "--output", required=True,
                   help="output prefix; also accepts a .tsv/.tsv.gz "
                        "path for the reference TSV layout")
    p.add_argument("--flank", "--window", dest="flank", type=int,
                   default=5, help="+/- bp collected around each site")
    p.add_argument("--source", choices=["reference", "reads"],
                   default="reference",
                   help="base frequencies from the FASTA context or "
                        "from the reads covering each position")
    p.add_argument("--bam", default=None,
                   help="BAM(s), comma-separated (required for "
                        "--source reads)")
    p = sub.add_parser(
        "metagene",
        help="MetaPlotR tripartite 5'UTR/CDS/3'UTR metagene "
             "(site_analysis/metagene.rs MetageneArgs)",
    )
    p.add_argument("-s", "--sites", required=True,
                   help="site parquet (from dartseq/atoi/apa output)")
    p.add_argument("-g", "--gff", required=True)
    p.add_argument("-o", "--output", required=True,
                   help="TSV path (a .parquet twin is written too)")
    p.add_argument("--bins", type=int, default=200,
                   help="total bins across 5'UTR+CDS+3'UTR, split in "
                        "proportion to the site-weighted medians")
    p.add_argument("--isoform", choices=["longest", "all"],
                   default="longest",
                   help="longest spliced coding isoform per gene "
                        "(MetaPlotR) or every coding transcript")
    p.add_argument("--ncrna", action="store_true",
                   help="also profile non-coding genes (own [0,1] track)")
    p.add_argument("--distances", default=None,
                   help="also write MetaPlotR's per-site distance "
                        "table (TSV) here")
    p.add_argument("--print", dest="print_hist", action="store_true",
                   help="print the ASCII histogram to stderr")
    p.add_argument("--max-width", type=int, default=60)
    p.add_argument("--gene-type", default=None,
                   help="GFF biotype filter")
    p.add_argument("--body", action="store_true",
                   help="legacy round-2 mode: uniform gene-body bins "
                        "(writes {out}.metagene.parquet only)")


def _cmd_pwm(args):
    not_ported(args.cmd)


def _cmd_metagene(args):
    not_ported(args.cmd)
