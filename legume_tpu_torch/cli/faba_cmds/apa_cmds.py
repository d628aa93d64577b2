"""faba `apa`: the JAX package's parsers (its
`cli/faba_cmds/apa_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "apa",
        help="alternative polyadenylation site usage "
             "(SCAPE mixture by default; run.rs CountApaArgs)",
    )
    p.add_argument("--bam", required=True,
                   help="BAM file(s), comma-separated (one batch each)")
    p.add_argument("--gff", default=None,
                   help="gene annotation; mixture mode uses its 3'UTRs "
                        "(three_prime_UTR rows, CDS-derived fallback)")
    p.add_argument("--output", required=True)
    p.add_argument("--method", choices=["simple", "mixture"], default="mixture",
                   help="pileup counting vs SCAPE EM mixture (run.rs default "
                        "mixture; falls back to simple when no 3'UTR is "
                        "derivable from --gff and no --utr-bed is given)")
    p.add_argument("--min-mapq", "--min-mapping-quality", dest="min_mapq",
                   type=int, default=20)
    p.add_argument("--peak-window", type=int, default=30,
                   help="simple-mode PAS peak clustering window")
    p.add_argument("--resolution-bp", type=int, default=10,
                   help="simple-mode site bin resolution (unused by mixture)")
    p.add_argument("--min-reads", "--min-coverage", dest="min_reads",
                   type=int, default=5,
                   help="min supporting reads per candidate site")
    p.add_argument("--polya-min-tail-length", type=int, default=0,
                   help="keep only reads with an untemplated A/T soft-clip "
                        "tail of at least this length (0 = all reads; "
                        "mixture default 10 when unset)")
    p.add_argument("--polya-max-non-a-or-t", type=int, default=3)
    p.add_argument("--polya-internal-prime-window", type=int, default=10,
                   help="genomic window checked for A/T-rich internal "
                        "priming around the cleavage site (needs --genome)")
    p.add_argument("--polya-internal-prime-count", type=int, default=7)
    p.add_argument("--genome", default=None,
                   help="FASTA for the internal-priming check")
    p.add_argument("--utr-bed", "-u", default=None,
                   help="3'UTR BED (3/4/6-col); alternative to --gff")
    p.add_argument("--min-utr-length", type=int, default=200,
                   help="skip UTRs with spliced length below this")
    p.add_argument("--pre-sites", default=None,
                   help="BED of known pA sites (name col = gene/UTR name, "
                        "start = UTR-relative position); skips discovery")
    p.add_argument("--min-fragments", type=int, default=50,
                   help="skip UTRs with fewer extracted fragments")
    p.add_argument("--mu-f", type=float, default=300.0,
                   help="expected fragment length mean (SCAPE mu_f)")
    p.add_argument("--sigma-f", type=float, default=50.0)
    p.add_argument("--theta-step", type=int, default=10,
                   help="pA candidate position enumeration step (bp)")
    p.add_argument("--min-beta", type=float, default=10.0)
    p.add_argument("--max-beta", type=float, default=70.0)
    p.add_argument("--min-ws", type=float, default=0.01,
                   help="prune components below this mixing weight")
    p.add_argument("--merge-distance", type=float, default=50.0,
                   help="merge candidate sites within this distance")
    p.add_argument("--skirt-eta", type=float, default=0.05,
                   help="per-site uniform skirt weight (robust emission)")
    p.add_argument("--skirt-mult", type=float, default=3.0,
                   help="skirt half-width in beta units")
    p.add_argument("--merge-beta-mult", type=float, default=2.0,
                   help="post-EM close-site merge tolerance in beta units")
    p.add_argument("--apa-max-sites", type=int, default=20,
                   help="cap candidate sites per UTR for BIC (0 = unlimited)")
    p.add_argument("--apa-em-pdui", action="store_true",
                   help="full SCAPE EM for PDUI instead of the fast top-2 "
                        "nearest-site assignment")
    p.add_argument("--mixture", dest="write_mixture", action="store_true",
                   help="also write the per-cell component matrix "
                        "({output}.apa_mixture.zarr); forces the EM")
    p.add_argument("--no-pdui", dest="compute_pdui", action="store_false",
                   default=True,
                   help="skip the proximal/distal PDUI channel matrix "
                        "(written by default)")
    p.add_argument("--drop-single-component", action="store_true",
                   help="drop genes with a single active pA site")
    p.add_argument("--no-umi-dedup", action="store_true",
                   help="count each fragment once (bulk / non-UMI data)")
    p.add_argument("--atoi-mask", default=None,
                   help="A-to-I sites parquet; overlapping pA sites drop")
    p.add_argument("--snp-mask", default=None,
                   help="snp_sites.parquet; pA sites at variants drop")
    p.add_argument("--valid-cells", default=None,
                   help="cell allow-list file (plain/.gz/first TSV column)")
    p.add_argument("--valid-genes", default=None,
                   help="gene allow-list file")
    p.add_argument("--skip-gene-qc", action="store_true",
                   help="skip the gene/cell expression QC gates")
    p.add_argument("--gene-min-cells", type=int, default=10)
    p.add_argument("--gene-min-counts", type=int, default=0)
    p.add_argument("--cell-min-genes", type=int, default=10)
    p.add_argument("--row-nnz-cutoff", type=int, default=10,
                   help="drop output sites with fewer non-zero cells")
    p.add_argument("--column-nnz-cutoff", type=int, default=1)
    p.add_argument("--compute-pdui-triplets", dest="compute_pdui_triplets",
                   action="store_true",
                   help="simple-mode per-(gene, cell) PDUI parquet "
                        "(round-2 behavior; mixture writes channel matrices)")


def _run_apa_cmd(args):
    not_ported(args.cmd)
