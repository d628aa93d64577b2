"""faba `depth, snp`: the JAX package's parsers (its
`cli/faba_cmds/variant_cmds.py`, flags and defaults unchanged), so that
`faba --help` lists every subcommand. The handlers are not ported yet
(ROADMAP item 10c) and raise `NotImplementedError`."""

from __future__ import annotations

from ._common import not_ported


def add_parsers(sub):
    p = sub.add_parser(
        "snp",
        help="cellSNP-lite-style pileup genotyper (snp/run.rs SnpArgs)",
    )
    p.add_argument("--bam", required=True,
                   help="comma-separated coordinate-sorted BAMs (merged pileup)")
    p.add_argument("--output", required=True,
                   help="output DIRECTORY: snp_sites.parquet + "
                        "snp_sites.vcf.gz + snp_mask.parquet "
                        "[+ {batch}_baf.zarr]")
    p.add_argument("-f", "--genome", default=None,
                   help="reference FASTA (optional here: the MD-tag "
                        "mismatch stream carries ref bases; validates "
                        "ref alleles + VCF contigs when given)")
    p.add_argument("--known-snps", default=None,
                   help="VCF(.gz) or snp_sites.parquet; force-called "
                        "regardless of alt evidence")
    p.add_argument("-g", "--gff", default=None,
                   help="gene model; gates sites to gene bodies and "
                        "enables the per-cell BAF matrices")
    p.add_argument("--cell-barcode-tag", default="CB")
    p.add_argument("--umi-tag", default="UB")
    p.add_argument("--no-umi-dedup", action="store_true")
    p.add_argument("--bulk", action="store_true",
                   help="genotype calls only, no per-cell output")
    p.add_argument("--skip-discovery", action="store_true",
                   help="known sites only")
    p.add_argument("--min-coverage", type=int, default=10,
                   help="de novo discovery depth gate")
    p.add_argument("--min-alt-count", type=int, default=3)
    p.add_argument("--min-alt-freq", type=float, default=0.1)
    p.add_argument("--min-depth", type=int, default=5,
                   help="genotype-calling depth gate")
    p.add_argument("--min-gq", type=float, default=20.0)
    p.add_argument("--base-error-rate", "--error-rate",
                   dest="base_error_rate", type=float, default=0.01)
    p.add_argument("--min-base-quality", type=int, default=20)
    p.add_argument("--min-mapping-quality", type=int, default=20)
    p.add_argument("--use-base-quality", dest="use_base_quality",
                   action="store_true", default=True,
                   help="Li 2011 per-base quality GLs on alt "
                        "observations (default; see MIGRATION.md)")
    p.add_argument("--no-use-base-quality", dest="use_base_quality",
                   action="store_false")
    p.add_argument("--min-vaf", type=float, default=None,
                   help="germline-like VAF gate on the SNP mask "
                        "(het in [v,1-v], hom-alt >= 1-v)")
    p.add_argument("--gene-type", default=None,
                   help="GFF biotype filter (e.g. protein_coding)")
    p.add_argument("--backend", choices=["zarr", "hdf5"], default="zarr",
                   help="per-cell BAF matrix backend")
    p.add_argument("--zip", action="store_true",
                   help="archive BAF matrices as .zarr.zip (reference "
                        "default; opt-in here — declared divergence)")

    p = sub.add_parser(
        "depth",
        help="per-cell coverage over BED regions or uniform tiles "
             "(read_depth/run.rs ReadDepthArgs)",
    )
    p.add_argument("--bam", required=True,
                   help="BAM(s), comma-separated")
    p.add_argument("--bed", default=None,
                   help="BED regions (alternative to --resolution-kb)")
    p.add_argument("--resolution-kb", type=float, default=None,
                   help="uniform genome tiles at this resolution "
                        "(the reference's bin mode)")
    p.add_argument("--output", required=True)
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--use-index", action="store_true",
                   help="with --bed: ranged .bai fetch of the BED "
                        "windows (built on first use) instead of a "
                        "whole-file stream; barcode columns then cover "
                        "only in-region cells")
    p.add_argument("--cell-barcode-tag", default="CB")
    p.add_argument("--row-nnz-cutoff", type=int, default=0)
    p.add_argument("--column-nnz-cutoff", type=int, default=0)
    p.add_argument("--backend", choices=["zarr", "hdf5"], default="zarr")
    p.add_argument("--zip", action="store_true")


def _cmd_snp(args):
    not_ported(args.cmd)


def _cmd_depth(args):
    not_ported(args.cmd)
