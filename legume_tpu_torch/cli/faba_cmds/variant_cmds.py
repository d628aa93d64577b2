"""faba `snp, depth`: parsers and handlers (the port's copy of the JAX
package's `cli/faba_cmds/variant_cmds.py`, flags, defaults and handlers unchanged;
the stages run with numpy and scipy on the host)."""

from __future__ import annotations

import os

import numpy as np


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
    from ...faba.snp import GenotypeParams, run_snp

    sites = run_snp(
        args.bam.split(","),
        args.output,
        genome=args.genome,
        known_snps=args.known_snps,
        gff=args.gff,
        params=GenotypeParams(
            min_depth=args.min_depth,
            min_gq=args.min_gq,
            base_error_rate=args.base_error_rate,
            min_coverage=args.min_coverage,
            min_alt_count=args.min_alt_count,
            min_alt_freq=args.min_alt_freq,
        ),
        cell_barcode_tag=args.cell_barcode_tag,
        umi_tag=args.umi_tag,
        no_umi_dedup=args.no_umi_dedup,
        use_base_quality=args.use_base_quality,
        min_base_quality=args.min_base_quality,
        min_mapping_quality=args.min_mapping_quality,
        bulk=args.bulk,
        skip_discovery=args.skip_discovery,
        min_vaf=args.min_vaf,
        gene_type=args.gene_type,
        backend=args.backend,
        zip_output=args.zip,
    )
    n_called = int((sites.genotype != 3).sum())
    print(
        f"wrote {args.output}/snp_sites.parquet "
        f"({len(sites)} sites, {n_called} called)"
    )
    return


def _cmd_depth(args):
    from ...data.sparse_io import create_sparse_from_csc
    from ...faba.depth import (
        depth_matrix_uniform,
        depth_per_region,
        read_bed,
    )

    if (args.bed is None) == (args.resolution_kb is None):
        raise SystemExit(
            "faba depth: give exactly one of --bed or --resolution-kb"
        )
    sfx = ".h5" if args.backend == "hdf5" else (
        ".zarr.zip" if args.zip else ".zarr")
    bam_list = args.bam.split(",")
    for bam_path in bam_list:
        tag = (
            "" if len(bam_list) == 1
            else "." + os.path.splitext(os.path.basename(bam_path))[0]
        )
        if args.bed is not None:
            cov, names, barcodes = depth_per_region(
                bam_path, read_bed(args.bed), min_mapq=args.min_mapq,
                use_index=args.use_index,
            )
        else:
            cov, names, barcodes = depth_matrix_uniform(
                bam_path,
                resolution_bp=int(args.resolution_kb * 1000),
                min_mapq=args.min_mapq,
                cb_tag=args.cell_barcode_tag,
            )
        if args.row_nnz_cutoff > 0 or args.column_nnz_cutoff > 0:
            csc = cov.tocsc()
            rk = np.asarray((csc > 0).sum(axis=1)).ravel() \
                >= args.row_nnz_cutoff
            ck = np.asarray((csc > 0).sum(axis=0)).ravel() \
                >= args.column_nnz_cutoff
            cov = csc[rk][:, ck]
            names = [n for n, k in zip(names, rk) if k]
            barcodes = [b for b, k in zip(barcodes, ck) if k]
        out_path = f"{args.output}{tag}{sfx}"
        create_sparse_from_csc(cov, out_path, names, barcodes)
        print(f"wrote backend: {out_path} ({cov.shape[0]} rows)")
    return

