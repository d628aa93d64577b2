"""faba `all`: parsers and handlers (the port's copy of the JAX
package's `cli/faba_cmds/pipeline_cmds.py`, flags, defaults and handlers unchanged;
the stages run with numpy and scipy on the host)."""

from __future__ import annotations

import os

import numpy as np


def add_parsers(sub):
    p = sub.add_parser(
        "all",
        help="unified pipeline: snp -> genes -> depth -> atoi -> m6a "
             "-> apa (pipeline/args.rs PipelineArgs)",
    )
    p.add_argument("--bam", required=True,
                   help="signal/WT BAM(s), comma-separated; every "
                        "sample (incl. controls) is quantified in "
                        "every modality")
    p.add_argument("--gff", required=True)
    p.add_argument("--output", required=True, help="output prefix")
    p.add_argument("--control-bam", default=None,
                   help="control/MUT BAM(s), comma-separated; used "
                        "for the editing contrast AND quantified")
    p.add_argument("-f", "--genome", default=None,
                   help="reference FASTA (optional; validates SNP ref "
                        "alleles)")
    p.add_argument("--gene-type", default=None,
                   help="GFF biotype filter")
    p.add_argument("--cell-barcode-tag", default="CB")
    p.add_argument("--umi-tag", default="UB")
    p.add_argument("--gene-barcode-tag", default=None,
                   help="key the genes stage by this aligner Z tag "
                        "(CellRanger GX); GFF overlap stays the "
                        "untagged-read fallback")
    p.add_argument("--no-umi-dedup", action="store_true")
    p.add_argument("--backend", choices=["zarr", "hdf5"], default="zarr")
    p.add_argument("--zip", action="store_true",
                   help="write .zarr.zip archives")
    p.add_argument("--min-mapq", "--min-mapping-quality",
                   dest="min_mapq", type=int, default=20)
    p.add_argument("--min-base-quality", type=int, default=20)
    p.add_argument("--skip-snp", action="store_true")
    p.add_argument("--skip-genes", action="store_true")
    p.add_argument("--skip-atoi", action="store_true")
    p.add_argument("--skip-apa", action="store_true")
    p.add_argument("--depth-resolution-kb", type=float, default=None,
                   help="opt-in step 2: per-cell depth over uniform "
                        "genome tiles at this resolution")
    # SNP stage (snp_* fields)
    p.add_argument("--known-snps", default=None)
    p.add_argument("--snp-min-depth", type=int, default=5)
    p.add_argument("--snp-min-gq", type=float, default=20.0)
    p.add_argument("--snp-min-coverage", type=int, default=8)
    p.add_argument("--snp-min-alt-count", type=int, default=2)
    p.add_argument("--snp-min-alt-freq", type=float, default=0.1)
    p.add_argument("--snp-mask-min-vaf", type=float, default=0.2,
                   help="germline-VAF gate on the editing mask so "
                        "true RNA-editing sites stay out of it")
    # editing stages
    p.add_argument("--atoi-min-coverage", type=int, default=0)
    p.add_argument("--atoi-min-conversion", type=int, default=3)
    p.add_argument("--atoi-pvalue-cutoff", type=float, default=0.05)
    p.add_argument("--edit-error-rate", type=float, default=0.01)
    p.add_argument("--edit-overdispersion", type=float, default=0.05)
    p.add_argument("--mixture-weight",
                   choices=["converted", "posterior"],
                   default="converted")
    p.add_argument("--mixture-prior-alpha", type=float, default=1.0,
                   help="Beta prior alpha for posterior-rate weighting")
    p.add_argument("--mixture-prior-beta", type=float, default=1.0,
                   help="Beta prior beta for posterior-rate weighting")
    p.add_argument("--no-mixture", action="store_true")
    p.add_argument("--drop-single-component", action="store_true")
    # APA stage
    p.add_argument("--apa-min-coverage", type=int, default=5)
    p.add_argument("--apa-max-sites", type=int, default=0,
                   help="cap called PAS sites per gene to the top-N by "
                        "coverage (0 = unbounded; bounds cost on long "
                        "3'UTRs)")
    p.add_argument("--polya-min-tail-length", type=int, default=0)
    p.add_argument("--no-apa-pdui", action="store_true")
    # expression QC (opt-in, as in the standalone commands)
    p.add_argument("--gene-qc", action="store_true")
    p.add_argument("--gene-min-cells", type=int, default=10)
    p.add_argument("--gene-min-counts", type=int, default=10)
    p.add_argument("--cell-min-genes", type=int, default=10)


def _cmd_all(args):
    from ...faba.pipeline import run_all

    res = run_all(
        args.bam.split(","), args.gff, args.output,
        control_bam=(args.control_bam.split(",")
                     if args.control_bam else None),
        genome=args.genome, gene_type=args.gene_type,
        cell_barcode_tag=args.cell_barcode_tag,
        gene_barcode_tag=args.gene_barcode_tag,
        umi_tag=args.umi_tag, no_umi_dedup=args.no_umi_dedup,
        backend=args.backend, zip_output=args.zip,
        min_mapq=args.min_mapq,
        min_base_quality=args.min_base_quality,
        skip_snp=args.skip_snp, skip_genes=args.skip_genes,
        skip_atoi=args.skip_atoi, skip_apa=args.skip_apa,
        depth_resolution_kb=args.depth_resolution_kb,
        known_snps=args.known_snps,
        snp_min_depth=args.snp_min_depth,
        snp_min_gq=args.snp_min_gq,
        snp_min_coverage=args.snp_min_coverage,
        snp_min_alt_count=args.snp_min_alt_count,
        snp_min_alt_freq=args.snp_min_alt_freq,
        snp_mask_min_vaf=args.snp_mask_min_vaf,
        atoi_min_coverage=args.atoi_min_coverage,
        atoi_min_conversion=args.atoi_min_conversion,
        atoi_pvalue_cutoff=args.atoi_pvalue_cutoff,
        edit_error_rate=args.edit_error_rate,
        edit_overdispersion=args.edit_overdispersion,
        apa_min_coverage=args.apa_min_coverage,
        apa_max_sites=args.apa_max_sites,
        polya_min_tail_length=args.polya_min_tail_length,
        no_apa_pdui=args.no_apa_pdui,
        mixture=not args.no_mixture,
        mixture_weight=args.mixture_weight,
        mixture_prior_alpha=args.mixture_prior_alpha,
        mixture_prior_beta=args.mixture_prior_beta,
        drop_single_component=args.drop_single_component,
        gene_qc=args.gene_qc,
        gene_min_cells=args.gene_min_cells,
        gene_min_counts=args.gene_min_counts,
        cell_min_genes=args.cell_min_genes,
    )
    print(f"wrote: {' '.join(sorted(res.outputs))}")

