"""faba `index` and `genes`: parsers + handlers (the port's copy of the
JAX package's `cli/faba_cmds/genes_cmds.py`, flags and defaults
unchanged; host only)."""

from __future__ import annotations

import os

import numpy as np

from ._common import _add_gene_qc_args


def add_parsers(sub):
    p = sub.add_parser(
        "index",
        help="build .bai indices for coordinate-sorted BAMs (the "
             "samtools-index analog; the reference requires them for "
             "ranged fetch — m6a/run.rs:660-675 check_all_bam_indices)",
    )
    p.add_argument("bam", nargs="+", help="BAM file(s) to index")
    p.add_argument("--force", action="store_true",
                   help="rebuild even when a .bai already exists")

    p = sub.add_parser(
        "genes",
        help="per-cell gene counts from BAM (gene_count/run.rs "
             "GeneCountArgs)",
    )
    p.add_argument("--bam", required=True,
                   help="BAM(s), comma-separated (multi-sample runs "
                        "write {out}.{batch}.* per batch)")
    p.add_argument("--gff", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--min-mapq", type=int, default=20)
    p.add_argument("--no-dedup", "--no-umi-dedup", dest="no_dedup",
                   action="store_true")
    p.add_argument("--cell-barcode-tag", default="CB")
    p.add_argument("--umi-tag", default="UB")
    p.add_argument("--gene-barcode-tag", default=None,
                   help="key genes by this aligner Z tag (CellRanger "
                        "GX); GFF overlap remains the fallback for "
                        "untagged reads")
    p.add_argument("--gene-type", default=None,
                   help="GFF biotype filter (empty = all biotypes)")
    p.add_argument("--row-nnz-cutoff", type=int, default=0,
                   help="drop genes with fewer non-zero cells")
    p.add_argument("--column-nnz-cutoff", type=int, default=0,
                   help="drop cells with fewer non-zero genes")
    p.add_argument("--backend", choices=["zarr", "hdf5"], default="zarr")
    p.add_argument("--zip", action="store_true",
                   help="archive outputs as .zarr.zip (the reference "
                        "default; opt-in here)")
    _add_gene_qc_args(p)
    p.add_argument(
        "--splice", action="store_true",
        help="emit spliced + unspliced backends (velocity input; the "
             "reference separates by default — declared divergence)",
    )


def _cmd_index(args):
    from ...faba.bam import bai_path_for, build_bam_index

    for bam in args.bam:
        bai = bai_path_for(bam)
        if os.path.exists(bai) and not args.force:
            print(f"{bai} exists (use --force to rebuild)")
            continue
        build_bam_index(bam, bai)
        print(f"wrote {bai}")


def _cmd_genes(args):
    bam_list = args.bam.split(",")
    gsfx = ".h5" if args.backend == "hdf5" else (
        ".zarr.zip" if args.zip else "")
    for bam_path in bam_list:
        tag = (
            "" if len(bam_list) == 1
            else "." + os.path.splitext(os.path.basename(bam_path))[0]
        )
        _run_genes_one(args, bam_path, f"{args.output}{tag}", gsfx)
    return


def _run_genes_one(args, bam_path, out_prefix, gsfx):
    """One batch of `faba genes` (gene_count/run.rs per-BAM loop):
    count, optional gene/mito QC, nnz cutoffs, backend write."""
    from ...data.sparse_io import create_sparse_from_csc
    from ...faba.genes import count_genes, count_genes_spliced

    if args.splice:
        s, u, genes, barcodes = count_genes_spliced(
            bam_path, args.gff,
            min_mapq=args.min_mapq, dedup_umi=not args.no_dedup,
            gene_barcode_tag=args.gene_barcode_tag,
        )
        create_sparse_from_csc(
            s, f"{out_prefix}.spliced{gsfx}", genes, barcodes)
        create_sparse_from_csc(
            u, f"{out_prefix}.unspliced{gsfx}", genes, barcodes)
        print(
            f"wrote backends: {out_prefix}.spliced / .unspliced "
            f"({s.nnz} spliced, {u.nnz} unspliced entries)"
        )
        return
    counts, genes, barcodes = count_genes(
        bam_path, args.gff, min_mapq=args.min_mapq,
        dedup_umi=not args.no_dedup, gene_type=args.gene_type,
        cb_tag=args.cell_barcode_tag, umi_tag=args.umi_tag,
        gene_barcode_tag=args.gene_barcode_tag,
    )
    if args.gene_qc and not args.skip_gene_qc:
        import pandas as pd

        from ...faba.cell_calling import gene_qc_masks, mito_qc
        from ...faba.genes import parse_gff_genes

        model = parse_gff_genes(args.gff, gene_type=args.gene_type)
        gene_chroms = [model.chrom_names[i] for i in model.chrom]
        mito_gene, mt_frac, mito_cell = mito_qc(
            counts, gene_chroms, mito_chr=args.mito_chr,
            keep_mito=args.keep_mito, max_mito_frac=args.max_mito_frac,
            no_mito_cell_qc=args.no_mito_cell_qc,
        )
        gk, ck = gene_qc_masks(
            counts, gene_min_cells=args.gene_min_cells,
            gene_min_counts=args.gene_min_counts,
            cell_min_genes=args.cell_min_genes,
        )
        gk &= mito_gene
        ck &= mito_cell
        pd.DataFrame(
            {
                "cell": barcodes,
                "total": np.asarray(counts.sum(axis=0)).ravel(),
                "n_genes": np.asarray((counts > 0).sum(axis=0)).ravel(),
                "mito_frac": mt_frac,
                "keep": ck,
            }
        ).to_parquet(f"{out_prefix}.cell_qc.parquet")
        print(
            f"gene qc: {int(gk.sum())}/{len(genes)} genes, "
            f"{int(ck.sum())}/{len(barcodes)} cells kept"
        )
        counts = counts[gk][:, ck]
        genes = [g for g, k in zip(genes, gk) if k]
        barcodes = [b for b, k in zip(barcodes, ck) if k]
    if args.row_nnz_cutoff > 0 or args.column_nnz_cutoff > 0:
        # output squeeze (GeneCountArgs row/column nnz cutoffs)
        csc = counts.tocsc()
        gk = np.asarray((csc > 0).sum(axis=1)).ravel() >= args.row_nnz_cutoff
        ck = np.asarray((csc > 0).sum(axis=0)).ravel() >= args.column_nnz_cutoff
        counts = csc[gk][:, ck]
        genes = [g for g, k in zip(genes, gk) if k]
        barcodes = [b for b, k in zip(barcodes, ck) if k]
    create_sparse_from_csc(counts, f"{out_prefix}{gsfx}", genes, barcodes)
    print(f"wrote backend: {out_prefix}{gsfx} "
          f"({counts.shape[0]} genes x {counts.shape[1]} cells)")

