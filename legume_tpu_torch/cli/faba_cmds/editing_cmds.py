"""faba `atoi, dartseq`: parsers and handlers (the port's copy of the JAX
package's `cli/faba_cmds/editing_cmds.py`, flags, defaults and handlers unchanged;
the stages run with numpy and scipy on the host)."""

from __future__ import annotations

import os

import numpy as np

from ._common import _add_gene_qc_args


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
    import pandas as pd

    from ...data.sparse_io import create_sparse_from_csc
    from ...faba.bam import read_bam
    from ...faba.dartseq import run_atoi, run_dartseq

    runner = run_dartseq if args.cmd == "dartseq" else run_atoi
    snp_mask = None
    if args.snp_mask_file:
        snp_mask = set()
        with open(args.snp_mask_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    snp_mask.add((parts[0], int(parts[1])))
    valid_cells = None
    if args.valid_cells:
        with open(args.valid_cells) as f:
            valid_cells = {line.strip() for line in f if line.strip()}
    run_gene_qc = args.gene_qc and not args.skip_gene_qc
    if args.cell_filter != "nnz" or run_gene_qc:
        # barcode QC on the gene-count matrix (cell_qc/mod.rs via
        # the quant stage) + gene-expression/mito cell QC; the
        # surviving set gates the site pipeline like an implicit
        # --valid-cells. One gene-count pass serves both.
        if not args.gff:
            raise SystemExit(
                f"{args.cmd} --cell-filter/--gene-qc needs --gff "
                "(both run on gene counts)"
            )
        from ...faba.cell_calling import (
            CellCallParams,
            call_cells,
            gene_qc_masks,
            mito_qc,
        )
        from ...faba.genes import count_genes, parse_gff_genes

        gcounts, _genes, gbarcodes = count_genes(
            args.bam, args.gff, min_mapq=args.min_mapq,
            cb_tag=args.cell_barcode_tag, umi_tag=args.umi_tag,
        )
        keep_cells = np.ones(len(gbarcodes), bool)
        if args.cell_filter != "nnz":
            keep_cells &= call_cells(
                gcounts,
                CellCallParams(
                    filter=args.cell_filter,
                    min_counts=args.cell_min_umis,
                    expected_cells=args.expected_cells,
                    ed_fdr=args.cell_fdr,
                    ed_n_sims=args.cell_sims,
                    ed_ambient_lo=args.ambient_lo,
                    ed_ambient_hi=args.ambient_hi,
                    ed_min_umis=args.cell_min_umis,
                ),
            )
        if run_gene_qc:
            model = parse_gff_genes(args.gff)
            gene_chroms = [model.chrom_names[i] for i in model.chrom]
            _gk, ck = gene_qc_masks(
                gcounts, gene_min_cells=args.gene_min_cells,
                gene_min_counts=args.gene_min_counts,
                cell_min_genes=args.cell_min_genes,
            )
            _mg, _frac, mito_cell = mito_qc(
                gcounts, gene_chroms, mito_chr=args.mito_chr,
                keep_mito=args.keep_mito,
                max_mito_frac=args.max_mito_frac,
                no_mito_cell_qc=args.no_mito_cell_qc,
            )
            keep_cells &= ck & mito_cell
        called = {b for b, k in zip(gbarcodes, keep_cells) if k}
        with open(f"{args.output}.called_cells.txt", "w") as f:
            f.write("\n".join(sorted(called)) + "\n")
        print(
            f"cell qc ({args.cell_filter}"
            f"{', gene-qc' if run_gene_qc else ''}): "
            f"{len(called)}/{len(gbarcodes)} barcodes kept"
        )
        valid_cells = called if valid_cells is None else (valid_cells & called)
    if args.cell_scan:
        # null-cell scan: score WT cells' genome-wide conversion
        # activity against depth-matched control cells and keep the
        # editing-competent set (cell_activity.rs call_and_report)
        import json as _json

        from ...faba.cell_activity import call_competent_cells
        from ...faba.dartseq import A, C, G, T, editing_activity_tallies

        wt_recs = read_bam(
            args.bam, cb_tag=args.cell_barcode_tag, umi_tag=args.umi_tag
        )
        ct_recs = read_bam(
            args.control_bam, cb_tag=args.cell_barcode_tag,
            umi_tag=args.umi_tag,
        )
        rb, ab = (C, T) if args.cmd == "dartseq" else (A, G)
        wt_e, wt_n, ct_e, ct_n = editing_activity_tallies(
            wt_recs, ct_recs, ref_base=rb, alt_base=ab,
            min_mapq=args.min_mapq, min_baseq=args.min_base_quality,
        )
        call = call_competent_cells(
            wt_e, wt_n, ct_e, ct_n,
            min_coverage=args.cell_scan_min_coverage,
            reject_tolerance=(
                args.cell_scan_tolerance
                if args.cell_scan_tolerance is not None
                else 1.0
            ),
            control_tail=args.cell_scan_control_tail,
        )
        competent = {
            wt_recs.barcodes[i] for i in np.nonzero(call.keep)[0]
        }
        report = {
            "n_scored": call.n_scored,
            "n_kept": len(competent),
            "kept_frac": round(call.kept_frac, 4),
            "selected_rate": call.selected_rate,
            "rejected_rate": call.rejected_rate,
            "control_rate": call.control_rate,
            "rejected_over_control": call.rejected_over_control,
            "control_percentile": call.control_percentile,
        }
        if (args.reader_genes or args.writer_genes) and args.gff:
            # diagnostic only (cell_activity.rs log_family_expression):
            # median per-cell expression of the listed genes in the
            # kept vs dropped pools
            from ...faba.genes import count_genes

            gcounts2, genes2, gb2 = count_genes(
                args.bam, args.gff, min_mapq=args.min_mapq,
                cb_tag=args.cell_barcode_tag, umi_tag=args.umi_tag,
            )
            kept_ix = [i for i, b in enumerate(gb2) if b in competent]
            drop_ix = [i for i, b in enumerate(gb2) if b not in competent]
            gl = {g.lower(): i for i, g in enumerate(genes2)}
            for fam, arg in (("reader", args.reader_genes),
                             ("writer", args.writer_genes)):
                if not arg:
                    continue
                ids = [gl[g.strip().lower()] for g in arg.split(",")
                       if g.strip().lower() in gl]
                if not ids:
                    continue
                dense = np.asarray(gcounts2[ids].todense())
                report[f"{fam}_median_kept"] = float(
                    np.median(dense[:, kept_ix].sum(0)) if kept_ix else 0.0
                )
                report[f"{fam}_median_dropped"] = float(
                    np.median(dense[:, drop_ix].sum(0)) if drop_ix else 0.0
                )
        with open(f"{args.output}.cell_scan.json", "w") as f:
            _json.dump(report, f, indent=1)
        print(
            f"cell scan: kept {len(competent)}/{call.n_scored} scored "
            f"cells (rejected/control = {call.rejected_over_control:.2f})"
        )
        scan_cells = competent
    else:
        scan_cells = None
    if args.gene_barcode_tag and not args.gff:
        raise SystemExit(f"{args.cmd} --gene-barcode-tag needs --gff")
    res = runner(
        args.bam, args.control_bam, max_p=args.max_p, min_alt=args.min_alt,
        min_coverage=args.min_coverage, min_mapq=args.min_mapq,
        min_baseq=args.min_base_quality, valid_cells=valid_cells,
        wt_cells=scan_cells,
        eps=args.error_rate, rho=args.overdispersion, snp_mask=snp_mask,
        cb_tag=args.cell_barcode_tag, umi_tag=args.umi_tag,
        gene_barcode_tag=args.gene_barcode_tag,
        include_missing_barcode=args.include_missing_barcode,
        gff=args.gff,
    )
    from ...faba.bam import read_bam_ref_names

    ref_names = read_bam_ref_names(args.bam)
    if args.cmd == "dartseq" and (
        getattr(args, "detect_atoi", False) or getattr(args, "atoi_mask", None)
    ):
        from ...faba.dartseq import atoi_confounder_mask, filter_sites, run_atoi

        if args.atoi_mask:
            adf = pd.read_parquet(args.atoi_mask)
            atoi_sites = set(zip(adf["chrom"].astype(str), adf["pos"].astype(int)))
        else:
            ares = run_atoi(
                args.bam, args.control_bam, max_p=args.atoi_pvalue,
                min_alt=args.atoi_min_conversion,
                min_coverage=args.atoi_min_coverage, min_mapq=args.min_mapq,
                min_baseq=args.min_base_quality, valid_cells=valid_cells,
                snp_mask=snp_mask,
            )
            adf = pd.DataFrame({
                "chrom": [ref_names[r] for r in ares.sites[:, 0]],
                "pos": ares.sites[:, 1],
                "strand": ares.strand,
            })
            adf.to_parquet(f"{args.output}.atoi_mask.sites.parquet")
            atoi_sites = set(zip(adf["chrom"].astype(str), adf["pos"].astype(int)))
        clear = atoi_confounder_mask(
            res.sites[:, 0], res.sites[:, 1], res.strand, ref_names, atoi_sites
        )
        print(f"A-to-I confounder mask: {len(clear)} m6A candidates -> "
              f"{int(clear.sum())} ({len(atoi_sites)} edited sites)")
        res = filter_sites(res, clear)
    if args.cmd == "dartseq" and getattr(args, "genome", None):
        from ...faba.context import read_fasta
        from ...faba.dartseq import filter_sites, m6a_motif_mask

        keep = m6a_motif_mask(
            read_fasta(args.genome), ref_names,
            res.sites[:, 0], res.sites[:, 1], res.strand,
            check_r_site=not args.no_check_r_site,
        )
        n0 = len(keep)
        res = filter_sites(res, keep)
        print(f"RAC motif gate: {n0} called sites -> {int(keep.sum())}")
    if args.site_min_cells > 0 and res.cell_counts.shape[0]:
        # site-axis sparsity gate (run.rs site_min_cells): the site
        # matrix drops sparse sites; the sites table keeps them
        from ...faba.dartseq import filter_sites as _fs

        ncells_per_site = np.asarray(
            (res.cell_counts > 0).sum(axis=1)
        ).ravel()
        keep_s = ncells_per_site >= args.site_min_cells
        print(
            f"site-min-cells {args.site_min_cells}: "
            f"{len(keep_s)} sites -> {int(keep_s.sum())}"
        )
        res = _fs(res, keep_s)
    df = pd.DataFrame(
        {
            "chrom": [ref_names[r] for r in res.sites[:, 0]],
            "pos": res.sites[:, 1],
            "strand": res.strand,
            "name": res.site_names,
            **{k: v for k, v in res.stats.items()},
        }
    )
    df.to_parquet(f"{args.output}.sites.parquet")
    if res.cell_counts.shape[0]:
        create_sparse_from_csc(
            res.cell_counts, f"{args.output}.zarr", res.site_names, res.barcodes
        )
    if args.output_bed_file and res.cell_counts.shape[0]:
        # per-(site, cell) conversion rows, bgzip-compatible gzip
        # (editing/bed_output.rs write_bed: chrom start stop strand
        # gene converted unconverted barcode site_pos [cell_type]);
        # row order is total — (site, barcode) — by construction
        import gzip as _gzip

        from ...faba.cell_calling import load_cell_membership, match_barcode
        from ...faba.dartseq import per_cell_coverage_at_sites

        membership = None
        if args.cell_membership:
            membership = load_cell_membership(
                args.cell_membership,
                barcode_col=args.membership_barcode_col,
                celltype_col=args.membership_celltype_col,
            )
        gene_of_site = ["."] * len(res.site_names)
        if args.gff:
            from ...faba.genes import assign_reads_to_genes, parse_gff_genes

            _model = parse_gff_genes(args.gff)
            gids = assign_reads_to_genes(
                res.sites[:, 0], res.sites[:, 1], res.sites[:, 1] + 1,
                ref_names, _model,
            )
            gene_of_site = [
                _model.names[g] if g >= 0 else "." for g in gids
            ]
        cov_sc = per_cell_coverage_at_sites(
            read_bam(args.bam, cb_tag=args.cell_barcode_tag,
                     umi_tag=args.umi_tag),
            res.sites[:, 0], res.sites[:, 1], len(res.barcodes),
            min_mapq=args.min_mapq,
        ).tocsr()
        conv = res.cell_counts.tocsr()
        bed_path = f"{args.output}.bed.gz"
        with _gzip.open(bed_path, "wt") as f:
            for si in range(conv.shape[0]):
                row = conv.getrow(si).tocoo()
                order = np.argsort(
                    [res.barcodes[c] for c in row.col], kind="stable"
                )
                chrom = ref_names[res.sites[si, 0]]
                pos = int(res.sites[si, 1])
                strand = res.strand[si] if res.strand is not None else "."
                for oi in order:
                    cb_i = int(row.col[oi])
                    cb = res.barcodes[cb_i]
                    converted = int(row.data[oi])
                    cov = int(cov_sc[si, cb_i])
                    cols = [
                        chrom, pos, pos + 1, strand, gene_of_site[si],
                        converted, max(cov - converted, 0), cb, pos,
                    ]
                    if args.output_cell_types and membership is not None:
                        cols.append(
                            match_barcode(
                                membership, cb,
                                exact=args.exact_barcode_match,
                            ) or "unknown"
                        )
                    f.write("\t".join(str(c) for c in cols) + "\n")
        print(f"wrote {bed_path}")
    if args.gff and not args.no_mixture and res.cell_counts.shape[0]:
        from ...faba.genes import parse_gff_exons, parse_gff_genes
        from ...faba.mixture import MixtureParams, run_mixture

        model = parse_gff_genes(args.gff)
        exons = parse_gff_exons(args.gff, model)
        cov = None
        if args.mixture_weight == "posterior":
            from ...faba.dartseq import per_cell_coverage_at_sites

            cov = per_cell_coverage_at_sites(
                read_bam(args.bam), res.sites[:, 0], res.sites[:, 1],
                len(res.barcodes), min_mapq=args.min_mapq,
            )
        modality = "m6a" if args.cmd == "dartseq" else "atoi"
        mat, names, components, bw = run_mixture(
            res.cell_counts, res.sites[:, 0], res.sites[:, 1], res.strand,
            ref_names, model, exons,
            modality=modality,
            params=MixtureParams(
                min_sites=args.mixture_min_sites,
                max_k=args.mixture_max_k,
                bandwidth=args.mixture_bandwidth,
                drop_single_component=args.drop_single_component,
            ),
            weight_mode=args.mixture_weight,
            prior_alpha=args.mixture_prior_alpha,
            prior_beta=args.mixture_prior_beta,
            cell_coverage=cov,
        )
        comp_path = f"{args.output}.{modality}_components.parquet"
        components.to_parquet(comp_path)
        if mat is not None:
            create_sparse_from_csc(
                mat, f"{args.output}.mixture.zarr", names, res.barcodes
            )
            print(
                f"wrote {args.output}.mixture.zarr "
                f"({len(names)} components, bandwidth {bw:.1f} nt) + "
                f"{comp_path}"
            )
        else:
            print(f"mixture: no gene met min-sites; wrote empty {comp_path}")
    print(f"wrote {args.output}.sites.parquet ({len(df)} sites)")

