"""faba `apa`: parsers and handlers (the port's copy of the JAX
package's `cli/faba_cmds/apa_cmds.py`, flags, defaults and handlers unchanged;
the stages run with numpy and scipy on the host)."""

from __future__ import annotations

import os

import numpy as np


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
    """`faba apa` dispatch: SCAPE mixture (default) with a logged
    fallback to the simple pileup path when no 3'UTR regions are
    derivable (run.rs:665-700 method dispatch)."""
    import logging

    import pandas as pd

    from ...data.sparse_io import create_sparse_from_csc

    log = logging.getLogger(__name__)
    bam_paths = [b for b in args.bam.split(",") if b]

    method = args.method
    utrs_available = bool(args.utr_bed)
    if method == "mixture" and not utrs_available and args.gff:
        from ...faba.apa_mixture import build_utr_regions_from_gff

        utrs_available = len(build_utr_regions_from_gff(args.gff)) > 0
    if method == "mixture" and not utrs_available:
        log.warning(
            "apa: no 3'UTR regions derivable from the GFF (no "
            "three_prime_UTR or CDS rows) and no --utr-bed; falling "
            "back to --method simple"
        )
        method = "simple"

    if method == "mixture":
        from ...faba.apa_mixture import ScapeParams, load_valid_set, run_apa_mixture

        params = ScapeParams(
            mu_f=args.mu_f, sigma_f=args.sigma_f, theta_step=args.theta_step,
            min_ws=args.min_ws, skirt_eta=args.skirt_eta,
            skirt_mult=args.skirt_mult, merge_beta_mult=args.merge_beta_mult,
            apa_max_sites=args.apa_max_sites,
            min_coverage=max(args.min_reads, 1),
            merge_distance=args.merge_distance,
            min_beta=args.min_beta, max_beta=args.max_beta,
            min_fragments=args.min_fragments,
            min_utr_length=args.min_utr_length,
            # 0 = unset on the shared flag; the mixture default is 10
            polya_min_tail_length=args.polya_min_tail_length or 10,
            polya_max_non_at=args.polya_max_non_a_or_t,
            internal_prime_window=args.polya_internal_prime_window,
            internal_prime_count=args.polya_internal_prime_count,
            min_mapq=args.min_mapq,
        )
        genome_seqs = None
        if args.genome:
            from ...faba.context import read_fasta

            genome_seqs = read_fasta(args.genome)
        pre = None
        if args.pre_sites:
            import numpy as np

            pre = {}
            with open(args.pre_sites) as f:
                for line in f:
                    t = line.split()
                    if len(t) >= 4:
                        pre.setdefault(t[3], []).append(float(t[1]))
            pre = {k: np.asarray(v) for k, v in pre.items()}
        res = run_apa_mixture(
            bam_paths, args.gff,
            utr_bed=args.utr_bed, params=params, pre_sites=pre,
            atoi_mask=args.atoi_mask, snp_mask=args.snp_mask,
            valid_cells=load_valid_set(args.valid_cells) if args.valid_cells else None,
            valid_genes=load_valid_set(args.valid_genes) if args.valid_genes else None,
            skip_gene_qc=args.skip_gene_qc,
            gene_min_cells=args.gene_min_cells,
            gene_min_counts=args.gene_min_counts,
            cell_min_genes=args.cell_min_genes,
            no_umi_dedup=args.no_umi_dedup,
            write_mixture=args.write_mixture,
            apa_em_pdui=args.apa_em_pdui,
            compute_pdui=args.compute_pdui,
            drop_single_component=args.drop_single_component,
            genome_seqs=genome_seqs,
        )

        import numpy as np

        def _squeeze(mat, rows, cols):
            # row/column nnz cutoffs (run.rs qc_cutoffs via SqueezeCutoffs)
            csr = mat.tocsr()
            keep_r = np.diff(csr.indptr) >= args.row_nnz_cutoff
            csc = csr[keep_r].tocsc()
            keep_c = np.diff(csc.indptr) >= args.column_nnz_cutoff
            out = csc[:, keep_c]
            return (
                out,
                [r for r, k in zip(rows, keep_r) if k],
                [c for c, k in zip(cols, keep_c) if k],
            )

        multi = len(bam_paths) > 1
        wrote = []
        if args.compute_pdui and res.pdui_names:
            for b, mat in enumerate(res.pdui):
                tag = f".{b}" if multi else ""
                path = f"{args.output}{tag}.apa.zarr"
                m, rn, cn = _squeeze(mat, res.pdui_names, res.barcodes[b])
                if not m.shape[0]:
                    continue
                create_sparse_from_csc(m, path, rn, cn)
                wrote.append(path)
        if args.write_mixture and res.mixture is not None and res.mixture_names:
            for b, mat in enumerate(res.mixture):
                tag = f".{b}" if multi else ""
                path = f"{args.output}{tag}.apa_mixture.zarr"
                m, rn, cn = _squeeze(mat, res.mixture_names, res.barcodes[b])
                if not m.shape[0]:
                    continue
                create_sparse_from_csc(m, path, rn, cn)
                wrote.append(path)
        res.annotations.to_parquet(f"{args.output}.apa_sites.parquet")
        wrote.append(f"{args.output}.apa_sites.parquet")
        print(
            f"apa mixture: {len(res.annotations)} sites, wrote "
            + ", ".join(wrote)
        )
        return

    from ...faba.apa import run_apa

    apa = run_apa(
        bam_paths[0], args.gff,
        min_mapq=args.min_mapq, peak_window=args.peak_window,
        min_reads=args.min_reads,
        polya_min_tail_length=args.polya_min_tail_length,
        polya_max_non_at=args.polya_max_non_a_or_t,
        utr_bed=args.utr_bed,
    )
    if apa.counts.shape[0]:
        create_sparse_from_csc(
            apa.counts, f"{args.output}.zarr", apa.site_names, apa.barcodes
        )
    if args.compute_pdui_triplets:
        from ...faba.apa import compute_pdui

        gg, cc2, vv = compute_pdui(apa)
        pd.DataFrame(
            {"gene": gg, "cell": cc2, "pdui": vv}
        ).to_parquet(f"{args.output}.pdui.parquet")
        print(f"wrote {args.output}.pdui.parquet ({len(vv)} gene-cell pairs)")
    pd.DataFrame(
        {"gene": list(apa.distal_index),
         "distal_usage": list(apa.distal_index.values())}
    ).to_parquet(f"{args.output}.distal.parquet")
    print(
        f"wrote {args.output}.zarr ({apa.counts.shape[0]} PAS sites) "
        f"+ .distal.parquet"
    )

