"""`data-beans` binary: sparse backend CLI (the port of the JAX package's
`cli/beans_cli.py`: the same subcommands, flags and defaults).

`qc` and `histogram` compute the per-cell statistics on the device
(`data/qc.py`) and take `--device` (default `cuda`); every other
subcommand runs on the host. `tile-cache` is kept in the parser and
refuses to run: the port's projection kernel reads column-sorted COO
blocks directly, with no prebucketed tiles."""

from __future__ import annotations

import argparse
import numpy as np


def run_beans(argv):
    ap = argparse.ArgumentParser(prog="data-beans", description="sparse matrix backends")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("from-mtx", help="build a backend from MatrixMarket")
    p.add_argument("--mtx", required=True)
    p.add_argument("--rows", default=None, help="row (gene) names file")
    p.add_argument("--cols", default=None, help="column (cell) names file")
    p.add_argument("--output", required=True)
    p.add_argument("--streaming", action="store_true",
                   help="force the bounded-memory external-sort path")
    p.add_argument("--do-squeeze", action="store_true",
                   help="drop rows/cols below the nnz cutoffs after build")
    p.add_argument("--row-nnz-cutoff", type=int, default=1)
    p.add_argument("--column-nnz-cutoff", type=int, default=1)
    p = sub.add_parser("from-h5ad", help="build from AnnData .h5ad")
    p.add_argument("--h5ad", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--do-squeeze", action="store_true",
                   help="drop rows/cols below the nnz cutoffs after build")
    p.add_argument("--row-nnz-cutoff", type=int, default=1)
    p.add_argument("--column-nnz-cutoff", type=int, default=1)
    p = sub.add_parser("from-10x-matrix", help="build from CellRanger .h5")
    p.add_argument("--h5", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--do-squeeze", action="store_true",
                   help="drop rows/cols below the nnz cutoffs after build")
    p.add_argument("--row-nnz-cutoff", type=int, default=1)
    p.add_argument("--column-nnz-cutoff", type=int, default=1)
    p = sub.add_parser("from-10x-molecule", help="build from molecule_info.h5")
    p.add_argument("--h5", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--min-umi", type=int, default=1, help="min reads per molecule")
    p = sub.add_parser("from-triplets", help="Xenium/transcript triplet table")
    p.add_argument("--table", required=True, help="parquet/csv, one row per transcript")
    p.add_argument("--output", required=True)
    p.add_argument("--feature-col", default="feature_name")
    p.add_argument("--cell-col", default="cell_id")
    p = sub.add_parser(
        "from-zarr",
        help="build from a raw CSC/CSR zarr store (Xenium "
             "cell_feature_matrix.zarr[.zip]); field paths as in the "
             "reference's from-zarr",
    )
    p.add_argument("zarr_file")
    p.add_argument("--output", "-o", required=True)
    p.add_argument("--data-field", "-d", default="/cell_features/data")
    p.add_argument("--indices-field", "-i", default="/cell_features/indices")
    p.add_argument("--indptr-field", "-p", default="/cell_features/indptr")
    p.add_argument("--pointer-type", "-t", choices=["row", "column"],
                   default="row",
                   help="what indptr runs over: row = CSR, column = CSC")
    p.add_argument("--row-id-field", "-r", default="/cell_features/feature_ids")
    p.add_argument("--row-name-field", "-n", default="/cell_features/feature_keys")
    p.add_argument("--row-type-field", "-f", default="/cell_features/feature_types")
    p.add_argument("--select-row-type", default="gene,peak",
                   help="comma patterns; ANY case-insensitive substring match keeps the row")
    p.add_argument("--remove-row-type", default="aggregate")
    p.add_argument("--column-name-field", "-c", default="/cell_features/cell_id")
    p.add_argument("--do-squeeze", action="store_true")
    p.add_argument("--row-nnz-cutoff", type=int, default=1)
    p.add_argument("--column-nnz-cutoff", type=int, default=1)
    p = sub.add_parser("from-fragments", help="ATAC fragments -> tile/peak counts")
    p.add_argument("--fragments", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--tile-size", type=int, default=5000)
    p.add_argument("--peaks", default=None, help="BED of peaks (else tiles)")
    p = sub.add_parser("list-rows", help="print row (feature) names")
    p.add_argument("backend")
    p = sub.add_parser("list-columns", help="print column (cell) names")
    p.add_argument("backend")
    p = sub.add_parser(
        "list-h5", help="list groups/datasets inside an HDF5 file"
    )
    p.add_argument("file")
    p = sub.add_parser(
        "list-zarr", help="list arrays inside a zarr store (.zarr dir or .zarr.zip)"
    )
    p.add_argument("file")
    p = sub.add_parser("take-columns", help="dense TSV of selected columns")
    p.add_argument("backend")
    p.add_argument("--columns", required=True, help="file: one column name per line")
    p.add_argument("--output", required=True, help="TSV out (.gz ok)")
    p = sub.add_parser(
        "take-rows", help="dense TSV of selected rows (transposed: cells x rows)"
    )
    p.add_argument("backend")
    p.add_argument("--rows", required=True, help="file: one row name per line")
    p.add_argument("--output", required=True, help="TSV out (.gz ok)")
    p = sub.add_parser("sort-rows", help="reorder feature rows by a name list")
    p.add_argument("backend")
    p.add_argument("--rows", required=True, help="file: one row name per line")
    p.add_argument("--output", required=True)
    p = sub.add_parser(
        "convert",
        help="convert backend format (zarr <-> h5 <-> zarr.zip)",
    )
    p.add_argument("backend")
    p.add_argument("--output", required=True,
                   help=".zarr dir, .zarr.zip archive, or .h5 file")
    p.add_argument("--zip", action="store_true",
                   help="archive a zarr target as {output}.zarr.zip "
                        "(main.rs convert --no-zip inverse; ignored for h5)")
    p = sub.add_parser(
        "tile-cache", help="prebucket Pallas SpMM tiles next to the backend"
    )
    p.add_argument("backend")
    p.add_argument("--block-size", type=int, default=8192)
    p = sub.add_parser("align", help="rewrite backends onto the shared row union")
    p.add_argument("backends", nargs="+")
    p.add_argument("--suffix", default=".aligned", help="output suffix per backend")
    p = sub.add_parser("reorder", help="reorder columns by a name list")
    p.add_argument("backend")
    p.add_argument("--columns", required=True, help="file with one column name per line")
    p.add_argument("--output", required=True)
    p = sub.add_parser("squeeze", help="drop all-zero feature rows")
    p.add_argument("backend")
    p.add_argument("--output", required=True)
    p.add_argument("--min-row-total", type=float, default=1.0)
    p = sub.add_parser("subsample", help="uniform cell and/or gene subsample")
    p.add_argument("backend")
    p.add_argument("--output", required=True)
    p.add_argument("-n", "--n-columns", "--cells", dest="n_columns",
                   type=int, default=None)
    p.add_argument("--cell-frac", type=float, default=None)
    p.add_argument("--genes", type=int, default=None)
    p.add_argument("--gene-frac", type=float, default=None)
    p.add_argument("--seed", type=int, default=0)
    p = sub.add_parser("subset", help="subset columns and/or rows by name file")
    p.add_argument("backend")
    p.add_argument("--output", required=True)
    p.add_argument("--columns", default=None, help="file: one column name per line")
    p.add_argument("--rows", default=None, help="file: one row name per line")
    p = sub.add_parser("stat", help="summary statistics JSON")
    p.add_argument("backend")
    p.add_argument("--peaks", default=None, help="BED of peaks (else tiles)")
    p = sub.add_parser("to-mtx", help="export MEX (mtx + features + barcodes)")
    p.add_argument("backend")
    p.add_argument("--output", required=True)
    p = sub.add_parser("to-h5ad", help="export AnnData .h5ad")
    p.add_argument("backend")
    p.add_argument("--output", required=True)
    p.add_argument("--obs", default=None,
                   help="TSV/parquet keyed by cell: extra obs columns")
    p.add_argument("--var", default=None,
                   help="TSV/parquet keyed by gene: extra var columns")
    p = sub.add_parser("merge-backend", help="merge backends column-wise")
    p.add_argument("backends", nargs="+")
    p.add_argument("--output", required=True)
    p = sub.add_parser("qc", help="cell QC stats + keep mask")
    p.add_argument("backend")
    p.add_argument("--device", default="cuda", help="torch device of the QC sums")
    p.add_argument("--output", required=True)
    p.add_argument("--min-total", "--qc-min-counts", dest="min_total",
                   type=float, default=0)
    p.add_argument("--min-genes", "--qc-min-cell-nnz", dest="min_genes",
                   type=int, default=0)
    p.add_argument("--max-mito-frac", type=float, default=1.0)
    p.add_argument("--mads", type=float, default=5.0,
                   help="MAD fence width on log totals/genes (qc_mads)")
    p.add_argument("--no-mad-on-counts", action="store_true")
    p.add_argument("--no-mad-on-genes", action="store_true")
    p.add_argument("--mito-pattern", default=None,
                   help="regex for mito genes (default: MT- prefixes)")
    p.add_argument("--ribo-pattern", default=None,
                   help="regex for ribo genes (enables ribo_frac)")
    p.add_argument("--max-ribo-frac", type=float, default=1.0)
    p.add_argument("--feature-min-cells", type=int, default=0,
                   help="also write a gene keep list: genes expressed "
                        "in >= this many cells")
    p.add_argument("--report", action="store_true",
                   help="write {output}.qc.report.json summary")
    p = sub.add_parser("info", help="backend shape and nnz")
    p.add_argument("backend")
    p = sub.add_parser("histogram", help="ASCII histogram of per-cell totals")
    p.add_argument("backend")
    p.add_argument("--device", default="cuda", help="torch device of the QC sums")
    p.add_argument("--bins", type=int, default=20)
    p = sub.add_parser("merge-mtx", help="merge MatrixMarket files column-wise")
    p.add_argument("mtx", nargs="+")
    p.add_argument("--rows", default=None, help="shared row (gene) names file")
    p.add_argument("--cols", nargs="+", default=None, help="one column file per mtx")
    p.add_argument("--output", required=True)
    args = ap.parse_args(argv)

    if args.cmd == "merge-mtx":
        from ..data.builders import merge_mtx

        merge_mtx(args.mtx, args.output, rows_file=args.rows, cols_files=args.cols)
        print(f"wrote backend: {args.output}")
        return

    from ..data import open_sparse_matrix

    if args.cmd == "histogram":

        from ..data.qc import compute_cell_qc

        be = open_sparse_matrix(args.backend)
        qc = compute_cell_qc(be, device=args.device)
        lx = np.log10(np.maximum(qc.total, 1))
        hist, edges = np.histogram(lx, bins=args.bins)
        peak = max(hist.max(), 1)
        for h, e in zip(hist, edges):
            bar = "#" * int(50 * h / peak)
            print(f"10^{e:5.2f} | {bar} {h}")
        print(f"median total: {np.median(qc.total):.0f}")
        return

    def _maybe_squeeze(be):
        if getattr(args, "do_squeeze", False):
            from ..data.builders import apply_build_squeeze

            be = apply_build_squeeze(
                be, args.output,
                row_nnz_cutoff=args.row_nnz_cutoff,
                column_nnz_cutoff=args.column_nnz_cutoff,
            )
        return be

    if args.cmd == "from-mtx":
        from ..data.builders import from_mtx

        be = from_mtx(args.mtx, args.output, rows_file=args.rows, cols_file=args.cols,
                      streaming=args.streaming or None)
        _maybe_squeeze(be)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "from-h5ad":
        from ..data.builders import from_h5ad

        be = from_h5ad(args.h5ad, args.output)
        _maybe_squeeze(be)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "from-10x-matrix":
        from ..data.builders import from_10x_h5

        be = from_10x_h5(args.h5, args.output)
        _maybe_squeeze(be)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "align":
        from ..data.builders import align_backends

        outs = [b.rstrip("/").rsplit(".zarr", 1)[0] + args.suffix for b in args.backends]
        align_backends(list(args.backends), outs)
        print(f"wrote aligned backends: {' '.join(outs)}")
    elif args.cmd == "reorder":
        from ..data.builders import _read_name_file, reorder_backend

        reorder_backend(args.backend, args.output, _read_name_file(args.columns))
        print(f"wrote backend: {args.output}")
    elif args.cmd == "squeeze":
        from ..data.builders import squeeze_backend

        be = squeeze_backend(
            args.backend, args.output, min_row_total=args.min_row_total
        )
        print(f"wrote backend: {args.output} ({be.num_rows} rows kept)")
    elif args.cmd == "subsample":
        from ..data.builders import subsample_backend

        if (
            args.n_columns is None and args.cell_frac is None
            and args.genes is None and args.gene_frac is None
        ):
            raise SystemExit(
                "subsample: provide --cells/--cell-frac and/or --genes/--gene-frac"
            )
        subsample_backend(
            args.backend, args.output, args.n_columns,
            cell_frac=args.cell_frac, n_genes=args.genes,
            gene_frac=args.gene_frac, seed=args.seed,
        )
        print(f"wrote backend: {args.output}")
    elif args.cmd == "subset":

        from ..data.builders import _read_name_file, subset_backend
        from ..data.sparse_io import open_sparse_matrix

        be = open_sparse_matrix(args.backend)
        cols = rows = None
        if args.columns:
            want = set(_read_name_file(args.columns))
            cols = np.asarray(
                [i for i, n in enumerate(be.column_names()) if n in want]
            )
        if args.rows:
            want = set(_read_name_file(args.rows))
            rows = np.asarray([i for i, n in enumerate(be.row_names()) if n in want])
        subset_backend(args.backend, args.output, columns=cols, rows=rows)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "stat":
        import json as _json

        from ..data.builders import backend_stat

        print(_json.dumps(backend_stat(args.backend)))
    elif args.cmd == "from-10x-molecule":
        from ..data.builders import from_10x_molecule

        from_10x_molecule(args.h5, args.output, min_umi=args.min_umi)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "from-triplets":
        from ..data.builders import from_triplets_table

        from_triplets_table(
            args.table, args.output,
            feature_col=args.feature_col, cell_col=args.cell_col,
        )
        print(f"wrote backend: {args.output}")
    elif args.cmd == "from-zarr":
        from ..data.builders import from_zarr_store

        from_zarr_store(
            args.zarr_file, args.output,
            data_field=args.data_field,
            indices_field=args.indices_field,
            indptr_field=args.indptr_field,
            pointer_type=args.pointer_type,
            row_id_field=args.row_id_field,
            row_name_field=args.row_name_field,
            row_type_field=args.row_type_field,
            select_row_type=args.select_row_type,
            remove_row_type=args.remove_row_type,
            column_name_field=args.column_name_field,
            do_squeeze=args.do_squeeze,
            row_nnz_cutoff=args.row_nnz_cutoff,
            column_nnz_cutoff=args.column_nnz_cutoff,
        )
        print(f"wrote backend: {args.output}")
    elif args.cmd == "from-fragments":
        from ..data.builders import from_fragments

        from_fragments(
            args.fragments, args.output,
            tile_size=args.tile_size, peaks_bed=args.peaks,
        )
        print(f"wrote backend: {args.output}")
    elif args.cmd == "to-mtx":
        from ..data.builders import to_mtx

        to_mtx(args.backend, args.output)
        print(f"wrote {args.output}.matrix.mtx.gz")
    elif args.cmd == "to-h5ad":
        from ..data.builders import to_h5ad

        to_h5ad(args.backend, args.output, obs_file=args.obs, var_file=args.var)
        print(f"wrote {args.output}")
    elif args.cmd == "merge-backend":
        from ..data.builders import merge_backends

        merge_backends(args.backends, args.output)
        print(f"wrote backend: {args.output}")
    elif args.cmd == "qc":
        import pandas as pd

        from ..data.qc import compute_cell_qc

        be = open_sparse_matrix(args.backend)
        qc = compute_cell_qc(
            be, mito_pattern=args.mito_pattern, ribo_pattern=args.ribo_pattern,
            device=args.device,
        )
        keep = qc.keep_mask(
            min_total=args.min_total,
            min_genes=args.min_genes,
            max_mito_frac=args.max_mito_frac,
            max_ribo_frac=args.max_ribo_frac,
            nmads=args.mads,
            mad_on_counts=not args.no_mad_on_counts,
            mad_on_genes=not args.no_mad_on_genes,
        )
        cols = {
            "cell": be.column_names(),
            "total": qc.total,
            "n_genes": qc.n_genes,
            "mito_frac": qc.mito_frac,
            "keep": keep,
        }
        if qc.ribo_frac is not None:
            cols["ribo_frac"] = qc.ribo_frac
        pd.DataFrame(cols).to_parquet(f"{args.output}.qc.parquet")
        extra = ""
        if args.feature_min_cells > 0:
            # count support among KEPT cells only (qc_feature_min_cells
            # contract: debris-only support must not pass the gene gate)
            from ..data.qc import feature_cells_kept

            fc = feature_cells_kept(be, keep, device=args.device)
            fmask = fc >= args.feature_min_cells
            pd.DataFrame(
                {"gene": be.row_names(), "cells_expressing": fc,
                 "keep": fmask}
            ).to_parquet(f"{args.output}.qc.features.parquet")
            extra = f", {int(fmask.sum())}/{len(fmask)} genes kept"
        if args.report:
            import json as _json

            with open(f"{args.output}.qc.report.json", "w") as f:
                _json.dump(qc.report(), f, indent=2)
        print(f"wrote {args.output}.qc.parquet ({keep.sum()}/{len(keep)} kept{extra})")
    elif args.cmd == "info":
        be = open_sparse_matrix(args.backend)
        print(f"rows: {be.num_rows}\ncols: {be.num_columns}\nnnz: {be.num_nonzeros}")
    elif args.cmd == "list-rows":
        for n in open_sparse_matrix(args.backend).row_names():
            print(n)
    elif args.cmd == "list-columns":
        for n in open_sparse_matrix(args.backend).column_names():
            print(n)
    elif args.cmd == "list-h5":
        from ..data.listing import list_h5

        for line in list_h5(args.file):
            print(line)
    elif args.cmd == "list-zarr":
        from ..data.listing import list_zarr

        for line in list_zarr(args.file):
            print(line)
    elif args.cmd in ("take-columns", "take-rows"):
        import pandas as pd

        from ..data.builders import _read_name_file

        be = open_sparse_matrix(args.backend)
        # names read once: each call decodes the store's name array
        row_names, col_names = be.row_names(), be.column_names()
        if args.cmd == "take-columns":
            want = _read_name_file(args.columns)
            pos = {n: i for i, n in enumerate(col_names)}
            idx = np.asarray([pos[n] for n in want if n in pos], np.int64)
            dense = be.read_columns_dense(idx)  # [genes, cells]
            df = pd.DataFrame(
                dense, index=row_names,
                columns=[col_names[i] for i in idx],
            )
        else:
            want = _read_name_file(args.rows)
            pos = {n: i for i, n in enumerate(row_names)}
            idx = np.asarray([pos[n] for n in want if n in pos], np.int64)
            dense = np.asarray(be.read_rows_csr(idx).todense()).T  # cells x rows
            df = pd.DataFrame(
                dense, index=col_names,
                columns=[row_names[i] for i in idx],
            )
        if idx.size < len(want):
            print(f"warning: {len(want) - idx.size} requested names absent")
        df.to_csv(args.output, sep="\t")
        print(f"wrote {args.output} ({df.shape[0]} x {df.shape[1]})")
    elif args.cmd == "sort-rows":
        from ..data.builders import _read_name_file, sort_rows_backend

        be = sort_rows_backend(
            args.backend, args.output, _read_name_file(args.rows)
        )
        print(f"wrote backend: {args.output} ({be.num_rows} rows)")
    elif args.cmd == "tile-cache":
        raise SystemExit(
            "data-beans tile-cache: not needed here: the projection kernel reads each "
            "block's column-sorted COO directly, so there are no tiles to prebucket"
        )
    elif args.cmd == "convert":
        from ..data.builders import convert_backend

        out = args.output
        if args.zip and not out.endswith((".h5", ".hdf5", ".zarr.zip")):
            # apply_zip_flag semantics (zarr_io.rs:100): zarr-ify the
            # bare/.zarr name; an hdf5 target is left untouched
            out = (out[:-5] if out.endswith(".zarr") else out) + ".zarr.zip"
        be = convert_backend(args.backend, out)
        print(f"wrote backend: {out} (nnz {be.num_nonzeros})")
