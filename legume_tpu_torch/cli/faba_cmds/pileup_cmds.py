"""faba `pileup, inspect`: parser + handler (the port's copy of the JAX
package's `cli/faba_cmds/pileup_cmds.py`, flags and defaults unchanged).
Host only: the BAM reader, `faba/context.py::pileup_at_sites`, the
matrix tracks and, where matplotlib imports, the Miami figure."""

from __future__ import annotations

import os

import numpy as np


def add_parsers(sub):
    p = sub.add_parser(
        "pileup", aliases=["inspect"],
        help="gene/region pileup of faba matrices (PileupArgs); "
             "--bam+--sites = base composition; --miami = figure mode",
    )
    p.add_argument("--bam", default=None,
                   help="BAM(s): base-composition mode, or the "
                        "read-depth track of --miami")
    p.add_argument("--sites", default=None,
                   help="site-level parquet (composition mode, or the "
                        "second track of the matrix mode)")
    p.add_argument("--output", default=None,
                   help="TSV path (matrix mode) / parquet prefix "
                        "(composition mode)")
    p.add_argument("--flank", type=int, default=2)
    p.add_argument("--fasta", default=None)
    # matrix-track mode (the reference's original ASCII/TSV pileup)
    p.add_argument("--data", default=None,
                   help="sparse matrix backend(s) from faba output, "
                        "comma-separated (matrix-track mode)")
    p.add_argument("--genes", default=None,
                   help="comma-separated gene symbols (needs --gff to "
                        "resolve spans — row names key by locus here)")
    p.add_argument("--regions", default=None,
                   help="comma-separated chr:lb-ub regions")
    p.add_argument("--signal", choices=["sum", "nnz", "log10-sum"],
                   default="sum",
                   help="per-position aggregation over cells")
    p.add_argument("--site-signal",
                   choices=["count", "wt-coverage", "mut-coverage",
                            "neglog10pv"],
                   default="count",
                   help="signal for the --sites second track")
    p.add_argument("--bins", type=int, default=80,
                   help="bins along the selected span")
    p.add_argument("--plot-height", type=int, default=12,
                   help="ASCII plot height in rows (per track)")
    p.add_argument("--quiet", "--no-plot", dest="quiet",
                   action="store_true", help="suppress the ASCII plot")
    p.add_argument("--modalities", default=None,
                   help="restrict matrix rows to these modalities "
                        "(e.g. m6a,atoi)")
    # figure (miami) mode
    p.add_argument("--miami", default=None,
                   help="figure out-path (.pdf/.svg/.png): sites up, gene "
                        "model middle, mirrored depth down")
    p.add_argument("--region", default=None, help="chr:lb-ub (miami mode)")
    p.add_argument("--gff", default=None,
                   help="gene model (miami track; resolves --genes)")
    p.add_argument("--cell-membership", default=None,
                   help="TSV cell TAB type: one depth panel per cell type")
    p.add_argument("--membership-barcode-col", type=int, default=0)
    p.add_argument("--membership-celltype-col", type=int, default=1)
    p.add_argument("--exact-barcode-match", action="store_true",
                   help="require exact membership-barcode matches "
                        "(default: membership barcodes match as "
                        "prefixes, handling '-1' suffixes)")
    p.add_argument("--cell-barcode-tag", default="CB",
                   help="BAM tag holding the cell barcode "
                        "(read-depth track)")
    p.add_argument("--fig-width", type=float, default=8.0)
    p.add_argument("--dpi", type=int, default=300)
    p.add_argument("--palette", default="auto",
                   help="matplotlib qualitative palette for cell-type "
                        "panels (e.g. tab10); 'auto' = single hue")
    p.add_argument("--raster-threshold", type=int, default=300,
                   help="rasterize the per-site dot layer past this "
                        "many sites (bounds SVG/PDF size)")
    p.add_argument("--out", default=None,
                   help="figure PREFIX: writes {out}.miami.{svg,pdf} "
                        "(reference layout; --miami with an extension "
                        "writes that single file)")
    p.add_argument("--format", choices=["svg", "pdf", "png"], default=None,
                   help="emit ONLY this format (prefix mode)")
    p.add_argument("--svg", action="store_true",
                   help="also write SVG when --format selects another "
                        "single format (on by default otherwise)")
    p.add_argument("--png", action="store_true",
                   help="(prefix mode) also write a flattened PNG")
    p.add_argument("--no-pdf", action="store_true",
                   help="(prefix mode) skip the PDF")


def _cmd_pileup(args):
    import pandas as pd

    if args.data:
        _run_faba_pileup_tracks(args)
        return
    fig_target = args.miami or args.out
    if not fig_target and not (args.bam and args.sites and args.output):
        raise SystemExit(
            "pileup: give --data (matrix-track mode), --miami/--out "
            "(figure mode), or --bam/--sites/--output "
            "(base-composition mode)"
        )
    if fig_target:
        from ...faba.bam import read_bam
        from ...utils.plot import miami_pileup

        if not args.region:
            raise SystemExit("pileup figure mode needs --region chr:lb-ub")
        chrom, span = args.region.rsplit(":", 1)
        lb, ub = (int(x) for x in span.replace(",", "").split("-"))
        df = pd.read_parquet(args.sites)
        insel = (
            (df["chrom"].astype(str) == chrom)
            & (df["pos"] >= lb) & (df["pos"] <= ub)
        )
        sel = df[insel]
        stat_cols = [
            c for c in sel.columns
            if c not in ("chrom", "pos", "strand")
            and pd.api.types.is_numeric_dtype(sel[c])
        ]
        vals = (
            sel[stat_cols[0]].to_numpy(float)
            if stat_cols else np.ones(len(sel))
        )
        # ranged fetch via the .bai index (built on first use): only the
        # BGZF blocks overlapping the window are decompressed, instead of
        # a whole-file scan (rust-htslib fetch parity; the superset
        # window keeps the inclusive-bound mask below authoritative)
        try:
            reads = read_bam(
                args.bam, cb_tag=args.cell_barcode_tag,
                region=(chrom, max(lb - 1, 0), ub + 1),
            )
        except (KeyError, IOError):
            # unknown contig (keep the empty-track behavior) or an
            # unindexable BAM (not coordinate-sorted): stream the file
            reads = read_bam(args.bam, cb_tag=args.cell_barcode_tag)
        rmap = {n: i for i, n in enumerate(reads.ref_names)}
        rid = rmap.get(chrom, -1)
        m = (
            (reads.ref_id == rid)
            & (reads.end_pos >= lb) & (reads.pos <= ub)
        )
        bins = np.linspace(lb, ub, 800)
        facet_names = None
        if args.cell_membership:
            memb = {}
            bc_col = args.membership_barcode_col
            ty_col = args.membership_celltype_col
            with open(args.cell_membership) as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) > max(bc_col, ty_col):
                        memb[parts[bc_col]] = parts[ty_col]
            facet_names = sorted(set(memb.values()))
            fidx = {t: i for i, t in enumerate(facet_names)}
            cb_facet = np.full(len(reads.barcodes), -1, np.int64)
            # membership barcodes match BAM barcodes exactly, or as
            # PREFIXES by default (PileupArgs exact_barcode_match: the
            # prefix rule absorbs CellRanger's "-1" suffixes)
            memb_keys = (
                None if args.exact_barcode_match
                else sorted(memb, key=len, reverse=True)
            )
            for bi, bc in enumerate(reads.barcodes):
                t = memb.get(bc)
                if t is None and memb_keys is not None:
                    for k in memb_keys:
                        if bc.startswith(k):
                            t = memb[k]
                            break
                if t is not None:
                    cb_facet[bi] = fidx[t]
            depth = np.zeros((len(facet_names), len(bins)))
            read_facet = np.where(
                reads.cb_id[m] >= 0, cb_facet[reads.cb_id[m]], -1
            )
            for rf, rs, re_ in zip(
                read_facet, reads.pos[m], reads.end_pos[m]
            ):
                if rf < 0:
                    continue
                i0 = np.searchsorted(bins, max(rs, lb))
                i1 = np.searchsorted(bins, min(re_, ub))
                depth[rf, i0:i1] += 1
        else:
            depth = np.zeros(len(bins))
            for rs, re_ in zip(reads.pos[m], reads.end_pos[m]):
                i0 = np.searchsorted(bins, max(rs, lb))
                i1 = np.searchsorted(bins, min(re_, ub))
                depth[i0:i1] += 1
        gene_rows = []
        if args.gff:
            from ...faba.genes import parse_gff_genes

            model = parse_gff_genes(args.gff)
            cidx = (
                model.chrom_names.index(chrom)
                if chrom in model.chrom_names else -1
            )
            for gi in range(len(model.names)):
                if (
                    model.chrom[gi] == cidx
                    and model.end[gi] >= lb and model.start[gi] <= ub
                ):
                    gene_rows.append((
                        model.names[gi], int(model.start[gi]),
                        int(model.end[gi]), int(model.strand[gi]),
                    ))
        if args.format:
            fmts = [args.format]
            if args.svg and "svg" not in fmts:  # --format pdf --svg
                fmts.append("svg")
        else:
            fmts = ["svg"]  # reference default: SVG + PDF
            if not args.no_pdf:
                fmts.append("pdf")
            if args.png:
                fmts.append("png")
        written = miami_pileup(
            sel["pos"].to_numpy(), vals, bins, depth, gene_rows,
            fig_target, title=args.region, facet_names=facet_names,
            fig_width=args.fig_width, dpi=args.dpi, palette=args.palette,
            raster_threshold=args.raster_threshold, formats=fmts,
        )
        print(
            f"wrote {', '.join(written)} ({len(sel)} sites, "
            f"{int(m.sum())} reads, {len(gene_rows)} genes)"
        )
        return

    from ...faba.bam import read_bam
    from ...faba.context import pileup_at_sites, read_fasta

    reads = read_bam(args.bam)
    df = pd.read_parquet(args.sites)
    rmap = {n: i for i, n in enumerate(reads.ref_names)}
    rid = df["chrom"].astype(str).map(rmap).to_numpy()
    fasta = read_fasta(args.fasta) if args.fasta else None
    pu = pileup_at_sites(
        reads, rid, df["pos"].to_numpy(), flank=args.flank, fasta=fasta
    )
    out = pd.DataFrame(pu["counts"], columns=pu["channels"])
    out["offset"] = pu["offsets"]
    out.to_parquet(f"{args.output}.pileup.parquet")
    print(f"wrote {args.output}.pileup.parquet (mismatch records: {pu['n_mismatch']})")


def _run_faba_pileup_tracks(args):
    """`faba pileup --data`: the reference's original matrix-track
    pileup (pileup.rs run_pileup, non-figure path): select positions
    from the backends' locus-keyed rows by gene span or region,
    aggregate per position (`--signal`), bin along the span, print the
    ASCII histogram and/or write the TSV. An optional `--sites`
    parquet adds the second track (`--site-signal`)."""
    import pandas as pd

    from ...data.sparse_io import open_sparse_matrix

    if not args.genes and not args.regions:
        raise SystemExit("pileup --data needs --genes or --regions")
    spans = []  # (chrom, lb, ub, label)
    if args.regions:
        for reg in args.regions.split(","):
            chrom, rng = reg.rsplit(":", 1)
            lb, ub = (int(x) for x in rng.replace(",", "").split("-"))
            spans.append((chrom, lb, ub, reg))
    if args.genes:
        if not args.gff:
            raise SystemExit(
                "pileup --genes needs --gff: matrix rows key by locus "
                "({chr}:{pos}/...), so gene symbols resolve via the "
                "gene model (declared divergence from the reference's "
                "gene-keyed rows)"
            )
        from ...faba.genes import parse_gff_genes

        model = parse_gff_genes(args.gff)
        want = {g.strip() for g in args.genes.split(",")}
        for gi, name in enumerate(model.names):
            if name in want:
                spans.append((
                    model.chrom_names[int(model.chrom[gi])],
                    int(model.start[gi]), int(model.end[gi]), name,
                ))
                want.discard(name)
        if want:
            raise SystemExit(f"genes not in the GFF: {sorted(want)}")

    mods = (
        {m.strip().lower() for m in args.modalities.split(",")}
        if args.modalities else None
    )
    # gather (pos, value) per span from every backend
    positions, values = [], []
    for path in args.data.split(","):
        be = open_sparse_matrix(path)
        names = be.row_names()
        rows = []
        metas = []
        for ri, name in enumerate(names):
            head, *rest = str(name).split("/")
            if mods is not None and not any(
                r.lower() in mods for r in rest
            ):
                continue
            if ":" not in head:
                continue
            chrom, _, ptxt = head.rpartition(":")
            try:
                pos = int(ptxt)
            except ValueError:
                continue
            for sc, lb, ub, label in spans:
                if chrom == sc and lb <= pos <= ub:
                    rows.append(ri)
                    metas.append((pos, label))
                    break
        if not rows:
            continue
        sub = be.read_columns_csc(np.arange(be.num_columns))[rows]
        row_sum = np.asarray(sub.sum(axis=1)).ravel()
        row_nnz = np.asarray((sub > 0).sum(axis=1)).ravel()
        for (pos, label), s, nz in zip(metas, row_sum, row_nnz):
            v = {
                "sum": s, "nnz": nz, "log10-sum": np.log10(1.0 + s)
            }[args.signal]
            positions.append(pos)
            values.append(v)
    positions = np.asarray(positions, np.int64)
    values = np.asarray(values, np.float64)

    lo = min(lb for _, lb, _, _ in spans)
    hi = max(ub for _, _, ub, _ in spans)
    nb = min(args.bins, max(len(np.unique(positions)), 1))
    edges = np.linspace(lo, hi + 1, nb + 1)
    tracks = []
    if len(positions):
        idx = np.clip(np.searchsorted(edges, positions, "right") - 1,
                      0, nb - 1)
        hist = np.zeros(nb)
        np.add.at(hist, idx, values)
        tracks.append(("matrix", args.signal, hist))
    if args.sites:
        df = pd.read_parquet(args.sites)
        insel = np.zeros(len(df), bool)
        ch = df["chrom"].astype(str).to_numpy()
        pp = df["pos"].to_numpy()
        for sc, lb, ub, _ in spans:
            insel |= (ch == sc) & (pp >= lb) & (pp <= ub)
        sel = df[insel]
        col = {
            "count": None,
            "wt-coverage": next(
                (c for c in sel.columns if "cov" in c.lower()
                 or c in ("wt_coverage", "coverage")), None),
            "mut-coverage": next(
                (c for c in sel.columns if "alt" in c.lower()
                 or "mut" in c.lower() or "converted" in c.lower()),
                None),
            "neglog10pv": next(
                (c for c in sel.columns if "pvalue" in c.lower()
                 or c == "p"), None),
        }[args.site_signal]
        sv = (
            np.ones(len(sel)) if col is None
            else (-np.log10(np.maximum(sel[col].to_numpy(float), 1e-300))
                  if args.site_signal == "neglog10pv"
                  else sel[col].to_numpy(float))
        )
        idx = np.clip(
            np.searchsorted(edges, sel["pos"].to_numpy(), "right") - 1,
            0, nb - 1,
        )
        hist = np.zeros(nb)
        np.add.at(hist, idx, sv)
        tracks.append(("sites", args.site_signal, hist))
    if not tracks:
        raise SystemExit("pileup: no matrix rows or sites in the "
                         "selected span")

    if not args.quiet:
        for label, signal, hist in tracks:
            peak = hist.max() or 1.0
            h = args.plot_height
            print(f"# {label} ({signal}) over {lo}-{hi}")
            for level in range(h, 0, -1):
                line = "".join(
                    "#" if hist[b] / peak * h >= level - 0.5 else " "
                    for b in range(nb)
                )
                print(f"{'':>2}|{line}")
            print(f"  +{'-' * nb}")
    if args.output:
        out_rows = []
        for label, signal, hist in tracks:
            for b in range(nb):
                out_rows.append({
                    "track": label, "signal": signal, "bin": b,
                    "lb": edges[b], "ub": edges[b + 1],
                    "value": hist[b],
                })
        pd.DataFrame(out_rows).to_csv(args.output, sep="\t", index=False)
        print(f"wrote pileup TSV to {args.output}")

