"""faba `plot`: parser + handler (the port's copy of the JAX package's
`cli/faba_cmds/plot_cmds.py`, flags and defaults unchanged, plus
`--device`, default `cuda`, for a layout the command computes: phate,
tsne and umap / tumap run through the port's `ops/layouts.py` and
`ops/umap.py`). The figure needs matplotlib, which the card's machine
does not have."""

from __future__ import annotations

import os

import numpy as np


def add_parsers(sub):
    p = sub.add_parser(
        "plot", help="render a lineage fit: annotated trajectory over a 2D layout"
    )
    p.add_argument("-f", "--from", dest="frm", required=True,
                   help="lineage output prefix ({from}.pseudotime/... parquet)")
    p.add_argument("--latent", required=True,
                   help="cell latent parquet (the gem fit the lineage used)")
    p.add_argument("-o", "--out", default=None,
                   help="figure path (default {from}.plot.pdf)")
    p.add_argument("--color-by",
                   choices=["pseudotime", "label", "celltype"],
                   default="pseudotime",
                   help="celltype reads the lineage's own node calls "
                        "({from}.trajectory_annotation.parquet)")
    p.add_argument("--annot", default=None,
                   help="cell,label parquet (required for --color-by label)")
    p.add_argument("--pt-ramp", choices=["sqrt", "linear", "rank"],
                   default="sqrt",
                   help="non-linear remap of the pseudotime ramp")
    p.add_argument("--width", type=float, default=9.0)
    p.add_argument("--height", type=float, default=8.0)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--point-size", type=float, default=3.0)
    p.add_argument("--alpha", type=float, default=0.7)
    p.add_argument("--label-font-size", type=float, default=8.0)
    p.add_argument("--velocity-scale", type=float, default=0.5,
                   help="scale on the velocity-field arrow length")
    p.add_argument("--no-velocity-field", action="store_true")
    p.add_argument("--backbone", choices=["auto", "curves", "tree"],
                   default="auto",
                   help="auto draws the Slingshot curves when "
                        "{from}.curves_2d.parquet exists, else the tree")
    p.add_argument("--no-type-labels", action="store_true",
                   help="skip the node cell-type annotations")
    p.add_argument("--show-unassigned", action="store_true")
    p.add_argument("--svg", action="store_true",
                   help="also emit the SVG next to the main output")
    p.add_argument("--layout",
                   choices=["auto", "phate", "umap", "tumap", "tsne"],
                   default="auto",
                   help="auto reuses {from}.cells_2d.parquet when the "
                        "lineage run already laid out (else tumap)")
    p.add_argument("--layout-pcs", type=int, default=50,
                   help="PCs carrying the umap/tumap kNN graph + SGD init, "
                        "leading (mean) axis dropped; 0 = raw latent + "
                        "random init (lineage/args.rs layout_pcs)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="torch device of the phate / tsne / umap layouts "
                        "(default: cuda)")


def _run_faba_plot(args):
    """`faba plot`: render a lineage fit — {from}.pseudotime + the
    forest backbone — over a 2D layout of the cell latent (reference
    `faba/src/plot/mod.rs` role; matplotlib instead of the SVG layer
    stack). Reads the reference-schema tables ({from}.nodes/.edges/
    .trees, and {from}.cells_2d when the lineage already laid out);
    falls back to the legacy .lineage_nodes/.lineage_edges pair."""
    import pandas as pd

    from ...utils.plot import trajectory_figure

    zdf = pd.read_parquet(args.latent)
    cells = zdf.iloc[:, 0].astype(str).to_numpy()
    z = zdf.iloc[:, 1:].to_numpy(np.float32)
    pt = pd.read_parquet(f"{args.frm}.pseudotime.parquet")
    pt = pt.set_index(pt.columns[0]).reindex(cells)
    if os.path.exists(f"{args.frm}.nodes.parquet"):
        nodes_df = pd.read_parquet(f"{args.frm}.nodes.parquet")
        nodes = nodes_df[
            [c for c in nodes_df.columns if c.startswith("T")]
        ].to_numpy(np.float32)
        edges_df = pd.read_parquet(f"{args.frm}.edges.parquet")
        sel = edges_df[edges_df["selected"] > 0]
        edges = sel[["from", "to"]].to_numpy(np.float32).astype(np.int64)
        trees = pd.read_parquet(f"{args.frm}.trees.parquet")
        root = int(trees["root"].iloc[0])
    else:  # legacy round-2 outputs
        nodes_df = pd.read_parquet(f"{args.frm}.lineage_nodes.parquet")
        hcols = [c for c in nodes_df.columns if c.startswith("h")]
        nodes = nodes_df[hcols].to_numpy(np.float32)
        root = int(nodes_df.index[nodes_df["is_root"].to_numpy()][0]) \
            if "is_root" in nodes_df else 0
        edges_df = pd.read_parquet(f"{args.frm}.lineage_edges.parquet")
        edges = edges_df[["src", "dst"]].to_numpy(np.int64)

    if os.path.exists(f"{args.frm}.cells_2d.parquet") and args.layout == "auto":
        xy = pd.read_parquet(f"{args.frm}.cells_2d.parquet")
        coords = xy.set_index(xy.columns[0]).reindex(cells)[
            ["x", "y"]].to_numpy(np.float32)
        nxy = pd.read_parquet(f"{args.frm}.nodes_2d.parquet")
        node_xy = nxy[["x", "y"]].to_numpy(np.float32)
        _finish_faba_plot(args, coords, node_xy, edges, root, pt, cells)
        return
    if args.layout == "auto":
        args.layout = "tumap"
    if args.layout == "phate":
        from ...ops.layouts import phate

        coords = phate(z, seed=args.seed, device=args.device)
    elif args.layout == "tsne":
        from ...ops.layouts import tsne

        coords = tsne(z, seed=args.seed, device=args.device)
    else:
        from ...ops.umap import umap

        coords = umap(
            z, seed=args.seed,
            kernel="tumap" if args.layout == "tumap" else "umap",
            pcs=min(args.layout_pcs, max(z.shape[1] - 1, 0)),
            device=args.device,
        )
    coords = np.asarray(coords, np.float32)

    # node positions in layout space: mean layout coords of the cells nearest
    # each node in latent space (nodes live in latent space, the layout is
    # non-linear, so projecting through member cells is the faithful lift)
    d2 = ((z[:, None, :] - nodes[None, :, :]) ** 2).sum(-1)  # [N, M]
    assign = d2.argmin(1)
    node_xy = np.zeros((nodes.shape[0], 2), np.float32)
    for m in range(nodes.shape[0]):
        sel = assign == m
        if sel.any():
            node_xy[m] = coords[sel].mean(0)
        else:  # empty node: nearest single cell
            node_xy[m] = coords[d2[:, m].argmin()]

    _finish_faba_plot(args, coords, node_xy, edges, root, pt, cells)


def _finish_faba_plot(args, coords, node_xy, edges, root, pt, cells):
    import pandas as pd

    from ...utils.plot import trajectory_figure

    labels = None
    color = None
    if args.color_by == "label":
        if not args.annot:
            raise SystemExit("--color-by label needs --annot")
        an = pd.read_parquet(args.annot)
        an = an.set_index(an.columns[0]).reindex(cells)
        labels = an.iloc[:, 0].fillna("NA").astype(str).to_numpy()
    elif args.color_by == "celltype":
        # the lineage's own node calls, carried to cells via their
        # nearest node (plot/mod.rs coarse-label colouring)
        ta_path = f"{args.frm}.trajectory_annotation.parquet"
        if not os.path.exists(ta_path):
            raise SystemExit(
                "--color-by celltype needs the lineage run's --markers "
                f"outputs ({ta_path})"
            )
        ta = pd.read_parquet(ta_path)
        node_of = _nearest_node_of_cells(args, coords, node_xy, cells)
        labels = ta["cell_type"].to_numpy(object)[node_of]
        if not args.show_unassigned:
            keep = labels != "unassigned"
            coords, labels = coords[keep], labels[keep]
    else:
        ramp = pt.iloc[:, 0].to_numpy(np.float32)
        if args.pt_ramp == "sqrt":
            lo = np.nanmin(ramp) if np.isfinite(ramp).any() else 0.0
            color = np.sqrt(np.maximum(ramp - lo, 0.0))
        elif args.pt_ramp == "rank":
            order = np.argsort(np.nan_to_num(ramp))
            color = np.empty(len(ramp), np.float32)
            color[order] = np.arange(len(ramp), dtype=np.float32)
        else:
            color = ramp

    curves = curve_w = arrows = node_labels = None
    if args.backbone != "tree" and os.path.exists(
        f"{args.frm}.curves_2d.parquet"
    ):
        cdf = pd.read_parquet(f"{args.frm}.curves_2d.parquet")
        curves = [
            g[["x", "y"]].to_numpy(np.float32)
            for _, g in cdf.groupby("lineage", sort=True)
        ]
        wpath = f"{args.frm}.cell_lineage_weights.parquet"
        if os.path.exists(wpath):
            w = pd.read_parquet(wpath)
            curve_w = w.iloc[:, 1:].to_numpy(np.float64).sum(0)[
                : len(curves)]
    if not args.no_velocity_field and os.path.exists(
        f"{args.frm}.velocity_grid_2d.parquet"
    ):
        arrows = pd.read_parquet(
            f"{args.frm}.velocity_grid_2d.parquet"
        ).to_numpy(np.float32)
    if not args.no_type_labels and os.path.exists(
        f"{args.frm}.trajectory_annotation.parquet"
    ):
        ta = pd.read_parquet(f"{args.frm}.trajectory_annotation.parquet")
        # one label per TYPE at its best node (plot/mod.rs default)
        node_labels = []
        best: dict = {}
        for ni, (ct, conf) in enumerate(
            zip(ta["cell_type"], ta.get("confidence", [0.0] * len(ta)))
        ):
            if str(ct) == "unassigned":
                continue
            if ct not in best or conf > best[ct][1]:
                best[ct] = (ni, conf)
        node_labels = [(ni, ct) for ct, (ni, _) in best.items()]

    out = args.out or f"{args.frm}.plot.pdf"
    trajectory_figure(
        coords, node_xy, edges, root, out,
        color=color, labels=labels,
        title=f"lineage: {args.frm.rsplit('/', 1)[-1]}",
        point_size=args.point_size, alpha=args.alpha,
        width=args.width, height=args.height, dpi=args.dpi,
        label_font_size=args.label_font_size,
        curves=curves, curve_weights=curve_w,
        arrows=arrows, velocity_scale=args.velocity_scale,
        node_labels=node_labels, also_svg=args.svg,
    )
    print(f"wrote {out}")


def _nearest_node_of_cells(args, coords, node_xy, cells):
    """Cell -> nearest trajectory node in LAYOUT space (for the
    celltype colouring; the lineage's own labels live on nodes)."""
    d2 = ((coords[:, None, :] - node_xy[None, :, :]) ** 2).sum(-1)
    return d2.argmin(1)

