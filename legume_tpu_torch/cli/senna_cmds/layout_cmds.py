"""`senna layout` (umap, tumap, tsne, phate, tree), `senna pseudotime`,
`senna plot`, `senna plot-topic` and `senna plot-strand` (the port of the
JAX package's `cli/senna_cmds/layout_cmds.py`).

Tables are read and written through `utils/output.py`, so a handler takes
the port's parquet or `.npz` and the JAX package's parquet, and writes
parquet where pandas and pyarrow are installed. Manifests carry the JAX
package's `outputs` and `params` keys, plus each command's stage seconds
under `timings`.
"""

from __future__ import annotations

import time

import numpy as np

from ...utils.manifest import ArtifactScale, RunManifest, manifest_path, save_manifest_back
from ...utils.output import read_table, write_table


def _columns(path: str) -> tuple[list[str], list[np.ndarray]]:
    cols = read_table(path)
    return list(cols), list(cols.values())


def _read_latent(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(cell names, [N, K] float32) of a latent table, a log-simplex
    exponentiated and a signed latent passed raw (run_manifest.rs:308-345)."""
    _, cols = _columns(path)
    z = np.stack(cols[1:], 1).astype(np.float32)
    if ArtifactScale.detect(z, axis=1) == ArtifactScale.LOG_SIMPLEX_COLUMNS:
        z = np.exp(z)
    return cols[0], z


def cmd_layout(args) -> np.ndarray:
    from ...ops.layouts import phate, tsne
    from ...ops.umap import umap

    t0 = time.perf_counter()
    cells, z = _read_latent(args.latent)
    timings = {"read_s": time.perf_counter() - t0}
    if args.method == "tsne":
        emb = tsne(z, perplexity=args.perplexity, n_iter=max(args.epochs, 300),
                   device=args.device, timings=timings)
    elif args.method == "phate":
        emb = phate(z, knn=args.n_neighbors, n_iter=args.epochs, device=args.device,
                    timings=timings)
    else:
        emb = umap(
            z, n_neighbors=args.n_neighbors, n_epochs=args.epochs,
            kernel="tumap" if args.method == "tumap" else "umap",
            pcs=min(args.pcs, max(z.shape[1] - 1, 0)), device=args.device, timings=timings,
        )
    path = write_table(f"{args.out}.layout", {"cell": cells, "x": emb[:, 0], "y": emb[:, 1]})
    timings["total_s"] = time.perf_counter() - t0
    RunManifest(
        command="layout", inputs={"latent": args.latent}, outputs={"layout": path},
        params={"method": args.method}, timings=timings,
    ).save(args.out)
    if args.from_run:
        # record the layout back into the source manifest so `senna plot
        # --from` picks it up (main.rs:607 manifest layout.cell_coords update)
        src = manifest_path(args.from_run)
        prev = RunManifest.load(src)
        prev.outputs["layout"] = path
        save_manifest_back(prev, src)
    print(f"wrote {path}")
    return emb


def cmd_layout_tree(args) -> np.ndarray:
    """Reingold-Tilford tree layout from a pseudotime run's principal graph
    (`senna layout tree`, fit_layout_tree.rs:55): y is geodesic
    pseudotime, x is sibling order; cells lerp along their projected edge
    with perpendicular jitter."""
    from ...ops.principal_graph import (
        place_cells_on_tree,
        project_cells_to_edges,
        reingold_tilford_layout,
    )

    if not args.from_run:
        raise SystemExit(
            "layout tree: provide --from <pseudotime run prefix> "
            "(run `senna pseudotime` first)"
        )
    src = manifest_path(args.from_run)
    manifest = RunManifest.load(src)
    nodes_p = manifest.outputs.get("pt_nodes_latent")
    edges_p = manifest.outputs.get("pt_edges")
    root = manifest.params.get("root_node")
    if nodes_p is None or edges_p is None or root is None:
        raise SystemExit(
            f"layout tree: {src} has no principal-graph entries — "
            "re-run `senna pseudotime` (a --velocity lineage run has "
            "no tree to lay out)"
        )
    t0 = time.perf_counter()
    cells, z = _read_latent(args.latent or manifest.inputs.get("latent"))
    nodes = np.stack(_columns(nodes_p)[1][1:], 1).astype(np.float32)
    ecols = read_table(edges_p)
    edges = np.stack([ecols["from"], ecols["to"]], 1).astype(np.int64)
    weights = ecols["weight"].astype(np.float32)

    node_xy = reingold_tilford_layout(nodes, edges, weights, int(root))
    n_finite = int(np.isfinite(node_xy).all(1).sum())
    if n_finite == 0:
        raise SystemExit(
            "layout tree: no finite nodes — the principal graph is "
            "disconnected from the root"
        )
    print(f"tree layout: {n_finite} reachable nodes, root = node {root}")
    t1 = time.perf_counter()
    e_star, t_star = project_cells_to_edges(z, nodes, edges, device=args.device)
    t2 = time.perf_counter()
    cell_xy = place_cells_on_tree(
        edges, node_xy, e_star, t_star,
        jitter_frac=args.tree_jitter, seed=args.tree_jitter_seed,
    )
    cc_path = write_table(f"{args.out}.tree_layout.cell_coords",
                          {"cell": cells, "x": cell_xy[:, 0], "y": cell_xy[:, 1]})
    n2_path = write_table(
        f"{args.out}.tree_layout.nodes_2d",
        {"node": np.asarray([f"node_{i}" for i in range(len(node_xy))]),
         "x": node_xy[:, 0], "y": node_xy[:, 1]},
    )
    manifest.outputs["tree_cell_coords"] = cc_path
    manifest.outputs["tree_nodes_2d"] = n2_path
    manifest.timings["tree_project_s"] = t2 - t1
    manifest.timings["tree_total_s"] = time.perf_counter() - t0
    save_manifest_back(manifest, src)
    print(f"wrote {cc_path}")
    return cell_xy


def cmd_pseudotime(args):
    from ...ops.principal_graph import edge_list_from_adjacency
    from ...ops.principal_graph import pseudotime as fit_pt

    t0 = time.perf_counter()
    cells, z = _read_latent(args.latent)
    timings = {"read_s": time.perf_counter() - t0}
    if args.velocity is not None:
        from ...embedding.lineage import velocity_oriented_lineage

        vel = np.stack(_columns(args.velocity)[1][1:], 1).astype(np.float32)
        result = velocity_oriented_lineage(z, vel, n_nodes=args.n_nodes, device=args.device,
                                           timings=timings)
        columns = {"cell": cells, "pseudotime": result.pseudotime,
                   "consistency": result.consistency}
    else:
        result = fit_pt(
            z, n_nodes=args.n_nodes, root_cell=args.root_cell,
            root_node=args.root_node, lam=args.lam, sigma=args.sigma,
            n_iter=args.max_iter, device=args.device, timings=timings,
        )
        columns = {"cell": cells, "pseudotime": result.pseudotime, "branch": result.branch,
                   "node": result.cell_to_node}
        # persist the principal graph for `senna layout tree`
        # (run_manifest.rs pseudotime.{nodes_latent, edges, root_node};
        # fit_layout_tree.rs reads them back)
        e_ft, e_w = edge_list_from_adjacency(result.nodes, result.edges)
        nodes_path = write_table(
            f"{args.out}.nodes_latent",
            {"node": np.arange(len(result.nodes)),
             **{f"dim{i}": result.nodes[:, i] for i in range(result.nodes.shape[1])}},
        )
        edges_path = write_table(f"{args.out}.edges",
                                 {"from": e_ft[:, 0], "to": e_ft[:, 1], "weight": e_w})
    path = write_table(f"{args.out}.pseudotime", columns)
    timings["total_s"] = time.perf_counter() - t0
    manifest = RunManifest(
        command="pseudotime", inputs={"latent": args.latent},
        outputs={"pseudotime": path}, params={"n_nodes": args.n_nodes}, timings=timings,
    )
    if args.velocity is None:
        manifest.outputs["pt_nodes_latent"] = nodes_path
        manifest.outputs["pt_edges"] = edges_path
        manifest.params["root_node"] = int(result.root)
    manifest.save(args.out)
    print(f"wrote {path}")
    return result


def _labels_by_cell(path: str, cells) -> np.ndarray:
    """Each cell's label from a (cell, label) table, a TSV of such pairs,
    or a file of one label per line in cell order; "NA" where missing."""
    if path.endswith((".parquet", ".npz")):
        _, cols = _columns(path)
        lut = dict(zip(cols[0].astype(str), cols[1]))
    else:
        with open(path) as f:
            lines = [x.strip() for x in f if x.strip()]
        if not (lines and "\t" in lines[0]):
            return np.asarray(lines)
        lut = dict(x.split("\t")[:2] for x in lines)
    return np.asarray([str(lut.get(str(c), "NA")) for c in cells])


def cmd_plot_topic(args) -> list[str]:
    from ...utils.plot import hinton, structure_bars

    names, cols = _columns(args.latent)
    cells = cols[0]
    # plot-topic REQUIRES a simplex: a signed matrix here means the wrong
    # artifact was passed (scale guard, run_manifest.rs:346)
    theta = ArtifactScale.to_linear_simplex(np.stack(cols[1:], 1).astype(np.float64), axis=1)
    theta = theta / np.maximum(theta.sum(1, keepdims=True), 1e-12)
    order_by = None
    if args.clusters:
        _, ccols = _columns(args.clusters)
        lut = dict(zip(ccols[0].astype(str), ccols[1]))
        order_by = np.asarray([lut.get(str(c), np.nan) for c in cells])
    written = []
    if not args.no_struct:
        if args.group_by:
            # one structure panel per group (per-batch panels)
            groups = _labels_by_cell(args.group_by, cells)
            base = args.out
            for ext in (".png", ".svg", ".pdf"):
                if base.endswith(ext):
                    base, sfx = base[: -len(ext)], ext
                    break
            else:
                sfx = ".png"
            for g in np.unique(groups):
                m = groups == g
                ob = order_by[m] if order_by is not None else None
                structure_bars(
                    theta[m], f"{base}.{g}{sfx}", order_by=ob,
                    title=f"topic proportions — {g} ({int(m.sum())} cells)",
                )
                written.append(f"{base}.{g}{sfx}")
        else:
            structure_bars(theta, args.out, order_by=order_by, title="topic proportions")
            written.append(args.out)
    if args.dictionary and not args.no_dict:
        dnames, dcols = _columns(args.dictionary)
        genes = dcols[0].astype(str)
        lb = np.stack(dcols[1:], 1).astype(np.float64)
        topics = dnames[1:]
        lines = []
        for t, col in enumerate(topics):
            top = genes[np.argsort(-lb[:, t])[: args.top_genes]]
            lines.append(f"{col}\t" + "\t".join(top))
        topf = f"{args.out}.top_genes.tsv"
        with open(topf, "w") as f:
            f.write("\n".join(lines) + "\n")
        written.append(topf)
        # gene x topic dictionary as a Hinton diagram over the union of top
        # genes (plot-topic long_help: "a Hinton plot at <= 100 genes")
        top_union = []
        for t in range(lb.shape[1]):
            for g in np.argsort(-lb[:, t])[: args.top_genes]:
                if g not in top_union:
                    top_union.append(g)
        top_union = np.asarray(top_union[:100])
        hf = f"{args.out}.dict_hinton.png"
        hinton(
            np.exp(lb[top_union]), hf,
            row_labels=genes[top_union], col_labels=topics,
            title="topic dictionary (top genes)",
        )
        written.append(hf)
    print("wrote " + " and ".join(written))
    return written


def cmd_plot(args) -> list[str]:
    from ...utils.plot import scatter_figure

    layout_path = args.layout
    clusters_path = args.clusters
    if args.from_run:
        prev = RunManifest.load(manifest_path(args.from_run))
        layout_path = layout_path or prev.outputs.get("layout", prev.outputs.get("latent"))
        clusters_path = clusters_path or prev.outputs.get("clusters")
    if not layout_path:
        raise SystemExit("plot: provide --layout or --from <run prefix>")
    _, lay = _columns(layout_path)
    cells = lay[0]
    coords = np.stack(lay[1:3], 1).astype(np.float32)

    labels = values = None
    if args.colour_by == "pseudotime":
        if not args.pseudotime:
            raise SystemExit("colour-by pseudotime needs --pseudotime")
        pt = read_table(args.pseudotime)
        values = (pt["pseudotime"] if "pseudotime" in pt else list(pt.values())[1]).astype(np.float32)
    elif args.colour_by == "topic":
        z = np.stack(lay[1:], 1).astype(np.float32)
        if np.all(z <= 0):
            z = np.exp(z)
        if args.topics and len(args.topics) == 1:
            values = z[:, args.topics[0]]
        else:
            cols = list(args.topics) if args.topics else list(range(z.shape[1]))
            labels = np.asarray([f"t{int(cols[i])}" for i in z[:, cols].argmax(1)])
    elif args.colour_by == "annotation":
        if not args.annotation:
            raise SystemExit("colour-by annotation needs --annotation")
        labels = _labels_by_cell(args.annotation, cells)
    elif clusters_path:
        labels = list(read_table(clusters_path).values())[1]

    # output formats (scatter.rs svg/png/no_pdf convention)
    base = args.out
    for ext in (".png", ".svg", ".pdf"):
        if base.endswith(ext):
            base = base[: -len(ext)]
    formats = []
    if args.png or args.out.endswith(".png"):
        formats.append(base + ".png")
    if args.svg or args.out.endswith(".svg"):
        formats.append(base + ".svg")
    if not args.no_pdf and (args.out.endswith(".pdf") or not formats):
        formats.append(base + ".pdf" if not args.out.endswith((".png", ".svg")) else args.out)
    if not formats:
        formats = [base + ".png"]
    scatter_figure(
        coords, formats, labels=labels, values=values,
        width=args.width, height=args.height, dpi=args.dpi,
        point_size=args.point_size, alpha=args.alpha,
        hull=args.hull, hull_coverage=args.hull_coverage,
        hull_fill_alpha=args.hull_fill_alpha,
        show_labels=not args.no_labels,
        label_font_size=args.label_font_size,
    )
    print(f"wrote {' '.join(formats)}")
    return formats


def cmd_plot_strand(args) -> list[str]:
    """One Watson/Crick ideogram per activity column: each gene of the
    `--activity` table (gene, then one column per group) placed at its
    TSS from the `--gff`, on the host."""
    from ...faba.genes import parse_gff_genes
    from ...utils.plot import strand_ideogram

    names, cols = _columns(args.activity)
    genes = np.asarray(cols[0]).astype(str)
    model = parse_gff_genes(args.gff)
    pos_of = {}
    for i, nm in enumerate(model.names):
        tss = model.start[i] if model.strand[i] > 0 else model.end[i]
        pos_of[nm] = (model.chrom[i], int(tss), int(model.strand[i]))
    rows = [r for r, g in enumerate(genes) if g in pos_of]
    if not rows:
        raise SystemExit("no activity rows match GFF gene names")
    hit = genes[rows]
    chrom = np.asarray([pos_of[g][0] for g in hit])
    pos = np.asarray([pos_of[g][1] for g in hit])
    strand = np.asarray([pos_of[g][2] for g in hit])
    outs = []
    for name, col in zip(names[1:], cols[1:]):
        f = f"{args.out}.{name}.png"
        strand_ideogram(np.asarray(col, np.float64)[rows], chrom, pos, strand,
                        model.chrom_names, f, bins=args.bins, title=str(name))
        outs.append(f)
    print(f"wrote {len(outs)} ideograms: {outs[0]} ...")
    return outs
