"""`pinto` binary of the port: spatial transcriptomics CLI (the JAX
package's `cli/pinto_cli.py` tree, every subcommand and flag). `lc`,
`cascade`, `prop`, `dsvd`, `cage`, `lc-etm` and `lra` take `--device`
(default `cuda`); `annotate`, `interfaces` and `p` run on the host (the
last two draw with matplotlib). `lc --data-parallel` shards the sweeps'
edges over the ranks, one a GPU (`pinto/lc.py`). A caller holding the cells in
memory passes them as `run_pinto(argv, vec=)`; the command then reads
them instead of `--data-files`."""

from __future__ import annotations

import argparse
import numpy as np


DEVICE_COMMANDS = ("lc", "cascade", "prop", "dsvd", "cage", "lc-etm", "lra")


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="pinto", description="spatial transcriptomics")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("lc", help="spatial link-community segmentation")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--out", required=True)
    p.add_argument("--n-communities", "-k", type=int, default=10)
    p.add_argument("--data-parallel", action="store_true",
                   help="dp-shard the edge-label Gibbs over all "
                        "visible devices")
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--sweeps", "--num-gibbs", dest="sweeps", type=int, default=30)
    p.add_argument("--num-greedy", type=int, default=10)
    p.add_argument("--em-sweeps", "--num-em", dest="em_sweeps", type=int, default=10,
                   help="frozen-incidence component-EM sweeps after Gibbs "
                        "(0 = skip the incidence phase)")
    p.add_argument("--alpha", type=float, default=1.0,
                   help="Dirichlet concentration over communities")
    p.add_argument("--incidence-a", type=float, default=1.0)
    p.add_argument("--incidence-b", type=float, default=1.0)
    p.add_argument("--min-gene-count", type=float, default=0.0,
                   help="genes with total count below this drop out")
    p.add_argument("--no-fisher-weights", action="store_true",
                   help="disable NB-Fisher housekeeping weights")
    p.add_argument("--merge-cut", type=float, default=0.0,
                   help="BHC consensus merge threshold (log-BF)")
    p.add_argument("--gene-network", default=None,
                   help="gene-gene edge list TSV: module-pair edge basis")
    p.add_argument("--gene-network-allow-prefix", action="store_true")
    p.add_argument("--gene-network-delimiter", default=None)
    p.add_argument("--snn-min-shared", type=int, default=2)
    p.add_argument("--gene-trim-min-degree", type=int, default=2)
    p.add_argument("--gene-modules-resolution", type=float, default=1.0)
    p.add_argument("--batch-files", nargs="+", default=None,
                   help="per-cell section labels: the per-batch gene "
                        "flavor divides out of the edge profiles")
    p.add_argument("--qc", action="store_true")
    p.add_argument("--qc-min-total", type=float, default=0.0)
    p.add_argument("--reciprocal", action="store_true",
                   help="keep only mutual spatial kNN pairs")
    p.add_argument("--seed", type=int, default=None)
    p = sub.add_parser("cascade", help="multilevel V-cycle link-community refinement")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--out", required=True)
    p.add_argument("--levels", type=int, nargs="+", default=[6, 4])
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--sweeps", type=int, default=30)
    p = sub.add_parser("annotate", help="marker enrichment labels for communities")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--edges", required=True, help="{out}.edges.parquet from lc/cascade")
    p.add_argument("--markers", required=True, help="GMT marker sets")
    p.add_argument("--out", required=True)
    p = sub.add_parser(
        "p", help="figure suite for an lc run (--from) or a single hex plot"
    )
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--values", default=None, help="parquet with a value column")
    p.add_argument("--column", default=None, help="column name (default: 2nd)")
    p.add_argument("--out", required=True, help="figure path, or dir with --from")
    p.add_argument("--from", dest="frm", default=None,
                   help="lc/cascade/prop output prefix: emits the full suite "
                        "(propensity argmax, per-community heatmaps, mesh, "
                        "LR overlays) + figures.json manifest")
    p.add_argument("--lra", default=None,
                   help="{out}.lra.parquet from `pinto lra` for LR overlays")
    p.add_argument("--data-files", nargs="+", default=None,
                   help="backends for LR overlay expression")
    p.add_argument("--max-communities", type=int, default=16)
    p.add_argument("--top-lr", type=int, default=6)
    p.add_argument("--lr-max-p", type=float, default=0.05)

    p = sub.add_parser(
        "interfaces", help="high-entropy interface cells: overview figure + TSV"
    )
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--propensity", required=True,
                   help="{out}.propensity.parquet from lc/cascade/prop")
    p.add_argument("--edges", default=None,
                   help="optional {out}.edges.parquet (else kNN on coords)")
    p.add_argument("--out", required=True)
    p.add_argument("--entropy-quantile", type=float, default=0.9)
    p.add_argument("--max-interface-cells", type=int, default=200)
    p.add_argument("--neighborhood-hops", type=int, default=2)
    p.add_argument("--knn", type=int, default=8)

    p = sub.add_parser("prop", help="edge-latent re-clustering (kmeans/leiden)")
    p.add_argument("--data-files", nargs="+", default=None)
    p.add_argument("--coords", default=None, help="TSV: cell x y")
    p.add_argument("--latent", "-z", default=None,
                   help="edge latent parquet from `pinto dsvd` "
                        "({out}.pair_factors.parquet with src/dst columns): "
                        "cluster THAT instead of re-deriving from counts "
                        "(SrtPropensityArgs latent_data_file)")
    p.add_argument("--out", required=True)
    p.add_argument("--method", choices=["kmeans", "leiden"], default="kmeans")
    p.add_argument("-k", "--n-clusters", type=int, default=10)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--proj-dim", type=int, default=30)
    p.add_argument("--resolution", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("dsvd", help="cell-pair shared/difference SVD")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--out", required=True)
    p.add_argument("--rank", type=int, default=16)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("cage", help="activity-gated cell-graph embedding")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--out", required=True)
    p.add_argument("-d", "--embedding-dim", type=int, default=16)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--proj-dim", type=int, default=30)
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser("lc-etm", help="indexed-VAE link community")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--out", required=True)
    p.add_argument("-k", "--n-communities", type=int, default=10)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--window", type=int, default=64)
    p.add_argument("--embed-dim", type=int, default=32)
    p.add_argument("--epochs", type=int, default=60)
    p.add_argument("--minibatch-size", type=int, default=256)
    p.add_argument("--seed", type=int, default=None)

    p = sub.add_parser(
        "lra", help="directional ligand->receptor activity vs gene-swap null"
    )
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--coords", required=True, help="TSV: cell x y")
    p.add_argument("--pairs", required=True, help="TSV: ligand TAB receptor")
    p.add_argument("--out", required=True)
    p.add_argument("--knn", type=int, default=8)
    p.add_argument("--permutations", type=int, default=200)
    p.add_argument("--seed", type=int, default=0)
    for name in DEVICE_COMMANDS:
        sub.choices[name].add_argument("--device", default="cuda",
                                       help="torch device (cuda, or cpu)")
    return ap


def run_pinto(argv, *, vec=None):
    args = build_parser().parse_args(argv)
    dev = getattr(args, "device", "cpu")

    def cells():
        if vec is not None:
            return vec
        from ..senna.topic import load_data_vec

        return load_data_vec(args.data_files)

    from ..utils.prng import DEFAULT_PROJECTION_SEED

    seed = getattr(args, "seed", None)
    seed = DEFAULT_PROJECTION_SEED if seed is None else seed

    if args.cmd == "interfaces":
        import pandas as pd

        from ..pinto.interfaces import interface_report
        from ..utils.plot import interface_map

        coords = np.loadtxt(args.coords, usecols=(1, 2))
        pdf = pd.read_parquet(args.propensity)
        comm_cols = [c for c in pdf.columns if c not in ("cell", "entropy")]
        prop = pdf[comm_cols].to_numpy()
        edges = None
        if args.edges:
            ed = pd.read_parquet(args.edges)
            edges = ed[["src", "dst"]].to_numpy()
        rep = interface_report(
            prop, coords, edges,
            community_names=comm_cols,
            entropy_quantile=args.entropy_quantile,
            max_cells=args.max_interface_cells,
            hops=args.neighborhood_hops, knn=args.knn,
        )
        interface_map(coords, rep.entropy, rep.focal, f"{args.out}.interfaces.pdf")
        pd.DataFrame(rep.rows).to_csv(
            f"{args.out}.interfaces.tsv", sep="\t", index=False
        )
        print(
            f"wrote {args.out}.interfaces.pdf + .tsv ({len(rep.focal)} focal cells)"
        )
        return
    if args.cmd == "prop":
        import pandas as pd

        if args.latent:
            # dsvd -> prop chain (SrtPropensityArgs): cluster the PAIR
            # latent, lift node propensity from edge labels
            from ..ops.kmeans import kmeans
            from ..ops.leiden import knn_adjacency, leiden_clustering
            from ..pinto.lc import compute_node_membership

            df = pd.read_parquet(args.latent)
            edges = df[["src", "dst"]].to_numpy(np.int64)
            z = df.drop(columns=["src", "dst"]).to_numpy(np.float32)
            # cell names/count from the dsvd sidecar: sizing by
            # edges.max()+1 silently drops trailing cells no edge touches
            import os as _os

            cells_txt = args.latent.replace(
                ".pair_factors.parquet", ".cells.txt"
            )
            cell_names = None
            if _os.path.exists(cells_txt):
                with open(cells_txt) as f:
                    cell_names = [x.strip() for x in f if x.strip()]
            if args.method == "leiden":
                adj = knn_adjacency(z, k=args.knn, device=dev)
                labels = leiden_clustering(
                    adj, resolution=args.resolution, seed=seed
                ).membership
            else:
                _, labels = kmeans(z, args.n_clusters, seed=seed, device=dev)
            n_cells = len(cell_names) if cell_names else int(edges.max()) + 1
            if cell_names is None:
                print("warning: no .cells.txt next to the pair latent; "
                      "propensity rows are positional 0..max-edge-id")
            k = int(np.max(labels)) + 1
            prop = compute_node_membership(edges, np.asarray(labels), n_cells, k)
            pd.DataFrame(
                {"src": edges[:, 0], "dst": edges[:, 1], "community": labels}
            ).to_parquet(f"{args.out}.edges.parquet")
            pdf = pd.DataFrame(
                prop, columns=[f"c{j}" for j in range(prop.shape[1])]
            )
            pdf.insert(0, "cell", cell_names if cell_names else np.arange(n_cells))
            pdf.to_parquet(f"{args.out}.propensity.parquet")
            print(f"wrote {args.out}.edges.parquet + .propensity.parquet "
                  f"({k} communities from the pair latent)")
            return
        if not (args.data_files and args.coords):
            raise SystemExit("prop: provide --latent or --data-files + --coords")
        from ..pinto.prop import edge_prop_clustering
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        labels, edges, prop = edge_prop_clustering(
            vec, coords,
            method=args.method, n_clusters=args.n_clusters,
            proj_dim=args.proj_dim, knn=args.knn,
            resolution=args.resolution, seed=seed, device=dev,
        )
        pd.DataFrame(
            {"src": edges[:, 0], "dst": edges[:, 1], "community": labels}
        ).to_parquet(f"{args.out}.edges.parquet")
        pd.DataFrame(
            prop, columns=[f"c{j}" for j in range(prop.shape[1])]
        ).reset_index(names="cell").to_parquet(f"{args.out}.propensity.parquet")
        print(f"wrote {args.out}.edges.parquet + .propensity.parquet")
        return
    if args.cmd == "dsvd":
        import pandas as pd

        from ..pinto.prop import pair_dsvd
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        factors, shared, diff, edges = pair_dsvd(
            vec, coords, rank=args.rank, knn=args.knn, seed=seed, device=dev
        )
        df = pd.DataFrame(
            factors, columns=[f"f{j}" for j in range(factors.shape[1])]
        )
        df.insert(0, "src", edges[:, 0])
        df.insert(1, "dst", edges[:, 1])
        df.to_parquet(f"{args.out}.pair_factors.parquet")
        with open(f"{args.out}.cells.txt", "w") as f:
            f.write("\n".join(str(c) for c in vec.column_names()) + "\n")
        genes = vec.row_names()
        pd.DataFrame(
            shared.T, index=genes,
            columns=[f"f{j}" for j in range(shared.shape[0])],
        ).reset_index(names="gene").to_parquet(f"{args.out}.shared_basis.parquet")
        pd.DataFrame(
            diff.T, index=genes,
            columns=[f"f{j}" for j in range(diff.shape[0])],
        ).reset_index(names="gene").to_parquet(f"{args.out}.diff_basis.parquet")
        print(f"wrote {args.out}.pair_factors/.shared_basis/.diff_basis parquet")
        return
    if args.cmd == "cage":
        import pandas as pd

        from ..pinto.cage import fit_cage
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        res = fit_cage(
            vec, coords,
            embedding_dim=args.embedding_dim, knn=args.knn,
            proj_dim=args.proj_dim, epochs=args.epochs, seed=seed, device=dev,
        )
        pd.DataFrame(
            res.embedding, index=vec.column_names(),
            columns=[f"h{j}" for j in range(res.embedding.shape[1])],
        ).reset_index(names="cell").to_parquet(f"{args.out}.latent.parquet")
        pd.DataFrame(
            {"src": res.edges[:, 0], "dst": res.edges[:, 1],
             "weight": res.edge_weights}
        ).to_parquet(f"{args.out}.edges.parquet")
        print(f"wrote {args.out}.latent.parquet + .edges.parquet")
        return
    if args.cmd == "lc-etm":
        import pandas as pd

        from ..pinto.lc_etm import fit_lc_etm
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        res = fit_lc_etm(
            vec, coords,
            n_communities=args.n_communities, knn=args.knn,
            window=args.window, embed_dim=args.embed_dim,
            epochs=args.epochs, minibatch=args.minibatch_size, seed=seed, device=dev,
        )
        pd.DataFrame(
            {"src": res.edges[:, 0], "dst": res.edges[:, 1],
             "community": res.edge_theta.argmax(1)}
        ).to_parquet(f"{args.out}.edges.parquet")
        pd.DataFrame(
            res.propensity, columns=[f"c{j}" for j in range(res.propensity.shape[1])]
        ).reset_index(names="cell").to_parquet(f"{args.out}.propensity.parquet")
        print(f"wrote {args.out}.edges.parquet + .propensity.parquet")
        return
    if args.cmd == "lra":
        import pandas as pd

        from ..pinto.lra import run_lra
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        pairs_df = pd.read_csv(args.pairs, sep="\t", header=None)
        lr_pairs = list(zip(pairs_df.iloc[:, 0], pairs_df.iloc[:, 1]))
        expr = np.log1p(
            np.asarray(
                vec.read_columns_csc(np.arange(vec.num_columns)).todense()
            ).T
        )
        res = run_lra(
            expr, vec.row_names(), coords, lr_pairs,
            knn=args.knn, n_null=args.permutations, seed=args.seed, device=dev,
        )
        pd.DataFrame(
            {"ligand": res.ligand, "receptor": res.receptor,
             "activity": res.activity, "pvalue": res.pvalue,
             "null_mean": res.null_mean}
        ).to_parquet(f"{args.out}.lra.parquet")
        print(f"wrote {args.out}.lra.parquet ({len(res.ligand)} pairs)")
        return

    if args.cmd == "cascade":
        import pandas as pd

        from ..pinto.cascade import cascade_link_community
        vec = cells()
        coords = np.loadtxt(args.coords, usecols=(1, 2))
        res = cascade_link_community(
            vec, coords, levels=tuple(args.levels),
            knn=args.knn, n_sweeps=args.sweeps, device=dev,
        )
        pd.DataFrame(
            {"src": res.edges[:, 0], "dst": res.edges[:, 1],
             "community": res.edge_labels}
        ).to_parquet(f"{args.out}.edges.parquet")
        pd.DataFrame(
            res.propensity, columns=res.leaf_names
        ).reset_index(names="cell").to_parquet(f"{args.out}.propensity.parquet")
        print(
            f"wrote {args.out}.edges.parquet + .propensity.parquet "
            f"({len(res.leaf_names)} leaf communities)"
        )
        return
    if args.cmd == "annotate":
        import pandas as pd

        from ..data.knowledge import read_gmt
        from ..ops.enrichment import annotate_by_markers
        vec = cells()
        ed = pd.read_parquet(args.edges)
        labels, uniq = pd.factorize(ed["community"])
        edges = ed[["src", "dst"]].to_numpy()
        profiles = np.zeros((len(uniq), vec.num_rows))
        for i in range(len(uniq)):
            cells = np.unique(edges[labels == i].ravel())
            profiles[i] = np.log1p(
                np.asarray(vec.read_columns_csc(cells).mean(axis=1)).ravel()
            )
        names, scores = annotate_by_markers(
            profiles, vec.row_names(), read_gmt(args.markers)
        )
        pd.DataFrame(
            {"community": list(uniq), "annotation": names, "score": scores.max(1)}
        ).to_parquet(f"{args.out}.annotation.parquet")
        print(f"wrote {args.out}.annotation.parquet")
        return

    if args.cmd == "p":
        import pandas as pd

        from ..utils.plot import spatial_hex

        coords = np.loadtxt(args.coords, usecols=(1, 2))
        if args.frm:
            _run_pinto_figure_suite(args, coords, cells)
            return
        if not args.values:
            raise SystemExit("pinto p needs --values or --from")
        df = pd.read_parquet(args.values)
        col = args.column or df.columns[1]
        spatial_hex(coords, df[col].to_numpy(), args.out, title=col)
        print(f"wrote {args.out}")
        return

    from ..pinto.lc import PintoLcArgs, run_lc

    return run_lc(
        PintoLcArgs(
            data_files=args.data_files,
            coord_file=args.coords,
            out=args.out,
            n_communities=args.n_communities,
            knn=args.knn,
            n_sweeps=args.sweeps,
            n_greedy=args.num_greedy,
            em_sweeps=args.em_sweeps,
            alpha=args.alpha,
            incidence_a=args.incidence_a,
            incidence_b=args.incidence_b,
            min_gene_count=args.min_gene_count,
            fisher_weights=not args.no_fisher_weights,
            merge_cut=args.merge_cut,
            gene_network=args.gene_network,
            gene_network_allow_prefix=args.gene_network_allow_prefix,
            gene_network_delimiter=args.gene_network_delimiter,
            snn_min_shared=args.snn_min_shared,
            gene_trim_min_degree=args.gene_trim_min_degree,
            gene_modules_resolution=args.gene_modules_resolution,
            batch_files=args.batch_files,
            qc=args.qc,
            qc_min_total=args.qc_min_total,
            reciprocal=args.reciprocal,
            data_parallel=args.data_parallel,
            device=dev,
            **({"seed": args.seed} if args.seed is not None else {}),
        ),
        vec=vec,
    )


def _run_pinto_figure_suite(args, coords, cells):
    """`pinto p --from`: auto-discover an lc/cascade/prop run's artifacts
    and emit the full figure suite (pinto/src/plot/mod.rs PlotKind::ALL:
    propensity argmax, per-community heatmaps, mesh, LR overlays) plus a
    figures.json manifest of everything produced."""
    import json
    import os

    import pandas as pd

    from ..utils.plot import lr_overlay, mesh_figure, scatter_by_label, spatial_hex

    os.makedirs(args.out, exist_ok=True)
    produced = {}

    pdf = pd.read_parquet(f"{args.frm}.propensity.parquet")
    comm_cols = [c for c in pdf.columns if c not in ("cell", "entropy")]
    prop = pdf[comm_cols].to_numpy(np.float32)
    argmax = np.asarray([comm_cols[i] for i in prop.argmax(1)])

    f = os.path.join(args.out, "propensity_argmax.pdf")
    scatter_by_label(coords, argmax, f, title="argmax community")
    produced["propensity"] = f

    heat = []
    order = np.argsort(-prop.sum(0))[: args.max_communities]
    for k in order:
        f = os.path.join(args.out, f"heatmap_{comm_cols[k]}.pdf")
        spatial_hex(coords, prop[:, k], f, title=str(comm_cols[k]))
        heat.append(f)
    if len(order) < len(comm_cols):
        print(
            f"note: heatmaps for top {len(order)}/{len(comm_cols)} "
            "communities by mass (--max-communities)"
        )
    produced["heatmaps"] = heat

    edges_path = f"{args.frm}.edges.parquet"
    if os.path.exists(edges_path):
        edf = pd.read_parquet(edges_path)
        edges = edf[["src", "dst"]].to_numpy(np.int64)
        elab = edf["community"].to_numpy() if "community" in edf else None
        f = os.path.join(args.out, "mesh.pdf")
        mesh_figure(coords, edges, f, cell_labels=argmax, edge_labels=elab,
                    title="link-community mesh")
        produced["mesh"] = f

    if args.lra:
        ldf = pd.read_parquet(args.lra)
        sig = ldf[ldf["pvalue"] <= args.lr_max_p].nlargest(
            args.top_lr, "activity"
        )
        if len(sig) and not args.data_files:
            print("note: --lra given without --data-files; skipping LR overlays")
        elif len(sig):
            vec = cells()
            names = {n: i for i, n in enumerate(vec.row_names())}
            lr_files = []
            for _, row in sig.iterrows():
                li, ri = names.get(row.ligand), names.get(row.receptor)
                if li is None or ri is None:
                    continue
                ex = np.asarray(
                    vec.read_columns_csc(np.arange(vec.num_columns))
                    .tocsr()[np.asarray([li, ri])]
                    .todense()
                )  # [2, N]
                f = os.path.join(
                    args.out, f"lr_{row.ligand}_{row.receptor}.pdf"
                )
                lr_overlay(
                    coords, ex[0], ex[1], f,
                    title=(f"{row.ligand} -> {row.receptor}  "
                           f"activity={row.activity:.3f} p={row.pvalue:.3g}"),
                )
                lr_files.append(f)
            produced["lr"] = lr_files

    man = os.path.join(args.out, "figures.json")
    with open(man, "w") as fh:
        json.dump(produced, fh, indent=1)
    n = sum(len(v) if isinstance(v, list) else 1 for v in produced.values())
    print(f"wrote {n} figures + {man}")
