"""faba `gem`, `gem-encoder`, `lineage` and `dyn-assoc`: parsers +
handlers (the port's copy of the JAX package's
`cli/faba_cmds/gem_cmds.py`, flags and defaults unchanged, plus
`--device` on `gem`, `gem-encoder`, `lineage` and `dyn-assoc`, default
`cuda`).

`gem --raw` projects the cells through K1 (`ops/random_projection.py`,
one launch per `--block-size` columns), sorts them into pseudobulks and
sums both tracks by the JAX package's dense one-hot product on the host.
`lineage` takes its k-means, kNN and layouts on `--device`
(`faba/lineage_run.py`). `gem` / `gem-encoder --data-parallel` run one
rank a GPU (`parallel/`): every rank reads both tracks and, with `--raw`,
repeats the projection (K1) and the pseudobulk sums; the fit shards the
pseudobulk rows and `--posterior` the Gibbs anchors over the ranks; rank
0 alone writes. A world of one is the plain run. `_cmd_gem` and
`_cmd_lineage` return their stage seconds.
"""

from __future__ import annotations

import os
import time

import numpy as np


def add_parsers(sub):
    for _name, _help in [
        ("gem", "geodesic embedding + motion (NCE, velocity delta)"),
        ("gem-encoder", "masked generative sibling (u+delta->s)"),
    ]:
        p = sub.add_parser(_name, help=_help)
        p.add_argument("--posterior", type=int, default=0,
                       help="gem only: two-gate Gibbs sweeps over the fit "
                            "(0 = off); writes delta_posterior.parquet")
        p.add_argument("--spliced", required=True,
                       help="spliced backend (pb-level, or cell-level "
                            "with --raw)")
        p.add_argument("--unspliced", required=True,
                       help="unspliced backend (same granularity)")
        p.add_argument("--output", required=True)
        p.add_argument("-d", "--embedding-dim", type=int, default=16)
        p.add_argument("--epochs", "-i", type=int, default=600)
        p.add_argument("--learning-rate", "--lr", type=float, default=None,
                       help="default: 0.02 (gem) / 0.01 (gem-encoder)")
        p.add_argument("--delta-l2", type=float, default=0.01,
                       help="L2 on the velocity offset delta "
                            "(gem/args.rs ModelArgs)")
        p.add_argument("--weight-decay", type=float, default=0.0,
                       help="AdamW decoupled weight decay (0 = Adam)")
        p.add_argument("--grad-clip", type=float, default=0.0,
                       help="global-norm gradient clip (0 = off)")
        p.add_argument("--seed", type=int, default=0)
        # CollapseArgs: run the pseudobulk collapse in-command on
        # CELL-level inputs (the reference gem always collapses;
        # pb-level inputs stay the no-flag behavior here)
        p.add_argument("--raw", action="store_true",
                       help="inputs are cell-level: hash cells into "
                            "pseudobulks first (CollapseArgs)")
        p.add_argument("--sort-dim", type=int, default=8,
                       help="[--raw] binary sketch bits (<= 2^bits pbs)")
        p.add_argument("--proj-dim", type=int, default=16,
                       help="[--raw] random-projection dimension")
        p.add_argument("--n-hvg", type=int, default=0,
                       help="[--raw] gate the projection sketch to the "
                            "top-N variable genes (every gene still "
                            "trains; hvg.rs)")
        p.add_argument("--block-size", type=int, default=2048)
        p.add_argument("--data-parallel", action="store_true",
                       help="dp-shard the pb row axis of training (and, "
                            "with --posterior, the Gibbs anchor axis) "
                            "over all visible devices")
        p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
        if _name == "gem-encoder":
            p.add_argument("--mask-fraction", type=float, default=0.2,
                           help="BERT-style masked-gene fraction")
        if _name == "gem":
            p.add_argument("--nce-objective",
                           choices=["logistic", "softmax"],
                           default="logistic",
                           help="phase-1 objective: binary NCE vs the "
                                "unigram noise, or the exact softmax "
                                "over the pb gene axis")
            p.add_argument("--ibp-alpha", type=float, default=2.0,
                           help="[--posterior] truncated-IBP "
                                "concentration of the gate ladder")
            p.add_argument("--half-cauchy-scale", type=float, default=1.0,
                           help="[--posterior] slab scale")
            p.add_argument("--sequential-velocity", action="store_true",
                           help="fit theta on the spliced track first, then "
                                "delta with theta frozen (default: joint)")
            p.add_argument("--lineage-dag", action="store_true",
                           help="second training pass with a velocity-drift "
                                "SEM residual over the oriented lineage; "
                                "writes dag_pseudotime/dag_fate parquets")
            p.add_argument("--lineage-smooth", action="store_true",
                           help="smooth the velocity readout over KNN "
                                "neighbours before orienting")
            p.add_argument("--dense-dag", action="store_true",
                           help="use the dense velocity-KNN graph instead "
                                "of the MST lineage tree")
    p = sub.add_parser(
        "lineage",
        help="velocity-informed forest lineage over a gem fit "
             "(lineage/args.rs LineageArgs)",
    )
    p.add_argument("-f", "--from", dest="frm", default=None,
                   help="gem / gem-encoder / topic output prefix")
    p.add_argument("-o", "--out", default=None,
                   help="output prefix (default: the gem prefix)")
    # legacy explicit-file pair (round-2 surface), still honored
    p.add_argument("--latent", default=None, help="explicit θ parquet "
                   "(legacy alternative to --from)")
    p.add_argument("--velocity", default=None, help="explicit δ parquet")
    p.add_argument("--n-centroids", "--n-nodes", dest="n_centroids",
                   type=int, default=None,
                   help="MST centroids K (default min(cells/10, 200))")
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--kmeans-iter", type=int, default=100)
    p.add_argument("--theta-from",
                   choices=["auto", "cell-embedding", "latent"],
                   default="auto",
                   help="which table supplies θ (auto: a log-θ simplex "
                        "latent when detected, else the cell embedding)")
    p.add_argument("--latent-geometry",
                   choices=["auto", "cosine", "euclidean", "hellinger"],
                   default="auto",
                   help="fit/layout metric (auto: hellinger on a "
                        "simplex, cosine on an embedding)")
    p.add_argument("--cluster-space",
                   choices=["identity", "nascent", "concat"],
                   default="identity",
                   help="grouping features: θ, θ+δ, or [θ̂|δ̂]")
    p.add_argument("--no-edge-direction", action="store_true",
                   help="skip the per-edge velocity test; forest = "
                        "the geometric MST")
    p.add_argument("--no-orient-velocity", action="store_true",
                   help="ignore velocity entirely")
    p.add_argument("--edge-cand-knn", type=int, default=4)
    p.add_argument("--edge-direction-n-boot", type=int, default=200)
    p.add_argument("--edge-direction-n-perm", type=int, default=500)
    p.add_argument("--edge-alpha", type=float, default=0.05)
    p.add_argument("--edge-min-cells", type=int, default=2)
    p.add_argument("--root-affinity", type=float, default=None,
                   help="forest granularity tau_root (default: median "
                        "arc weight)")
    p.add_argument("--root-type", default=None,
                   help="root at this cell type's best node (needs "
                        "--markers)")
    p.add_argument("--root-from-gem", action="store_true",
                   help="root at gem's velocity-DAG source "
                        "({from}.dag_pseudotime.parquet)")
    p.add_argument("--root-node", type=int, default=None)
    p.add_argument("--root-cell", default=None)
    p.add_argument("--curve-bandwidth", type=float, default=0.0)
    p.add_argument("--curve-resolution", type=int, default=100)
    p.add_argument("--max-iter", type=int, default=15)
    p.add_argument("--tol", type=float, default=1e-3)
    p.add_argument("--markers", default=None,
                   help="gene<TAB>celltype TSV (or GMT) naming nodes "
                        "by cell type")
    p.add_argument("--marker-num-perm", type=int, default=500)
    p.add_argument("--marker-obo", default=None)
    p.add_argument("--marker-label-cl", default=None)
    p.add_argument("--no-bootstrap-markers", action="store_true")
    p.add_argument("--marker-n-boot", type=int, default=200)
    p.add_argument("--marker-min-support", type=float, default=0.5)
    p.add_argument("--layout", choices=["none", "phate", "umap"],
                   default="phate")
    p.add_argument("--layout-space",
                   choices=["identity", "nascent", "concat"],
                   default="identity")
    p.add_argument("--layout-pcs", type=int, default=20)
    p.add_argument("--velocity-aware-layout",
                   choices=["auto", "on", "off"], default="auto")
    p.add_argument("--phate-knn", type=int, default=15)
    p.add_argument("--phate-t", type=int, default=0)
    p.add_argument("--phate-landmarks", type=int, default=2000)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser(
        "dyn-assoc",
        help="between-branch Bayesian modality contrast "
             "(assoc/run.rs AssocArgs)",
    )
    p.add_argument("--backend", "--sites-backend", dest="backend",
                   required=True,
                   help="site x cell counts backend(s), comma-separated "
                        "(rows concatenate)")
    p.add_argument("-f", "--from", dest="frm", default=None,
                   help="lineage prefix: reads {from}.pseudotime.parquet "
                        "as --branches")
    p.add_argument("--branches", default=None,
                   help="parquet: cell, branch|pseudotime (alternative "
                        "to --from)")
    p.add_argument("--output", default=None,
                   help="output prefix (default: the lineage prefix)")
    p.add_argument("--modality", default=None,
                   help="restrict rows to this modality channel "
                        "(e.g. m6a, atoi)")
    p.add_argument("--seed", type=int, default=42,
                   help="accepted for parity; the contrast here is "
                        "closed-form conjugate, not a sampler")
    p.add_argument("--posterior-prior-sd", "--prior-sd",
                   dest="prior_sd", type=float, default=1.0,
                   help="effect-scale prior: maps onto the Gamma "
                        "pseudo-counts a0=b0=1/sd^2 (the reference's "
                        "ESS sampler prior sd; declared mapping)")
    p.add_argument("--cell-membership", default=None,
                   help="cell<TAB>cell_type TSV: adds the per-type "
                        "contrast report {out}.assoc.celltype.parquet")
    p.add_argument("--no-celltype", action="store_true")
    p.add_argument("--exposure", default=None, help="optional coverage backend")
    p.add_argument("--n-bins", type=int, default=8,
                   help="pseudotime windows (AssocArgs n_bins)")
    p.add_argument("--min-total-coverage", type=float, default=0.0,
                   help="sites with fewer total counts drop out")
    p.add_argument("--min-cells", type=int, default=0,
                   help="sites expressed in fewer cells drop out")
    p.add_argument("--fdr-alpha", type=float, default=0.0,
                   help=">0: add a BH significant column at this level")
    p.add_argument("--trend-method", choices=["bayes", "quasi", "binomial"],
                   default="bayes",
                   help="within-branch trend estimator (AssocArgs "
                        "trend_method): bayes = Gamma-Poisson windows, "
                        "quasi/binomial = IRLS spline GAM with F / "
                        "deviance-LRT test (assoc/gam.rs:194)")
    p.add_argument("--n-knots", type=int, default=5,
                   help="GAM spline knots (quasi/binomial only)")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _cmd_gem(args):
    import pandas as pd

    from ...data.sparse_io import open_sparse_matrix
    from ...embedding.gem import fit_gem, fit_gem_encoder
    from ...parallel.mesh import live, make_mesh
    from ...parallel.multihost import barrier

    mesh = make_mesh(args.device) if args.data_parallel else None
    primary = live(mesh) is None or mesh.primary
    timings = {}
    t0 = time.perf_counter()
    sb = open_sparse_matrix(args.spliced)
    ub = open_sparse_matrix(args.unspliced)
    s = np.asarray(
        sb.read_columns_csc(np.arange(sb.num_columns)).todense()
    ).T  # [P, D]
    u = np.asarray(ub.read_columns_csc(np.arange(ub.num_columns)).todense()).T
    if s.shape != u.shape:
        raise SystemExit(
            f"spliced {s.shape} and unspliced {u.shape} backends must "
            "share genes and columns"
        )
    genes = sb.row_names()
    pb_names = sb.column_names()
    timings["read_s"] = time.perf_counter() - t0
    if args.raw:
        # CollapseArgs path: hash cells into pseudobulks on the
        # SPLICED sketch, aggregate BOTH tracks by the same
        # partition (one grouping so theta and delta read the same
        # populations)
        from ...ops import random_projection as rp

        t0 = time.perf_counter()
        row_weights = None
        if args.n_hvg and args.n_hvg < len(genes):
            from ...ops.gene_stats import hvg_row_weights

            row_weights = hvg_row_weights(
                sb, args.n_hvg, block_size=args.block_size, device=args.device
            )
        _, proj = rp.project_columns(
            sb, args.proj_dim, block_size=args.block_size,
            row_weights=row_weights, seed=args.seed, device=args.device,
        )
        codes = rp.binary_sort_columns(
            proj, args.sort_dim, seed=args.seed, device=args.device
        )
        timings["projection_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, groups = np.unique(codes, return_inverse=True)
        n_pb = int(groups.max()) + 1
        onehot = np.zeros((len(groups), n_pb), np.float32)
        onehot[np.arange(len(groups)), groups] = 1.0
        s = onehot.T @ s
        u = onehot.T @ u
        pb_names = [f"pb{j}" for j in range(n_pb)]
        if primary:
            np.savez(
                f"{args.output}.partition.npz",
                fine_groups=groups.astype(np.int32),
            )
        timings["pseudobulk_s"] = time.perf_counter() - t0
        if primary:
            print(f"collapse: {len(groups)} cells -> {n_pb} pseudobulks "
                  f"(sort_dim={args.sort_dim}); wrote "
                  f"{args.output}.partition.npz")
    t0 = time.perf_counter()
    if args.cmd == "gem":
        if args.lineage_dag and args.posterior > 0:
            raise SystemExit(
                "--lineage-dag cannot combine with --posterior: the "
                "posterior REPLACES phase-1 training, so there is no "
                "fit for the second pass to refine (gem/args.rs)"
            )
        res = fit_gem(
            s, u, embedding_dim=args.embedding_dim, epochs=args.epochs,
            learning_rate=args.learning_rate or 0.02,
            delta_l2=args.delta_l2,
            objective=args.nce_objective,
            weight_decay=args.weight_decay,
            grad_clip=args.grad_clip,
            sequential_velocity=args.sequential_velocity,
            lineage_dag=args.lineage_dag,
            lineage_smooth=args.lineage_smooth,
            lineage_mst=not args.dense_dag,
            seed=args.seed,
            mesh=mesh,
            device=args.device,
        )
        timings["fit_s"] = time.perf_counter() - t0
        timings["losses"] = res.losses
        if res.dag_pseudotime is not None and primary:
            pd.DataFrame({
                "cell": pb_names,
                "pseudotime": res.dag_pseudotime,
            }).to_parquet(f"{args.output}.dag_pseudotime.parquet")
            pd.DataFrame(
                res.dag_fate,
                index=pb_names,
                columns=[f"leaf{int(l)}" for l in res.dag_leaves],
            ).reset_index(names="cell").to_parquet(
                f"{args.output}.dag_fate.parquet"
            )
            print(f"lineage DAG: {len(res.dag_edges)} edges, "
                  f"{len(res.dag_leaves)} leaves")
        delta, emb = res.delta, res.e_feat
        vel = res.cell_velocity(u)
        w = s / np.maximum(s.sum(1, keepdims=True), 1e-9)
        cell_emb = w @ emb  # spliced-weighted gene embedding
        if args.posterior > 0:
            from ...embedding.posterior import gem_gibbs

            t0 = time.perf_counter()
            post = gem_gibbs(
                s, u, res.e_feat, res.delta,
                res.b_feat_s, res.b_feat_u, res.pb_e, res.pb_b,
                n_sweeps=args.posterior,
                burnin=max(args.posterior // 4, 2),
                stick_alpha=args.ibp_alpha,
                half_cauchy_scale=args.half_cauchy_scale,
                seed=args.seed,
                mesh=mesh,
                device=args.device,
            )
            timings["posterior_s"] = time.perf_counter() - t0
            timings["posterior_rhat_max"] = float(post.rhat.max())
            if primary:
                pd.DataFrame({
                    "gene": genes,
                    "delta_pip": post.delta_pip.max(axis=1),
                    "delta_norm": np.linalg.norm(post.delta_mean, axis=1),
                    "beta_pip": post.beta_pip.max(axis=1),
                    "identified": post.delta_identified,
                }).to_parquet(f"{args.output}.delta_posterior.parquet")
                print(
                    f"posterior: {args.posterior} sweeps, rhat max "
                    f"{post.rhat.max():.2f}"
                )
    else:
        res = fit_gem_encoder(
            s, u, latent_dim=args.embedding_dim, epochs=args.epochs,
            learning_rate=args.learning_rate or 0.01,
            mask_frac=args.mask_fraction, delta_l2=args.delta_l2,
            weight_decay=args.weight_decay,
            grad_clip=args.grad_clip, seed=args.seed,
            mesh=mesh, device=args.device,
        )
        timings["fit_s"] = time.perf_counter() - t0
        timings["losses"] = res.losses
        delta, emb = res.delta, res.rho
        vel = res.cell_velocity(u)
        cell_emb = res.encode(u)
    if not primary:  # rank 0 writes the outputs
        barrier(live(mesh))
        return timings
    t0 = time.perf_counter()
    pd.DataFrame(
        emb, index=genes, columns=[f"h{j}" for j in range(emb.shape[1])]
    ).reset_index(names="gene").to_parquet(f"{args.output}.gene_embedding.parquet")
    out_v = pd.DataFrame(
        vel, index=pb_names,
        columns=[f"v{j}" for j in range(vel.shape[1])],
    ).reset_index(names="cell")
    out_v.to_parquet(f"{args.output}.velocity.parquet")
    pd.DataFrame(
        {"gene": genes, "velocity_norm": np.linalg.norm(delta, axis=1)}
    ).to_parquet(f"{args.output}.gene_velocity.parquet")
    cell_df = pd.DataFrame(
        cell_emb, index=pb_names,
        columns=[f"h{j}" for j in range(cell_emb.shape[1])],
    ).reset_index(names="cell")
    cell_df.to_parquet(f"{args.output}.latent.parquet")
    # reference table names (gem/run.rs outputs): the co-embedded
    # feature rows keyed {gene}/count/{spliced,unspliced} (unspliced
    # = spliced + the nascent increment δ_g) and the cell θ table —
    # what `faba annotate`/`faba lineage` read by prefix
    cell_df.to_parquet(f"{args.output}.cell_embedding.parquet")
    feat_rows = np.vstack([emb, emb + delta])
    feat_names = (
        [f"{g}/count/spliced" for g in genes]
        + [f"{g}/count/unspliced" for g in genes]
    )
    pd.DataFrame(
        feat_rows, index=feat_names,
        columns=[f"h{j}" for j in range(emb.shape[1])],
    ).reset_index(names="feature").to_parquet(
        f"{args.output}.feature_embedding.parquet"
    )
    import json as _json

    # run manifest ({prefix}.gem.json, faba/manifest.rs): names the
    # producer so `faba annotate` can resolve --mode. DIVERGENCE:
    # our gem-encoder is an embedding model (masked generative,
    # H-space latent), not the reference's topic sibling, so both
    # report "embedding"; enrichment mode reads topic prefixes
    # (senna topic writes dictionary/latent log tables).
    with open(f"{args.output}.gem.json", "w") as f:
        _json.dump(
            {"model_type": "embedding", "program": args.cmd,
             "latent": "h-space"}, f,
        )
    timings["write_s"] = time.perf_counter() - t0
    print(
        f"wrote {args.output}."
        "{gene_embedding,velocity,gene_velocity,latent,"
        "cell_embedding,feature_embedding,gem.json}"
    )
    barrier(live(mesh))
    return timings


def _cmd_lineage(args):
    import pandas as pd

    from ...faba.lineage_run import run_lineage

    if args.frm is None and args.latent is None:
        raise SystemExit("faba lineage: need --from PREFIX (or the "
                         "legacy --latent/--velocity pair)")
    theta = vel = cells = None
    prefix = args.frm
    if args.latent is not None:
        zdf = pd.read_parquet(args.latent)
        cells = zdf.iloc[:, 0].astype(str).tolist()
        theta = zdf.iloc[:, 1:].to_numpy(np.float32)
        if args.velocity is not None:
            vel = pd.read_parquet(args.velocity).iloc[:, 1:].to_numpy(
                np.float32)
        prefix = prefix or os.path.splitext(args.latent)[0]
    res = run_lineage(
        prefix, args.out,
        theta=theta, velocity=vel, cell_names=cells,
        theta_from=args.theta_from,
        latent_geometry=args.latent_geometry,
        n_centroids=args.n_centroids, seed=args.seed,
        kmeans_iter=args.kmeans_iter,
        cluster_space=args.cluster_space,
        no_edge_direction=args.no_edge_direction,
        no_orient_velocity=args.no_orient_velocity,
        edge_cand_knn=args.edge_cand_knn,
        edge_direction_n_boot=args.edge_direction_n_boot,
        edge_direction_n_perm=args.edge_direction_n_perm,
        edge_alpha=args.edge_alpha,
        edge_min_cells=args.edge_min_cells,
        root_affinity=args.root_affinity,
        root_type=args.root_type,
        root_from_gem=args.root_from_gem,
        root_node=args.root_node, root_cell=args.root_cell,
        curve_bandwidth=args.curve_bandwidth,
        curve_resolution=args.curve_resolution,
        max_iter=args.max_iter, tol=args.tol,
        markers=args.markers,
        marker_num_perm=args.marker_num_perm,
        marker_obo=args.marker_obo,
        marker_label_cl=args.marker_label_cl,
        no_bootstrap_markers=args.no_bootstrap_markers,
        marker_n_boot=args.marker_n_boot,
        marker_min_support=args.marker_min_support,
        layout=args.layout, layout_space=args.layout_space,
        layout_pcs=args.layout_pcs,
        velocity_aware_layout=args.velocity_aware_layout,
        phate_knn=args.phate_knn, phate_t=args.phate_t,
        phate_landmarks=args.phate_landmarks, device=args.device,
    )
    print(
        f"lineage: {res['n_trees']} tree(s), {res['n_lineages']} "
        f"lineage(s), {res['edges_called']}/{res['edges_total']} edges "
        f"oriented, roots {res['roots']}"
    )
    return res["timings"]


def _cmd_dyn_assoc(args):
    import pandas as pd

    from ...data.sparse_io import open_sparse_matrix
    from ...faba.assoc import dyn_assoc, dyn_assoc_pseudotime

    if args.branches is None and args.frm is None:
        raise SystemExit("dyn-assoc: need --from PREFIX or --branches")
    branches_path = args.branches or f"{args.frm}.pseudotime.parquet"
    out_prefix = args.output or args.frm
    if out_prefix is None:
        raise SystemExit("dyn-assoc: need --output (or --from)")
    args.output = out_prefix
    # multi-backend: rows concatenate over one shared cell axis
    counts_parts, site_names, cells = [], [], None
    for path in args.backend.split(","):
        be = open_sparse_matrix(path)
        mat = np.asarray(
            be.read_columns_csc(np.arange(be.num_columns)).todense()
        )
        names = list(be.row_names())
        if args.modality:
            keep = [
                i for i, nme in enumerate(names)
                if f"/{args.modality.lower()}/" in f"/{str(nme).lower()}/"
            ]
            mat = mat[keep]
            names = [names[i] for i in keep]
        if cells is None:
            cells = be.column_names()
        elif list(be.column_names()) != list(cells):
            raise SystemExit(
                f"dyn-assoc: {path} has a different cell axis"
            )
        counts_parts.append(mat)
        site_names += names
    counts = np.concatenate(counts_parts, axis=0)  # [S, N]
    keep_sites = (counts.sum(1) >= args.min_total_coverage) & (
        (counts > 0).sum(1) >= args.min_cells
    )
    if not keep_sites.all():
        counts = counts[keep_sites]
        site_names = [s for s, k in zip(site_names, keep_sites) if k]
    lab = pd.read_parquet(branches_path)
    lab = lab.set_index(lab.columns[0]).reindex(cells)
    exposure_sm = None  # per-(site, cell) trials when row-aligned
    if args.exposure:
        ex_be = open_sparse_matrix(args.exposure)
        ex_mat = np.asarray(
            ex_be.read_columns_csc(np.arange(ex_be.num_columns)).todense()
        )
        if ex_mat.shape[0] == len(keep_sites):
            # site-aligned coverage backend: keep the per-site rows
            # for the GAM's binomial denominators (trend.rs bd.n)
            exposure_sm = ex_mat[keep_sites]
        exposure = ex_mat.sum(0)
    else:
        exposure = counts.sum(0) + 1.0
    branch_col = next((c for c in ("branch", "state") if c in lab.columns), None)

    if args.trend_method != "bayes":
        # frequentist within-branch spline GAM (assoc/gam.rs via
        # trend.rs): per-branch when a branch column exists, one
        # whole-trajectory fit otherwise
        from ...faba.gam import gam_association_batch

        if "pseudotime" not in lab.columns:
            raise SystemExit(
                "dyn-assoc --trend-method quasi|binomial needs a "
                "pseudotime column in --branches"
            )
        x_all = lab["pseudotime"].to_numpy(np.float64)
        n_all = (
            exposure_sm
            if exposure_sm is not None
            else np.broadcast_to(exposure[None, :], counts.shape)
        )
        branch_labels = (
            lab[branch_col].to_numpy()
            if branch_col is not None
            else np.zeros(len(x_all), np.int64)
        )
        rows = []
        for b in np.unique(branch_labels):
            sel = (branch_labels == b) & np.isfinite(x_all)
            fit = gam_association_batch(
                counts[:, sel], n_all[:, sel], x_all[sel],
                n_knots=args.n_knots,
                overdispersion=args.trend_method == "quasi",
                device=args.device,
            )
            if fit is None:
                continue
            rows.append(
                pd.DataFrame(
                    {
                        "site": site_names,
                        "branch": b,
                        "n_cells": fit["n_obs"],
                        "stat": fit["stat"],
                        "effect": fit["effect"],
                        "dispersion": fit["dispersion"],
                        "pvalue": fit["pvalue"],
                    }
                )[fit["ok"]]
            )
        if not rows:
            raise SystemExit("dyn-assoc: no branch supports a spline fit")
        df = pd.concat(rows, ignore_index=True)
        if args.fdr_alpha > 0:
            from ...ops.enrichment import bh_fdr

            df["qvalue"] = bh_fdr(df["pvalue"].to_numpy())
            df["significant"] = df["qvalue"] <= args.fdr_alpha
        df.to_parquet(f"{args.output}.assoc.parquet")
        print(f"wrote {args.output}.assoc.parquet ({len(df)} trends)")
        return

    a0 = b0 = 1.0 / max(args.prior_sd, 1e-3) ** 2
    if branch_col is not None:
        out = dyn_assoc(
            counts, exposure, lab[branch_col].to_numpy(), a0=a0, b0=b0
        )
        df = pd.DataFrame(
            {
                "site": site_names,
                "branch": out["branch"],
                "log_fold_change": out["log_fold_change"],
                "z": out["z"],
                "log_bf": out["log_bf"],
                "pvalue": out["pvalue"],
            }
        )
        if args.cell_membership and not args.no_celltype:
            # cell-type-level report (AssocArgs cell_membership):
            # the same branch contrast restricted to each type's
            # cells, one table row per (site, cell_type)
            memb = {}
            with open(args.cell_membership) as f:
                for ln in f:
                    parts = ln.split()
                    if len(parts) >= 2:
                        memb[parts[0]] = parts[1]
            ct = np.asarray(
                [memb.get(str(c), "") for c in cells], object
            )
            blab = lab[branch_col].to_numpy()
            ct_rows = []
            for t in sorted(set(ct) - {""}):
                sel = ct == t
                if len(np.unique(blab[sel])) < 2 or sel.sum() < 4:
                    continue
                o = dyn_assoc(
                    counts[:, sel], exposure[sel], blab[sel],
                    a0=a0, b0=b0,
                )
                ct_rows.append(pd.DataFrame({
                    "site": site_names, "cell_type": t,
                    "branch": o["branch"],
                    "log_fold_change": o["log_fold_change"],
                    "z": o["z"], "pvalue": o["pvalue"],
                }))
            if ct_rows:
                pd.concat(ct_rows, ignore_index=True).to_parquet(
                    f"{args.output}.assoc.celltype.parquet"
                )
                print(f"wrote {args.output}.assoc.celltype.parquet")
    else:
        pt_col = "pseudotime" if "pseudotime" in lab.columns else lab.columns[0]
        out = dyn_assoc_pseudotime(
            counts, exposure, lab[pt_col].to_numpy(),
            n_windows=args.n_bins,
        )
        df = pd.DataFrame(
            {
                "site": site_names,
                "slope": out["slope"],
                "z": out["z"],
                "pvalue": out["pvalue"],
            }
        )
    if args.fdr_alpha > 0:
        from ...ops.enrichment import bh_fdr

        df["qvalue"] = bh_fdr(df["pvalue"].to_numpy())
        df["significant"] = df["qvalue"] <= args.fdr_alpha
    df.to_parquet(f"{args.output}.assoc.parquet")
    print(f"wrote {args.output}.assoc.parquet ({len(df)} sites)")

