"""`senna qmatrix`, `annotate-ontology`, `annotate-by-enrichment`,
`annotate-by-projection`, `deconvolve`, `probe` and `impute` (the port
of the JAX package's `cli/senna_cmds/annotate_cmds.py`, with the parsers
of its `cli/senna_cli.py`: the same flags and defaults, plus `--device` where a command
runs on the card).

Tables are read and written with `utils/output.py` (parquet where pandas
and pyarrow import, else `.npz`); the bulk matrix of `deconvolve` and the
annotation TSVs are read with pandas. A caller holding cells in memory
passes them as `vec` (the command's `--data-files`, or `--sc-data` of
`deconvolve --from`) or as `vecs` for the two-input modes: `[query,
calibration]` for `probe --model` and `[query, reference]` for `impute
--model`.
"""

from __future__ import annotations

import json

import numpy as np

from ...utils.output import read_table, write_table


def add_annotate_parsers(sub) -> None:
    """The parsers of the seven commands, the JAX flags and defaults."""
    p = sub.add_parser("deconvolve", help="bulk deconvolution against a reference")
    p.add_argument("--bulk", required=True, help="TSV/parquet: samples x genes counts")
    p.add_argument("--reference", default=None,
                   help="direct mode: parquet of genes x components rates")
    p.add_argument("--from", dest="from_run", default=None,
                   help="archetype mode: prior embedding run prefix")
    p.add_argument("--sc-data", nargs="+", default=None,
                   help="archetype mode: single-cell count backends "
                        "(default: the --from run's data files)")
    p.add_argument("--annotation", default=None,
                   help="archetype mode: TSV cell<TAB>label (soft readout)")
    p.add_argument("--archetypes", type=int, nargs="+", default=[200],
                   help="target archetype counts; several granularities pool into one posterior")
    p.add_argument("--archetype-min-cells", type=int, default=10)
    p.add_argument("--out", required=True)
    p.add_argument("--sweeps", "--draws", dest="sweeps", type=int, default=300)
    p.add_argument("--burn-in", "--warmup", dest="burn_in", type=int, default=100)
    p.add_argument("--thin", type=int, default=1)
    p.add_argument("--frac-prior-shape", type=float, default=1.0)
    p.add_argument("--frac-prior-rate", type=float, default=1.0)
    p.add_argument("--nb-dispersion", type=float, default=10.0)
    p.add_argument("--count-scale", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("probe", help="drift probe: model-based conformal fit null "
                                     "(--model + --calibration) or latent drift (--train-latent)")
    p.add_argument("--data-files", nargs="+", default=None,
                   help="model mode: query backends to probe")
    p.add_argument("--model", default=None, help="model mode: trained topic-model prefix")
    p.add_argument("--calibration", default=None,
                   help="model mode: in-distribution backend defining the null")
    p.add_argument("--alpha", type=float, default=0.05,
                   help="null tail probability = per-cell FP rate")
    p.add_argument("--minibatch-size", type=int, default=2048)
    p.add_argument("--counterfactual", action="store_true",
                   help="first-order benefit/forgetting along the pull direction")
    p.add_argument("--cf-seed", type=int, default=42)
    p.add_argument("--train-latent", default=None)
    p.add_argument("--heldout-latent", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("qmatrix", help="gene-set x topic enrichment Q-matrix")
    p.add_argument("--dictionary", required=True, help="{out}.dictionary.parquet")
    p.add_argument("--markers", required=True, help="GMT gene sets")
    p.add_argument("--out", required=True)
    p.add_argument("--permutations", type=int, default=500)
    p.add_argument("--specificity", choices=["raw", "simplex", "abs"], default="raw")
    p.add_argument("--no-stratify", action="store_true",
                   help="disable abundance-stratified null sets (GOseq fix)")
    p.add_argument("--latent", default=None,
                   help="cell topic proportions: also writes per-cell labels via theta . Q")
    p.add_argument("--q-temperature", type=float, default=1.0,
                   help="softmax temperature of the normalized Q lens")
    p.add_argument("--fdr-alpha", type=float, default=0.05, help="survival gate for the Q lens")
    p.add_argument("--min-confidence", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("annotate-ontology", help="ontology-consensus cluster annotation (TreeBH)")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--clusters", required=True, help="clusters parquet")
    p.add_argument("--obo", required=True, help="ontology .obo")
    p.add_argument("--gaf", required=True, help="term-gene annotations GAF")
    p.add_argument("--out", required=True)
    p.add_argument("--top-frac", type=float, default=0.1)
    p.add_argument("--alpha", type=float, default=0.05)
    p.add_argument("--by", choices=["ora", "module-score"], default="ora",
                   help="module-score adds the descriptive cross-cluster contrast table")

    p = sub.add_parser("annotate-by-enrichment", help="marker-panel cluster annotation")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--clusters", required=True, help="clusters parquet")
    p.add_argument("--markers", required=True, help="GMT marker sets")
    p.add_argument("--out", required=True)
    p.add_argument("--bootstrap", "--n-boot", dest="bootstrap", type=int, default=0,
                   help="panel stability bootstrap draws (0 = off)")
    p.add_argument("--support-threshold", "--min-support", dest="support_threshold",
                   type=float, default=0.6)
    p.add_argument("--min-score", type=float, default=0.0,
                   help="below this marker z the cluster stays UNASSIGNED")
    p.add_argument("--min-markers", type=int, default=0,
                   help="panels matching fewer genes drop out")
    p.add_argument("--min-gene-set", type=int, default=0)
    p.add_argument("--max-gene-set", type=int, default=0, help="0 = no cap")
    p.add_argument("--num-perm", type=int, default=0,
                   help="gene-label permutation null: adds perm_z/perm_p columns")
    p.add_argument("--seed", type=int, default=0)

    p = sub.add_parser("impute", help="kNN count imputation: against a reference dataset "
                                      "(--model + --reference-latent + --reference-data) or "
                                      "self-latent smoothing (--latent)")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--latent", default=None, help="self mode: this dataset's own latent")
    p.add_argument("--model", default=None, help="reference mode: trained model prefix")
    p.add_argument("--reference-latent", default=None,
                   help="reference mode: the reference run's latent")
    p.add_argument("--reference-data", nargs="+", default=None,
                   help="reference mode: data files behind --reference-latent")
    p.add_argument("--reference-batch-files", nargs="+", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--knn", type=int, default=15)
    p.add_argument("--knn-temperature", type=float, default=1.0,
                   help="softmax temperature on kNN distances (w ~ exp(-d^2/2 tau^2))")
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("annotate-by-projection",
                       help="marker projection into a co-embedding (--from + --markers) "
                            "or kNN label transfer (--train-latent)")
    p.add_argument("--from", dest="from_run", default=None,
                   help="rest/bge run prefix with feature_embedding + latent")
    p.add_argument("--markers", default=None, help="GMT marker sets")
    p.add_argument("--no-idf", action="store_true",
                   help="skip the inverse-panel-frequency marker weighting")
    p.add_argument("--assign-mad", type=float, default=3.0,
                   help="cells further than this many MADs below the median winning "
                        "score stay UNASSIGNED")
    p.add_argument("--no-assign-qc", action="store_true")
    p.add_argument("--train-latent", default=None)
    p.add_argument("--train-clusters", default=None, help="clusters parquet")
    p.add_argument("--latent", default=None, help="held-out latent parquet")
    p.add_argument("--out", required=True)
    p.add_argument("--knn", type=int, default=15)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _matrix(table: dict, dtype="float32") -> tuple[np.ndarray, np.ndarray, list[str]]:
    """(first column, the other columns as [N, C], their names)."""
    names = list(table)
    return (np.asarray(table[names[0]]),
            np.stack([np.asarray(table[c], dtype) for c in names[1:]], 1), names[1:])


def _cluster_profiles(vec, clusters_path: str) -> tuple[np.ndarray, np.ndarray]:
    """(cluster ids, [C, D] mean log1p profile of each cluster)."""
    labels = np.asarray(list(read_table(clusters_path).values())[1])
    uniq = np.unique(labels)
    profiles = np.zeros((len(uniq), vec.num_rows))
    for i, c in enumerate(uniq):
        cells = np.nonzero(labels == c)[0]
        profiles[i] = np.log1p(np.asarray(vec.read_columns_csc(cells).mean(axis=1)).ravel())
    return uniq, profiles


def _load(args, vec):
    from ...senna.topic import load_data_vec

    return vec if vec is not None else load_data_vec(args.data_files)


def cmd_annotate_by_projection(args):
    from ...ops.knn import knn_search

    if args.from_run:
        # marker projection into the shared cell+gene space
        # (annotate/args.rs marker-projection path): each label's score
        # is the IDF-weighted mean similarity of the cell to the label's
        # marker-gene embeddings
        from ...data.knowledge import read_gmt
        from ...utils.manifest import RunManifest, manifest_path

        if not args.markers:
            raise SystemExit("annotate-by-projection --from needs --markers")
        prev = RunManifest.load(manifest_path(args.from_run))
        gene_col, g_emb, _ = _matrix(read_table(prev.outputs["feature_embedding"]))
        cells, z, _ = _matrix(read_table(prev.outputs["latent"]))
        genes = {str(g).lower(): i for i, g in enumerate(gene_col)}
        zn = z / np.maximum(np.linalg.norm(z, axis=1, keepdims=True), 1e-9)
        gn = g_emb / np.maximum(np.linalg.norm(g_emb, axis=1, keepdims=True), 1e-9)
        sets = read_gmt(args.markers)
        # IDF: markers shared by many panels discriminate less
        counts: dict[str, int] = {}
        for gl in sets.values():
            for g in gl:
                counts[str(g).lower()] = counts.get(str(g).lower(), 0) + 1
        n_panels = max(len(sets), 1)
        scores = np.full((len(z), len(sets)), -np.inf, np.float32)
        labels = list(sets)
        for li, label in enumerate(labels):
            idxs, wts = [], []
            for g in sets[label]:
                j = genes.get(str(g).lower())
                if j is not None:
                    idxs.append(j)
                    wts.append(1.0 if args.no_idf else np.log1p(n_panels / counts[str(g).lower()]))
            if not idxs:
                continue
            w = np.asarray(wts, np.float32)
            sim = zn @ gn[np.asarray(idxs)].T  # [N, M]
            scores[:, li] = (sim * w[None, :]).sum(1) / w.sum()
        best = scores.argmax(1)
        ann = np.asarray(labels)[best]
        conf = scores[np.arange(len(z)), best]
        if not args.no_assign_qc:
            # MAD fence on the winning score (assign_mad)
            med = np.median(conf)
            mad = np.median(np.abs(conf - med)) * 1.4826
            low = conf < med - args.assign_mad * max(mad, 1e-9)
            ann = np.where(low, "UNASSIGNED", ann)
        path = write_table(f"{args.out}.annotation",
                           {"cell": cells, "annotation": ann, "score": conf})
        print(f"wrote {path} ({(np.asarray(ann) != 'UNASSIGNED').sum()}/{len(ann)} assigned)")
        return ann
    if not (args.train_latent and args.train_clusters and args.latent):
        raise SystemExit(
            "annotate-by-projection: provide --from/--markers or "
            "--train-latent/--train-clusters/--latent"
        )
    tr_cells, zt, _ = _matrix(read_table(args.train_latent))
    ho_cells, zh, _ = _matrix(read_table(args.latent))
    cl = list(read_table(args.train_clusters).values())
    lut = dict(zip(cl[0].tolist(), cl[1].tolist()))
    lab = np.asarray([lut.get(c, np.nan) for c in tr_cells.tolist()], dtype=object)
    dist, idx = knn_search(zh, zt, min(args.knn, len(zt)), device=args.device)
    w = np.exp(-(dist - dist.min(1, keepdims=True)))
    w = w / np.maximum(w.sum(1, keepdims=True), 1e-30)
    uniq, lab_codes = np.unique(lab.astype(str), return_inverse=True)
    votes = np.zeros((len(zh), len(uniq)))
    for j in range(idx.shape[1]):
        np.add.at(votes, (np.arange(len(zh)), lab_codes[idx[:, j]]), w[:, j])
    best = votes.argmax(1)
    conf = votes[np.arange(len(zh)), best] / np.maximum(votes.sum(1), 1e-30)
    path = write_table(f"{args.out}.annotation",
                       {"cell": ho_cells, "annotation": uniq[best], "confidence": conf})
    print(f"wrote {path}")
    return uniq[best]


def cmd_qmatrix(args):
    from ...data.knowledge import read_gmt
    from ...ops.enrichment import geneset_topic_qmatrix, label_cells

    genes, dic, topics = _matrix(read_table(args.dictionary), "float64")
    out = geneset_topic_qmatrix(
        dic.T, [str(g) for g in genes], read_gmt(args.markers), n_perm=args.permutations,
        specificity=args.specificity, stratify=not args.no_stratify, device=args.device,
    )

    def by_set(mat):
        return {"gene_set": np.asarray(out["labels"]),
                **{t: mat[:, j] for j, t in enumerate(topics)}}

    write_table(f"{args.out}.qmatrix", by_set(out["z"]))
    if args.latent:
        cells, th, _ = _matrix(read_table(args.latent), "float64")
        if np.all(th <= 0):
            th = np.exp(th)
        # FDR-sparse lens: zero out non-significant entries
        zq = np.where(out["q"] < 0.05, np.maximum(out["z"], 0.0), 0.0)
        _, cell_labels, conf = label_cells(th, zq.T, out["labels"],
                                           min_confidence=args.min_confidence)
        write_table(f"{args.out}.cell_annotation",
                    {"cell": cells, "annotation": np.asarray(cell_labels), "confidence": conf})
    write_table(f"{args.out}.qvalues", by_set(out["q"]))
    # normalized Q lens (q_matrix.rs build_q_matrix): per topic, the
    # surviving (q < alpha, z > 0) labels softmax at 1/temperature;
    # topics with nothing surviving stay a zero column
    beta = 1.0 / max(args.q_temperature, 1e-6)
    z = out["z"]  # [n_sets, K]
    surv = (out["q"] < args.fdr_alpha) & (z > 0)
    qsm = np.zeros_like(z)
    for kk in range(z.shape[1]):
        m = surv[:, kk]
        if m.any():
            v = z[m, kk] * beta
            e = np.exp(v - v.max())
            qsm[m, kk] = e / e.sum()
    write_table(f"{args.out}.qsoftmax", by_set(qsm))
    print(f"wrote {args.out}.qmatrix/.qvalues/.qsoftmax tables")
    return out


def cmd_annotate_ontology(args, *, vec=None):
    from ...data.knowledge import parse_obo, read_gaf
    from ...ops.enrichment import annotate_ontology, ontology_module_score

    vec = _load(args, vec)
    uniq, profiles = _cluster_profiles(vec, args.clusters)
    ont = parse_obo(args.obo)
    term_genes = read_gaf(args.gaf, ont)
    if args.by == "module-score":
        ms = ontology_module_score(profiles.T, term_genes, gene_names=vec.row_names())
        path = write_table(f"{args.out}.module_score", {
            "cluster": np.asarray([str(u) for u in uniq]),
            **{str(t): ms["effect_kt"][:, j] for j, t in enumerate(ms["terms"])},
        })
        print(f"wrote {path} ({len(ms['terms'])} terms x {len(uniq)} clusters)")
    res = annotate_ontology(profiles, vec.row_names(), term_genes, ont,
                            top_frac=args.top_frac, alpha=args.alpha, term_names=ont.terms)
    path = write_table(f"{args.out}.annotation", {
        "cluster": uniq, "annotation": np.asarray(res["labels"]), "q": res["q"]})
    print(f"wrote {path}")
    return res


def cmd_annotate_by_enrichment(args, *, vec=None):
    from scipy.stats import norm

    from ...data.knowledge import read_gmt
    from ...ops.enrichment import annotate_by_markers, marker_bootstrap

    vec = _load(args, vec)
    uniq, profiles = _cluster_profiles(vec, args.clusters)
    sets = read_gmt(args.markers)
    # panel filters (AnnotateArgs min_markers / min/max_gene_set)
    gene_pool = {str(g).lower() for g in vec.row_names()}
    kept_sets = {}
    for label, gl in sets.items():
        if args.min_gene_set and len(gl) < args.min_gene_set:
            continue
        if args.max_gene_set and len(gl) > args.max_gene_set:
            continue
        matched = sum(str(g).lower() in gene_pool for g in gl)
        if args.min_markers and matched < args.min_markers:
            continue
        kept_sets[label] = gl
    if not kept_sets:
        raise SystemExit("annotate: no marker panel survives the filters")
    sets = kept_sets
    names, scores = annotate_by_markers(profiles, vec.row_names(), sets,
                                        min_score=args.min_score)
    table = {"cluster": uniq, "annotation": np.asarray(names), "score": scores.max(1)}
    if args.num_perm > 0:
        # gene-label permutation null on the winning score
        rng = np.random.default_rng(args.seed)
        gene_list = list(vec.row_names())
        null = np.zeros((args.num_perm, len(uniq)))
        for t in range(args.num_perm):
            perm_genes = [gene_list[i] for i in rng.permutation(len(gene_list))]
            _, s_t = annotate_by_markers(profiles, perm_genes, sets)
            null[t] = s_t.max(1)
        mu0 = null.mean(0)
        sd0 = np.maximum(null.std(0), 1e-9)
        perm_z = (scores.max(1) - mu0) / sd0
        table["perm_z"] = perm_z
        table["perm_p"] = norm.sf(perm_z)
    if args.bootstrap > 0:
        bs = marker_bootstrap(profiles, vec.row_names(), sets, n_boot=args.bootstrap,
                              support_threshold=args.support_threshold)
        table["annotation"] = np.asarray(bs["annotation"])
        table["cluster_label_support"] = bs["cluster_label_support"]
    path = write_table(f"{args.out}.annotation", table)
    print(f"wrote {path}")
    return table


def _read_bulk(path: str):
    """The samples x genes counts table, parquet or TSV (whose first
    column is the sample index), as a pandas frame."""
    import pandas as pd

    df = pd.read_parquet(path) if path.endswith(".parquet") else pd.read_csv(
        path, sep="\t", index_col=0)
    return df


def cmd_deconvolve(args, *, vec=None):
    import pandas as pd
    import pandas.api.types as ptypes

    from ...senna.deconvolve import DeconvConfig, build_archetype_reference, deconvolve

    bulk_df = _read_bulk(args.bulk)
    cfg = DeconvConfig(
        n_sweeps=args.sweeps, burn_in=args.burn_in, thin=args.thin,
        a0=args.frac_prior_shape, b0=args.frac_prior_rate,
        nb_dispersion=args.nb_dispersion, count_scale=args.count_scale, seed=args.seed,
    )
    samples = np.asarray([str(s) for s in bulk_df.index])
    if args.from_run:
        # archetype mode (deconvolve/source.rs + archetypes.rs): cluster
        # the prior run's cell embedding into measured sub-type profiles;
        # pool granularities into one posterior
        from ...senna.topic import load_data_vec
        from ...utils.manifest import RunManifest, manifest_path

        prev = RunManifest.load(manifest_path(args.from_run))
        latent_path = prev.outputs.get("latent")
        if latent_path is None:
            raise SystemExit("deconvolve --from: source run has no latent")
        _, emb, _ = _matrix(read_table(latent_path))
        if np.all(emb <= 0):
            emb = np.exp(emb)
        sc_files = args.sc_data or prev.inputs.get("data_files")
        if vec is None and not sc_files:
            raise SystemExit("deconvolve --from: no --sc-data and no "
                             "data files in the source manifest")
        sc_vec = vec if vec is not None else load_data_vec(sc_files)
        ann = np.array([""] * sc_vec.num_columns, dtype=object)
        if args.annotation:
            adf = pd.read_csv(args.annotation, sep="\t", header=None,
                              names=["cell", "label"], dtype=str)
            lut = dict(zip(adf.cell, adf.label))
            ann = np.array([lut.get(str(c), "") for c in sc_vec.column_names()], dtype=object)
        frac_means, memb_cols = [], {}
        celltypes = None
        for gi, n_arch in enumerate(args.archetypes):
            ref = build_archetype_reference(
                sc_vec, emb, ann, n_archetypes=n_arch,
                min_cells=args.archetype_min_cells, seed=args.seed + gi, device=args.device,
            )
            celltypes = ref.celltype_names
            shared = [g for g in ref.gene_names if g in bulk_df.columns]
            gpos = {g: i for i, g in enumerate(ref.gene_names)}
            rows = [gpos[g] for g in shared]
            y = bulk_df[shared].to_numpy(np.float32)
            res = deconvolve(y, ref.mu_gm[rows], readout_mc=ref.readout, config=cfg,
                             device=args.device)
            frac_means.append(res.fractions)
            memb_cols[f"archetype_k{n_arch}"] = ref.membership
        frac = np.mean(frac_means, axis=0)
        write_table(f"{args.out}.fractions",
                    {"sample": samples, **{str(c): frac[:, j] for j, c in enumerate(celltypes)}})
        write_table(f"{args.out}.membership",
                    {"cell": np.asarray(sc_vec.column_names()), **memb_cols})
        print(f"wrote {args.out}.fractions ({len(args.archetypes)} granularities pooled) "
              "+ membership")
        return frac
    if not args.reference:
        raise SystemExit("deconvolve: provide --reference or --from")
    ref_df = pd.read_parquet(args.reference)
    # a non-numeric first column is the gene-name index
    ref = (ref_df.set_index(ref_df.columns[0])
           if not ptypes.is_numeric_dtype(ref_df.iloc[:, 0]) else ref_df)
    shared = [g for g in ref.index if g in bulk_df.columns]
    y = bulk_df[shared].to_numpy(np.float32)
    mu = ref.loc[shared].to_numpy(np.float32)
    res = deconvolve(y, mu, config=cfg, device=args.device)
    write_table(f"{args.out}.fractions",
                {"sample": samples,
                 **{str(c): res.fractions[:, j] for j, c in enumerate(ref.columns)}})
    print(f"wrote {args.out}.fractions (worst Rhat {res.rhat.max():.2f})")
    return res


def cmd_probe(args, *, vecs=None):
    if args.model:
        # model-based conformal probe (probe.rs)
        from ...senna.probe import probe_model

        if vecs is None and not (args.data_files and args.calibration):
            raise SystemExit("probe model mode needs --data-files AND --calibration")
        qv, cv = vecs if vecs is not None else (None, None)
        res = probe_model(
            args.model, args.data_files, args.calibration,
            alpha=args.alpha, block_size=args.minibatch_size,
            counterfactual=args.counterfactual, cf_seed=args.cf_seed,
            query_vec=qv, calibration_vec=cv, device=args.device,
        )
        write_table(f"{args.out}.probe.fit", {"fit": res.q_fit,
                                              "flagged": res.q_fit < res.threshold})
        doc = {
            "verdict": res.verdict,
            "flag_rate": res.flag_rate,
            "binom_p": res.binom_p,
            "threshold": res.threshold,
            "alpha": args.alpha,
        }
        if res.counterfactual is not None:
            doc["counterfactual"] = res.counterfactual
        with open(f"{args.out}.probe.json", "w") as f:
            json.dump(doc, f, indent=2)
        print(json.dumps({k: v for k, v in doc.items() if k != "counterfactual"}))
        if res.counterfactual:
            cfd = res.counterfactual
            print(f"counterfactual: benefit={cfd['benefit']:+.4e} "
                  f"forgetting={cfd['forgetting']:+.4e} ||g||={cfd['pull_norm']:.4e}")
        return res
    if not (args.train_latent and args.heldout_latent):
        raise SystemExit(
            "probe: provide --model/--calibration/--data-files or "
            "--train-latent/--heldout-latent"
        )
    from ...senna.impute import probe_latent

    _, tr, _ = _matrix(read_table(args.train_latent))
    _, ho, _ = _matrix(read_table(args.heldout_latent))
    v = probe_latent(tr, ho)
    doc = {"verdict": v.verdict, "drift_score": v.drift_score, "novelty_frac": v.novelty_frac}
    with open(f"{args.out}.probe.json", "w") as f:
        json.dump(doc, f, indent=2)
    print(json.dumps(doc))
    return v


def cmd_impute(args, *, vec=None, vecs=None):
    import scipy.sparse as sp

    from ...data.sparse_io import create_sparse_from_csc
    from ...senna.impute import impute_counts, impute_from_reference
    from ...senna.topic import load_data_vec

    ref_mode = bool(args.model or args.reference_latent or args.reference_data)
    if ref_mode:
        if not (args.model and args.reference_latent and (args.reference_data or vecs)):
            raise SystemExit("impute reference mode needs --model, --reference-latent "
                             "AND --reference-data")
        qvec, ref_vec = vecs if vecs is not None else (
            load_data_vec(args.data_files),
            load_data_vec(args.reference_data, args.reference_batch_files))
        # 1. project the query through the trained encoder
        # (impute.rs:113 delegates to predict)
        from ...senna.predict import PredictArgs, predict_model

        z_new = predict_model(
            PredictArgs(data_files=list(args.data_files), model=args.model,
                        out=f"{args.out}.query", block_size=args.block_size),
            vec=qvec, device=args.device,
        )
        _, z_ref, _ = _matrix(read_table(args.reference_latent))
        # latents store log proportions; compare in linear space
        theta_new = np.exp(z_new) if np.all(z_new <= 0) else z_new
        theta_ref = np.exp(z_ref) if np.all(z_ref <= 0) else z_ref
        imp = impute_from_reference(
            theta_new, theta_ref, ref_vec, knn=args.knn,
            knn_temperature=args.knn_temperature, cell_block=args.block_size,
            device=args.device,
        )
        path = write_table(f"{args.out}.imputed", {
            "cell": np.asarray(qvec.column_names()),
            **{str(g): imp[:, j] for j, g in enumerate(ref_vec.row_names())},
        })
        print(f"wrote {path} ({imp.shape[0]} x {imp.shape[1]})")
        return imp
    vec = _load(args, vec)
    if not args.latent:
        raise SystemExit("impute self mode needs --latent")
    _, z, _ = _matrix(read_table(args.latent))
    if len(z) != vec.num_columns:
        raise SystemExit(f"latent has {len(z)} cells but data has {vec.num_columns}")
    imp = impute_counts(vec, z, knn=args.knn, device=args.device)
    create_sparse_from_csc(sp.csc_matrix(imp.T), f"{args.out}.zarr",
                           vec.row_names(), vec.column_names())
    print(f"wrote backend: {args.out}.zarr (imputed)")
    return imp
