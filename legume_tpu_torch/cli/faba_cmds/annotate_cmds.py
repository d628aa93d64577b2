"""faba `annotate`: parser + handler (the port's copy of the JAX
package's `cli/faba_cmds/annotate_cmds.py`, flags and defaults
unchanged, plus `--device`, default `cuda`: the projection mode's cell
kNN graph and the enrichment mode's Q-matrices run there,
`faba/annotate.py`). The legacy `--backend` / `--clusters` path is host
numpy."""

from __future__ import annotations

import os

import numpy as np


def add_parsers(sub):
    p = sub.add_parser(
        "annotate",
        help="marker cell-type annotation of a gem run "
             "(annotate/run.rs AnnotateArgs)",
    )
    p.add_argument("-f", "--from", dest="frm", default=None,
                   help="gem / gem-encoder / topic output prefix")
    p.add_argument("--markers", required=True,
                   help="gene<TAB>celltype TSV (or GMT) marker panels")
    p.add_argument("-o", "--out", default=None,
                   help="output prefix (default: the gem prefix)")
    p.add_argument("--mode", choices=["projection", "enrichment"],
                   default=None,
                   help="how markers become a call (default: from "
                        "{from}.gem.json — topic -> enrichment, "
                        "embedding -> projection)")
    p.add_argument("--track",
                   choices=["spliced", "velocity", "nascent", "both"],
                   default="both",
                   help="spliced/velocity are projection tracks; "
                        "spliced/nascent are enrichment tracks")
    p.add_argument("--knn", type=int, default=15,
                   help="k for the cosine cell kNN graph fed to Leiden")
    p.add_argument("--resolution", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--num-perm", type=int, default=200,
                   help="permutation draws calibrating the "
                        "over-representation statistic")
    p.add_argument("--min-markers", type=int, default=3)
    p.add_argument("--no-assign-qc", action="store_true")
    p.add_argument("--assign-mad", type=float, default=3.0)
    p.add_argument("--fdr-alpha", type=float, default=0.05)
    p.add_argument("--q-temperature", type=float, default=1.0)
    p.add_argument("--no-idf", action="store_true")
    p.add_argument("--obo", default=None,
                   help="Cell Ontology OBO: TreeBH layer (needs "
                        "--label-cl)")
    p.add_argument("--label-cl", default=None)
    p.add_argument("--ontology-fdr-q", type=float, default=0.05)
    p.add_argument("--ontology-by", action="store_true")
    p.add_argument("--panel-perm", type=int, default=0,
                   help="marker-panel permutation null (bias guard); "
                        "0 = off, try 200")
    p.add_argument("--support-perm", type=int, default=0,
                   help="support permutation null calibrating "
                        "label_support; 0 = off")
    p.add_argument("--no-bootstrap-markers", action="store_true")
    p.add_argument("--n-boot", type=int, default=100)
    p.add_argument("--no-recluster", action="store_true",
                   help="hold the clustering fixed across resamples "
                        "(weakens the bootstrap)")
    p.add_argument("--min-support", type=float, default=0.5)
    p.add_argument("--abstain-separable", action="store_true",
                   help="abstain by a top-vs-runner-up sign test "
                        "instead of the --min-support threshold")
    p.add_argument("--abstain-alpha", type=float, default=0.05)
    p.add_argument("--set-coverage", type=float, default=0.8,
                   help="coverage of the reported label_set")
    p.add_argument("--max-set-size", type=int, default=3)
    p.add_argument("--min-panel-coverage", type=float, default=0.0)
    # legacy round-2 surface (site-track cluster labelling) stays:
    p.add_argument("--backend", default=None,
                   help="LEGACY: site x cell counts backend (with "
                        "--clusters; pre-r3 surface)")
    p.add_argument("--clusters", default=None, help="LEGACY clusters parquet")
    p.add_argument("--min-score", type=float, default=0.0)
    p.add_argument("--output", default=None, help="LEGACY output prefix")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _cmd_annotate(args):
    import pandas as pd

    if args.backend is None:
        _run_faba_annotate(args)
        return

    from ...data.knowledge import read_gmt
    from ...data.sparse_io import open_sparse_matrix
    from ...ops.enrichment import annotate_by_markers

    be = open_sparse_matrix(args.backend)
    cl = pd.read_parquet(args.clusters)
    labels = cl.iloc[:, 1].to_numpy()
    uniq = np.unique(labels)
    profiles = np.zeros((len(uniq), be.num_rows))
    for i, c in enumerate(uniq):
        cells = np.nonzero(labels == c)[0]
        profiles[i] = np.log1p(
            np.asarray(be.read_columns_csc(cells).mean(axis=1)).ravel()
        )
    # faba features follow gene/modality/channel; match markers on
    # the gene part of the row name (feature_name.rs convention)
    genes = [str(n).split(":")[0].split("/")[0] for n in be.row_names()]
    sets = read_gmt(args.markers)
    names, scores = annotate_by_markers(
        profiles, genes, sets, min_score=args.min_score
    )
    table = {"cluster": uniq, "annotation": names, "score": scores.max(1)}
    if args.n_boot > 0:
        from ...ops.enrichment import marker_bootstrap

        bs = marker_bootstrap(
            profiles, genes, sets, n_boot=args.n_boot,
            support_threshold=args.min_support,
        )
        table["annotation"] = bs["annotation"]
        table["cluster_label_support"] = bs["cluster_label_support"]
    pd.DataFrame(table).to_parquet(f"{args.output}.annotation.parquet")
    print(f"wrote {args.output}.annotation.parquet")
    return


def _run_faba_annotate(args):
    """`faba annotate --from PREFIX`: the reference's gem-prefix
    annotator (annotate/run.rs run_annotate). Projection mode scores
    the co-embedded feature rows against the cell table per track;
    enrichment mode routes through the topic dictionary + θ."""
    import pandas as pd

    from ...faba.annotate import (
        UNASSIGNED,
        annotate_enrichment,
        annotate_projection,
        resolve_mode,
    )

    if args.frm is None:
        raise SystemExit("faba annotate: need --from PREFIX (or the "
                         "legacy --backend/--clusters pair)")
    prefix = args.frm
    out = args.out or prefix
    mode = resolve_mode(prefix, args.mode)

    def read_tbl(path):
        df = pd.read_parquet(path)
        return (df.iloc[:, 0].astype(str).tolist(),
                df.iloc[:, 1:].to_numpy(np.float32))

    if mode == "enrichment":
        if args.track == "velocity":
            raise SystemExit(
                "--track velocity does not apply to --mode enrichment: "
                "the velocity is a displacement, not a membership on "
                "the simplex. Use --track nascent (the nascent PROGRAM) "
                "— reading it against spliced is the well-posed form "
                "of the same question."
            )
        ignored = [
            f for f, on in [
                ("--panel-perm", args.panel_perm > 0),
                ("--support-perm", args.support_perm > 0),
                ("--obo", args.obo is not None),
                ("--label-cl", args.label_cl is not None),
                ("--no-assign-qc", args.no_assign_qc),
            ] if on
        ]
        if ignored:
            raise SystemExit(
                "these flags belong to --mode projection and do "
                f"nothing under --mode enrichment: {', '.join(ignored)}"
            )
        tracks = {
            "spliced": [("", "")],
            "nascent": [(".nascent", "_nascent")],
            "both": [("", ""), (".nascent", "_nascent")],
        }[args.track]
        for tag_sfx, tbl_sfx in tracks:
            dic_path = f"{prefix}.dictionary{tbl_sfx}.parquet"
            lat_path = f"{prefix}.latent{tbl_sfx}.parquet"
            if not (os.path.exists(dic_path) and os.path.exists(lat_path)):
                if args.track == "both" and tbl_sfx:
                    print(f"nascent track skipped: missing {dic_path} "
                          f"and/or {lat_path}")
                    continue
                raise SystemExit(f"--mode enrichment needs {dic_path} + "
                                 f"{lat_path} (a topic-model run)")
            genes, log_beta = read_tbl(dic_path)
            cells, log_theta = read_tbl(lat_path)
            pb_gene = pb_log_theta = None
            pbg = f"{prefix}.pb_gene{tbl_sfx}.parquet"
            pbl = f"{prefix}.pb_latent{tbl_sfx}.parquet"
            if os.path.exists(pbg) and os.path.exists(pbl):
                _, pb_gene = read_tbl(pbg)
                _, pb_log_theta = read_tbl(pbl)
            res = annotate_enrichment(
                log_beta, genes, log_theta, cells, args.markers,
                min_markers=args.min_markers,
                min_panel_coverage=args.min_panel_coverage,
                n_perm=args.num_perm, fdr_alpha=args.fdr_alpha,
                q_temperature=args.q_temperature, seed=args.seed,
                bootstrap=not args.no_bootstrap_markers,
                n_boot=args.n_boot, min_support=args.min_support,
                pb_gene=pb_gene, pb_log_theta=pb_log_theta,
                device=args.device,
            )
            tag = f"enrichment{tag_sfx}"
            pd.DataFrame({
                "cell": cells, "annotation": res["cell_labels"],
                "score": res["cell_scores"].max(1),
            }).to_parquet(f"{out}.{tag}.annotation.parquet")
            fac = {
                "factor": [f"t{k}" for k in range(len(res["factor_call"]))],
                "call": res["factor_call"],
            }
            if res["factor_support"] is not None:
                fac["support"] = res["factor_support"]
            pd.DataFrame(fac).to_parquet(f"{out}.{tag}.factors.parquet")
            pd.DataFrame(
                res["qmatrix"], columns=res["labels"],
            ).assign(factor=fac["factor"]).to_parquet(
                f"{out}.{tag}.qmatrix.parquet")
            n_called = sum(lab != UNASSIGNED for lab in res["cell_labels"])
            print(f"wrote {out}.{tag}.* ({n_called}/{len(cells)} cells "
                  "annotated)")
        return

    # --mode projection
    if args.track == "nascent":
        raise SystemExit(
            "--track nascent applies to --mode enrichment, not "
            "projection; projection's unspliced side is --track velocity"
        )
    fe_path = f"{prefix}.feature_embedding.parquet"
    if not os.path.exists(fe_path):
        raise SystemExit(f"--mode projection needs {fe_path} "
                         "(run `faba gem` to produce it)")
    feat_names, feat = read_tbl(fe_path)

    def modality_rows(suffix):
        keep = [i for i, n in enumerate(feat_names) if n.endswith(suffix)]
        genes = [feat_names[i][: -len(suffix)] for i in keep]
        return genes, feat[keep]

    ce_path = f"{prefix}.cell_embedding.parquet"
    if not os.path.exists(ce_path):
        ce_path = f"{prefix}.latent.parquet"
    specs = []
    if args.track in ("spliced", "both"):
        specs.append(("/count/spliced", ce_path, "spliced"))
    if args.track in ("velocity", "both"):
        vpath = f"{prefix}.velocity.parquet"
        if os.path.exists(vpath):
            specs.append(("/count/unspliced", vpath, "velocity"))
        elif args.track == "velocity":
            raise SystemExit("--track velocity requested but "
                             f"{vpath} is absent")
        else:
            print(f"velocity track skipped: missing {vpath}")
    for mod_suffix, cell_path, tag in specs:
        genes, gene_emb = modality_rows(mod_suffix)
        if not genes:
            if tag == "velocity":
                print("velocity track skipped: no unspliced feature rows")
                continue
            raise SystemExit(f"{fe_path} has no `{mod_suffix}` rows")
        cells, cell_emb = read_tbl(cell_path)
        res = annotate_projection(
            gene_emb, genes, cell_emb, cells, args.markers,
            use_idf=not args.no_idf, min_markers=args.min_markers,
            min_panel_coverage=args.min_panel_coverage,
            knn=args.knn, resolution=args.resolution, seed=args.seed,
            n_perm=args.num_perm, assign_qc=not args.no_assign_qc,
            assign_mad=args.assign_mad, fdr_alpha=args.fdr_alpha,
            q_temperature=args.q_temperature,
            panel_perm=args.panel_perm, support_perm=args.support_perm,
            bootstrap=not args.no_bootstrap_markers, n_boot=args.n_boot,
            recluster=not args.no_recluster,
            min_support=args.min_support,
            abstain_separable=args.abstain_separable,
            abstain_alpha=args.abstain_alpha,
            set_coverage=args.set_coverage,
            max_set_size=args.max_set_size,
            obo=args.obo, label_cl=args.label_cl,
            ontology_fdr_q=args.ontology_fdr_q,
            ontology_by=args.ontology_by, device=args.device,
        )
        c_ids = list(np.unique(res.clusters))
        cl_of = {c: i for i, c in enumerate(c_ids)}
        cell_label = [
            res.cluster_call[cl_of[c]] for c in res.clusters
        ]
        pd.DataFrame({
            "cell": cells,
            "cluster": res.clusters,
            "assigned_type": [
                res.type_names[a] if a >= 0 else UNASSIGNED
                for a in res.cell_assign
            ],
            "assign_dist": res.assign_dist,
            "annotation": cell_label,
        }).to_parquet(f"{out}.{tag}.annotation.parquet")
        cl_tbl = {
            "cluster": c_ids,
            "call": res.cluster_call,
            "p": res.cluster_p, "q": res.cluster_q,
        }
        if res.support is not None:
            cl_tbl["label_support"] = res.support
            cl_tbl["label_set"] = res.label_sets
        if res.support_p is not None:
            cl_tbl["support_p"] = res.support_p
        pd.DataFrame(cl_tbl).to_parquet(f"{out}.{tag}.clusters.parquet")
        pd.DataFrame(
            res.qmatrix, columns=res.type_names,
        ).assign(cluster=c_ids).to_parquet(f"{out}.{tag}.qmatrix.parquet")
        if res.panel_bias_p is not None:
            pd.DataFrame({
                "type": res.type_names, "panel_bias_p": res.panel_bias_p,
            }).to_parquet(f"{out}.{tag}.panel_bias.parquet")
        if res.ontology_q:
            pd.DataFrame({
                "term": list(res.ontology_q),
                "q": list(res.ontology_q.values()),
            }).to_parquet(f"{out}.{tag}.ontology.parquet")
        n_ann = sum(lab != UNASSIGNED for lab in cell_label)
        print(f"wrote {out}.{tag}.* ({n_ann}/{len(cells)} cells annotated, "
              f"{len(c_ids)} clusters)")

