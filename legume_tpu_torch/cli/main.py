"""Command line of the port: `python -m legume_tpu_torch senna
{topic,vae,svd,joint-svd,joint-topic,masked-topic,masked-vae,masked-sbp,
bge,fne,resolve-embedding-space (rest),predict,eval-topic,clustering,
layout,pseudotime,plot,plot-topic,plot-strand,qmatrix,annotate-ontology,
annotate-by-enrichment,annotate-by-projection,deconvolve,probe,impute}
...`, `python -m legume_tpu_torch cocoa {diff,collapse,simulate-one,
simulate-collider} ...`, `python -m legume_tpu_torch data-beans ...`
(`cli/beans_cli.py`), `python -m legume_tpu_torch data-beans-sim ...`
(`cli/sim_cli.py`) and `python -m legume_tpu_torch faba {index,genes,gem,
gem-encoder,dyn-assoc,...} ...` (`cli/faba_cli.py`, every subcommand of
the JAX package's) and `python -m legume_tpu_torch pinto {lc,
cascade,annotate,p,interfaces,prop,dsvd,cage,lc-etm,lra} ...`
(`cli/pinto_cli.py`), `python -m legume_tpu_torch fagioli {map-sumstat,
fit-sumstat-sgvb,fit-prs-susie,fit-sumstat-mcmc,sim-sumstat,sim-geno,sim-qtl,
map-qtl,fit-qtl-sgvb,sim-mediation,fit-regression,pseudobulk} ...`
(`cli/fagioli_cli.py`) and `python -m legume_tpu_torch chickpea {p2g,
from-multiome} ...` (`cli/chickpea_cli.py`) (or `python -m
legume_tpu_torch.cli.main`, or the `legume-torch` script).

The flags are those of the JAX package's commands, and every one runs.
`--device` picks the torch device (default `cuda`); the commands that
run on the host alone (`plot`, `plot-topic`, `plot-strand`,
`annotate-ontology`, `annotate-by-enrichment`, and every `data-beans`
subcommand but `qc` and `histogram`) have none. `--from <run>`
resolves the latent (and `plot-topic`'s dictionary) from that run's
`{run}.senna.json`; `clustering` and `layout` record their outputs back
into it. `senna topic --from <run>` inherits the run's data files and
reuses its cell -> pseudobulk partition. A caller holding the cells in
memory passes them to `run_senna(argv, vec=)` (`vecs=`, one per modality,
for `joint-topic` and `joint-svd`); the command then reads them instead
of `--data-files` (`vecs=[query, calibration]` for `probe --model` and
`[query, reference]` for `impute --model`). A first Ctrl-C ends a
trainer's epochs and lets the command write its partial outputs.

Data parallelism runs one process per GPU: with `LEGUME_COORDINATOR`
(host:port), `LEGUME_NUM_PROCESSES` and `LEGUME_PROCESS_ID` set, or
`LEGUME_DISTRIBUTED=1` under torchrun, `main` starts the process group
before it dispatches (`parallel/multihost.py`) and destroys it at exit.
Every command with `--data-parallel` runs over it: `senna topic`, `vae`,
`svd`, `bge`, `masked-topic`, `masked-vae`, `masked-sbp`, `cocoa diff`,
`faba gem`, `gem-encoder` and `pinto lc`. Without the switches
`--data-parallel` is a world of one, the plain run.
"""

from __future__ import annotations

import argparse
import logging
import sys


def _topic_parser(sub):
    p = sub.add_parser("topic", help="multilevel pseudobulk VAE topic model")
    p.add_argument("--data-files", nargs="*", default=[])
    p.add_argument("--out", required=True)
    p.add_argument("--from", dest="from_run", default=None)
    p.add_argument("--init-from", dest="init_from", default=None)
    p.add_argument("--batch-files", nargs="+", default=None)
    p.add_argument("--n-latent-topics", "-k", type=int, default=10)
    p.add_argument("--encoder-layers", type=int, nargs="+", default=[128, 1024, 128])
    p.add_argument("--epochs", "-i", type=int, default=1000)
    p.add_argument("--minibatch-size", type=int, default=100)
    p.add_argument("--learning-rate", "--lr", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--decoder", default="nb")
    p.add_argument("--decoder-weights", type=float, nargs="+", default=None)
    p.add_argument("--adj-method", choices=["batch", "residual"], default="residual")
    p.add_argument("--rho-prior-weight", type=float, default=0.0)
    p.add_argument("--rho-prior-alpha", type=float, default=2.0)
    p.add_argument("--rho-prior-beta", type=float, default=18.0)
    p.add_argument("--amort-refine-steps", type=int, default=0)
    p.add_argument("--amort-refine-lr", type=float, default=0.01)
    p.add_argument("--amort-refine-reg", type=float, default=1.0)
    p.add_argument("--preload-data", action="store_true")
    p.add_argument("--topic-smoothing", type=float, default=1e-4)
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--sort-dim", type=int, default=10)
    p.add_argument("--knn-cells", type=int, default=10)
    p.add_argument("--num-levels", type=int, default=3)
    p.add_argument("--iter-opt", type=int, default=30)
    p.add_argument("--ignore-batch", action="store_true")
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--max-coarse-features", type=int, default=0)
    p.add_argument("--cnv", action="store_true")
    p.add_argument("--qc", action="store_true")
    p.add_argument("--qc-min-total", type=float, default=0.0)
    p.add_argument("--qc-min-genes", type=int, default=0)
    p.add_argument("--qc-max-mito-frac", type=float, default=1.0)
    p.add_argument("--hvg-genes", type=int, default=5000)
    p.add_argument("--no-refine", action="store_true")
    p.add_argument("--gene-weighting", choices=["nb-fisher", "none"], default="nb-fisher")
    p.add_argument("--anchor-penalty", type=float, default=0.0)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _bge_parser(sub):
    p = sub.add_parser("bge", help="count-NCE joint embedding")
    p.add_argument("--posterior", type=int, default=0)
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--embed-dim", "-d", type=int, default=16)
    p.add_argument("--epochs", type=int, default=1000)
    p.add_argument("--sort-dim", type=int, default=8)
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--batch-files", nargs="+", default=None)
    p.add_argument("--feature-qc", action="store_true")
    p.add_argument("--hvg-min-excess", type=float, default=0.0)
    p.add_argument("--min-nnz-rows", type=float, default=0.0)
    p.add_argument("--multiome", action="store_true")
    p.add_argument("--bridge-weight", type=float, default=1.0)
    p.add_argument("--num-topics", type=int, default=0)
    p.add_argument("--phase1-cells-per-pb", type=int, default=0)
    p.add_argument("--skip-etm", action="store_true")
    p.add_argument("--compute-dtype", choices=["float32", "bfloat16"], default="float32")
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _rest_parser(sub):
    p = sub.add_parser("resolve-embedding-space", aliases=["rest"],
                       help="frozen-theta co-embedding of a topic run (--from) or "
                            "Procrustes alignment of runs (--runs)")
    p.add_argument("--from", dest="from_run", default=None)
    p.add_argument("--data-files", nargs="+", default=None)
    p.add_argument("--embedding-dim", "-d", type=int, default=None)
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--learning-rate", "--lr", type=float, default=0.05)
    p.add_argument("--num-negatives", type=float, default=5.0)
    p.add_argument("--runs", nargs="+", default=None)
    p.add_argument("--out", required=True)
    p.add_argument("--reference", type=int, default=0)
    p.add_argument("--no-scale", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _predict_parser(sub):
    p = sub.add_parser("predict", aliases=["eval-topic"],
                       help="held-out latent inference (eval-topic: +batch null, refinement)")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--model", required=True, help="output prefix of a senna topic run")
    p.add_argument("--out", required=True)
    p.add_argument("--block-size", type=int, default=4096)
    p.add_argument("--batch-files", nargs="+", default=None)
    p.add_argument("--refine-steps", type=int, default=0)
    p.add_argument("--refine-lr", type=float, default=0.01)
    p.add_argument("--refine-reg", type=float, default=1.0)
    p.add_argument("--decoder-only", action="store_true")
    p.add_argument("--delta-iters", type=int, default=0)
    p.add_argument("--residual-out", default=None)
    p.add_argument("--residual-include-delta", action="store_true")
    p.add_argument("--residual-threshold", type=float, default=0.0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _clustering_parser(sub):
    p = sub.add_parser("clustering", help="kmeans/leiden/hsblock on a latent table")
    p.add_argument("--latent", default=None)
    p.add_argument("--from", dest="from_run", default=None,
                   help="prefix of a prior run: the latent resolves from its manifest")
    p.add_argument("--out", required=True)
    p.add_argument("--method", choices=["kmeans", "leiden", "hsblock"], default="leiden")
    p.add_argument("--hsblock-depth", "--tree-depth", dest="hsblock_depth", type=int, default=4)
    p.add_argument("--n-clusters", type=int, default=10)
    p.add_argument("--knn", type=int, default=15)
    p.add_argument("--resolution", type=float, default=1.0)
    p.add_argument("--max-iter", type=int, default=10)
    p.add_argument("--no-degree-corrected", action="store_true")
    p.add_argument("--edge-scale", type=float, default=1.0)
    p.add_argument("--min-cluster-size", type=int, default=1)
    p.add_argument("--data-files", nargs="+", default=None)
    p.add_argument("--bhc-gamma-per-gene", type=float, default=1.0)
    p.add_argument("--bhc-cut", type=float, default=0.0)
    p.add_argument("--bhc-block-size", type=int, default=4096)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")
    return p


def _layout_parsers(sub):
    p = sub.add_parser("layout", help="2D layout of a latent table")
    p.add_argument("--latent", default=None)
    p.add_argument("--from", dest="from_run", default=None,
                   help="prefix of a prior run: inputs resolve from its manifest")
    p.add_argument("--out", required=True)
    p.add_argument("--method", choices=["umap", "tumap", "tsne", "phate", "tree"],
                   default="umap")
    p.add_argument("--n-neighbors", type=int, default=15)
    p.add_argument("--epochs", type=int, default=200)
    p.add_argument("--perplexity", type=float, default=30.0, help="tsne only")
    p.add_argument("--pcs", type=int, default=0)
    p.add_argument("--tree-jitter", type=float, default=0.08)
    p.add_argument("--tree-jitter-seed", type=int, default=42)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("pseudotime", help="principal-graph pseudotime")
    p.add_argument("--latent", default=None)
    p.add_argument("--from", dest="from_run", default=None,
                   help="prefix of a prior run: inputs resolve from its manifest")
    p.add_argument("--out", required=True)
    p.add_argument("--n-nodes", "--n-centroids", dest="n_nodes", type=int, default=50)
    p.add_argument("--root-cell", type=int, default=None)
    p.add_argument("--root-node", type=int, default=None)
    p.add_argument("--gamma", "--lam", dest="lam", type=float, default=1.0)
    p.add_argument("--sigma", type=float, default=0.1)
    p.add_argument("--max-iter", type=int, default=30)
    p.add_argument("--velocity", default=None,
                   help="table of per-cell velocity in latent space; orients the tree "
                        "and overrides --root-cell")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("plot", help="scatter a layout colored by clusters")
    p.add_argument("--layout", default=None, help="layout/latent table")
    p.add_argument("--from", dest="from_run", default=None,
                   help="prior run prefix: layout/latent + clusters resolve from its manifest")
    p.add_argument("--clusters", default=None, help="clusters table")
    p.add_argument("--colour-by", "--color-by", dest="colour_by",
                   choices=["cluster", "topic", "pseudotime", "annotation"], default="cluster")
    p.add_argument("--topics", type=int, nargs="+", default=None)
    p.add_argument("--annotation", default=None)
    p.add_argument("--pseudotime", default=None)
    p.add_argument("--width", type=float, default=6.0)
    p.add_argument("--height", type=float, default=5.0)
    p.add_argument("--dpi", type=int, default=150)
    p.add_argument("--point-size", type=float, default=3.0)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--hull", action="store_true")
    p.add_argument("--hull-coverage", type=float, default=0.9)
    p.add_argument("--hull-fill-alpha", type=float, default=0.15)
    p.add_argument("--no-labels", action="store_true")
    p.add_argument("--label-font-size", type=float, default=8.0)
    p.add_argument("--svg", action="store_true")
    p.add_argument("--png", action="store_true")
    p.add_argument("--no-pdf", action="store_true")
    p.add_argument("--out", required=True)

    p = sub.add_parser("plot-topic", help="structure bars + top genes per topic")
    p.add_argument("--latent", default=None)
    p.add_argument("--from", dest="from_run", default=None)
    p.add_argument("--out", required=True, help="output image (.png/.svg/.pdf)")
    p.add_argument("--clusters", default=None)
    p.add_argument("--dictionary", default=None)
    p.add_argument("--top-genes", type=int, default=10)
    p.add_argument("--group-by", default=None)
    p.add_argument("--no-struct", action="store_true")
    p.add_argument("--no-dict", action="store_true")

    p = sub.add_parser("plot-strand", help="Watson/Crick mirrored genomic-activity ideograms")
    p.add_argument("--activity", required=True, help="parquet: gene x group activity")
    p.add_argument("--gff", required=True, help="gene coordinates + strand")
    p.add_argument("--out", required=True, help="output prefix (one image per group)")
    p.add_argument("--bins", type=int, default=200)


def _inherit_from(a):
    """`--from` chaining (run_manifest.rs:848 inherit_from): the latent and
    the dictionary resolve from a prior run's manifest."""
    from ..utils.manifest import RunManifest, manifest_path

    prev = RunManifest.load(manifest_path(a.from_run))
    for key in ("latent", "dictionary"):
        if hasattr(a, key) and getattr(a, key) is None and key in prev.outputs:
            setattr(a, key, prev.outputs[key])


def _run_clustering(a):
    from ..senna.clustering import ClusteringArgs, run_clustering
    from ..utils.manifest import RunManifest, manifest_path, save_manifest_back
    from ..utils.output import table_path

    fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device", "from_run",
                                                            "no_degree_corrected")}
    labels = run_clustering(
        ClusteringArgs(**fields, degree_corrected=not a.no_degree_corrected), device=a.device
    )
    if a.from_run:  # record the clusters back into the source manifest
        src = manifest_path(a.from_run)
        prev = RunManifest.load(src)
        prev.outputs["clusters"] = table_path(f"{a.out}.clusters")
        save_manifest_back(prev, src)
    return labels


def run_senna(argv, *, vec=None, vecs=None):
    from ..senna.topic import TopicArgs, fit_topic_model
    from ..utils.prng import DEFAULT_PROJECTION_SEED
    from .senna_cmds import annotate_cmds, embed_cmds, masked_cmds, topic_cmds

    ap = argparse.ArgumentParser(prog="senna")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _topic_parser(sub)
    topic_cmds.add_topic_parsers(sub)
    embed_cmds.add_svd_parsers(sub)
    masked_cmds.add_masked_parsers(sub)
    _bge_parser(sub)
    _rest_parser(sub)
    _predict_parser(sub)
    _clustering_parser(sub)
    _layout_parsers(sub)
    annotate_cmds.add_annotate_parsers(sub)
    embed_cmds.add_fne_parser(sub)
    a = ap.parse_args(argv)
    trainers = {
        "vae": lambda: topic_cmds.run_vae(a, vec=vec),
        "joint-topic": lambda: topic_cmds.run_joint_topic(a, vecs=vecs),
        "svd": lambda: embed_cmds.run_svd(a, vec=vec),
        "joint-svd": lambda: embed_cmds.run_joint_svd(a, vecs=vecs),
        **{name: (lambda: masked_cmds.run_masked(a, vec=vec))
           for name in ("masked-topic", "masked-vae", "masked-sbp")},
    }
    if a.cmd in trainers:
        return trainers[a.cmd]()
    if a.cmd == "fne":
        return embed_cmds.run_fne(a)
    if a.cmd in ("resolve-embedding-space", "rest"):
        from .senna_cmds.embed_cmds import RestArgs, run_rest

        fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device")}
        return run_rest(RestArgs(**fields), device=a.device)
    if getattr(a, "from_run", None) and a.cmd != "topic":
        _inherit_from(a)
    if (
        a.cmd in ("clustering", "layout", "pseudotime", "plot-topic")
        and not a.latent
        # layout tree resolves its latent from the pseudotime manifest's inputs
        and not (a.cmd == "layout" and a.method == "tree" and a.from_run)
    ):
        raise SystemExit(f"{a.cmd}: provide --latent or --from <run prefix>")
    if a.cmd == "bge":
        from .senna_cmds.embed_cmds import BgeArgs, run_bge

        fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device")}
        return run_bge(BgeArgs(**fields), device=a.device)
    if a.cmd in ("predict", "eval-topic"):
        from ..senna.predict import PredictArgs, predict_model

        fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device")}
        return predict_model(PredictArgs(**fields), device=a.device)
    if a.cmd == "clustering":
        return _run_clustering(a)
    A = annotate_cmds
    annotators = {
        "qmatrix": lambda: A.cmd_qmatrix(a),
        "annotate-ontology": lambda: A.cmd_annotate_ontology(a, vec=vec),
        "annotate-by-enrichment": lambda: A.cmd_annotate_by_enrichment(a, vec=vec),
        "annotate-by-projection": lambda: A.cmd_annotate_by_projection(a),
        "deconvolve": lambda: A.cmd_deconvolve(a, vec=vec),
        "probe": lambda: A.cmd_probe(a, vecs=vecs),
        "impute": lambda: A.cmd_impute(a, vec=vec, vecs=vecs),
    }
    if a.cmd in annotators:
        return annotators[a.cmd]()
    if a.cmd in ("layout", "pseudotime", "plot", "plot-topic", "plot-strand"):
        from .senna_cmds import layout_cmds as L

        if a.cmd == "layout" and a.method == "tree":
            return L.cmd_layout_tree(a)
        return {"layout": L.cmd_layout, "pseudotime": L.cmd_pseudotime, "plot": L.cmd_plot,
                "plot-topic": L.cmd_plot_topic, "plot-strand": L.cmd_plot_strand}[a.cmd](a)
    if not a.data_files and not a.from_run and vec is None:
        raise SystemExit("topic: provide --data-files or --from <run prefix>")
    args = TopicArgs(
        data_files=a.data_files, out=a.out, from_run=a.from_run, init_from=a.init_from,
        batch_files=a.batch_files, n_latent_topics=a.n_latent_topics,
        encoder_layers=tuple(a.encoder_layers), epochs=a.epochs,
        minibatch_size=a.minibatch_size, learning_rate=a.learning_rate,
        grad_clip=a.grad_clip, decoder=a.decoder, decoder_weights=a.decoder_weights,
        adj_method=a.adj_method, rho_prior_weight=a.rho_prior_weight,
        rho_prior_alpha=a.rho_prior_alpha, rho_prior_beta=a.rho_prior_beta,
        amort_refine_steps=a.amort_refine_steps, amort_refine_lr=a.amort_refine_lr,
        amort_refine_reg=a.amort_refine_reg, preload_data=a.preload_data,
        topic_smoothing=a.topic_smoothing,
        proj_dim=a.proj_dim, sort_dim=a.sort_dim, knn_cells=a.knn_cells,
        num_levels=a.num_levels, iter_opt=a.iter_opt, ignore_batch=a.ignore_batch,
        block_size=a.block_size, max_coarse_features=a.max_coarse_features, cnv=a.cnv,
        qc=a.qc, qc_min_total=a.qc_min_total, qc_min_genes=a.qc_min_genes,
        qc_max_mito_frac=a.qc_max_mito_frac, hvg_genes=a.hvg_genes, refine=not a.no_refine,
        gene_weighting=a.gene_weighting, anchor_penalty=a.anchor_penalty,
        data_parallel=a.data_parallel,
        seed=a.seed if a.seed is not None else DEFAULT_PROJECTION_SEED,
    )
    return fit_topic_model(args, vec=vec, device=a.device)


def run_cocoa(argv, *, vec=None):
    """`cocoa {diff,collapse,simulate-one,simulate-collider}`; `vec`
    overrides the data files of `diff` and `collapse`."""
    ap = argparse.ArgumentParser(prog="cocoa", description="counterfactual confounder-adjusted DE")
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("diff", help="counterfactual differential expression")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--indv", required=True, help="cell -> individual labels, one per line")
    p.add_argument("--exposure", required=True, help="individual TAB exposure table")
    p.add_argument("--topic", default=None, help="cell topic proportions table")
    p.add_argument("--topic-assignment", default=None,
                   help="hard per-cell topic labels, one per line")
    p.add_argument("--topic-proportion-value", choices=["prob", "logit"], default="prob")
    p.add_argument("--covariate-file", default=None)
    p.add_argument("--n-pb-samples", type=int, default=10)
    p.add_argument("--knn", type=int, default=10)
    p.add_argument("--proj-dim", type=int, default=30)
    p.add_argument("--iter-opt", type=int, default=100)
    p.add_argument("--a0", type=float, default=1.0)
    p.add_argument("--b0", type=float, default=1.0)
    p.add_argument("--permutations", type=int, default=0)
    p.add_argument("--permutation-seed", type=int, default=None)
    p.add_argument("--no-collider-fix", action="store_true")
    p.add_argument("--no-adjust-housekeeping", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--gff", default=None)
    p.add_argument("--cnv-ground-truth", default=None)
    p.add_argument("--cnv-states", type=int, default=3)
    p.add_argument("--cnv-gmm-k-max", type=int, default=0)
    p.add_argument("--cnv-ref-iters", type=int, default=2)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--no-match-cache", action="store_true")
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("collapse", help="per-individual pseudobulk Gamma means")
    p.add_argument("--data-files", nargs="+", required=True)
    p.add_argument("--indv", required=True)
    p.add_argument("--out", required=True)
    p.add_argument("--iter-opt", type=int, default=30)
    p.add_argument("--a0", type=float, default=1.0)
    p.add_argument("--b0", type=float, default=1.0)
    p.add_argument("--no-adjust-housekeeping", action="store_true")
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    for name in ("simulate-one", "simulate-collider"):
        p = sub.add_parser(name, help="cocoa's generative simulators")
        p.add_argument("--output", required=True)
        p.add_argument("--genes", type=int, default=200)
        p.add_argument("--indv", type=int, default=20)
        p.add_argument("--cells-per-indv", type=int, default=50)
        p.add_argument("--n-causal", type=int, default=20)
        p.add_argument("--depth", type=float, default=2000.0)
        p.add_argument("--seed", type=int, default=0)
        if name == "simulate-one":
            p.add_argument("--pve-exposure-gene", type=float, default=0.3)
        else:
            p.add_argument("--types", type=int, default=3)
    a = ap.parse_args(argv)

    if a.cmd == "collapse":
        from ..cocoa.diff import run_cocoa_collapse

        return run_cocoa_collapse(
            a.data_files, a.indv, a.out, iter_opt=a.iter_opt, a0=a.a0, b0=a.b0,
            adjust_housekeeping=not a.no_adjust_housekeeping, block_size=a.block_size,
            vec=vec, device=a.device,
        )
    if a.cmd in ("simulate-one", "simulate-collider"):
        from ..cocoa.sim import write_simulation

        return write_simulation(a)
    from ..cocoa.diff import CocoaDiffArgs, run_cocoa_diff

    return run_cocoa_diff(CocoaDiffArgs(
        data_files=a.data_files, out=a.out, indv_file=a.indv, exposure_file=a.exposure,
        topic_file=a.topic, topic_assignment_file=a.topic_assignment,
        topic_proportion_value=a.topic_proportion_value, covariate_file=a.covariate_file,
        n_pb_samples=a.n_pb_samples, knn=a.knn, proj_dim=a.proj_dim, n_opt_iter=a.iter_opt,
        a0=a.a0, b0=a.b0, n_permutations=a.permutations, permutation_seed=a.permutation_seed,
        collider_fix=not a.no_collider_fix, adjust_housekeeping=not a.no_adjust_housekeeping,
        gff=a.gff, cnv_ground_truth=a.cnv_ground_truth, cnv_states=a.cnv_states,
        cnv_gmm_k_max=a.cnv_gmm_k_max, cnv_ref_iters=a.cnv_ref_iters,
        data_parallel=a.data_parallel, match_cache=not a.no_match_cache,
        **({"seed": a.seed} if a.seed is not None else {}),
    ), vec=vec, device=a.device)


def _device_arg(argv) -> str:
    """The value of `--device` in `argv` (the commands' default, cuda,
    when it is not given): the device a rank's process group is for."""
    for i, arg in enumerate(argv):
        if arg == "--device" and i + 1 < len(argv):
            return argv[i + 1]
        if arg.startswith("--device="):
            return arg.split("=", 1)[1]
    return "cuda"


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s %(name)s] %(message)s")
    import torch.distributed as dist

    from ..parallel.multihost import maybe_initialize_distributed, shutdown_distributed
    from ..utils.stop import install_sigint_handler

    install_sigint_handler()  # a first Ctrl-C ends training with partial outputs
    # data parallelism: the process group starts before any CUDA context
    # (a caller that started one keeps it)
    started = not dist.is_initialized() and maybe_initialize_distributed(
        device=_device_arg(argv))
    try:
        return _dispatch(argv)
    finally:
        if started:
            shutdown_distributed()


def _dispatch(argv) -> int:
    binaries = {"senna": run_senna, "cocoa": run_cocoa, "data-beans": run_beans,
                "data-beans-sim": run_sim, "faba": run_faba, "pinto": run_pinto,
                "fagioli": run_fagioli, "chickpea": run_chickpea}
    if not argv or argv[0] not in binaries:
        print("usage: python -m legume_tpu_torch senna {topic,vae,svd,joint-svd,"
              "joint-topic,masked-topic,masked-vae,masked-sbp,bge,fne,resolve-embedding-space,"
              "rest,predict,eval-topic,clustering,layout,pseudotime,plot,plot-topic,plot-strand,"
              "qmatrix,annotate-ontology,annotate-by-enrichment,annotate-by-projection,"
              "deconvolve,probe,impute} ...\n"
              "       python -m legume_tpu_torch cocoa {diff,collapse,simulate-one,"
              "simulate-collider} ...\n"
              "       python -m legume_tpu_torch data-beans <subcommand> ...\n"
              "       python -m legume_tpu_torch data-beans-sim {topic,faba,multimodal,multiome,"
              "bulk} ...\n"
              "       python -m legume_tpu_torch faba {index,genes,gem,gem-encoder,dyn-assoc} ...\n"
              "       python -m legume_tpu_torch pinto {lc,cascade,annotate,p,interfaces,prop,dsvd,"
              "cage,lc-etm,lra} ...\n"
              "       python -m legume_tpu_torch fagioli {map-sumstat,fit-sumstat-sgvb,"
              "fit-prs-susie,fit-sumstat-mcmc,sim-sumstat,sim-geno,sim-qtl,map-qtl,fit-qtl-sgvb,"
              "sim-mediation,fit-regression,pseudobulk} ...\n"
              "       python -m legume_tpu_torch chickpea {p2g,from-multiome} ...")
        return 1
    binaries[argv[0]](argv[1:])
    return 0


def run_beans(argv):
    """`data-beans`: build, convert, subset, inspect and QC sparse backends."""
    from .beans_cli import run_beans as _run

    return _run(argv)


def run_sim(argv):
    """`data-beans-sim`: synthetic count generators."""
    from .sim_cli import run_sim as _run

    return _run(argv)


def run_faba(argv):
    """`faba`: BAM feature extraction and gem (RNA velocity)."""
    from .faba_cli import run_faba as _run

    return _run(argv)


def run_pinto(argv, *, vec=None):
    """`pinto`: spatial link communities and their companions."""
    from .pinto_cli import run_pinto as _run

    return _run(argv, vec=vec)


def run_fagioli(argv):
    """`fagioli`: GWAS and single-cell eQTL fine-mapping."""
    from .fagioli_cli import run_fagioli as _run

    return _run(argv)


def run_chickpea(argv):
    """`chickpea`: peak-to-gene linkage."""
    from .chickpea_cli import run_chickpea as _run

    return _run(argv)


if __name__ == "__main__":
    raise SystemExit(main())
