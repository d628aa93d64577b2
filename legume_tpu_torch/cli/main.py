"""Command line of the port: `python -m legume_tpu_torch.cli.main senna
{topic,bge,predict,eval-topic,clustering} ...`.

The flags are those of the JAX package's commands; the ones the port
does not carry yet are accepted and raise `NotImplementedError` when set.
`--device` picks the torch device (default `cuda`). `--from <run>`
resolves `clustering`'s latent from that run's `{run}.senna.json`, and
the clusters path is recorded back into it.
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


def _manifest_path(run: str) -> str:
    return run if run.endswith(".json") else run + ".senna.json"


def _run_clustering(a):
    from ..senna.clustering import ClusteringArgs, run_clustering
    from ..utils.manifest import RunManifest
    from ..utils.output import table_path

    if a.from_run and a.latent is None:
        a.latent = RunManifest.load(_manifest_path(a.from_run)).outputs.get("latent")
    if not a.latent:
        raise SystemExit("clustering: provide --latent or --from <run prefix>")
    fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device", "from_run",
                                                            "no_degree_corrected")}
    labels = run_clustering(
        ClusteringArgs(**fields, degree_corrected=not a.no_degree_corrected), device=a.device
    )
    if a.from_run:  # record the clusters back into the source manifest
        src = _manifest_path(a.from_run)
        suffix = "senna.json" if src.endswith(".senna.json") else "json"
        prev = RunManifest.load(src)
        prev.outputs["clusters"] = table_path(f"{a.out}.clusters")
        prev.save(src[: -len(suffix) - 1], suffix)
    return labels


def run_senna(argv):
    from ..senna.topic import TopicArgs, fit_topic_model
    from ..utils.prng import DEFAULT_PROJECTION_SEED

    ap = argparse.ArgumentParser(prog="senna")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _topic_parser(sub)
    _bge_parser(sub)
    _predict_parser(sub)
    _clustering_parser(sub)
    a = ap.parse_args(argv)
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
    if not a.data_files and not a.from_run:
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
    return fit_topic_model(args, device=a.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s %(name)s] %(message)s")
    if not argv or argv[0] != "senna":
        print("usage: python -m legume_tpu_torch.cli.main senna "
              "{topic,bge,predict,eval-topic,clustering} ...")
        return 1
    run_senna(argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
