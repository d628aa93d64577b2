"""Command line of the port: `python -m legume_tpu_torch.cli.main senna
{topic,bge} ...`.

The flags are those of the JAX package's `senna topic` and `senna bge`;
the ones the port does not carry yet are accepted and raise
`NotImplementedError` when set. `--device` picks the torch device
(default `cuda`).
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
    p.add_argument("--amort-refine-steps", type=int, default=0)
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


def run_senna(argv) -> dict:
    from ..senna.topic import TopicArgs, fit_topic_model
    from ..utils.prng import DEFAULT_PROJECTION_SEED

    ap = argparse.ArgumentParser(prog="senna")
    sub = ap.add_subparsers(dest="cmd", required=True)
    _topic_parser(sub)
    _bge_parser(sub)
    a = ap.parse_args(argv)
    if a.cmd == "bge":
        from .senna_cmds.embed_cmds import BgeArgs, run_bge

        fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device")}
        return run_bge(BgeArgs(**fields), device=a.device)
    if not a.data_files and not a.from_run:
        raise SystemExit("topic: provide --data-files or --from <run prefix>")
    args = TopicArgs(
        data_files=a.data_files, out=a.out, from_run=a.from_run, init_from=a.init_from,
        batch_files=a.batch_files, n_latent_topics=a.n_latent_topics,
        encoder_layers=tuple(a.encoder_layers), epochs=a.epochs,
        minibatch_size=a.minibatch_size, learning_rate=a.learning_rate,
        grad_clip=a.grad_clip, decoder=a.decoder, decoder_weights=a.decoder_weights,
        adj_method=a.adj_method, amort_refine_steps=a.amort_refine_steps,
        preload_data=a.preload_data, topic_smoothing=a.topic_smoothing,
        proj_dim=a.proj_dim, sort_dim=a.sort_dim, knn_cells=a.knn_cells,
        num_levels=a.num_levels, iter_opt=a.iter_opt, ignore_batch=a.ignore_batch,
        block_size=a.block_size, max_coarse_features=a.max_coarse_features, cnv=a.cnv,
        qc=a.qc, hvg_genes=a.hvg_genes, refine=not a.no_refine,
        gene_weighting=a.gene_weighting, anchor_penalty=a.anchor_penalty,
        data_parallel=a.data_parallel,
        seed=a.seed if a.seed is not None else DEFAULT_PROJECTION_SEED,
    )
    return fit_topic_model(args, device=a.device)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    logging.basicConfig(level=logging.INFO, format="[%(levelname)s %(name)s] %(message)s")
    if not argv or argv[0] != "senna":
        print("usage: python -m legume_tpu_torch.cli.main senna {topic,bge} ...")
        return 1
    run_senna(argv[1:])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
