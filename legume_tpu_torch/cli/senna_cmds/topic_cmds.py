"""`senna vae` and `senna joint-topic` from the command line (the port of
the vae and joint-topic parts of the JAX package's
`cli/senna_cmds/topic_cmds.py`), with the JAX flags and defaults plus
`--device`."""

from __future__ import annotations

import numpy as np

from ...senna.joint import JointTopicArgs, fit_joint_topic
from ...senna.topic import load_data_vec
from ...senna.vae import VaeArgs, fit_vae
from ...utils.manifest import RunManifest
from ...utils.output import matrix_columns, write_table
from ...utils.prng import DEFAULT_PROJECTION_SEED


def add_topic_parsers(sub) -> None:
    p = sub.add_parser("vae", help="scVI-style Gaussian-latent VAE")
    p.add_argument("--data-files", nargs="*", default=[])
    p.add_argument("--out", required=True)
    p.add_argument("--from", dest="from_run", default=None)
    p.add_argument("--init-from", dest="init_from", default=None)
    p.add_argument("--batch-files", nargs="+", default=None)
    p.add_argument("-k", "--n-latent", type=int, default=16)
    p.add_argument("--encoder-layers", type=int, nargs="+", default=[128, 64])
    p.add_argument("--epochs", type=int, default=500)
    p.add_argument("--minibatch-size", type=int, default=100)
    p.add_argument("--learning-rate", "--lr", type=float, default=0.01)
    p.add_argument("--grad-clip", type=float, default=1.0)
    p.add_argument("--adj-method", choices=["batch", "residual"], default="residual")
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--sort-dim", type=int, default=10)
    p.add_argument("--num-levels", type=int, default=2)
    p.add_argument("--iter-opt", type=int, default=30)
    p.add_argument("--block-size", type=int, default=8192)
    p.add_argument("--qc", action="store_true")
    p.add_argument("--qc-min-total", type=float, default=0.0)
    p.add_argument("--qc-min-genes", type=int, default=0)
    p.add_argument("--qc-max-mito-frac", type=float, default=1.0)
    p.add_argument("--hvg-genes", type=int, default=5000)
    p.add_argument("--data-parallel", action="store_true")
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")

    p = sub.add_parser("joint-topic", help="multi-modality topic model (shared cells)")
    p.add_argument("--data-files", nargs="+", required=True, action="append",
                   help="repeat once per modality")
    p.add_argument("--out", required=True)
    p.add_argument("-k", "--n-latent-topics", type=int, default=10)
    p.add_argument("--encoder-layers", type=int, nargs="+", default=[128, 128])
    p.add_argument("--epochs", type=int, default=300)
    p.add_argument("--minibatch-size", type=int, default=100)
    p.add_argument("--decoder", choices=["multinomial", "nb", "poisson", "delta"], default="nb")
    p.add_argument("--decoder-weights", type=float, nargs="+", default=None)
    p.add_argument("--proj-dim", type=int, default=50)
    p.add_argument("--sort-dim", type=int, default=8)
    p.add_argument("--iter-opt", type=int, default=30)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--device", default="cuda", help="torch device (default: cuda)")


def _seed(a) -> int:
    return a.seed if a.seed is not None else DEFAULT_PROJECTION_SEED


def run_vae(a, *, vec=None) -> dict:
    if not a.data_files and not a.from_run and vec is None:
        raise SystemExit("vae: provide --data-files or --from <run prefix>")
    fields = {k: v for k, v in vars(a).items() if k not in ("cmd", "device", "seed")}
    fields["encoder_layers"] = tuple(fields["encoder_layers"])
    return fit_vae(VaeArgs(**fields, seed=_seed(a)), vec=vec, device=a.device)


def run_joint_topic(a, *, vecs=None) -> dict:
    """`vecs` (one per modality) override the `--data-files` groups."""
    mods = vecs if vecs is not None else [load_data_vec(files) for files in a.data_files]
    res = fit_joint_topic(mods, JointTopicArgs(
        n_topics=a.n_latent_topics, encoder_layers=tuple(a.encoder_layers), epochs=a.epochs,
        minibatch_size=a.minibatch_size, decoder=a.decoder, decoder_weights=a.decoder_weights,
        proj_dim=a.proj_dim, sort_dim=a.sort_dim, iter_opt=a.iter_opt, seed=_seed(a),
    ), device=a.device)
    pb = res["pb_latent"]
    outputs = {
        "latent": write_table(f"{a.out}.latent", matrix_columns(
            pb[res["groups"]], "topic", "cell", mods[0].column_names())),
        "pb_latent": write_table(f"{a.out}.pb_latent", matrix_columns(
            pb, "topic", "pseudobulk", np.arange(pb.shape[0]))),
    }
    RunManifest(command="joint-topic", inputs={"modalities": [list(f) for f in a.data_files]},
                outputs=outputs, timings=res["timings"], engine="legume-tpu-torch").save(a.out)
    return res
