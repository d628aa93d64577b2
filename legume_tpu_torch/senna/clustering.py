"""`senna clustering`: kmeans / leiden / hsblock on a latent table, with
an optional BHC merge tree over per-cluster count sums (the port of the
JAX package's `senna/clustering.py`).

kmeans and the hsblock sweeps run on the device, Leiden and the BHC
merge tree on the host. The per-cluster sums of the BHC step go through
the collapse kernel (K3, `ops/kernels.py::collapse`) on a CUDA tensor
and its plain version on a CPU tensor.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..ops.kmeans import kmeans
from ..ops.leiden import knn_adjacency, leiden_clustering
from ..utils.manifest import RunManifest
from ..utils.output import read_table, write_table

log = logging.getLogger(__name__)


@dataclass
class ClusteringArgs:
    latent: str = ""  # {prefix}.latent table (.parquet or .npz)
    out: str = "clusters"
    method: str = "leiden"  # kmeans | leiden | hsblock
    hsblock_depth: int = 4  # hsblock: K = 2^(depth-1) tree leaves
    n_clusters: int = 10  # kmeans K
    knn: int = 15
    resolution: float = 1.0
    max_iter: int = 10  # leiden hierarchy sweeps
    degree_corrected: bool = True
    edge_scale: float = 1.0
    # clusters smaller than this unassign to -1
    min_cluster_size: int = 1
    # BHC over the hard labels: per-cluster count sums of these files,
    # then the Dirichlet-multinomial merge tree and its cut
    data_files: "list[str] | None" = None
    bhc_gamma_per_gene: float = 1.0
    bhc_cut: float = 0.0
    bhc_block_size: int = 4096
    seed: int = 0
    exp_latent: bool = True  # a latent of log-proportions is exponentiated first


def read_latent(path: str) -> tuple[np.ndarray, np.ndarray]:
    """(cell names, [N, K] float32 latent) of a latent table."""
    cols = read_table(path)
    names = list(cols)
    return cols[names[0]], np.stack([cols[c] for c in names[1:]], 1).astype(np.float32)


def cluster_latent(z: np.ndarray, args: ClusteringArgs, *, device="cuda") -> np.ndarray:
    """[N] labels of the latent rows by `args.method`, small clusters
    unassigned (-1) and the rest renumbered."""
    if args.exp_latent and np.all(z <= 0):
        z = np.exp(z)  # log-softmax latent -> proportions

    if args.method == "kmeans":
        _, labels = kmeans(z, args.n_clusters, seed=args.seed, device=device)
    elif args.method == "leiden":
        adj = knn_adjacency(z, k=args.knn, device=device)
        res = leiden_clustering(adj, resolution=args.resolution, max_iter=args.max_iter,
                                seed=args.seed)
        labels = res.membership
        log.info("leiden: %d communities, quality %.4f", res.n_communities, res.quality)
    elif args.method == "hsblock":
        from ..ops.hsblock import hsblock_clustering

        adj = knn_adjacency(z, k=args.knn, device=device)
        res = hsblock_clustering(
            adj, max_depth=args.hsblock_depth, degree_corrected=args.degree_corrected,
            edge_scale=args.edge_scale, seed=args.seed, device=device,
        )
        labels = res.membership
        log.info("hsblock: %d leaves occupied (tree K=%d)",
                 len(np.unique(labels)), 1 << (args.hsblock_depth - 1))
    else:
        raise ValueError(f"unknown clustering method {args.method}")

    labels = np.asarray(labels, np.int64)
    if args.min_cluster_size > 1:
        sizes = np.bincount(labels[labels >= 0], minlength=int(labels.max()) + 1)
        small = sizes < args.min_cluster_size
        keepers = np.nonzero(~small)[0]
        remap = np.full(len(sizes), -1, np.int64)
        remap[keepers] = np.arange(len(keepers))
        labels = np.where(labels >= 0, remap[np.maximum(labels, 0)], -1)
        log.info("min-cluster-size %d: %d cells unassigned, %d clusters kept",
                 args.min_cluster_size, int((labels < 0).sum()), len(keepers))
    return labels


def run_clustering(args: ClusteringArgs, *, vec=None, device="cuda") -> np.ndarray:
    """End-to-end `senna clustering`: `{out}.clusters` (and with
    `data_files`, or a `vec` of counts in their place, `{out}.bhc.merges`
    / `{out}.bhc.cut`) and a manifest."""
    names, z = read_latent(args.latent)
    labels = cluster_latent(z, args, device=device)
    path = write_table(f"{args.out}.clusters", {"cell": names, "cluster": labels})
    if args.data_files or vec is not None:
        _run_cluster_bhc(args, labels, vec=vec, device=device)
    RunManifest(
        command="clustering", inputs={"latent": args.latent}, outputs={"clusters": path},
        params={"method": args.method}, engine="legume-tpu-torch",
    ).save(args.out)
    return labels


@torch.no_grad()
def cluster_sums(vec, labels: np.ndarray, k: int, *, block_size: int = 4096,
                 device="cuda") -> np.ndarray:
    """[D, k] float64 count sums of each cluster's cells; cells labelled -1
    map to group k, which the collapse drops."""
    from ..data.visitors import visit_columns_by_block
    from ..ops import kernels
    from ..ops.random_projection import block_to_device

    seg = torch.from_numpy(np.where(labels >= 0, labels, k).astype(np.int32)).to(device)
    sums = torch.zeros(vec.num_rows, k, dtype=torch.float64, device=device)
    for blk in visit_columns_by_block(vec, block_size=block_size):
        r, p, v = block_to_device(blk, device)
        plane = kernels.collapse(r, p, v, seg[blk.lb : blk.lb + blk.ncols],
                                 num_genes=vec.num_rows, num_groups=k)
        sums += plane.double()
    return sums.cpu().numpy()


def _run_cluster_bhc(args: ClusteringArgs, labels: np.ndarray, *, vec=None,
                     device="cuda") -> None:
    """BHC over hard labels: per-cluster gene sums, then the
    Dirichlet-multinomial Bayes-factor merge tree and its cut."""
    from ..ops.bhc import bhc_cluster
    from .topic import load_data_vec

    if vec is None:
        vec = load_data_vec(list(args.data_files))
    if vec.num_columns != len(labels):
        raise ValueError(f"BHC: data has {vec.num_columns} cells but latent has {len(labels)}")
    k = int(labels.max()) + 1
    if k < 2:
        log.info("BHC: only %d cluster(s); skipping", k)
        return
    sums = cluster_sums(vec, labels, k, block_size=args.bhc_block_size, device=device)
    res = bhc_cluster(sums.T, alpha=args.bhc_gamma_per_gene, cutoff=args.bhc_cut)
    m = np.asarray(res.merges, dtype=np.float64).reshape(-1, 3)
    write_table(f"{args.out}.bhc.merges", {
        "merge_id": np.arange(len(m), dtype=np.int64), "left": m[:, 0].astype(np.int64),
        "right": m[:, 1].astype(np.int64), "log_bf": m[:, 2],
    })
    write_table(f"{args.out}.bhc.cut", {"cluster": np.arange(k), "consensus": res.labels})
    log.info("BHC cut (log_bf >= %.3f): %d -> %d consensus clusters",
             args.bhc_cut, k, res.n_clusters)
