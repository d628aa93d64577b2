"""`pinto lc`: spatial link-community segmentation (the port of the JAX
package's `pinto/lc.py`).

1. a spatial kNN graph over the coordinates (`ops/knn.py`, exact, ties
   to the lower index);
2. edge profiles x_e = y_src + y_dst, the sparse gene sums of the two
   endpoints, optionally NB-Fisher weighted and batch-scaled;
3. blocked sweeps over the edge labels: each sweep sums the [D, E]
   profile plane by edge label into [D, K] (K3), scores every edge
   against every community with one sparse [E, D] x [D, K] product (K2),
   and draws the labels by a Gumbel argmax whose noise is JAX's threefry
   stream, drawn on the device bit for bit (`prng.gumbel_keys`);
4. a component-EM stage with the incidence frozen, then per-cell
   propensity and entropy;
5. parquet outputs and the manifest.

On the card every sum of a sweep goes through K3 and K2, which add in
a fixed order, so a chain is bit-equal from run to run.

`--data-parallel` (`mesh`) shards the edges over the ranks, one rank a
GPU, as the JAX package's placements do: the edges pad to a multiple of
the world (empty profiles, kept out of the community sizes and the
trace), each rank sweeps its own edges (its K3 partials summed across
the ranks in rank order, K2 against the replicated rates), every draw
over edges is made for the whole padded axis and sliced, and the greedy
stage stops when the gathered labels stop moving. Every rank repeats the
kNN and the edge profiles; rank 0 writes. A world of one is the plain
run.
"""

from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field
from typing import Optional, Sequence

import numpy as np
import scipy.sparse as sp
import torch

from ..ops import kernels
from ..ops.gamma import digamma
from ..parallel.mesh import live, padded_share
from ..parallel.multihost import gather_padded, sum_across_ranks
from ..utils import prng
from ..utils.manifest import RunManifest
from ..utils.prng import DEFAULT_PROJECTION_SEED

log = logging.getLogger(__name__)


def spatial_knn_edges(
    coords: np.ndarray, k: int = 10, *, reciprocal: bool = False, chunk: int = 4096,
    device="cuda",
) -> np.ndarray:
    """Undirected edge list [E, 2] (lower id first, sorted, unique) of the
    spatial kNN graph; `reciprocal` keeps only mutual neighbour pairs."""
    from ..ops.knn import knn_within

    _, idx = knn_within(np.asarray(coords).astype(np.float32), k, chunk=chunk, device=device)
    n = coords.shape[0]
    src = np.repeat(np.arange(n), idx.shape[1])
    dst = idx.ravel()
    if reciprocal:
        keep = np.isin(dst * n + src, src * n + dst)
        src, dst = src[keep], dst[keep]
    a, b = np.minimum(src, dst), np.maximum(src, dst)
    edges = np.unique(np.stack([a, b], 1), axis=0)
    return edges[edges[:, 0] != edges[:, 1]]


def cell_rows(
    data, *, gene_weights: np.ndarray | None = None,
    batch_scale: "tuple[np.ndarray, np.ndarray] | None" = None, block: int = 50_000,
) -> sp.csr_matrix:
    """[N, D] CSR of every cell's counts, each divided by its batch's gene
    flavour (`batch_scale = (delta_gb [D, B], membership [N])`) and then
    weighted by `gene_weights`, with the JAX package's operations."""
    n = data.num_columns
    parts = []
    for lb in range(0, n, block):
        ub = min(lb + block, n)
        csc = data.read_columns_csc(np.arange(lb, ub)).tocsc()
        if batch_scale is not None:
            delta_gb, memb = batch_scale
            csc = csc.tocsc(copy=True)
            inv = 1.0 / np.maximum(delta_gb, 1e-6)
            per_nz = np.repeat(memb[lb:ub], np.diff(csc.indptr))
            csc.data *= inv[csc.indices, per_nz]
        if gene_weights is not None:
            csc = sp.diags(gene_weights) @ csc
        parts.append(csc.T.tocsr())
    if not parts:
        return sp.csr_matrix((0, data.num_rows), dtype=np.float32)
    return sp.vstack(parts, format="csr")


EDGE_CHUNK = 200_000  # edges whose profiles are formed at once


def edge_profiles(
    data, edges: np.ndarray, *, gene_weights: np.ndarray | None = None,
    batch_scale: "tuple[np.ndarray, np.ndarray] | None" = None,
    block: int = 50_000,
) -> sp.csr_matrix:
    """Sparse [E, D] edge profiles x_e = y_src + y_dst (canonical CSR:
    sorted gene ids, duplicates summed), EDGE_CHUNK edges at a time."""
    d = data.num_rows
    y = cell_rows(data, gene_weights=gene_weights, batch_scale=batch_scale, block=block)
    if len(edges) == 0:
        return sp.csr_matrix((0, d), dtype=np.float32)
    pieces = []
    for lb in range(0, len(edges), EDGE_CHUNK):
        e = edges[lb : lb + EDGE_CHUNK]
        pieces.append(y[e[:, 0]] + y[e[:, 1]])
    out = sp.vstack(pieces, format="csr") if len(pieces) > 1 else pieces[0].tocsr()
    out.sort_indices()
    return out.astype(np.float32, copy=False)


@dataclass
class SweepPlane:
    """An [E, D] profile plane on the device, edges as the columns of K2
    and K3, and the one-row plane of the edge totals that K3 sums into
    the community sizes."""

    rows: torch.Tensor  # [nnz] int32 gene ids
    ptr: torch.Tensor  # [E + 1] int32
    vals: torch.Tensor  # [nnz] f32
    edge_tot: torch.Tensor  # [E] f32
    tot_rows: torch.Tensor  # [E] int32 zeros
    tot_ptr: torch.Tensor  # [E + 1] int32 0..E
    n_genes: int

    @classmethod
    def from_csr(cls, profiles: sp.csr_matrix, device) -> "SweepPlane":
        e, d = profiles.shape
        if profiles.nnz >= 1 << 31:
            raise ValueError(f"{profiles.nnz} profile nonzeros do not fit int32 offsets")
        tot = np.asarray(profiles.sum(1)).ravel().astype(np.float32)

        def put(a, dtype):
            return torch.from_numpy(np.ascontiguousarray(a, dtype)).to(device)

        return cls(
            rows=put(profiles.indices, np.int32), ptr=put(profiles.indptr, np.int32),
            vals=put(profiles.data, np.float32), edge_tot=put(tot, np.float32),
            tot_rows=torch.zeros(e, dtype=torch.int32, device=device),
            tot_ptr=torch.arange(e + 1, dtype=torch.int32, device=device), n_genes=d,
        )

    @property
    def n_edges(self) -> int:
        return self.ptr.shape[0] - 1

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.rows, self.ptr, self.vals, self.edge_tot, self.tot_rows, self.tot_ptr))


def sweep(
    plane: SweepPlane,
    labels: torch.Tensor,  # [E] int32
    noise: torch.Tensor | None,  # [E, K] Gumbel noise, or None for the argmax
    inc_scores: torch.Tensor | None,  # [E, K] frozen-incidence term, or None
    *,
    k: int,
    alpha: float,
    a0: float = 1.0,
    b0: float = 1.0,
    mesh=None,
    mask_e: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One blocked sweep (JAX's `_sweep`): refresh the Gamma rates from
    the labels, score every edge against every community, and take the
    (noisy) argmax. Returns (labels [E] int32, scores [E, K]). Under
    `mesh` the plane holds this rank's edges (`mask_e` 0 on pad edges):
    the count, size and membership sums add across the ranks."""
    cnt_dk = kernels.collapse(plane.rows, plane.ptr, plane.vals, labels,
                              num_genes=plane.n_genes, num_groups=k)
    size_k = kernels.collapse(plane.tot_rows, plane.tot_ptr, plane.edge_tot, labels,
                              num_genes=1, num_groups=k)[0]
    if mask_e is None:
        n_k = torch.bincount(labels.long(), minlength=k).float()
    else:
        n_k = torch.bincount(labels.long(), weights=mask_e, minlength=k).float()
    if live(mesh) is not None:
        d = plane.n_genes
        tot = sum_across_ranks(mesh, torch.cat([cnt_dk.reshape(-1), size_k, n_k]))
        cnt_dk, size_k, n_k = tot[: d * k].view(d, k), tot[d * k : d * k + k], tot[d * k + k :]
    log_rate = digamma(a0 + cnt_dk) - torch.log(b0 + size_k)[None, :]  # [D, K]
    log_pi = torch.log(alpha + n_k) - torch.log(alpha * k + n_k.sum())
    scores = kernels.project(log_rate.contiguous(), plane.rows, plane.ptr, plane.vals,
                             normed=False)
    logz = torch.logsumexp(log_rate, dim=0)
    scores = scores - plane.edge_tot[:, None] * logz[None, :] + log_pi[None, :]
    if inc_scores is not None:
        scores = scores + inc_scores
    pick = scores if noise is None else scores + noise
    return torch.argmax(pick, dim=1).to(torch.int32), scores


def compute_node_membership(
    edges: np.ndarray, labels: np.ndarray, n_cells: int, k: int
) -> np.ndarray:
    """[N, K] soft propensity: the fraction of each cell's edges in each
    community."""
    ends = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    lab = np.concatenate([labels, labels]).astype(np.int64)
    prop = np.bincount(ends * k + lab, minlength=n_cells * k).reshape(n_cells, k)
    prop = prop.astype(np.float64)
    return prop / np.maximum(prop.sum(1, keepdims=True), 1.0)


def fit_log_incidence(
    edges: np.ndarray, labels: np.ndarray, propensity: np.ndarray, k: int, *,
    a: float = 1.0, b: float = 1.0,
) -> np.ndarray:
    """Frozen variational E_q[log B[k, k']] under a Gamma(a, b) prior:
    S[k, k'] = sum_{e: z_e = k} (theta_L + theta_R)[k'], W[k'] = sum_e
    (theta_L + theta_R)[k'], E_q[log B] = psi(a + S) - log(b + W), with
    the digamma in float32 as the JAX package evaluates it."""
    th = propensity[edges[:, 0]] + propensity[edges[:, 1]]  # [E, K]
    s = np.zeros((k, k))
    for c in range(k):
        s[c] = th[labels == c].sum(0)
    w = th.sum(0)
    psi = digamma(torch.from_numpy((a + s).astype(np.float32))).numpy()
    return psi - np.log(b + w)[None, :]


def _fit_edge_labels(
    profiles,
    k: int,
    *,
    n_genes: int,
    n_sweeps: int = 30,
    n_greedy: int = 10,
    alpha: float = 1.0,
    seed: int = DEFAULT_PROJECTION_SEED,
    edges: np.ndarray | None = None,
    n_cells: int | None = None,
    em_sweeps: int = 0,
    incidence_a: float = 1.0,
    incidence_b: float = 1.0,
    init_labels: np.ndarray | None = None,
    mesh=None,
    device="cuda",
) -> tuple[np.ndarray, list]:
    """Blocked Gibbs over edge labels on an [E, D] sparse profile matrix,
    with JAX's key schedule: `key(seed & 0x7FFFFFFF)`, split once for the
    `randint` init labels and once per sweep for that sweep's Gumbel
    draw. With `em_sweeps > 0` (and `edges` / `n_cells`), a component-EM
    stage follows with the incidence frozen from the post-Gibbs labels.
    `mesh` shards the edges (the module's docstring); every rank returns
    all the labels."""
    mesh = live(mesh)
    e = profiles.shape[0]
    if profiles.shape[1] != n_genes:
        raise ValueError(f"profiles have {profiles.shape[1]} features, expected {n_genes}")
    e_pad, lb, ub = padded_share(mesh, e)
    csr = sp.csr_matrix(profiles)
    mask_e = None
    if mesh is not None:  # this rank's edges, the pad edges empty
        own = csr[lb : min(ub, e)]
        csr = sp.vstack([own, sp.csr_matrix((ub - lb - own.shape[0], csr.shape[1]),
                                            dtype=np.float32)], format="csr")
        mask_e = torch.from_numpy((np.arange(lb, ub) < e).astype(np.float32)).to(device)
        log.info("lc: rank %d sweeps edges [%d, %d) of %d", mesh.rank, lb, min(ub, e), e)
    plane = SweepPlane.from_csr(csr, device)
    key = prng.key(seed & 0x7FFFFFFF)
    key, k_init = prng.split(key)
    if init_labels is not None:
        lab0 = np.zeros(e_pad, np.int32)
        lab0[:e] = np.asarray(init_labels, np.int32)
        labels = torch.from_numpy(lab0[lb:ub]).to(device)
    else:
        labels = prng.randint_rows(prng.key_rows(k_init[None], device), e_pad, 0, k)[0][lb:ub]
        labels = labels.to(torch.int32)
    trace = []

    def run(labels, n_sample, n_max, inc, phase):
        nonlocal key
        prev = None
        for s in range(n_sample + n_max):
            key, k_s = prng.split(key)
            noise = (prng.gumbel_keys(k_s[None], e_pad * k, device).view(e_pad, k)[lb:ub]
                     if s < n_sample else None)
            labels, scores = sweep(plane, labels, noise, inc, k=k, alpha=alpha, mesh=mesh,
                                   mask_e=mask_e)
            chosen = torch.gather(scores, 1, labels[:, None].long())
            if mesh is None:
                trace.append((phase, float(chosen.sum())))
            else:
                trace.append((phase, float(sum_across_ranks(mesh, (chosen[:, 0] * mask_e).sum()))))
            if s >= n_sample:
                # the gathered labels decide, so every rank stops at the same sweep
                now = labels if mesh is None else gather_padded(mesh, labels, e)
                if prev is not None and (torch.equal(prev, now) if mesh is None
                                         else np.array_equal(prev, now)):
                    break  # greedy converged
                prev = now
        return labels

    labels = run(labels, n_sweeps, n_greedy, None, "gibbs")
    if em_sweeps > 0 and edges is not None and n_cells is not None:
        lab_np = gather_padded(mesh, labels, e)
        theta = compute_node_membership(edges, lab_np, n_cells, k)
        log_b = fit_log_incidence(edges, lab_np, theta, k, a=incidence_a, b=incidence_b)
        th_e = theta[edges[:, 0]] + theta[edges[:, 1]]
        inc_np = np.zeros((e_pad, k), np.float32)
        inc_np[:e] = th_e @ log_b.T
        inc = torch.from_numpy(inc_np[lb:ub]).to(device)
        labels = run(labels, em_sweeps, n_greedy, inc, "em")
    return gather_padded(mesh, labels, e), trace


@dataclass
class LinkCommunityResult:
    edge_labels: np.ndarray  # [E]
    propensity: np.ndarray  # [N, K] per-cell soft community propensity
    entropy: np.ndarray  # [N]
    edges: np.ndarray  # [E, 2]
    scores_trace: list
    timings: dict = field(default_factory=dict)  # seconds of each stage
    profile_nnz: int = 0


def fit_link_community(
    data,
    coords: np.ndarray,
    *,
    n_communities: int = 10,
    knn: int = 10,
    n_sweeps: int = 30,
    n_greedy: int = 10,
    em_sweeps: int = 10,
    alpha: float = 1.0,
    incidence_a: float = 1.0,
    incidence_b: float = 1.0,
    gene_weights: np.ndarray | None = None,
    batch_scale: "tuple[np.ndarray, np.ndarray] | None" = None,
    gene_network: str | None = None,
    gene_network_allow_prefix: bool = False,
    gene_network_delimiter: str | None = None,
    snn_min_shared: int = 2,
    gene_trim_min_degree: int = 2,
    gene_modules_resolution: float = 1.0,
    reciprocal: bool = False,
    mesh=None,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
) -> LinkCommunityResult:
    """`pinto lc`'s fit: the kNN edges, their profiles and the sweeps
    (`mesh` shards the sweeps' edges; the rest runs on every rank)."""
    n = data.num_columns
    d = data.num_rows
    k = n_communities
    timings = {}
    t0 = time.perf_counter()
    edges = spatial_knn_edges(coords, knn, reciprocal=reciprocal, device=device)
    timings["knn_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    if gene_network:
        from .gene_network import (
            GenePairGraph,
            ModulePairBasis,
            build_module_expression,
            kcore_trim,
            leiden_gene_modules,
            module_pair_edge_profiles,
        )

        graph = GenePairGraph.from_edge_list(
            gene_network, data.row_names(),
            allow_prefix=gene_network_allow_prefix, delimiter=gene_network_delimiter,
        )
        if graph.num_edges == 0:
            raise ValueError("gene network matched 0 gene pairs (check name conventions)")
        graph.augment_with_snn(snn_min_shared)
        keep = kcore_trim(graph, gene_trim_min_degree)
        mog = leiden_gene_modules(
            graph, keep, resolution=gene_modules_resolution, seed=seed & 0x7FFFFFFF)
        basis = ModulePairBasis.build(graph, mog)
        if basis.n_pairs == 0:
            raise ValueError("module-pair basis is empty; lower trim/resolution")
        module_expr, cell_totals = build_module_expression(
            data, mog, basis.n_modules, gene_weights=gene_weights, device=device)
        profiles = module_pair_edge_profiles(module_expr, cell_totals, edges, basis)
        n_feat = basis.n_pairs
    else:
        profiles = edge_profiles(data, edges, gene_weights=gene_weights, batch_scale=batch_scale)
        n_feat = d
    timings["profiles_s"] = time.perf_counter() - t0
    e = profiles.shape[0]
    log.info("link community: %d cells, %d edges, K=%d, %d features%s",
             n, e, k, n_feat, " (module pairs)" if gene_network else "")

    t0 = time.perf_counter()
    labels_np, trace = _fit_edge_labels(
        profiles, k, n_genes=n_feat, n_sweeps=n_sweeps, n_greedy=n_greedy,
        alpha=alpha, incidence_a=incidence_a, incidence_b=incidence_b, seed=seed,
        edges=edges, n_cells=n, em_sweeps=em_sweeps, mesh=mesh, device=device,
    )
    timings["sweeps_s"] = time.perf_counter() - t0
    timings["sweeps"] = len(trace)
    prop = compute_node_membership(edges, labels_np, n, k)
    p_safe = np.maximum(prop, 1e-30)
    entropy = -(prop * np.log(p_safe)).sum(1)
    return LinkCommunityResult(
        edge_labels=labels_np, propensity=prop.astype(np.float32),
        entropy=entropy.astype(np.float32), edges=edges, scores_trace=trace,
        timings=timings, profile_nnz=int(profiles.nnz),
    )


def gene_community_rates(
    data, propensity: np.ndarray, *, a0: float = 1.0, b0: float = 1.0, block_size: int = 8192,
) -> np.ndarray:
    """[D, K] Poisson-Gamma gene rates per community, each cell weighted
    by its soft propensity (one sparse product a block on the host, in
    float64, of the float32 products the JAX package forms)."""
    from ..data.visitors import visit_columns_by_block

    d = data.num_rows
    k = propensity.shape[1]
    num = np.zeros((d, k))
    for blk in visit_columns_by_block(data, block_size=block_size):
        x = sp.csr_matrix((blk.vals.astype(np.float64), (blk.row_ids, blk.col_ids)),
                          shape=(d, blk.ncols))
        num += x @ propensity[blk.lb : blk.lb + blk.ncols].astype(np.float64)
    den = propensity.sum(0)
    return ((a0 + num) / (b0 + den)[None, :]).astype(np.float32)


def bhc_consensus(gene_rates_dk: np.ndarray, *, cutoff: float = 0.0) -> tuple[np.ndarray, list]:
    """BHC merge of the community gene profiles: a consensus label per
    community and the merge trace."""
    from ..ops.bhc import bhc_cluster

    res = bhc_cluster(gene_rates_dk.T, cutoff=cutoff)
    return np.asarray(res.labels), list(getattr(res, "merges", []))


@dataclass
class PintoLcArgs:
    data_files: Sequence[str] = ()
    coord_file: str = ""  # TSV: cell x y
    out: str = "pinto"
    n_communities: int = 10
    knn: int = 10
    n_sweeps: int = 30
    n_greedy: int = 10
    em_sweeps: int = 10
    alpha: float = 1.0
    incidence_a: float = 1.0
    incidence_b: float = 1.0
    min_gene_count: float = 0.0
    fisher_weights: bool = True
    batch_files: "Optional[Sequence[str]]" = None
    qc: bool = False
    qc_min_total: float = 0.0
    merge_cut: float = 0.0
    gene_network: Optional[str] = None
    gene_network_allow_prefix: bool = False
    gene_network_delimiter: Optional[str] = None
    snn_min_shared: int = 2
    gene_trim_min_degree: int = 2
    gene_modules_resolution: float = 1.0
    reciprocal: bool = False
    seed: int = DEFAULT_PROJECTION_SEED
    data_parallel: bool = False
    device: str = "cuda"


def run_lc(args: PintoLcArgs, *, vec=None) -> LinkCommunityResult:
    """`pinto lc`; `vec` holds the cells in memory instead of
    `data_files` (with their batches registered)."""
    import pandas as pd

    from ..ops.gene_stats import nb_fisher_weights

    from ..parallel.mesh import make_mesh
    from ..parallel.multihost import barrier

    t_run = time.perf_counter()
    dev = args.device
    mesh = make_mesh(dev) if args.data_parallel else None
    shared = live(mesh)
    if vec is None:
        from ..senna.topic import load_data_vec

        vec = load_data_vec(args.data_files, args.batch_files)
    coords = np.loadtxt(args.coord_file, usecols=(1, 2), skiprows=0)
    if args.qc:
        from ..data.qc import compute_cell_qc

        qs = compute_cell_qc(vec, device=dev)
        keep = qs.keep_mask(min_total=args.qc_min_total)
        vec = vec.subset_columns(keep)
        coords = coords[keep]
        log.info("pinto qc: keeping %d cells", int(keep.sum()))
    batch_scale = None
    if args.batch_files and vec.num_batches > 1:
        from ..ops import collapse as _clp

        memb = vec.batch_membership()
        stat = _clp.collect_basic_stats(vec, memb.astype(np.int32), vec.num_batches, device=dev)
        pb = np.asarray(stat.observed_sum_ds, np.float64)  # [D, B]
        prop = pb / np.maximum(pb.sum(0, keepdims=True), 1e-12)
        global_prop = pb.sum(1) / max(pb.sum(), 1e-12)
        delta_gb = np.clip(
            prop / np.maximum(global_prop[:, None], 1e-12), 0.1, 10.0).astype(np.float32)
        batch_scale = (delta_gb, memb)
        log.info("pinto batch correction over %d sections", vec.num_batches)
    t0 = time.perf_counter()
    w = (nb_fisher_weights(vec, device=dev) if args.fisher_weights
         else np.ones(vec.num_rows, np.float32))
    if args.min_gene_count > 0:
        from ..ops.gene_stats import streaming_gene_stats

        st = streaming_gene_stats(vec, device=dev)
        low = (st.mean * st.n_cells) < args.min_gene_count
        w = np.where(low, 0.0, w).astype(np.float32)
        log.info("min-gene-count %g: %d/%d genes dropped",
                 args.min_gene_count, int(low.sum()), vec.num_rows)
    gene_weights_s = time.perf_counter() - t0
    res = fit_link_community(
        vec, coords,
        n_communities=args.n_communities, knn=args.knn,
        n_sweeps=args.n_sweeps, n_greedy=args.n_greedy,
        em_sweeps=args.em_sweeps, alpha=args.alpha,
        incidence_a=args.incidence_a, incidence_b=args.incidence_b,
        gene_weights=w, batch_scale=batch_scale,
        gene_network=args.gene_network,
        gene_network_allow_prefix=args.gene_network_allow_prefix,
        gene_network_delimiter=args.gene_network_delimiter,
        snn_min_shared=args.snn_min_shared,
        gene_trim_min_degree=args.gene_trim_min_degree,
        gene_modules_resolution=args.gene_modules_resolution,
        reciprocal=args.reciprocal, mesh=mesh, seed=args.seed, device=dev,
    )
    res.timings["gene_weights_s"] = gene_weights_s
    if shared is not None and not shared.primary:  # rank 0 writes
        barrier(shared)
        return res
    t0 = time.perf_counter()
    cells = vec.column_names()
    pd.DataFrame(
        res.propensity, index=cells, columns=[f"c{i}" for i in range(args.n_communities)],
    ).assign(entropy=res.entropy).reset_index(names="cell").to_parquet(
        f"{args.out}.propensity.parquet")
    pd.DataFrame(
        {"src": res.edges[:, 0], "dst": res.edges[:, 1], "community": res.edge_labels}
    ).to_parquet(f"{args.out}.edges.parquet")
    pd.DataFrame({
        "sweep": np.arange(len(res.scores_trace)),
        "phase": [p for p, _ in res.scores_trace],
        "score": [s for _, s in res.scores_trace],
    }).to_parquet(f"{args.out}.score_trace.parquet")
    rates = gene_community_rates(vec, res.propensity)
    pd.DataFrame(
        rates, index=vec.row_names(), columns=[f"c{i}" for i in range(rates.shape[1])],
    ).reset_index(names="gene").to_parquet(f"{args.out}.gene_community.parquet")
    consensus, _merges = bhc_consensus(rates, cutoff=args.merge_cut)
    pd.DataFrame(
        {"community": np.arange(len(consensus)), "consensus": consensus}
    ).to_parquet(f"{args.out}.consensus.parquet")
    res.timings["outputs_s"] = time.perf_counter() - t0
    res.timings["total_s"] = time.perf_counter() - t_run
    RunManifest(
        command="lc",
        inputs={"data_files": list(args.data_files), "coords": args.coord_file},
        outputs={
            "propensity": f"{args.out}.propensity.parquet",
            "edges": f"{args.out}.edges.parquet",
            "score_trace": f"{args.out}.score_trace.parquet",
            "gene_community": f"{args.out}.gene_community.parquet",
            "consensus": f"{args.out}.consensus.parquet",
        },
        params={"edges": int(len(res.edges)), "profile_nnz": res.profile_nnz},
        timings=res.timings,
    ).save(args.out, "metadata.json")
    barrier(shared)
    return res
