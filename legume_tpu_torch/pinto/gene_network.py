"""Gene-network module-pair edge basis for pinto link communities (the
port of the JAX package's `pinto/gene_network.py`).

Pipeline (fit.rs:80-137): external gene-gene edge list -> SNN
augmentation -> k-core trim -> Leiden gene modules -> canonical
module-pair basis with modularity null factors -> per-cell module
expression (one streaming pass) -> per-cell-edge pair features

    y_e[(a,b)] = max(x_i[a] x_j[b] + x_i[b] x_j[a]
                     - mass_e * deg(a) deg(b) / (2W)^2, 0)

The pair features replace the raw-gene edge profiles when a gene
network is supplied, giving the link-community Gibbs a biology-aware,
low-dimensional basis.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

log = logging.getLogger(__name__)


@dataclass
class GenePairGraph:
    n_genes: int
    edges: np.ndarray  # [E, 2] gene index pairs (undirected, deduped)

    @classmethod
    def from_edge_list(
        cls,
        path: str,
        gene_names: list[str],
        *,
        allow_prefix: bool = False,
        delimiter: str | None = None,
    ) -> "GenePairGraph":
        """TSV edge list of gene-name pairs, matched (case-insensitively,
        optionally by prefix before `delimiter`) onto the data's gene
        names (gene_network/graph.rs)."""
        def norm(s: str) -> str:
            s = str(s).strip().lower()
            if delimiter and delimiter in s:
                s = s.split(delimiter)[0]
            return s

        pos: dict[str, int] = {}
        for i, nm in enumerate(gene_names):
            pos.setdefault(norm(nm), i)
            if allow_prefix:
                base = norm(nm).split(".")[0]
                pos.setdefault(base, i)
        pairs = set()
        import gzip

        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            for line in f:
                p = line.split()
                if len(p) < 2:
                    continue
                a, b = pos.get(norm(p[0])), pos.get(norm(p[1]))
                if a is None or b is None or a == b:
                    continue
                pairs.add((min(a, b), max(a, b)))
        edges = (
            np.asarray(sorted(pairs), np.int64)
            if pairs
            else np.zeros((0, 2), np.int64)
        )
        return cls(n_genes=len(gene_names), edges=edges)

    @property
    def num_edges(self) -> int:
        return len(self.edges)

    def adjacency(self) -> sp.csr_matrix:
        e = self.edges
        a = sp.coo_matrix(
            (np.ones(len(e)), (e[:, 0], e[:, 1])),
            shape=(self.n_genes, self.n_genes),
        )
        return (a + a.T).tocsr()

    def augment_with_snn(self, min_shared: int = 2):
        """Add edges between genes sharing >= min_shared neighbors
        (shared-nearest-neighbor augmentation, fit.rs:104)."""
        if min_shared <= 0 or self.num_edges == 0:
            return
        adj = self.adjacency()
        adj.data[:] = 1.0
        shared = (adj @ adj).tocoo()  # counts of shared neighbors
        keep = (shared.data >= min_shared) & (shared.row < shared.col)
        new = set(map(tuple, self.edges.tolist()))
        before = len(new)
        new.update(zip(shared.row[keep].tolist(), shared.col[keep].tolist()))
        self.edges = np.asarray(sorted(new), np.int64)
        log.info("snn augment: %d -> %d gene edges", before, len(new))


def kcore_trim(graph: GenePairGraph, min_degree: int = 2) -> np.ndarray:
    """Boolean keep mask after iterative k-core trimming (fit.rs:106)."""
    keep = np.ones(graph.n_genes, bool)
    if graph.num_edges == 0:
        return keep
    while True:
        e = graph.edges
        live = keep[e[:, 0]] & keep[e[:, 1]]
        deg = np.zeros(graph.n_genes, np.int64)
        np.add.at(deg, e[live].ravel(), 1)
        drop = keep & (deg < min_degree)
        if not drop.any():
            return keep
        keep &= ~drop


def leiden_gene_modules(
    graph: GenePairGraph,
    keep: np.ndarray,
    *,
    resolution: float = 1.0,
    seed: int = 0,
) -> np.ndarray:
    """module_of_gene [G] with -1 for trimmed/moduleless genes
    (fit.rs:107 leiden_gene_modules)."""
    from ..ops.leiden import leiden_clustering

    out = np.full(graph.n_genes, -1, np.int64)
    e = graph.edges
    live = e[keep[e[:, 0]] & keep[e[:, 1]]]
    if len(live) == 0:
        return out
    nodes = np.unique(live.ravel())
    remap = np.full(graph.n_genes, -1, np.int64)
    remap[nodes] = np.arange(len(nodes))
    a = sp.coo_matrix(
        (np.ones(len(live)), (remap[live[:, 0]], remap[live[:, 1]])),
        shape=(len(nodes), len(nodes)),
    )
    res = leiden_clustering((a + a.T).tocsr(), resolution=resolution, seed=seed)
    out[nodes] = res.membership
    return out


@dataclass
class ModulePairBasis:
    """Canonical (a <= b) module pairs with modularity null factors
    (profiles.rs ModulePairBasis)."""

    n_modules: int
    module_of_gene: np.ndarray  # [G] module id or -1
    pairs: np.ndarray  # [P, 2]
    null_ab: np.ndarray  # [P] deg(a) deg(b) / (2W)^2

    @property
    def n_pairs(self) -> int:
        return len(self.pairs)

    @classmethod
    def build(cls, graph: GenePairGraph, module_of_gene: np.ndarray) -> "ModulePairBasis":
        mog = np.asarray(module_of_gene, np.int64)
        n_modules = int(mog.max()) + 1 if (mog >= 0).any() else 0
        weights: dict[tuple, float] = {}
        deg = np.zeros(max(n_modules, 1), np.float64)
        for u, v in graph.edges:
            mu, mv = mog[u], mog[v]
            if mu < 0 or mv < 0:
                continue
            a, b = (mu, mv) if mu <= mv else (mv, mu)
            weights[(a, b)] = weights.get((a, b), 0.0) + 1.0
            deg[mu] += 1.0
            deg[mv] += 1.0
        two_w = deg.sum()
        denom = two_w * two_w
        kept = sorted((p for p, w in weights.items() if w > 0))
        pairs = np.asarray(kept, np.int64) if kept else np.zeros((0, 2), np.int64)
        null = (
            deg[pairs[:, 0]] * deg[pairs[:, 1]] / denom
            if denom > 0 and len(pairs)
            else np.zeros(len(pairs))
        )
        log.info(
            "ModulePairBasis: %d modules, %d retained pairs, 2W=%.1f",
            n_modules, len(pairs), two_w,
        )
        return cls(
            n_modules=n_modules, module_of_gene=mog,
            pairs=pairs, null_ab=null.astype(np.float64),
        )


def build_module_expression(
    data,
    module_of_gene: np.ndarray,
    n_modules: int,
    *,
    gene_weights: np.ndarray | None = None,
    block_size: int = 8192,
    device="cuda",
) -> tuple[np.ndarray, np.ndarray]:
    """(module_expr [M, N], cell_totals [N]) in one streaming pass. Each
    block's genes are summed into their modules by K3 on the transposed
    block (genes as K3's columns, each in its module's group; trimmed
    genes in group M, which K3 drops), so the sums are deterministic on
    the card."""
    import torch

    from ..data.visitors import visit_columns_by_block
    from ..ops import kernels

    n = data.num_columns
    mog = np.asarray(module_of_gene, np.int64)
    gene_to_mod = np.where(mog >= 0, mog, n_modules).astype(np.int32)
    w = None if gene_weights is None else np.asarray(gene_weights, np.float32)
    seg = torch.from_numpy(gene_to_mod).to(device)
    expr = np.zeros((n_modules, n), np.float32)
    totals = np.zeros(n, np.float32)
    for blk in visit_columns_by_block(data, block_size=block_size):
        vals = blk.vals if w is None else blk.vals * w[blk.row_ids]
        by_gene = sp.csr_matrix((vals, blk.row_ids, blk.col_ptr),
                                shape=(blk.ncols, data.num_rows)).tocsc()
        out = kernels.collapse(
            torch.from_numpy(by_gene.indices.astype(np.int32)).to(device),
            torch.from_numpy(by_gene.indptr.astype(np.int32)).to(device),
            torch.from_numpy(by_gene.data.astype(np.float32)).to(device),
            seg, num_genes=blk.ncols, num_groups=max(n_modules, 1),
        )[:, :n_modules]  # [B, M]
        expr[:, blk.lb : blk.lb + blk.ncols] = out.T.cpu().numpy()
        totals[blk.lb : blk.lb + blk.ncols] = out.sum(dim=1).cpu().numpy()
    return expr, totals


def module_pair_edge_profiles(
    module_expr: np.ndarray,  # [M, N]
    cell_totals: np.ndarray,  # [N]
    edges: np.ndarray,  # [E, 2]
    basis: ModulePairBasis,
) -> sp.csr_matrix:
    """[E, P] sparse pair features with the modularity null subtracted
    (profiles.rs:847 build_module_pair_profiles_for_edges)."""
    src, dst = edges[:, 0], edges[:, 1]
    xi = module_expr[:, src].astype(np.float64)  # [M, E]
    xj = module_expr[:, dst].astype(np.float64)
    mass = cell_totals[src].astype(np.float64) * cell_totals[dst].astype(np.float64)
    cols_l, rows_l, vals_l = [], [], []
    for p, (a, b) in enumerate(basis.pairs):
        if a == b:
            y = xi[a] * xj[a]
        else:
            y = xi[a] * xj[b] + xi[b] * xj[a]
        y = np.maximum(y - mass * basis.null_ab[p], 0.0)
        nz = np.nonzero(y > 0)[0]
        if len(nz):
            rows_l.append(nz)
            cols_l.append(np.full(len(nz), p, np.int64))
            vals_l.append(y[nz])
    if not rows_l:
        return sp.csr_matrix((len(edges), basis.n_pairs), dtype=np.float32)
    return sp.coo_matrix(
        (
            np.concatenate(vals_l).astype(np.float32),
            (np.concatenate(rows_l), np.concatenate(cols_l)),
        ),
        shape=(len(edges), basis.n_pairs),
    ).tocsr()
