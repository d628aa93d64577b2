"""`senna deconvolve` — hierarchical-Bayes bulk deconvolution (the port of
the JAX package's `senna/deconvolve.py`; `senna/src/deconvolve/gibbs.rs:1-23`
model):

    eps_{s,g} ~ Gamma(r, r)                       NB overdispersion, mean 1
    y_{s,g}   ~ Poisson(eps_{s,g} sum_m u_{s,m} mu_{g,m})
    Z split   ~ Multinomial(y, p), p_m ~ u_m mu_gm  (eps cancels)
    eps       ~ Gamma(r + tau y, r + tau lam)       conjugate
    u_{s,m}   ~ Gamma(a0 + tau sum_g Z, b0 + tau sum_g eps mu)

`tau` tempers the likelihood (power posterior); `r` is fixed. Fractions
map components to cell types through the readout A. The chains of all
bulk samples step in lockstep on `device`, one sweep after another; the
multinomial split is drawn exactly, as a chain of binomials over the
components. The Gamma and binomial draws come from torch's samplers with
an explicit generator seeded from `seed`, so a chain is the JAX
package's in distribution, not draw for draw.

`build_archetype_reference` clusters a prior run's cell embedding into
Leiden communities at a target count (`leiden_at_count`, also used by
`senna bge --num-topics`) and measures each community's mean profile from
the counts; the per-community sums go through K3
(`senna/clustering.py::cluster_sums`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.leiden import knn_adjacency, leiden_clustering
from ..ops.mcmc import ess as ess_diag
from ..ops.mcmc import split_rhat

ABUNDANCE_FLOOR = 1e-12  # gibbs.rs:41


@dataclass
class DeconvConfig:
    n_sweeps: int = 300
    burn_in: int = 100
    thin: int = 1
    a0: float = 1.0  # --frac-prior-shape
    b0: float = 1.0  # --frac-prior-rate
    nb_dispersion: float = 10.0  # r
    count_scale: float = 1.0  # tau
    seed: int = 0


@dataclass
class ArchetypeReference:
    """Measured archetype profiles (deconvolve/archetypes.rs:1-15):
    Leiden communities on the cell embedding give sub-type-resolution
    profiles; the annotation posterior carries each community's label
    mix into the readout instead of forcing a hard label."""

    mu_gm: np.ndarray  # [D_sc, R] measured mean profiles
    readout: np.ndarray  # [R, C] community -> cell-type posterior
    gene_names: list
    celltype_names: list
    membership: np.ndarray  # [N] cell -> community (-1 = dropped)
    n_cells: np.ndarray  # [R]


def leiden_at_count(
    embedding: np.ndarray, target: int, *, knn: int = 30, seed: int = 0,
    max_bisect: int = 8, device="cuda",
) -> np.ndarray:
    """Leiden membership with ~`target` communities: binary search on
    the resolution from 1.0 (archetypes.rs LEIDEN_RESOLUTION binary
    search)."""
    adj = knn_adjacency(embedding, k=min(knn, len(embedding) - 1), device=device)
    lo, hi = 0.01, 100.0
    res = 1.0
    best = None
    for _ in range(max_bisect):
        memb = leiden_clustering(adj, resolution=res, seed=seed).membership
        k = int(memb.max()) + 1
        if best is None or abs(k - target) < abs(int(best.max()) + 1 - target):
            best = memb
        if k == target:
            break
        if k < target:
            lo = res
        else:
            hi = res
        res = float(np.sqrt(lo * hi))
    return best


def build_archetype_reference(
    sc_vec,  # backend/vec: [D_sc, N] counts
    embedding: np.ndarray,  # [N, H] cell embedding
    annotation: np.ndarray,  # [N] string labels ('' = unannotated)
    *,
    n_archetypes: int = 200,
    min_cells: int = 10,
    knn: int = 30,
    seed: int = 0,
    block_size: int = 2048,
    device="cuda",
) -> ArchetypeReference:
    """One granularity of the empirical archetype reference
    (archetypes.rs build): profiles are MEASURED from the counts (mean
    per community), never reconstructed from the embedding."""
    from .clustering import cluster_sums

    n = sc_vec.num_columns
    if len(embedding) != n or len(annotation) != n:
        raise ValueError("embedding/annotation rows must match sc columns")

    memb = leiden_at_count(embedding, n_archetypes, knn=knn, seed=seed, device=device)
    counts = np.bincount(memb, minlength=int(memb.max()) + 1)
    keep = counts >= min_cells
    remap = np.full(len(counts), -1, np.int64)
    remap[keep] = np.arange(int(keep.sum()))
    memb = np.where(memb >= 0, remap[memb], -1)
    r_comp = int(keep.sum())
    if r_comp == 0:
        raise ValueError("no archetype community reached --archetype-min-cells")

    # measured profiles: per-community count sums, one K3 launch a block
    sums = cluster_sums(sc_vec, memb, r_comp, block_size=block_size, device=device)
    n_cells = np.bincount(memb[memb >= 0], minlength=r_comp).astype(np.float32)
    mu_gm = (sums / np.maximum(n_cells, 1.0)).astype(np.float32)

    # soft readout: per-community annotation fractions; with NO
    # annotations at all the readout is the identity (each archetype
    # reports as itself) instead of a silent all-zero matrix
    labels = np.asarray([str(a) for a in annotation])
    annotated = labels != ""
    if not annotated.any():
        return ArchetypeReference(
            mu_gm=mu_gm,
            readout=np.eye(r_comp, dtype=np.float32),
            gene_names=list(sc_vec.row_names()),
            celltype_names=[f"archetype{r}" for r in range(r_comp)],
            membership=memb,
            n_cells=n_cells,
        )
    types = sorted(set(labels[annotated]))
    t_idx = {t: i for i, t in enumerate(types)}
    readout = np.zeros((r_comp, len(types)), np.float32)
    for j in np.nonzero(annotated & (memb >= 0))[0]:
        readout[memb[j], t_idx[labels[j]]] += 1.0
    readout = readout / np.maximum(readout.sum(1, keepdims=True), 1e-12)
    # unannotated communities fall back to the global label marginal
    empty = readout.sum(1) == 0
    if empty.any():
        marg = np.bincount(
            [t_idx[t] for t in labels[annotated]], minlength=len(types)
        ).astype(np.float32)
        readout[empty] = marg / marg.sum()

    return ArchetypeReference(
        mu_gm=mu_gm,
        readout=readout,
        gene_names=list(sc_vec.row_names()),
        celltype_names=list(types),
        membership=memb,
        n_cells=n_cells,
    )


@dataclass
class DeconvResult:
    fractions: np.ndarray  # [S, C] posterior-mean cell-type fractions
    fractions_sd: np.ndarray
    u_mean: np.ndarray  # [S, R]
    rhat: np.ndarray  # [S] worst split-Rhat across components
    ess: np.ndarray


@torch.no_grad()
def _sweep(u, y, mu, cfg: DeconvConfig, gen: torch.Generator):
    """One Gibbs sweep of every chain: (u [S, R], eps [S, D])."""
    tau, r_nb = cfg.count_scale, cfg.nb_dispersion
    r_comp = mu.shape[1]
    lam = torch.clamp_min(u @ mu.T, 1e-12)  # [S, D]
    # EXACT multinomial count split (gibbs.rs:148 binomial chain):
    # Z_{s,.,g} ~ Multinomial(y_sg, p), p_m = u_m mu_gm / lam; component
    # m draws Binomial(n_rem, p_m / p_rem) per (s, g), in order
    p_smg = u[:, None, :] * mu[None, :, :] / lam[:, :, None]  # [S, D, R]
    n_rem, p_rem = y, torch.ones_like(y)
    z_sm = torch.empty_like(u)
    for m in range(r_comp - 1):
        p_m = p_smg[:, :, m]
        frac = torch.clamp(p_m / torch.clamp_min(p_rem, 1e-12), 0.0, 1.0)
        z_m = torch.binomial(n_rem, frac, generator=gen)
        z_sm[:, m] = z_m.sum(1)
        n_rem, p_rem = n_rem - z_m, p_rem - p_m
    z_sm[:, r_comp - 1] = n_rem.sum(1)
    # eps | rest ~ Gamma(r + tau y, r + tau lam) per gene
    eps = torch._standard_gamma(r_nb + tau * y, generator=gen) / (r_nb + tau * lam)
    # u | rest ~ Gamma(a0 + tau sum_g Z, b0 + tau sum_g eps mu): tau
    # tempers the sufficient statistics (power posterior, gibbs.rs:207)
    u_b = cfg.b0 + tau * (eps @ mu)
    u_a = cfg.a0 + tau * z_sm
    u = torch.clamp_min(torch._standard_gamma(u_a, generator=gen) / u_b, ABUNDANCE_FLOOR)
    return u, eps


def deconvolve(
    y_sg: np.ndarray,  # [S, D] bulk counts
    mu_gm: np.ndarray,  # [D, R] reference component rates
    readout_mc: np.ndarray | None = None,  # [R, C] component -> cell type
    config: DeconvConfig | None = None,
    *,
    device="cuda",
) -> DeconvResult:
    cfg = config or DeconvConfig()
    s, _ = y_sg.shape
    r_comp = mu_gm.shape[1]
    a_read = (
        np.eye(r_comp, dtype=np.float32) if readout_mc is None
        else np.asarray(readout_mc, np.float32)
    )
    dev = torch.device(device)
    gen = torch.Generator(device=dev).manual_seed(int(cfg.seed))
    y = torch.tensor(np.asarray(y_sg, np.float32), device=dev)
    mu = torch.tensor(np.asarray(mu_gm, np.float32), device=dev)
    u = torch._standard_gamma(
        torch.full((s, r_comp), float(cfg.a0), device=dev), generator=gen) / cfg.b0
    draws = []
    for _ in range(cfg.n_sweeps):
        u, _ = _sweep(u, y, mu, cfg, gen)
        draws.append(u)
    u_draws = torch.stack(draws).cpu().numpy()[cfg.burn_in :: max(cfg.thin, 1)]  # [T, S, R]
    frac_draws = (u_draws @ a_read) / np.maximum(u_draws.sum(-1, keepdims=True), 1e-30)

    rhat = np.zeros(s)
    ess_v = np.zeros(s)
    for si in range(s):
        worst_r, worst_e = 1.0, np.inf
        for m in range(min(r_comp, 10)):
            x = u_draws[:, si, m]
            worst_r = max(worst_r, split_rhat(x))
            worst_e = min(worst_e, ess_diag(x))
        rhat[si] = worst_r
        ess_v[si] = worst_e

    return DeconvResult(
        fractions=frac_draws.mean(0),
        fractions_sd=frac_draws.std(0),
        u_mean=u_draws.mean(0),
        rhat=rhat,
        ess=ess_v,
    )
