"""Synthetic counts (the port's copies of `simulate_topic`,
`simulate_multimodal` and `simulate_multiome` from the JAX package's
`data/sim.py`, same generators, same seeds, same draws).

    log beta(g,k)  = s_b * [ sqrt(pi_t) u(g,k) + sqrt(1-pi_t) v(g) ] - s_b^2/2
    log delta(g,b) =        sqrt(pi_b) z(g,b) + sqrt(1-pi_b) w(g)
    theta(k*,j)    = pi_t + (1-pi_t)/K ; theta(k,j) = (1-pi_t)/K otherwise
    Y(g,j) ~ Poisson( (depth/G) * delta(g,B(j)) * sum_k beta(g,k) theta(k,j) )
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class TopicSim:
    counts: sp.csc_matrix  # [G, N]
    beta: np.ndarray  # [G, K] true dictionary
    theta: np.ndarray  # [N, K] true proportions
    ln_delta: np.ndarray  # [G, B] log batch effects
    batch: np.ndarray  # [N] batch membership
    row_names: list[str]
    col_names: list[str]


def simulate_topic(
    rows: int = 2000,
    cols: int = 1000,
    factors: int = 8,
    batches: int = 1,
    pve_topic: float = 0.7,
    pve_batch: float = 0.3,
    beta_scale: float = 1.0,
    depth: float = 1000.0,
    seed: int = 42,
    pve_noise: float = 0.0,
    hierarchical_depth: "int | None" = None,
    n_housekeeping: int = 0,
    housekeeping_fold: float = 10.0,
    batch_rank: int = 0,
) -> TopicSim:
    """Single-modality factored counts (`data-beans-sim topic`)."""
    rng = np.random.default_rng(seed)
    g, n, b = rows, cols, batches
    k = (1 << hierarchical_depth) if hierarchical_depth else factors

    if hierarchical_depth:
        depth_t = hierarchical_depth
        node_u = rng.standard_normal((g, (1 << (depth_t + 1)) - 1))
        u = np.zeros((g, k))
        for leaf in range(k):
            node = leaf + (1 << depth_t)
            path = []
            while node >= 1:
                path.append(node - 1)
                node >>= 1
            u[:, leaf] = node_u[:, path].sum(1) / np.sqrt(len(path))
    else:
        u = rng.standard_normal((g, k))
    v = rng.standard_normal((g, 1))
    log_beta = (
        beta_scale * (np.sqrt(pve_topic) * u + np.sqrt(1.0 - pve_topic) * v)
        - beta_scale**2 / 2.0
    )
    beta = np.exp(log_beta)

    if n_housekeeping > 0:
        h = min(n_housekeeping, g - 1)
        hk_mean = housekeeping_fold * float(beta.mean())
        hk = np.exp(np.log(hk_mean) - 0.5 * 0.25**2 + 0.25 * rng.standard_normal(h))
        beta[:h] = hk[:, None]

    if b > 1:
        if batch_rank > 0:
            f = rng.standard_normal((g, batch_rank))
            c = rng.standard_normal((batch_rank, b))
            z = f @ c
            z = z / np.maximum(z.std(), 1e-12)
        else:
            z = rng.standard_normal((g, b))
        w = rng.standard_normal((g, 1))
        ln_delta = np.sqrt(pve_batch) * z + np.sqrt(1.0 - pve_batch) * w
        ln_delta -= ln_delta.mean(axis=1, keepdims=True) + 0.0
    else:
        ln_delta = np.zeros((g, 1))
    delta = np.exp(ln_delta)

    k_star = rng.integers(0, k, size=n)
    theta = np.full((n, k), (1.0 - pve_topic) / k)
    theta[np.arange(n), k_star] += pve_topic

    batch = rng.integers(0, b, size=n) if b > 1 else np.zeros(n, dtype=np.int64)

    if n > 100_000:
        # column-chunked draw keeps the dense rate plane bounded
        chunks = []
        beta32 = beta.astype(np.float32)
        delta32 = delta.astype(np.float32)
        theta32 = theta.astype(np.float32)
        for lb in range(0, n, 50_000):
            ub = min(lb + 50_000, n)
            rate = (depth / g) * delta32[:, batch[lb:ub]] * (beta32 @ theta32[lb:ub].T)
            if pve_noise > 0:
                rate = rate * np.exp(
                    np.sqrt(pve_noise) * rng.standard_normal(rate.shape).astype(np.float32)
                )
            chunks.append(sp.csc_matrix(rng.poisson(rate).astype(np.float32)))
        counts = sp.hstack(chunks, format="csc")
    else:
        rate = (depth / g) * delta[:, batch] * (beta @ theta.T)
        if pve_noise > 0:
            rate = rate * np.exp(np.sqrt(pve_noise) * rng.standard_normal(rate.shape))
        counts = sp.csc_matrix(rng.poisson(rate).astype(np.float32))

    return TopicSim(
        counts=counts,
        beta=beta,
        theta=theta,
        ln_delta=ln_delta,
        batch=batch,
        row_names=[f"g{i}" for i in range(g)],
        col_names=[f"cell{j}" for j in range(n)],
    )


@dataclass
class MultimodalSim:
    counts: list  # per modality [G_m, N] csc
    theta: np.ndarray  # shared [N, K]
    betas: list  # per modality [G_m, K]


def simulate_multimodal(
    rows_per_modality=(1000, 400),
    cols: int = 800,
    factors: int = 6,
    pve_topic: float = 0.7,
    beta_scale: float = 1.0,
    depth: float = 1000.0,
    seed: int = 11,
) -> MultimodalSim:
    """M coupled count matrices sharing latent topics with
    modality-specific dictionaries (`data-beans-sim multimodal`)."""
    rng = np.random.default_rng(seed)
    k = factors
    k_star = rng.integers(0, k, size=cols)
    theta = np.full((cols, k), (1.0 - pve_topic) / k)
    theta[np.arange(cols), k_star] += pve_topic

    counts, betas = [], []
    for g in rows_per_modality:
        u = rng.standard_normal((g, k))
        v = rng.standard_normal((g, 1))
        log_beta = (
            beta_scale * (np.sqrt(pve_topic) * u + np.sqrt(1 - pve_topic) * v)
            - beta_scale**2 / 2
        )
        beta = np.exp(log_beta)
        lam = (depth / g) * (beta @ theta.T)
        counts.append(sp.csc_matrix(rng.poisson(lam).astype(np.float32)))
        betas.append(beta)
    return MultimodalSim(counts=counts, theta=theta, betas=betas)


@dataclass
class MultiomeSim:
    rna: sp.csc_matrix  # [G, N]
    atac: sp.csc_matrix  # [P, N]
    theta: np.ndarray
    peak_to_gene: np.ndarray  # [G, C] driving peak indices (-1 = none)
    linked: np.ndarray  # [G] bool: gene has a cis-regulating peak


def simulate_multiome(
    genes: int = 300,
    peaks: int = 600,
    cols: int = 600,
    factors: int = 5,
    depth: float = 1500.0,
    depth_atac: "float | None" = None,  # defaults to depth
    # causal structure (MultiomeArgs): several driving peaks per linked
    # gene, a fraction of genes with no cis-regulating peak, and a cis-PVE
    # mixing the peak-driven rate with a free topic rate
    n_causal_per_gene: int = 1,
    linked_gene_fraction: float = 1.0,
    pve_cis: float = 1.0,
    seed: int = 13,
) -> MultiomeSim:
    """Paired ATAC + RNA with peak-gene ground truth
    (`data-beans-sim multiome`)."""
    rng = np.random.default_rng(seed)
    mm = simulate_multimodal(
        rows_per_modality=(peaks,), cols=cols, factors=factors, depth=depth, seed=seed
    )
    atac = mm.counts[0]
    theta = mm.theta
    beta_p = mm.betas[0]  # [P, K]
    c = max(n_causal_per_gene, 1)
    p2g = rng.integers(0, peaks, (genes, c))
    linked = rng.uniform(size=genes) < linked_gene_fraction
    p2g[~linked] = -1
    # cis component: mean of the driving peaks' topic profiles;
    # trans/free component: an independent factored profile
    cis = beta_p[np.maximum(p2g, 0)].mean(axis=1)  # [G, K]
    free = np.exp(0.5 * rng.standard_normal((genes, factors)))
    w_cis = np.where(linked, pve_cis, 0.0)[:, None]
    beta_g = (w_cis * cis + (1.0 - w_cis) * free) * np.exp(
        0.2 * rng.standard_normal((genes, factors))
    )
    lam = (depth / genes) * (beta_g @ theta.T)
    rna = sp.csc_matrix(rng.poisson(lam).astype(np.float32))
    return MultiomeSim(rna=rna, atac=atac, theta=theta, peak_to_gene=p2g, linked=linked)
