"""Synthetic counts (the port's copies of `simulate_topic`,
`simulate_multimodal`, `simulate_multiome`, `simulate_bulk`,
`simulate_faba` and `simulate_from_reference` from the JAX package's
`data/sim.py`: same generators, same seeds, same numpy draws).

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


def simulate_bulk(
    sc_counts: sp.spmatrix,  # [G, N] real/simulated single cells
    cell_labels: np.ndarray,  # [N] type of each cell
    n_samples: int = 20,
    reads_per_sample: float = 100_000,
    alpha: float = 1.0,
    seed: int = 17,
) -> tuple[np.ndarray, np.ndarray]:
    """Bulk pseudo-samples by Dirichlet-mixing single cells
    (`data-beans-sim bulk`); returns (bulk [S, G], fractions [S, C])."""
    rng = np.random.default_rng(seed)
    labels = np.asarray(cell_labels)
    types = np.unique(labels)
    g = sc_counts.shape[0]
    csc = sp.csc_matrix(sc_counts)
    profiles = np.stack(
        [np.asarray(csc[:, labels == t].sum(1)).ravel() for t in types]
    )  # [C, G]
    profiles = profiles / np.maximum(profiles.sum(1, keepdims=True), 1)
    fracs = rng.dirichlet(np.full(len(types), alpha), size=n_samples)
    lam = fracs @ profiles * reads_per_sample
    return rng.poisson(lam).astype(np.float32), fracs


@dataclass
class FabaSim:
    counts: sp.csc_matrix  # [S, N] site x cell modality counts
    site_names: list  # gene/modality/channel convention (feature_name.rs)
    col_names: list
    modality: np.ndarray  # [S] modality of each site
    true_rates: np.ndarray  # [S, K] per-state rates
    state: np.ndarray  # [N] latent cell state


def simulate_faba(
    n_genes: int = 50,
    n_cells: int = 500,
    n_states: int = 3,
    sites_per_gene: int = 2,
    depth: float = 30.0,
    seed: int = 0,
) -> FabaSim:
    """`data-beans-sim faba`: m6A / A-to-I / APA tracks in faba's
    `gene/modality/channel` row-name convention (feature_name.rs), with
    state-dependent modification rates as ground truth for dyn-assoc /
    masked-topic style benchmarks."""
    rng = np.random.default_rng(seed)
    modalities = [("m6a", "CT"), ("atoi", "AG"), ("apa", "distal")]
    state = rng.integers(0, n_states, n_cells)

    names, mods, rate_rows = [], [], []
    for g in range(n_genes):
        for s in range(sites_per_gene):
            mod, channel = modalities[(g * sites_per_gene + s) % len(modalities)]
            names.append(f"g{g}:{100 * (s + 1)}/{mod}/{channel}")
            mods.append(mod)
            base = rng.uniform(0.02, 0.1)
            rates = np.full(n_states, base)
            if rng.random() < 0.3:  # 30% of sites are state-specific
                rates[rng.integers(0, n_states)] = rng.uniform(0.2, 0.5)
            rate_rows.append(rates)
    true_rates = np.stack(rate_rows)  # [S, K]

    lam = true_rates[:, state] * depth  # [S, N]
    counts = sp.csc_matrix(rng.poisson(lam).astype(np.float32))
    return FabaSim(
        counts=counts,
        site_names=names,
        col_names=[f"cell{i}" for i in range(n_cells)],
        modality=np.asarray(mods),
        true_rates=true_rates,
        state=state,
    )


def simulate_from_reference(
    ref_counts: sp.spmatrix,  # [G, N] real cells
    n_cells: int = 1000,
    *,
    rank: int = 10,
    seed: int = 0,
    max_ref_cells: int = 5000,
) -> tuple[sp.csc_matrix, dict]:
    """Reference-conditioned NB + Gaussian-copula generator
    (`data-beans-sim topic --reference`, `data-beans-sim/src/copula/`):

    1. per-gene NB marginals from the reference (method-of-moments
       mean/dispersion on library-size-normalized counts),
    2. a rank-``rank`` Gaussian copula capturing gene-gene dependence
       (factor loadings from the SVD of the z-scored log1p matrix),
    3. sample latent z = L f + sqrt(1 - ||L||^2) eps, push through the
       NB quantile at each gene.

    Returns ([G, n_cells] counts, params dict with nb_mean/nb_phi/
    loadings)."""
    rng = np.random.default_rng(seed)
    csc = sp.csc_matrix(ref_counts)
    g, n = csc.shape
    if n > max_ref_cells:
        pick = rng.choice(n, max_ref_cells, replace=False)
        csc = csc[:, pick]
        n = max_ref_cells
    x = np.asarray(csc.todense(), np.float64)  # [G, N]
    lib = np.maximum(x.sum(0), 1.0)
    depth = lib.mean()
    xn = x / lib[None, :] * depth  # depth-normalized

    mu = xn.mean(1)
    var = xn.var(1)
    # NB: var = mu + phi mu^2  ->  phi = max((var - mu) / mu^2, 0)
    phi = np.maximum((var - mu) / np.maximum(mu**2, 1e-12), 1e-6)

    # copula loadings from z-scored log1p
    z = np.log1p(xn)
    z = (z - z.mean(1, keepdims=True)) / np.maximum(z.std(1, keepdims=True), 1e-8)
    rank = min(rank, min(g, n) - 1)
    u_svd, s_svd, _ = np.linalg.svd(z / np.sqrt(n), full_matrices=False)
    load = u_svd[:, :rank] * s_svd[:rank][None, :]  # [G, R]
    # cap so the residual variance stays positive
    norms = np.linalg.norm(load, axis=1)
    scale = np.minimum(0.99 / np.maximum(norms, 1e-9), 1.0)
    load = load * scale[:, None]
    resid_sd = np.sqrt(np.maximum(1.0 - (load**2).sum(1), 1e-4))

    from scipy.stats import nbinom, norm, poisson

    f = rng.standard_normal((rank, n_cells))
    eps = rng.standard_normal((g, n_cells))
    z_new = load @ f + resid_sd[:, None] * eps
    u = norm.cdf(z_new)  # [G, n_cells] uniforms with gene dependence

    counts = np.zeros((g, n_cells), np.float32)
    for j in range(g):
        if mu[j] <= 0:
            continue
        if phi[j] < 1e-5:
            counts[j] = poisson.ppf(u[j], mu[j])
        else:
            r = 1.0 / phi[j]
            p = r / (r + mu[j])
            counts[j] = nbinom.ppf(u[j], r, p)
    return (
        sp.csc_matrix(counts),
        {"nb_mean": mu, "nb_phi": phi, "loadings": load},
    )


def write_topic_sim(sim: TopicSim, output: str) -> str:
    """Write the backend and the ground-truth sidecars the way the
    reference does (`data-beans-sim/README.md` outputs table): the counts
    at `{output}.zarr` (or `output` itself with a `.zarr` / `.h5`
    suffix), the dictionary, proportions and log batch effects as tables
    (`utils/output.py::write_table`) and the batch labels as
    `{output}.batch.gz`. Returns the backend's path."""
    from ..utils.output import matrix_columns, write_table
    from .sparse_io import create_sparse_from_csc

    path = output if output.endswith((".zarr", ".h5")) else output + ".zarr"
    create_sparse_from_csc(sim.counts, path, sim.row_names, sim.col_names)
    write_table(output + ".dict", matrix_columns(sim.beta, "k", "row", sim.row_names))
    write_table(output + ".prop", matrix_columns(sim.theta, "k", "cell", sim.col_names))
    write_table(output + ".ln_batch", matrix_columns(sim.ln_delta, "b", "row", sim.row_names))
    np.savetxt(output + ".batch.gz", sim.batch, fmt="%d")
    return path
