"""CoCoA generative simulators (`cocoa simulate-one`,
`cocoa simulate-collider`): the port's copy of the JAX package's
`cocoa/sim.py`, same generators, same seeds, same draws.

simulate-one (single cell type, individual-level confounding):

    V_i ~ N(0, I)                       individual confounders
    X_i ~ Bern(sigmoid(V_i alpha))      exposure (confounded)
    log mu_ig = beta_g X_i + V_i gamma_g
    Y_jg ~ Poisson(rho_j exp(log mu_ig))
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp


@dataclass
class CocoaSim:
    counts: sp.csc_matrix  # [G, N]
    cell_indv: np.ndarray  # [N]
    exposure: np.ndarray  # [I]
    causal_genes: np.ndarray  # [G] bool
    beta: np.ndarray  # [G] true exposure effects (log scale)


@dataclass
class ColliderSim:
    counts: sp.csc_matrix  # [G, N]
    cell_indv: np.ndarray
    cell_type: np.ndarray  # [N] collider A
    exposure: np.ndarray  # [I]
    causal_genes: np.ndarray
    beta: np.ndarray


def simulate_collider(
    n_genes: int = 200,
    n_types: int = 3,
    n_indv: int = 20,
    cells_per_indv: int = 50,
    n_causal: int = 20,
    pve_covar_exposure: float = 0.5,
    pve_exposure_celltype: float = 0.4,
    pve_cell_covar_celltype: float = 0.4,
    pve_exposure_gene: float = 0.3,
    pve_covar_gene: float = 0.2,
    pve_cell_covar_gene: float = 0.3,
    depth: float = 2000.0,
    seed: int = 0,
) -> ColliderSim:
    """Multi-cell-type DAG with the cell-type collider
    (`cocoa simulate-collider`, run_sim_collider.rs; cocoa/README.md):

        V -> X, X -> A <- U, U -> Y, V -> Y, (X -> Y causal genes)

    Conditioning on A opens X -> A <- U -> Y.
    """
    rng = np.random.default_rng(seed)
    g, i, t = n_genes, n_indv, n_types
    n = i * cells_per_indv

    v = rng.standard_normal(i)
    alpha = np.sqrt(pve_covar_exposure / (1 - pve_covar_exposure + 1e-9)) * 2.0
    x = (rng.random(i) < 1.0 / (1.0 + np.exp(-(v * alpha)))).astype(np.int64)

    cell_indv = np.repeat(np.arange(i), cells_per_indv)
    u = rng.standard_normal(n)  # cell-level confounder

    # collider: A ~ Cat(softmax(U delta + X eta))
    delta = rng.normal(0, np.sqrt(pve_cell_covar_celltype) * 2, t)
    eta = rng.normal(0, np.sqrt(pve_exposure_celltype) * 2, t)
    logits = u[:, None] * delta[None, :] + x[cell_indv][:, None] * eta[None, :]
    logits += rng.gumbel(size=(n, t)) * 0.5
    cell_type = logits.argmax(1)

    causal = np.zeros(g, bool)
    causal[rng.choice(g, n_causal, replace=False)] = True
    beta = np.where(causal, rng.normal(0, np.sqrt(pve_exposure_gene) * 2, g), 0.0)
    gamma = rng.normal(0, np.sqrt(pve_covar_gene), g)
    xi = rng.normal(0, np.sqrt(pve_cell_covar_gene), g)
    delta_gt = rng.normal(0, 0.8, size=(g, t))  # cell-type programs

    log_mu = (
        delta_gt[:, cell_type]
        + beta[:, None] * x[cell_indv][None, :]
        + gamma[:, None] * v[cell_indv][None, :]
        + xi[:, None] * u[None, :]
    )
    log_mu -= log_mu.mean()
    rho = rng.gamma(10.0, 0.1, size=n)
    lam = (depth / g) * rho[None, :] * np.exp(np.clip(log_mu, -6, 6))
    y = rng.poisson(lam).astype(np.float32)
    return ColliderSim(
        counts=sp.csc_matrix(y),
        cell_indv=cell_indv,
        cell_type=cell_type,
        exposure=x,
        causal_genes=causal,
        beta=beta,
    )


def simulate_one(
    n_genes: int = 200,
    n_indv: int = 20,
    cells_per_indv: int = 50,
    n_causal: int = 20,
    pve_covar_exposure: float = 0.5,
    pve_exposure_gene: float = 0.3,
    pve_covar_gene: float = 0.3,
    depth: float = 2000.0,
    seed: int = 0,
) -> CocoaSim:
    rng = np.random.default_rng(seed)
    g, i = n_genes, n_indv
    n = i * cells_per_indv

    v = rng.standard_normal(i)  # 1-dim confounder
    alpha = np.sqrt(pve_covar_exposure / (1 - pve_covar_exposure + 1e-9)) * 2.0
    x = (rng.random(i) < 1.0 / (1.0 + np.exp(-(v * alpha)))).astype(np.int64)

    causal = np.zeros(g, bool)
    causal[rng.choice(g, n_causal, replace=False)] = True
    beta = np.where(causal, rng.normal(0, np.sqrt(pve_exposure_gene) * 2, g), 0.0)
    gamma = rng.normal(0, np.sqrt(pve_covar_gene), g)

    cell_indv = np.repeat(np.arange(i), cells_per_indv)
    log_mu = beta[:, None] * x[None, cell_indv] + gamma[:, None] * v[None, cell_indv]
    log_mu -= log_mu.mean()
    rho = rng.gamma(10.0, 0.1, size=n)  # per-cell size factor
    base = depth / g
    lam = base * rho[None, :] * np.exp(np.clip(log_mu, -6, 6))
    y = rng.poisson(lam).astype(np.float32)
    return CocoaSim(
        counts=sp.csc_matrix(y),
        cell_indv=cell_indv,
        exposure=x,
        causal_genes=causal,
        beta=beta,
    )


def write_simulation(a) -> dict:
    """`cocoa simulate-one` / `simulate-collider` outputs from parsed
    flags `a`: `{output}.zarr`, `.indv.txt`, `.exposure.tsv`, the truth
    table and (collider) the cell-type table."""
    from ..data.sparse_io import create_sparse_from_csc
    from ..utils.output import write_table

    if a.cmd == "simulate-one":
        sim = simulate_one(
            n_genes=a.genes, n_indv=a.indv, cells_per_indv=a.cells_per_indv,
            n_causal=a.n_causal, pve_exposure_gene=a.pve_exposure_gene, depth=a.depth,
            seed=a.seed,
        )
    else:
        sim = simulate_collider(
            n_genes=a.genes, n_types=a.types, n_indv=a.indv, cells_per_indv=a.cells_per_indv,
            n_causal=a.n_causal, depth=a.depth, seed=a.seed,
        )
    n = sim.counts.shape[1]
    genes = [f"g{i}" for i in range(a.genes)]
    cells = [f"cell{j}" for j in range(n)]
    create_sparse_from_csc(sim.counts, f"{a.output}.zarr", genes, cells)
    with open(f"{a.output}.indv.txt", "w") as f:
        f.write("\n".join(f"i{v:04d}" for v in sim.cell_indv) + "\n")
    with open(f"{a.output}.exposure.tsv", "w") as f:
        for i, x in enumerate(sim.exposure):
            f.write(f"i{i:04d}\t{int(x)}\n")
    out = {"truth": write_table(f"{a.output}.truth", {
        "gene": np.asarray(genes), "causal": sim.causal_genes, "beta": sim.beta})}
    if a.cmd == "simulate-collider":
        out["celltype"] = write_table(f"{a.output}.celltype",
                                      {"cell": np.asarray(cells), "type": sim.cell_type})
    return {"sim": sim, "outputs": out}
