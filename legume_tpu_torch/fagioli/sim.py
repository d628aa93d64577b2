"""Genotype-panel and mediation simulators (the port's copy of the JAX
package's `fagioli/sim.py`, numpy on the host: the same arrays for the
same seeds)
(`fagioli sim-geno` / `fagioli sim-mediation`;
`fagioli/src/main.rs:66-85`, `fagioli/tests/sim_mediation_roundtrip.rs`).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class GenoSim:
    genotypes: np.ndarray  # [n, p] 0/1/2 dosages
    maf: np.ndarray
    block: np.ndarray  # [p] LD-block id per variant


def simulate_genotypes(
    n: int = 500,
    p: int = 200,
    block_size: int = 25,
    ld_decay: float = 0.1,
    maf_low: float = 0.05,
    seed: int = 0,
) -> GenoSim:
    """LD-blocked dosage panel: AR(1)-correlated latents WITHIN each
    block, independent across blocks (the reference's LD-block GWAS
    panel shape)."""
    rng = np.random.default_rng(seed)
    rho = np.exp(-ld_decay)
    lat = np.empty((n, p))
    block = np.arange(p) // block_size
    eps = rng.standard_normal((n, p))
    for j in range(p):
        if j % block_size == 0:
            lat[:, j] = eps[:, j]
        else:
            lat[:, j] = rho * lat[:, j - 1] + np.sqrt(1 - rho * rho) * eps[:, j]
    maf = rng.uniform(maf_low, 0.5, p)
    from scipy.stats import norm

    thr = norm.ppf(1 - maf)
    geno = (lat > thr[None, :]).astype(np.float64) + (
        rng.standard_normal((n, p)) + lat > thr[None, :]
    ).astype(np.float64)
    return GenoSim(genotypes=geno, maf=maf, block=block)


@dataclass
class MediationSim:
    genotypes: np.ndarray  # [n, p]
    mediators: np.ndarray  # [n, m]
    outcome: np.ndarray  # [n]
    z_med: np.ndarray  # [p, m] variant -> mediator marginal z
    z_out: np.ndarray  # [p] variant -> outcome marginal z
    alpha: np.ndarray  # [p, m] true variant->mediator effects
    beta_med: np.ndarray  # [m] true mediator->outcome effects
    theta_direct: np.ndarray  # [p] true direct variant->outcome effects


def simulate_mediation(
    n: int = 800,
    p: int = 100,
    n_mediators: int = 5,
    n_causal_med: int = 2,
    pve_mediated: float = 0.2,
    pve_direct: float = 0.05,
    seed: int = 0,
) -> MediationSim:
    """X -> M -> Y with a small direct X -> Y path; marginal summary
    statistics for both stages (the mediation-roundtrip fixture,
    `fagioli/tests/sim_mediation_roundtrip.rs`)."""
    rng = np.random.default_rng(seed)
    gs = simulate_genotypes(n=n, p=p, seed=seed)
    x = (gs.genotypes - gs.genotypes.mean(0)) / np.maximum(gs.genotypes.std(0), 1e-8)

    m = n_mediators
    alpha = np.zeros((p, m))
    for j in range(m):
        idx = rng.choice(p, 3, replace=False)
        alpha[idx, j] = rng.normal(0, 0.5, 3)
    med = x @ alpha + rng.standard_normal((n, m))

    beta_med = np.zeros(m)
    causal_m = rng.choice(m, n_causal_med, replace=False)
    beta_med[causal_m] = rng.normal(0, 1.0, n_causal_med)
    g_med = med @ beta_med
    if g_med.var() > 0:
        s_med = np.sqrt(pve_mediated / g_med.var())
        beta_med *= s_med
        g_med *= s_med

    theta_direct = np.zeros(p)
    idx_d = rng.choice(p, 2, replace=False)
    theta_direct[idx_d] = rng.normal(0, 1.0, 2)
    g_dir = x @ theta_direct
    if g_dir.var() > 0:
        s_dir = np.sqrt(pve_direct / g_dir.var())
        theta_direct *= s_dir
        g_dir *= s_dir

    y = g_med + g_dir + rng.standard_normal(n) * np.sqrt(
        max(1.0 - pve_mediated - pve_direct, 0.05)
    )

    med_s = (med - med.mean(0)) / np.maximum(med.std(0), 1e-8)
    y_s = (y - y.mean()) / max(y.std(), 1e-8)
    z_med = x.T @ med_s / np.sqrt(n)
    z_out = x.T @ y_s / np.sqrt(n)
    return MediationSim(
        genotypes=gs.genotypes,
        mediators=med,
        outcome=y,
        z_med=z_med * np.sqrt(n),
        z_out=z_out * np.sqrt(n),
        alpha=alpha,
        beta_med=beta_med,
        theta_direct=theta_direct,
    )


def simulate_mediation_full(
    genotypes: np.ndarray,  # [n, p]
    var_pos: "np.ndarray | None" = None,
    *,
    n_genes: int = 20,
    gene_tss: "np.ndarray | None" = None,
    cis_window: int = 1_000_000,
    n_eqtl_per_gene: int = 3,
    num_mediator_genes: int = 5,
    num_observed_mediators: "int | None" = None,
    expression_heritability: float = 0.3,
    pve_mediated: float = 0.2,
    pve_direct: float = 0.05,
    pve_confounder_expr: float = 0.1,
    pve_confounder_y: float = 0.1,
    num_confounders: int = 3,
    num_hidden_factors: int = 2,
    num_collider_genes: int = 0,
    collider_confounder_correlation: float = 0.5,
    induce_collider_bias: bool = False,
    num_conditioned_colliders: int = 1,
    collider_selection_quantile: float = 0.5,
    n_eqtl_discovery: "int | None" = None,
    eqtl_pvalue_threshold: float = 1e-3,
    seed: int = 42,
) -> dict:
    """Reference-style mediation simulator (`sim_mediation.rs`):
    SNP -> gene expression -> outcome with horizontal pleiotropy,
    hidden-factor confounders hitting BOTH expression and Y, optional
    COLLIDER genes (confounder-correlated expression) with
    selection-on-liability to induce collider bias, and an optional
    discovery/replication split with p-value instrument selection."""
    rng = np.random.default_rng(seed)
    n, p = genotypes.shape
    x = np.nan_to_num(
        (genotypes - np.nanmean(genotypes, 0))
        / np.maximum(np.nanstd(genotypes, 0), 1e-8)
    )

    def scale_to(term, pve):
        v = term.var()
        return term * np.sqrt(pve / max(v, 1e-12)) if v > 0 else term

    # hidden-factor confounders (num_hidden_factors -> num_confounders)
    h = rng.standard_normal((n, max(num_hidden_factors, 1)))
    w = rng.standard_normal((max(num_hidden_factors, 1),
                             max(num_confounders, 1)))
    u = h @ w if num_confounders > 0 else np.zeros((n, 1))

    # per-gene cis eQTL architecture
    alpha = np.zeros((p, n_genes))
    for g in range(n_genes):
        if gene_tss is not None and var_pos is not None:
            cand = np.flatnonzero(
                np.abs(var_pos - gene_tss[g]) <= cis_window)
        else:
            cand = np.arange(p)
        if cand.size == 0:
            continue
        idx = rng.choice(cand, min(n_eqtl_per_gene, cand.size),
                         replace=False)
        alpha[idx, g] = rng.normal(0, 1.0, len(idx))
    genetic = x @ alpha  # [n, G]
    for g in range(n_genes):
        genetic[:, g] = scale_to(genetic[:, g], expression_heritability)
        alpha[:, g] *= (
            np.sqrt(expression_heritability
                    / max((x @ alpha[:, g]).var(), 1e-12))
            if (x @ alpha[:, g]).var() > 0 else 1.0
        )

    # confounder loadings on expression; collider genes get a loading
    # CORRELATED with Y's confounder direction
    y_conf_dir = rng.standard_normal(u.shape[1])
    conf_load = rng.standard_normal((u.shape[1], n_genes))
    collider_ids = np.arange(
        num_mediator_genes,
        min(num_mediator_genes + num_collider_genes, n_genes),
    )
    for g in collider_ids:
        indep = rng.standard_normal(u.shape[1])
        conf_load[:, g] = (
            collider_confounder_correlation * y_conf_dir
            + np.sqrt(max(1 - collider_confounder_correlation**2, 0.0))
            * indep
        )
    conf_expr = u @ conf_load
    for g in range(n_genes):
        conf_expr[:, g] = scale_to(conf_expr[:, g], pve_confounder_expr)
    noise_var = max(
        1.0 - expression_heritability - pve_confounder_expr, 0.05)
    expr = genetic + conf_expr + rng.standard_normal(
        (n, n_genes)) * np.sqrt(noise_var)

    # outcome: mediated + direct (pleiotropy) + confounder + noise
    beta_med = np.zeros(n_genes)
    beta_med[:num_mediator_genes] = rng.normal(
        0, 1.0, num_mediator_genes)
    mediated = scale_to(expr @ beta_med, pve_mediated)
    theta_direct = np.zeros(p)
    idx_d = rng.choice(p, max(2, n_eqtl_per_gene), replace=False)
    theta_direct[idx_d] = rng.normal(0, 1.0, len(idx_d))
    direct = scale_to(x @ theta_direct, pve_direct)
    conf_y = scale_to(u @ y_conf_dir, pve_confounder_y)
    resid = max(
        1.0 - pve_mediated - pve_direct - pve_confounder_y, 0.05)
    y = mediated + direct + conf_y + rng.standard_normal(n) * np.sqrt(
        resid)

    # optional selection on collider liability -> collider bias
    keep = np.ones(n, bool)
    if induce_collider_bias and len(collider_ids):
        cond = collider_ids[: max(num_conditioned_colliders, 1)]
        liability = expr[:, cond].sum(1)
        keep = liability >= np.quantile(
            liability, collider_selection_quantile)

    def marginal_z(xm, ym):
        # z = corr * sqrt(n): xs'ys sums n standardized products
        xs = (xm - xm.mean(0)) / np.maximum(xm.std(0), 1e-8)
        ys = (ym - ym.mean(0)) / np.maximum(ym.std(0), 1e-8)
        return xs.T @ ys / np.sqrt(len(xm))

    # discovery / replication split for instrument selection
    instruments = None
    if n_eqtl_discovery is not None and 0 < n_eqtl_discovery < n:
        disc = np.arange(n) < n_eqtl_discovery
        from scipy.stats import norm as _norm

        zd = marginal_z(x[disc], expr[disc])
        pd_ = 2 * _norm.sf(np.abs(zd))
        instruments = pd_ < eqtl_pvalue_threshold  # [p, G]
        rep = ~disc & keep
    else:
        rep = keep
    nr = int(rep.sum())
    z_med = marginal_z(x[rep], expr[rep])
    z_out = marginal_z(x[rep], y[rep, None])[:, 0]

    obs = num_observed_mediators or num_mediator_genes
    return {
        "expression": expr, "outcome": y, "confounders": u,
        "keep": keep, "alpha": alpha, "beta_med": beta_med,
        "theta_direct": theta_direct,
        "mediator_ids": np.arange(num_mediator_genes),
        "observed_ids": np.arange(min(obs, num_mediator_genes)),
        "collider_ids": collider_ids,
        "z_med": z_med, "z_out": z_out,
        "instruments": instruments, "n_replication": nr,
    }


def simulate_sumstat_full(
    genotypes: np.ndarray,  # [n, p]
    block: "np.ndarray | None" = None,  # [p] LD-block id per variant
    *,
    num_traits: int = 10,
    num_shared_causal: int = 1,
    num_independent_causal: int = 1,
    h2_sparse: float = 0.25,
    h2_polygenic: float = 0.0,
    num_causal_blocks: int = 3,
    num_confounders: int = 0,
    num_hidden_factors: int = 2,
    pve_confounders: float = 0.1,
    seed: int = 42,
) -> dict:
    """Reference-style multi-trait GWAS generator (`sim_sumstat.rs`):
    causal SNPs live in `num_causal_blocks` LD blocks — each causal
    block carries `num_shared_causal` SNPs hitting EVERY trait plus
    `num_independent_causal` per-trait private SNPs; a dense
    infinitesimal term adds `h2_polygenic`; hidden-factor confounders
    add `pve_confounders`. Returns per-trait z-scores + truth."""
    rng = np.random.default_rng(seed)
    n, p = genotypes.shape
    x = np.nan_to_num(
        (genotypes - np.nanmean(genotypes, 0))
        / np.maximum(np.nanstd(genotypes, 0), 1e-8)
    )
    if block is None:
        block = np.arange(p) // max(p // 10, 1)
    blocks = np.unique(block)
    causal_blocks = rng.choice(
        blocks, min(num_causal_blocks, len(blocks)), replace=False)

    beta = np.zeros((p, num_traits))
    truth = []
    for b in causal_blocks:
        members = np.flatnonzero(block == b)
        shared = rng.choice(
            members, min(num_shared_causal, members.size), replace=False)
        for v in shared:
            eff = rng.normal(0, 1.0, num_traits)
            beta[v] += eff
            truth.append((int(v), -1, "shared"))
        for t in range(num_traits):
            indep = rng.choice(
                members, min(num_independent_causal, members.size),
                replace=False)
            for v in indep:
                beta[v, t] += rng.normal()
                truth.append((int(v), t, "independent"))

    def scale_cols(term, pve):
        v = term.var(0)
        s = np.sqrt(pve / np.maximum(v, 1e-12))
        return term * s[None, :], s

    g_sparse, s_sp = scale_cols(x @ beta, h2_sparse)
    beta *= s_sp[None, :]
    if h2_polygenic > 0:
        beta_poly = rng.normal(0, 1.0 / np.sqrt(p), (p, num_traits))
        g_poly, _ = scale_cols(x @ beta_poly, h2_polygenic)
    else:
        g_poly = 0.0
    if num_confounders > 0 and pve_confounders > 0:
        h = rng.standard_normal((n, max(num_hidden_factors, 1)))
        w = rng.standard_normal((max(num_hidden_factors, 1),
                                 num_confounders))
        u = h @ w
        load = rng.standard_normal((num_confounders, num_traits))
        conf, _ = scale_cols(u @ load, pve_confounders)
    else:
        conf = 0.0
    resid = max(1.0 - h2_sparse - h2_polygenic - pve_confounders, 0.05)
    y = (g_sparse + g_poly + conf
         + rng.standard_normal((n, num_traits)) * np.sqrt(resid))

    ys = (y - y.mean(0)) / np.maximum(y.std(0), 1e-8)
    z = x.T @ ys / np.sqrt(n)  # [p, T]
    return {"z": z, "beta": beta, "truth": truth, "y": y,
            "causal_blocks": causal_blocks}
