"""Single-cell eQTL mapping and simulation (the port of the JAX package's
`fagioli/qtl.py`).

map-qtl: per (individual, cell type) Poisson-Gamma pseudobulk posterior,
then a per-gene weighted-Gaussian SuSiE regression on the genotypes
(weights = posterior precision of the log-rate).

The pseudobulk sums stay sparse: the counts' CSC goes to the device and
one K3 launch (`ops/kernels.py::collapse`) per cell type sums each
gene's counts over each individual's cells, the values scaled by the
cells' membership of that type. A dense [G, N] array is accepted as
well (it is made sparse first). The Gamma posterior is float32, as the
JAX package's is with x64 off.
"""

from __future__ import annotations

import dataclasses
import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..models.sgvb import (
    SgvbConfig,
    fit_regression,
    fit_regression_ash,
    fit_regression_grid,
    weighted_gaussian_llik,
)
from ..ops import kernels
from ..ops.gamma import GammaParam

log = logging.getLogger(__name__)


@dataclass
class QtlSim:
    counts: np.ndarray  # [G, N] cell counts
    cell_indv: np.ndarray
    genotypes: np.ndarray  # [I, P]
    causal_variant: np.ndarray  # [G] variant index (-1 none)
    beta: np.ndarray  # [G] effect size


def simulate_qtl(
    n_genes: int = 40,
    n_indv: int = 60,
    cells_per_indv: int = 25,
    n_variants: int = 50,
    frac_egenes: float = 0.5,
    effect_sd: float = 0.5,
    depth: float = 2000.0,
    seed: int = 0,
) -> QtlSim:
    """Single-cell eQTL generative model (`fagioli sim-qtl --legacy`)."""
    rng = np.random.default_rng(seed)
    g, i, p = n_genes, n_indv, n_variants
    maf = rng.uniform(0.1, 0.5, p)
    geno = rng.binomial(2, maf[None, :], size=(i, p)).astype(np.float64)
    gs = (geno - geno.mean(0)) / np.maximum(geno.std(0), 1e-8)

    causal = np.full(g, -1, np.int64)
    beta = np.zeros(g)
    egenes = rng.random(g) < frac_egenes
    causal[egenes] = rng.integers(0, p, egenes.sum())
    beta[egenes] = rng.normal(0, effect_sd, egenes.sum())

    cell_indv = np.repeat(np.arange(i), cells_per_indv)
    base = rng.gamma(2.0, 1.0, g)
    log_mu = np.log(base)[:, None] + np.where(
        causal[:, None] >= 0, beta[:, None] * gs[cell_indv][:, np.clip(causal, 0, p - 1)].T, 0.0
    )
    lam = depth / g * np.exp(np.clip(log_mu, -6, 6))
    counts = rng.poisson(lam * rng.gamma(8, 0.125, size=(g, len(cell_indv))))
    return QtlSim(
        counts=counts.astype(np.float32),
        cell_indv=cell_indv,
        genotypes=geno,
        causal_variant=causal,
        beta=beta,
    )


def _csc(counts_gn) -> sp.csc_matrix:
    c = sp.csc_matrix(counts_gn, dtype=np.float32)
    c.sort_indices()
    return c


def pseudobulk_sums(counts_gn, cell_indv: np.ndarray, n_indv: int, membership_nc: np.ndarray,
                    *, device="cuda") -> torch.Tensor:
    """[C, G, I] sums of each gene's counts over each individual's cells,
    the cells weighted by their membership of each type (K3, one launch
    per cell type). `counts_gn` is a [G, N] scipy matrix or array."""
    csc = _csc(counts_gn)
    g = csc.shape[0]
    dev = torch.device(device)
    rows = torch.from_numpy(csc.indices.astype(np.int32)).to(dev)
    ptr = torch.from_numpy(csc.indptr.astype(np.int32)).to(dev)
    vals = torch.from_numpy(csc.data).to(dev)
    seg = torch.from_numpy(np.asarray(cell_indv, np.int32)).to(dev)
    col = torch.repeat_interleave(torch.arange(csc.shape[1], device=dev),
                                  (ptr[1:] - ptr[:-1]).long())
    memb = torch.from_numpy(np.asarray(membership_nc, np.float32)).to(dev)
    planes = []
    for ci in range(memb.shape[1]):
        w = memb[:, ci]
        v = vals if bool((w == 1.0).all()) else (vals * w[col]).contiguous()
        planes.append(kernels.collapse(rows, ptr, v, seg, num_genes=g, num_groups=n_indv))
    return torch.stack(planes)


def _log_rates(sums: torch.Tensor, sizes: np.ndarray, a0: float, b0: float):
    """(log_mean, precision weights) of Gamma(a0 + sums, b0 + sizes); `b`
    is formed in float64 and rounded once, as the JAX package forms it."""
    b = torch.from_numpy((b0 + sizes).astype(np.float32)).to(sums.device)
    gp = GammaParam(a=a0 + sums, b=b)
    log_mean = gp.log_mean().cpu().numpy()
    log_sd = gp.log_sd().cpu().numpy()
    return log_mean, 1.0 / np.maximum(log_sd, np.float32(1e-3)) ** 2


def pseudobulk_log_rates(
    counts_gn, cell_indv: np.ndarray, n_indv: int, *, a0=1.0, b0=1.0, device="cuda"
):
    """Per-(gene, individual) Gamma posterior of the rate: returns
    (log_mean [G, I], precision weights [G, I])."""
    ones = np.ones((len(cell_indv), 1), np.float32)
    sums = pseudobulk_sums(counts_gn, cell_indv, n_indv, ones, device=device)[0]
    sizes = np.zeros(n_indv)
    np.add.at(sizes, cell_indv, 1.0)
    return _log_rates(sums, sizes[None, :], a0, b0)


def map_qtl(
    counts_gn,
    cell_indv: np.ndarray,
    genotypes: np.ndarray,  # [I, P]
    *,
    L: int = 3,
    num_steps: int = 800,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Per-gene SuSiE fine-mapping of pseudobulk log-rates on genotypes
    with posterior-precision weights."""
    n_indv = genotypes.shape[0]
    log_mu, w = pseudobulk_log_rates(counts_gn, cell_indv, n_indv, device=device)
    gs = (genotypes - genotypes.mean(0)) / np.maximum(genotypes.std(0), 1e-8)

    g = counts_gn.shape[0]
    pips, effects = [], []
    for gi in range(g):
        y = (log_mu[gi] - log_mu[gi].mean())[:, None]
        wg = torch.from_numpy(
            (w[gi][:, None] / max(w[gi].mean(), 1e-9)).astype(np.float32)).to(device)
        out = fit_regression(
            gs, y, family="susie", L=L,
            llik=lambda yy, ee, wg=wg: weighted_gaussian_llik(yy, ee, wg),
            config=SgvbConfig(num_steps=num_steps, learning_rate=0.02, seed=seed),
            device=device,
        )
        pips.append(out["pip"][:, 0])
        effects.append(out["theta_mean"][:, 0])
    return {"pip": np.stack(pips), "effect": np.stack(effects)}


def pseudobulk_celltype_log_rates(
    counts_gn,
    cell_indv: np.ndarray,
    n_indv: int,
    membership_nc: np.ndarray,  # [N, C] soft cell-type membership
    *,
    a0: float = 1.0,
    b0: float = 1.0,
    device="cuda",
):
    """Per-(celltype, gene, individual) Gamma posterior log-rates with
    membership-weighted sufficient statistics: returns (log_mean [C, G, I],
    precision weights [C, G, I], effective cell weight [C, I])."""
    c = membership_nc.shape[1]
    sums = pseudobulk_sums(counts_gn, cell_indv, n_indv, membership_nc, device=device)
    sizes = np.zeros((c, n_indv))
    for ci in range(c):
        np.add.at(sizes[ci], cell_indv, membership_nc[:, ci])
    log_mean, prec = _log_rates(sums, sizes[:, None, :], a0, b0)
    return log_mean, prec, sizes


def fit_qtl_sgvb(
    counts_gn,
    cell_indv: np.ndarray,
    genotypes: np.ndarray,  # [I, P]
    *,
    membership_nc: np.ndarray | None = None,  # [N, C]; None = one bulk type
    celltype_names: list | None = None,
    model: str = "susie",
    prior_type: str = "single",
    prior_vars=None,
    L: int = 3,
    num_steps: int = 800,
    min_weight: float = 2.0,
    gene_tss: np.ndarray | None = None,  # [G] bp (cis mode)
    var_pos: np.ndarray | None = None,  # [P] bp (cis mode)
    cis_window: int = 1_000_000,
    a0: float = 1.0,
    b0: float = 1.0,
    learning_rate: float = 0.02,
    mc_samples: int = 8,
    # per-individual covariates [I, K], residualized out of the
    # pseudobulk log-rates before the fit
    covariates_i: np.ndarray | None = None,
    # append the per-individual cell-type composition fractions to the
    # covariates
    composition_covariates: bool = False,
    # cross-gene empirical Bayes on the prior-variance grid: pool every
    # gene's grid ELBOs, pick one variance, report each gene's fit at it
    empirical_bayes: bool = False,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Per-(celltype, gene) SGVB eQTL fine-mapping on membership-weighted
    pseudobulk: model family and prior grid / ash, with optional cis-window
    variant subsets and a least effective cell weight per (individual,
    cell type)."""
    n_indv = genotypes.shape[0]
    if membership_nc is None:
        membership_nc = np.ones((counts_gn.shape[1], 1), np.float32)
    c = membership_nc.shape[1]
    names = celltype_names or [f"ct{j}" for j in range(c)]
    grid = list(prior_vars) if prior_vars else [0.01, 0.1, 1.0]
    log_mu, prec, eff = pseudobulk_celltype_log_rates(
        counts_gn, cell_indv, n_indv, membership_nc, a0=a0, b0=b0, device=device
    )
    gs = (genotypes - np.nanmean(genotypes, 0)) / np.maximum(np.nanstd(genotypes, 0), 1e-8)
    gs = np.nan_to_num(gs)

    cov = None
    if covariates_i is not None:
        cov = np.asarray(covariates_i, np.float64)
    if composition_covariates and c > 1:
        frac = eff.T / np.maximum(eff.sum(0)[:, None], 1e-9)  # [I, C]
        cov = frac if cov is None else np.concatenate([cov, frac], 1)

    def residualize(y, keep_i):
        if cov is None:
            return y
        z = cov[keep_i]
        z = np.concatenate([np.ones((len(z), 1)), z], 1)
        beta, *_ = np.linalg.lstsq(z, y, rcond=None)
        return y - z @ beta

    rows = {"celltype": [], "gene": [], "variant": [], "pip": [],
            "effect": [], "prior_var": []}
    g = counts_gn.shape[0]
    eb_stash = []  # (meta, per-variance fits) for the empirical-Bayes pass
    for ci in range(c):
        keep_i = np.flatnonzero(eff[ci] >= min_weight)
        if keep_i.size < 3:
            log.info("fit-qtl-sgvb: %s has <3 usable individuals; skipped", names[ci])
            continue
        for gi in range(g):
            cols = (
                np.flatnonzero(np.abs(var_pos - gene_tss[gi]) <= cis_window)
                if gene_tss is not None and var_pos is not None
                else np.arange(gs.shape[1])
            )
            if cols.size == 0:
                continue
            x = gs[np.ix_(keep_i, cols)]
            y = log_mu[ci, gi, keep_i]
            y = residualize((y - y.mean())[:, None], keep_i)
            w = prec[ci, gi, keep_i][:, None]
            w = torch.from_numpy((w / max(w.mean(), 1e-9)).astype(np.float32)).to(device)
            cfg = SgvbConfig(num_steps=num_steps, learning_rate=learning_rate,
                             num_samples=mc_samples, seed=seed)
            llik = lambda yy, ee, w=w: weighted_gaussian_llik(yy, ee, w)  # noqa: E731
            if prior_type == "ash":
                out = fit_regression_ash(x, y, prior_vars=grid, llik=llik, config=cfg,
                                         device=device)
                out["prior_var"] = float("nan")
            elif empirical_bayes:
                fits = [
                    fit_regression(x, y, family=model, L=L, llik=llik,
                                   config=dataclasses.replace(cfg, prior_var=float(v)),
                                   device=device)
                    for v in grid
                ]
                eb_stash.append((names[ci], gi, cols, fits))
                continue
            else:
                out = fit_regression_grid(x, y, prior_vars=grid, family=model, L=L, llik=llik,
                                          config=cfg, device=device)
            _emit(rows, names[ci], gi, cols, out)
    if eb_stash:
        pooled = np.zeros(len(grid))
        for _, _, _, fits in eb_stash:
            pooled += np.asarray([f["elbo"] for f in fits])
        v_star = int(np.argmax(pooled))
        log.info("empirical Bayes: pooled grid ELBOs over %d fits pick prior_var=%g",
                 len(eb_stash), grid[v_star])
        for ct, gi, cols, fits in eb_stash:
            out = dict(fits[v_star])
            out["prior_var"] = float(grid[v_star])
            _emit(rows, ct, gi, cols, out)
    return rows


def _emit(rows, ct, gi, cols, out):
    pip = np.asarray(out["pip"]).reshape(-1)
    rows["celltype"].extend([ct] * len(cols))
    rows["gene"].extend([gi] * len(cols))
    rows["variant"].extend(np.asarray(cols).tolist())
    rows["pip"].extend(pip.tolist())
    rows["effect"].extend(np.asarray(out["theta_mean"])[:, 0].tolist())
    rows["prior_var"].extend([float(out.get("prior_var", float("nan")))] * len(cols))


def simulate_qtl_full(
    genotypes: np.ndarray,  # [I, P] dosages (PLINK panel or synthetic)
    var_pos: "np.ndarray | None" = None,
    *,
    n_genes: int = 50,
    gene_tss: "np.ndarray | None" = None,  # [G] bp (cis mode)
    n_cell_types: int = 5,
    n_factors: int = 5,
    gene_loading_std: float = 0.5,
    factor_score_std: float = 0.5,
    eqtl_gene_proportion: float = 0.5,
    shared_eqtl_proportion: float = 0.5,
    independent_eqtl_proportion: float = 0.5,
    n_shared_causal: int = 1,
    n_independent_causal: int = 1,
    genetic_variance: float = 0.3,
    cis_window: int = 1_000_000,
    pve_cell_type: float = 0.3,
    mean_cells_per_individual: float = 50.0,
    depth_per_cell: float = 2000.0,
    dirichlet_alpha: "list | None" = None,
    seed: int = 42,
) -> dict:
    """Single-cell eQTL generator with cell types, a factor model across
    individuals and shared / cell-type-specific causal variants:

      log-rate[g, cell] = mu_g + sqrt(pve_ct) * ct_effect[g, ct(cell)]
                        + factor model (loadings @ scores[indv])
                        + genetic term (scaled to `genetic_variance`)
      counts ~ Multinomial(depth_per_cell, softmax over genes) per cell

    The same arrays as the JAX package's for the same seed. Returns counts
    [G, N], cell_indv, cell_type and the truth."""
    rng = np.random.default_rng(seed)
    n_indv, p = genotypes.shape
    gs = np.nan_to_num(
        (genotypes - np.nanmean(genotypes, 0))
        / np.maximum(np.nanstd(genotypes, 0), 1e-8)
    )

    n_cells_i = rng.poisson(mean_cells_per_individual, n_indv).clip(min=1)
    cell_indv = np.repeat(np.arange(n_indv), n_cells_i)
    n = len(cell_indv)
    alpha = (
        np.asarray(dirichlet_alpha, np.float64)
        if dirichlet_alpha else np.ones(n_cell_types)
    )
    frac_i = rng.dirichlet(alpha, n_indv)  # [I, C]
    cell_type = np.concatenate([
        rng.choice(n_cell_types, k, p=frac_i[i])
        for i, k in enumerate(n_cells_i)
    ])

    is_egene = rng.uniform(size=n_genes) < eqtl_gene_proportion
    truth = []
    genetic_i = np.zeros((n_genes, n_cell_types, n_indv))
    for gi in range(n_genes):
        if not is_egene[gi]:
            continue
        if gene_tss is not None and var_pos is not None:
            cand = np.flatnonzero(np.abs(var_pos - gene_tss[gi]) <= cis_window)
        else:
            cand = np.arange(p)
        if cand.size == 0:
            continue
        if rng.uniform() < shared_eqtl_proportion:
            for v in rng.choice(cand, min(n_shared_causal, cand.size), replace=False):
                b = rng.normal()
                genetic_i[gi, :, :] += b * gs[:, v][None, :]
                truth.append((gi, -1, int(v), float(b), "shared"))
        if rng.uniform() < independent_eqtl_proportion:
            for v in rng.choice(cand, min(n_independent_causal, cand.size), replace=False):
                ct = int(rng.integers(n_cell_types))
                b = rng.normal()
                genetic_i[gi, ct, :] += b * gs[:, v]
                truth.append((gi, ct, int(v), float(b), "independent"))

    loadings = rng.normal(0, gene_loading_std, (n_genes, n_factors))
    scores = rng.normal(0, factor_score_std, (n_factors, n_indv))
    indiv_term = loadings @ scores  # [G, I]
    ct_effect = rng.normal(0, 1.0, (n_genes, n_cell_types))
    mu_g = rng.normal(0, 0.5, n_genes)

    non_gen = (
        np.sqrt(pve_cell_type) * ct_effect[:, cell_type]
        + np.sqrt(1 - pve_cell_type) * indiv_term[:, cell_indv]
    )  # [G, N]
    gen_cells = genetic_i[:, cell_type, cell_indv]  # [G, N]
    gvar = gen_cells.var(1)
    rvar = non_gen.var(1)
    scale = np.where(
        gvar > 1e-12,
        np.sqrt(genetic_variance / max(1 - genetic_variance, 1e-6)
                * np.maximum(rvar, 1e-12) / np.maximum(gvar, 1e-12)),
        0.0,
    )
    log_rate = mu_g[:, None] + non_gen + scale[:, None] * gen_cells
    prob = np.exp(log_rate - log_rate.max(0, keepdims=True))
    prob /= prob.sum(0, keepdims=True)
    counts = np.stack([
        rng.multinomial(int(rng.poisson(depth_per_cell)), prob[:, j])
        for j in range(n)
    ], axis=1).astype(np.float32)
    return {
        "counts": counts, "cell_indv": cell_indv,
        "cell_type": cell_type,
        "truth": truth, "frac_i": frac_i,
    }
