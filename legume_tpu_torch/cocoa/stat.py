"""CoCoA sufficient statistics and the per-topic Gamma fit (the port of
the JAX package's `cocoa/stat.py`).

Model, per topic k:

    shared     mu(d,p)    = (y1 + y0) / (sum_i tau(d,i) n(i,p) + gamma(d,p) n(p))
    matched    gamma(d,p) = y0 / (mu(d,p) n(p))
    exposure   tau(d,i)   = y1(d,i) / (sum_p mu(d,p) n(i,p))

The coordinate descent runs on the device for all topics at once (the
JAX package vmaps it over topics). The exposure contrast is the mean
log tau difference between exposure groups, averaged over topics.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.gamma import GammaParam, digamma


@dataclass
class CocoaStat:
    """[K, D, P] / [K, D, I] sufficient-statistic planes (host arrays)."""

    y1_sum_kdp: np.ndarray  # topic x gene x pseudobulk
    y0_sum_kdp: np.ndarray
    size_kp: np.ndarray  # topic x pseudobulk
    y1_sum_kdi: np.ndarray  # topic x gene x individual
    size_kip: np.ndarray  # topic x individual x pseudobulk

    @classmethod
    def zeros(cls, n_topics, n_genes, n_indv, n_samples):
        return cls(
            y1_sum_kdp=np.zeros((n_topics, n_genes, n_samples), np.float32),
            y0_sum_kdp=np.zeros((n_topics, n_genes, n_samples), np.float32),
            size_kp=np.zeros((n_topics, n_samples), np.float32),
            y1_sum_kdi=np.zeros((n_topics, n_genes, n_indv), np.float32),
            size_kip=np.zeros((n_topics, n_indv, n_samples), np.float32),
        )

    def apply_gene_weights(self, w: np.ndarray):
        """Row-scale y1, y0 and y1_di by the NB-Fisher gene weights."""
        w = np.asarray(w, np.float32)[None, :, None]
        self.y1_sum_kdp = self.y1_sum_kdp * w
        self.y0_sum_kdp = self.y0_sum_kdp * w
        self.y1_sum_kdi = self.y1_sum_kdi * w


@dataclass
class CocoaGammaOut:
    shared: GammaParam  # [K, D, P]
    residual: GammaParam  # [K, D, P]
    exposure: GammaParam  # [K, D, I]


def _optimize_topics(y1_kdp, y0_kdp, size_kp, y1_kdi, size_kip, *, n_opt_iter: int,
                     a0=1.0, b0=1.0):
    """Coordinate descent over all topics at once (batched matmuls)."""
    y10 = y1_kdp + y0_kdp
    gamma_mean = torch.zeros_like(y1_kdp)
    tau_mean = torch.zeros_like(y1_kdi)
    mu_b = g_b = torch.ones_like(y1_kdp)
    t_b = torch.ones_like(y1_kdi)
    n_p = size_kp[:, None, :]
    for _ in range(n_opt_iter):
        mu_b = b0 + gamma_mean * n_p + tau_mean @ size_kip
        mu_mean = (a0 + y10) / mu_b
        g_b = b0 + mu_mean * n_p
        gamma_mean = (a0 + y0_kdp) / g_b
        t_b = b0 + mu_mean @ size_kip.transpose(1, 2)
        tau_mean = (a0 + y1_kdi) / t_b
    return (a0 + y10, mu_b), (a0 + y0_kdp, g_b), (a0 + y1_kdi, t_b)


def estimate_parameters(
    stat: CocoaStat, *, n_opt_iter: int = 100, a0: float = 1.0, b0: float = 1.0,
    device="cuda",
) -> CocoaGammaOut:
    t = lambda x: torch.from_numpy(np.array(x, np.float32)).to(device)  # noqa: E731
    (mu_a, mu_b), (g_a, g_b), (t_a, t_b) = _optimize_topics(
        t(stat.y1_sum_kdp), t(stat.y0_sum_kdp), t(stat.size_kp), t(stat.y1_sum_kdi),
        t(stat.size_kip), n_opt_iter=n_opt_iter, a0=a0, b0=b0,
    )
    return CocoaGammaOut(
        shared=GammaParam(a=mu_a, b=mu_b, a0=a0, b0=b0),
        residual=GammaParam(a=g_a, b=g_b, a0=a0, b0=b0),
        exposure=GammaParam(a=t_a, b=t_b, a0=a0, b0=b0),
    )


def exposure_log_means(out: CocoaGammaOut) -> np.ndarray:
    """[K, D, I] posterior log-means of tau."""
    return (digamma(out.exposure.a) - torch.log(out.exposure.b)).cpu().numpy()


def compute_exposure_contrast(out: CocoaGammaOut, exposure_assignment: np.ndarray) -> np.ndarray:
    """Per-gene signed log contrast mean(log tau | x = 1) - mean(log tau |
    x = 0), averaged over topics."""
    tau_log = exposure_log_means(out)
    x = np.asarray(exposure_assignment)
    m1 = tau_log[:, :, x == 1].mean(axis=2)
    m0 = tau_log[:, :, x == 0].mean(axis=2)
    return (m1 - m0).mean(axis=0)


def z_to_pvalue(z: np.ndarray) -> np.ndarray:
    """Two-sided normal p-value."""
    from scipy.special import erfc

    return erfc(np.abs(z) / np.sqrt(2.0))


def remove_exposure_effect_from_topic_proportions(
    cell_topic_nk: np.ndarray,
    cell_to_individual: np.ndarray,
    individual_exposure: np.ndarray,
    covariates: np.ndarray | None = None,  # [I, C] known individual covariates
) -> tuple[np.ndarray, np.ndarray]:
    """Residual collider adjustment: scale each cell's topic proportions
    by exp(-(group mean - grand mean)) of the per-individual mean log
    proportions. With `covariates` the removed shift is the OLS-fitted
    part of the per-individual logits on [1, exposure, V] minus the
    intercept. Returns (adjusted proportions, per-topic max |shift|)."""
    z = np.asarray(cell_topic_nk, np.float64)
    c2i = np.asarray(cell_to_individual)
    n_indv = len(individual_exposure)
    log_z = np.log(np.maximum(z, 1e-30))
    sums = np.zeros((n_indv, z.shape[1]))
    counts = np.zeros(n_indv)
    ok = c2i < n_indv
    np.add.at(sums, c2i[ok], log_z[ok])
    np.add.at(counts, c2i[ok], 1.0)
    indv_logits = sums / np.maximum(counts[:, None], 1.0)

    groups = np.asarray(individual_exposure)
    out = z.copy()
    if covariates is not None:
        v = np.asarray(covariates, np.float64)
        if v.ndim == 1:
            v = v[:, None]
        design = np.column_stack([np.ones(n_indv), groups.astype(np.float64), v])
        beta, *_ = np.linalg.lstsq(design, indv_logits, rcond=None)
        shift_i = design[:, 1:] @ beta[1:]
        shift_i = shift_i - shift_i.mean(axis=0, keepdims=True)
        out[ok] *= np.exp(-shift_i)[c2i[ok]]
        return out.astype(np.float32), np.abs(shift_i).max(axis=0)

    n_groups = groups.max() + 1
    group_means = np.stack([indv_logits[groups == g].mean(axis=0) for g in range(n_groups)])
    shift = group_means - indv_logits.mean(axis=0, keepdims=True)  # [G, K]
    out[ok] *= np.exp(-shift)[groups[c2i[ok]]]
    return out.astype(np.float32), np.abs(shift).max(axis=0)
