"""Second-order model-X knockoffs (matrix-util `knockoff.rs` +
chickpea's GhostKnockoff FDR filter, `chickpea/src/p2g/knockoff.rs`).

Equi-correlated construction: for standardized X with correlation S,
knockoffs satisfy cov([X, X~]) = [[S, S - diag(s)], [S - diag(s), S]]
with s_j = min(1, 2 lambda_min(S)). Sampling is Gaussian conditional —
dense matmuls + one Cholesky, all device-friendly.

`knockoff_filter` computes the Barber-Candes threshold on feature
statistics W (e.g. |beta_j| - |beta~_j|).
"""

from __future__ import annotations

import numpy as np


def knockoff_s_equicorrelated(s_corr: np.ndarray) -> np.ndarray:
    """Equicorrelated s: s_j = clamp(2 lambda_min(Sigma), 0, 1) for all j."""
    p = s_corr.shape[0]
    lam_min = float(np.linalg.eigvalsh(s_corr)[0])
    return np.full(p, min(1.0, 2.0 * max(lam_min, 0.0)))


def _knockoff_s_coordinate(s_corr: np.ndarray, objective: str) -> np.ndarray:
    """Coordinate descent shared by MVR and ME (Spector & Janson 2020;
    matrix-util knockoff.rs:91 solve_coordinate).

    Both objectives separate into a tr/logdet term in M = 2 Sigma - D
    plus a barrier in s, with closed-form 1-D minimizers:
      MVR  (min tr(M^-1) + sum 1/s_j):  s_j <- (1 + s_j m_jj) / (sqrt(c_j) + m_jj)
      ME   (min -logdet M - sum log s_j): s_j <- (1 + s_j m_jj) / (2 m_jj)
    with m_jj = (M^-1)_jj and c_j = ||M^-1 e_j||^2. M^-1 is refreshed
    exactly once per sweep and Sherman-Morrison rank-1 updated within
    the sweep (Gauss-Seidel), so later coordinates see the current
    iterate without inverse drift accumulating across sweeps.
    """
    p = s_corr.shape[0]
    if p == 0:
        return np.zeros(0)
    two_sigma = 2.0 * s_corr
    lam_min = float(np.linalg.eigvalsh(s_corr)[0])
    if lam_min <= 1e-10:
        # Sigma not PD enough for an interior start; equi fallback.
        return knockoff_s_equicorrelated(s_corr)
    # feasible interior start: M = 2 Sigma - D > 0 with margin
    s = np.full(p, np.clip(2.0 * lam_min, 1e-6, 1.0) * 0.5)

    for _ in range(50):
        m = two_sigma - np.diag(s)
        try:
            minv = np.linalg.inv(m)
        except np.linalg.LinAlgError:
            break  # hit the boundary; keep the last feasible s
        max_delta = 0.0
        for j in range(p):
            m_jj = float(minv[j, j])
            if not np.isfinite(m_jj) or m_jj <= 1e-12:
                continue
            s_old = float(s[j])
            if objective == "me":
                s_target = (1.0 + m_jj * s_old) / (2.0 * m_jj)
            else:  # mvr
                c_j = float(minv[:, j] @ minv[:, j])
                s_target = (1.0 + m_jj * s_old) / (np.sqrt(c_j) + m_jj)
            # delta keeps M - delta e_j e_j^T > 0 iff delta < 1/m_jj
            delta = min(s_target - s_old, 0.99 / m_jj)
            delta = max(delta, 1e-8 - s_old)  # keep s_j > 0
            if abs(delta) < 1e-15:
                continue
            denom = 1.0 - delta * m_jj
            if denom <= 1e-12:
                continue
            # Sherman-Morrison: (M - d e e^T)^-1 = M^-1 + (d/denom) u u^T
            u = minv[:, j].copy()
            minv += (delta / denom) * np.outer(u, u)
            s[j] = s_old + delta
            max_delta = max(max_delta, abs(delta))
        if max_delta < 1e-8:
            break
    return s


def second_order_knockoffs(
    x: np.ndarray, *, seed: int = 0, eps: float = 1e-4, s_method: str = "equi"
) -> np.ndarray:
    """Gaussian second-order knockoffs. `eps` is the correlation ridge
    (chickpea --ko-ridge); `s_method` picks the diag(s) construction
    (chickpea --ko-s KoSMethod): "equi" equicorrelated closed form,
    "mvr" minimum-variance-reconstructability, or "me" maximum-entropy
    — both solved by the shared closed-form coordinate descent
    (knockoff.rs:50,91)."""
    rng = np.random.default_rng(seed)
    n, p = x.shape
    xs = (x - x.mean(0)) / np.maximum(x.std(0), 1e-8)
    s_corr = np.corrcoef(xs, rowvar=False)
    s_corr = (s_corr + s_corr.T) / 2 + eps * np.eye(p)

    if s_method in ("me", "mvr"):
        s_diag = _knockoff_s_coordinate(s_corr, s_method)
    else:
        s_diag = knockoff_s_equicorrelated(s_corr) * (1 - eps)

    sinv = np.linalg.inv(s_corr)
    # conditional mean: X (I - Sinv diag(s)); conditional cov:
    # 2 diag(s) - diag(s) Sinv diag(s)
    mean = xs @ (np.eye(p) - sinv * s_diag[None, :])
    cov = 2 * np.diag(s_diag) - (s_diag[:, None] * sinv) * s_diag[None, :]
    cov = (cov + cov.T) / 2 + eps * np.eye(p)
    chol = np.linalg.cholesky(cov)
    return mean + rng.standard_normal((n, p)) @ chol.T


def knockoff_filter(w: np.ndarray, fdr: float = 0.1, *, offset: int = 1) -> tuple[float, np.ndarray]:
    """Barber-Candes threshold: smallest t with
    (offset + #{W <= -t}) / #{W >= t} <= fdr. Returns (threshold,
    selected mask)."""
    w = np.asarray(w, np.float64)
    ts = np.sort(np.abs(w[w != 0]))
    for t in ts:
        num = offset + np.sum(w <= -t)
        den = max(np.sum(w >= t), 1)
        if num / den <= fdr:
            return float(t), w >= t
    return float("inf"), np.zeros_like(w, bool)
