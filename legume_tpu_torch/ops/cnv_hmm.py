"""Copy-number HMM on genomic segments (the port of the JAX package's
`ops/cnv_hmm.py`).

Gaussian emissions with a per-sample scale alpha and variance sigma^2
over relative copy-number states (for example means [-0.5, 0, 0.3]).
Forward-backward and Viterbi run in log space as loops over segments,
every sample of a batch at once (the JAX package's scan vmapped over
samples), in float32 on the device.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class CnvHmmParams:
    emission_means: np.ndarray  # [K]
    log_trans: np.ndarray  # [K, K]
    log_pi: np.ndarray  # [K]

    @classmethod
    def new(cls, emission_means, transition_prob: float = 1e-4, neutral_idx: int | None = None):
        means = np.asarray(emission_means, np.float32)
        k = len(means)
        if neutral_idx is None:
            neutral_idx = int(np.argmin(np.abs(means)))
        trans = np.full((k, k), transition_prob / max(k - 1, 1))
        np.fill_diagonal(trans, 1.0 - transition_prob)
        pi = np.full(k, 0.05 / max(k - 1, 1))
        pi[neutral_idx] = 0.95
        return cls(emission_means=means, log_trans=np.log(trans).astype(np.float32),
                   log_pi=np.log(pi).astype(np.float32))

    @classmethod
    def default_3state(cls):
        """{del, neutral, gain}."""
        return cls.new(np.asarray([-0.5, 0.0, 0.3]))

    @classmethod
    def from_kmeans_bic(cls, values: np.ndarray, k_range=(3, 5, 6), *,
                        transition_prob: float = 1e-4, seed: int = 0,
                        device="cuda") -> "CnvHmmParams":
        """State means from the marginal signal: 1-D k-means per candidate
        K, the soft Gaussian-mixture log-likelihood at the k-means
        statistics, BIC with 3K - 1 free parameters; the smallest BIC
        wins and its sorted means seed the states."""
        v = np.asarray(values, np.float64).ravel()
        n = len(v)
        best = None
        for k in k_range:
            if k <= 1 or k > n:
                continue
            means, _, _, ll = _kmeans_component_stats(v, k, seed, device)
            bic = -2.0 * ll + (3 * k - 1) * np.log(max(n, 1))
            if best is None or bic < best[0]:
                best = (bic, means)
        if best is None:
            return cls.default_3state()
        return cls.new(np.sort(best[1]).astype(np.float32), transition_prob=transition_prob)

    @property
    def n_states(self):
        return len(self.emission_means)


def _log_emissions(means, y, alpha, sigma_sq):
    """[B, S, K] Gaussian log density of y [B, S] around alpha * mu_k
    (alpha, sigma_sq: [B])."""
    mu = alpha[:, None, None] * means[None, None, :]
    s2 = sigma_sq[:, None, None]
    return -0.5 * ((y[:, :, None] - mu) ** 2 / s2 + torch.log(2 * math.pi * s2))


def _forward_backward(log_pi, log_trans, log_emit):
    """Posteriors [B, S, K] and log-likelihoods [B]."""
    b, s, k = log_emit.shape
    alphas = torch.empty_like(log_emit)
    alphas[:, 0] = log_pi + log_emit[:, 0]
    for t in range(1, s):
        alphas[:, t] = torch.logsumexp(alphas[:, t - 1, :, None] + log_trans, dim=1) + log_emit[:, t]
    betas = torch.zeros_like(log_emit)
    for t in range(s - 2, -1, -1):
        betas[:, t] = torch.logsumexp(log_trans + (log_emit[:, t + 1] + betas[:, t + 1])[:, None, :],
                                      dim=2)
    log_post = alphas + betas
    loglik = torch.logsumexp(alphas[:, -1], dim=1)
    post = torch.exp(log_post - torch.logsumexp(log_post, dim=2, keepdim=True))
    return post, loglik


def _viterbi(log_pi, log_trans, log_emit):
    """Most likely paths [B, S] by max-product."""
    b, s, k = log_emit.shape
    delta = log_pi + log_emit[:, 0]
    backs = []
    for t in range(1, s):
        scores = delta[:, :, None] + log_trans
        backs.append(torch.argmax(scores, dim=1))
        delta = torch.max(scores, dim=1).values + log_emit[:, t]
    path = torch.empty(b, s, dtype=torch.int64, device=log_emit.device)
    state = torch.argmax(delta, dim=1)
    path[:, -1] = state
    rows = torch.arange(b, device=log_emit.device)
    for t in range(s - 2, -1, -1):
        state = backs[t][rows, state]
        path[:, t] = state
    return path


def _params_on(params: CnvHmmParams, device):
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    return t(params.emission_means), t(params.log_pi), t(params.log_trans)


@dataclass
class HmmResult:
    posteriors: np.ndarray  # [S, K]
    viterbi_path: np.ndarray  # [S]
    log_likelihood: float


def infer_sample(params: CnvHmmParams, y: np.ndarray, alpha: float = 1.0,
                 sigma_sq: float = 0.04, *, device="cuda") -> HmmResult:
    means, log_pi, log_trans = _params_on(params, device)
    yt = torch.as_tensor(np.asarray(y, np.float32), device=device)[None]
    emit = _log_emissions(means, yt, torch.full((1,), float(alpha), device=device),
                          torch.full((1,), float(sigma_sq), device=device))
    post, ll = _forward_backward(log_pi, log_trans, emit)
    path = _viterbi(log_pi, log_trans, emit)
    return HmmResult(posteriors=post[0].cpu().numpy(), viterbi_path=path[0].cpu().numpy(),
                     log_likelihood=float(ll[0]))


def fit_em(params: CnvHmmParams, y_samples: np.ndarray, *, n_iter: int = 20,
           min_sigma: float = 1e-3, device="cuda") -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Per-sample (alpha, sigma^2) EM with shared states over y [B, S].
    Returns (alpha [B], sigma_sq [B], posteriors [B, S, K])."""
    means, log_pi, log_trans = _params_on(params, device)
    y = torch.as_tensor(np.asarray(y_samples, np.float32), device=device)
    b = y.shape[0]
    alpha = torch.ones(b, device=device)
    sigma = torch.full((b,), 0.04, device=device)

    def one(alpha, sigma):
        post, _ = _forward_backward(log_pi, log_trans, _log_emissions(means, y, alpha, sigma))
        mu_s = post @ means  # [B, S] expected state mean
        denom = torch.clamp_min((post @ means**2).sum(1), 1e-8)
        alpha_new = torch.clamp((y * mu_s).sum(1) / denom, 0.1, 10.0)
        resid = y - alpha_new[:, None] * mu_s
        return alpha_new, torch.clamp_min((resid**2).mean(1), min_sigma), post

    for _ in range(n_iter):
        alpha, sigma, _ = one(alpha, sigma)
    _, _, post = one(alpha, sigma)
    return alpha.cpu().numpy(), sigma.cpu().numpy(), post.cpu().numpy()


def viterbi_batch(params: CnvHmmParams, y_samples: np.ndarray, alpha: np.ndarray,
                  sigma_sq: np.ndarray, *, device="cuda") -> np.ndarray:
    """Viterbi paths [B, S] of y [B, S] under each sample's (alpha, sigma^2)."""
    means, log_pi, log_trans = _params_on(params, device)
    t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
    emit = _log_emissions(means, t(y_samples), t(alpha), t(sigma_sq))
    return _viterbi(log_pi, log_trans, emit).cpu().numpy()


def _kmeans_component_stats(v: np.ndarray, k: int, seed: int, device):
    """1-D k-means component fit: (means, variances, weights) from the
    hard assignment and the soft Gaussian-mixture log-likelihood at them."""
    from .kmeans import kmeans

    _, labels = kmeans(v[:, None].astype(np.float32), k, seed=seed, device=device)
    means = np.zeros(k)
    variances = np.full(k, 1e-4)
    weights = np.zeros(k)
    for j in range(k):
        sel = labels == j
        if sel.any():
            means[j] = v[sel].mean()
            variances[j] = max(float(v[sel].var()), 1e-4)
            weights[j] = sel.mean()
    log_p = (np.log(np.maximum(weights, 1e-30))[None, :]
             - 0.5 * ((v[:, None] - means[None, :]) ** 2 / variances[None, :]
                      + np.log(2 * np.pi * variances[None, :])))
    mx = log_p.max(1, keepdims=True)
    ll = float((mx[:, 0] + np.log(np.exp(log_p - mx).sum(1))).sum())
    return means, variances, weights, ll
