"""Black-box stochastic-gradient variational Bayes for regression and
fine-mapping (the port of the JAX package's `models/sgvb.py`).

- likelihoods evaluate log p(y | eta) on S sampled linear predictors;
- variational families expose elementwise moments (mean, var), so the
  linear predictor is sampled in eta-space (local reparameterization):
      eta ~ N(X E[theta], X^2 Var[theta]);
- priors give the KL from q analytically.

Families: mean-field Gaussian, spike-slab, SuSiE (with or without the
null absorber), BiSuSiE (selection shared across traits), multilevel
SuSiE (block x within-block selection) and the ash mixture prior over a
spike-slab q. Likelihoods: Gaussian, weighted Gaussian, Poisson, NB, vMF
and RSS (summary statistics through the eigenspace design `RssDesign`).

The trainer draws the JAX package's key schedule: `key(seed)`, one split
for the init (drawn on the host with `prng.normal_exact`, bit-equal to
`jax.random.normal`), one split a step whose normal draw of shape
[S, n, k] is made on the device with `prng.normal_exact_keys` (bit-equal
as well, on the CPU and the card), and the final ELBO at
`key(seed ^ 0x5EED)`. The step keys are split on the host once, and the
draws are made on the device in blocks of steps. Adam is optax's `adam`
on one flat buffer; on the card each step is a CUDA graph's replay; the
loss is read back every 50 steps, as the JAX package reads it.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, NamedTuple

import numpy as np
import torch

from ..utils import prng

_DRAW_VALUES = 1 << 22  # normal draws made on the device at once (steps x S x n x k)

# ----------------------------------------------------------------------------
# variational families
# ----------------------------------------------------------------------------


def _softmax(x, dim: int):
    """softmax as `jax.nn.softmax` forms it: exp(x - max) / sum, the max a
    constant of the gradient. (torch's CPU softmax kernels open a thread
    team on every call, which stalls when processes share the cores.)"""
    e = torch.exp(x - x.amax(dim=dim, keepdim=True).detach())
    return e / e.sum(dim=dim, keepdim=True)


def _log_softmax(x, dim: int):
    """log-softmax as `jax.nn.log_softmax` forms it: (x - max) - log(sum)."""
    shifted = x - x.amax(dim=dim, keepdim=True).detach()
    return shifted - torch.log(torch.exp(shifted).sum(dim=dim, keepdim=True))


def smoothed_sigmoid(logits, epsilon=1e-3):
    """eps + (1 - 2 eps) sigmoid(x)."""
    return epsilon + (1.0 - 2.0 * epsilon) * torch.sigmoid(logits)


def _slab_kl(a, beta_mean, beta_ln_std, prior_var):
    var_b = torch.exp(2.0 * beta_ln_std)
    return torch.sum(
        a * 0.5 * ((var_b + beta_mean**2) / prior_var - 1.0 + float(np.log(np.float32(prior_var)))
                   - 2.0 * beta_ln_std)
    )


def _gate_kl(a, prior_pi):
    return torch.sum(
        a * (torch.log(a) - float(np.log(np.float32(prior_pi))))
        + (1 - a) * (torch.log1p(-a) - float(np.log(np.float32(1 - prior_pi))))
    )


def _init_normal(key, shape, device) -> torch.Tensor:
    return torch.from_numpy(np.float32(0.01) * prng.normal_exact(key, shape)).to(device)


class GaussianVarParams(NamedTuple):
    mean: torch.Tensor  # [p, k]
    ln_std: torch.Tensor  # [p, k]


def gaussian_var_init(key, p, k, scale=0.01, device="cpu"):
    return GaussianVarParams(
        mean=torch.from_numpy(np.float32(scale) * prng.normal_exact(key, (p, k))).to(device),
        ln_std=torch.full((p, k), -2.0, device=device),
    )


def gaussian_var_moments(q: GaussianVarParams):
    return q.mean, torch.exp(2.0 * q.ln_std)


def gaussian_var_kl(q: GaussianVarParams, prior_var: float = 1.0):
    """KL(N(mu, s^2) || N(0, v0)) summed."""
    var = torch.exp(2.0 * q.ln_std)
    return 0.5 * torch.sum(
        (var + q.mean**2) / prior_var - 1.0 + float(np.log(np.float32(prior_var))) - 2.0 * q.ln_std
    )


class SpikeSlabVarParams(NamedTuple):
    gate_logits: torch.Tensor  # [p, k]
    beta_mean: torch.Tensor  # [p, k]
    beta_ln_std: torch.Tensor  # [p, k]


def spike_slab_init(key, p, k, device="cpu"):
    return SpikeSlabVarParams(
        gate_logits=torch.zeros((p, k), device=device),
        beta_mean=_init_normal(key, (p, k), device),
        beta_ln_std=torch.full((p, k), -2.0, device=device),
    )


def spike_slab_moments(q: SpikeSlabVarParams):
    a = smoothed_sigmoid(q.gate_logits)
    var_b = torch.exp(2.0 * q.beta_ln_std)
    mean = a * q.beta_mean
    var = a * (var_b + q.beta_mean**2) - mean**2
    return mean, torch.clamp_min(var, 1e-12)


def spike_slab_kl(q: SpikeSlabVarParams, prior_pi: float = 0.1, prior_var: float = 1.0):
    a = smoothed_sigmoid(q.gate_logits)
    return _gate_kl(a, prior_pi) + _slab_kl(a, q.beta_mean, q.beta_ln_std, prior_var)


class SusieVarParams(NamedTuple):
    logits: torch.Tensor  # [L, p (+1 null), k]
    beta_mean: torch.Tensor  # [L, p, k]
    beta_ln_std: torch.Tensor  # [L, p, k]


def susie_init(key, L, p, k, *, with_null: bool = True, device="cpu"):
    return SusieVarParams(
        logits=torch.zeros((L, p + int(with_null), k), device=device),
        beta_mean=_init_normal(key, (L, p, k), device),
        beta_ln_std=torch.full((L, p, k), -2.0, device=device),
    )


def susie_alpha(q: SusieVarParams, p: int):
    """Selection probabilities over the real positions [L, p, k] (the null
    mass excluded)."""
    return _softmax(q.logits, dim=1)[:, :p, :]


def _single_effect_moments(a, q):
    var_b = torch.exp(2.0 * q.beta_ln_std)
    mean_l = a * q.beta_mean
    var_l = a * (var_b + q.beta_mean**2) - mean_l**2
    return mean_l.sum(0), torch.clamp_min(var_l, 1e-12).sum(0)


def susie_moments(q: SusieVarParams):
    return _single_effect_moments(susie_alpha(q, q.beta_mean.shape[1]), q)


def susie_pip(q: SusieVarParams):
    """Posterior inclusion probability 1 - prod_l (1 - alpha_l)."""
    a = susie_alpha(q, q.beta_mean.shape[1])
    return 1.0 - torch.prod(1.0 - a, dim=0)


def _categorical_kl(logits, p, q, prior_var):
    p_logits = logits.shape[1]
    full = _softmax(logits, dim=1)
    log_full = _log_softmax(logits, dim=1)
    kl_cat = torch.sum(full * (log_full + float(np.log(np.float32(p_logits)))))
    return kl_cat + _slab_kl(full[:, :p, :], q.beta_mean, q.beta_ln_std, prior_var)


def susie_kl(q: SusieVarParams, prior_var: float = 1.0):
    """Categorical-vs-uniform KL per component plus the alpha-weighted
    Gaussian KL."""
    return _categorical_kl(q.logits, q.beta_mean.shape[1], q, prior_var)


class BiSusieVarParams(NamedTuple):
    """BiSuSiE: selection shared across the k output traits, per-trait
    effect sizes."""

    logits: torch.Tensor  # [L, p (+1 null), 1] shared selection
    beta_mean: torch.Tensor  # [L, p, k]
    beta_ln_std: torch.Tensor  # [L, p, k]


def bisusie_init(key, L, p, k, *, with_null: bool = True, device="cpu"):
    return BiSusieVarParams(
        logits=torch.zeros((L, p + int(with_null), 1), device=device),
        beta_mean=_init_normal(key, (L, p, k), device),
        beta_ln_std=torch.full((L, p, k), -2.0, device=device),
    )


def bisusie_moments(q: BiSusieVarParams):
    p = q.beta_mean.shape[1]
    return _single_effect_moments(_softmax(q.logits, dim=1)[:, :p, :], q)


def bisusie_kl(q: BiSusieVarParams, prior_var: float = 1.0):
    return _categorical_kl(q.logits, q.beta_mean.shape[1], q, prior_var)


def bisusie_pip(q: BiSusieVarParams):
    p = q.beta_mean.shape[1]
    a = _softmax(q.logits, dim=1)[:, :p, 0]
    return 1.0 - torch.prod(1.0 - a, dim=0)


class MlSusieVarParams(NamedTuple):
    """Multilevel SuSiE: the per-effect selection is a categorical over LD
    blocks (plus a null block) times a categorical over the variants
    within the selected block."""

    block_logits: torch.Tensor  # [L, B + 1, k] (last block = null)
    within_logits: torch.Tensor  # [L, p, k]
    beta_mean: torch.Tensor  # [L, p, k]
    beta_ln_std: torch.Tensor  # [L, p, k]


def ml_susie_init(key, L, p, k, n_blocks, device="cpu"):
    return MlSusieVarParams(
        block_logits=torch.zeros((L, n_blocks + 1, k), device=device),
        within_logits=torch.zeros((L, p, k), device=device),
        beta_mean=_init_normal(key, (L, p, k), device),
        beta_ln_std=torch.full((L, p, k), -2.0, device=device),
    )


def _ml_susie_alpha(q: MlSusieVarParams, group_onehot: torch.Tensor):
    """alpha[l, j, k] = P(block of j) * P(j | block of j), the block sums
    and their spread back to the variants products with the one-hot [p, B]
    (a gather's backward would add with atomics, in no fixed order)."""
    b = group_onehot.shape[1]
    block_prob = _softmax(q.block_logits, dim=1)  # [L, B+1, k]
    # within-block softmax by segment normalization, shifted by the
    # global max (a constant of the gradient)
    w = q.within_logits
    e = torch.exp(w - w.max(dim=1, keepdim=True).values.detach())
    denom_b = torch.einsum("lpk,pb->lbk", e, group_onehot)  # [L, B, k]
    denom_p = torch.einsum("lbk,pb->lpk", denom_b, group_onehot)
    within_prob = e / torch.clamp_min(denom_p, 1e-30)
    blk_p = torch.einsum("lbk,pb->lpk", block_prob[:, :b, :], group_onehot)
    return blk_p * within_prob  # [L, p, k]; null mass = block_prob[:, b]


def ml_susie_moments(q: MlSusieVarParams, group_onehot):
    return _single_effect_moments(_ml_susie_alpha(q, group_onehot), q)


def ml_susie_kl(q: MlSusieVarParams, group_onehot, prior_var: float = 1.0):
    """KL of the factored categorical against uniform over p + 1 outcomes,
    plus the alpha-weighted Gaussian slab KL."""
    p = q.beta_mean.shape[1]
    b = group_onehot.shape[1]
    a = _ml_susie_alpha(q, group_onehot)
    null = _softmax(q.block_logits, dim=1)[:, b, :]  # [L, k]
    log_p1 = float(np.log(np.float32(p + 1.0)))
    kl_cat = torch.sum(a * (torch.log(torch.clamp_min(a, 1e-30)) + log_p1)) + torch.sum(
        null * (torch.log(torch.clamp_min(null, 1e-30)) + log_p1)
    )
    return kl_cat + _slab_kl(a, q.beta_mean, q.beta_ln_std, prior_var)


def ml_susie_pip(q: MlSusieVarParams, group_onehot):
    return 1.0 - torch.prod(1.0 - _ml_susie_alpha(q, group_onehot), dim=0)


def contiguous_ld_blocks(p: int, block_size: int | None = None) -> np.ndarray:
    """Positional LD blocks: contiguous windows of ~sqrt(p) variants."""
    if block_size is None:
        block_size = max(int(np.ceil(np.sqrt(p))), 2)
    return (np.arange(p) // block_size).astype(np.int32)


# family registry: (init, moments, kl)
FAMILIES = {
    "gaussian": (gaussian_var_init, gaussian_var_moments, gaussian_var_kl),
    "spike-slab": (spike_slab_init, spike_slab_moments, spike_slab_kl),
    "susie": (None, susie_moments, susie_kl),  # init needs L
    "bisusie": (None, bisusie_moments, bisusie_kl),
}


def cavi_susie(
    x: np.ndarray,  # [n, p] standardized design
    y: np.ndarray,  # [n]
    *,
    L: int = 5,
    prior_var: float = 0.2,
    obs_var: float | None = None,
    n_iter: int = 50,
) -> dict:
    """Exact SuSiE coordinate ascent (Wang et al. 2020): iterative
    Bayesian single-effect regressions on residuals, on the host.
    Returns alpha [L, p], posterior means, pip [p]."""
    n, p = x.shape
    y = np.asarray(y, np.float64).ravel()
    x = np.asarray(x, np.float64)
    xtx = (x * x).sum(0)  # [p]
    s2 = float(np.var(y)) if obs_var is None else obs_var

    alpha = np.full((L, p), 1.0 / p)
    mu = np.zeros((L, p))
    fitted = np.zeros(n)
    for _ in range(n_iter):
        for l in range(L):
            fitted -= x @ (alpha[l] * mu[l])
            r = y - fitted
            bhat = (x.T @ r) / np.maximum(xtx, 1e-12)
            shat2 = s2 / np.maximum(xtx, 1e-12)
            post_var = 1.0 / (1.0 / prior_var + 1.0 / shat2)
            post_mean = post_var * bhat / shat2
            # log Bayes factor per variable
            lbf = 0.5 * np.log(shat2 / (shat2 + prior_var)) + 0.5 * bhat**2 / shat2 * (
                prior_var / (prior_var + shat2)
            )
            lbf -= lbf.max()
            w = np.exp(lbf)
            alpha[l] = w / w.sum()
            mu[l] = post_mean
            fitted += x @ (alpha[l] * mu[l])
    pip = 1.0 - np.prod(1.0 - alpha, axis=0)
    return {"alpha": alpha, "mu": mu, "pip": pip, "beta": (alpha * mu).sum(0)}


# ----------------------------------------------------------------------------
# likelihoods: y [n, k], eta [S, n, k] -> [S]
# ----------------------------------------------------------------------------


def gaussian_llik(y, eta, obs_var=1.0):
    """log N(y | eta, v) summed over observations."""
    return -0.5 * torch.sum((y[None] - eta) ** 2 / obs_var, dim=(1, 2))


def weighted_gaussian_llik(y, eta, weights):
    """`weights` [n, k] a tensor on eta's device (a card's step is a captured
    graph, into which no host array can be copied)."""
    return -0.5 * torch.sum(weights[None] * (y[None] - eta) ** 2, dim=(1, 2))


def poisson_llik(y, eta):
    """y ~ Poisson(exp(eta))."""
    lam = torch.exp(torch.clamp(eta, -20.0, 20.0))
    return torch.sum(y[None] * eta - lam, dim=(1, 2))


def nb_llik(y, eta, log_phi=0.0):
    from .losses import nb_log_likelihood_elem

    mu = torch.exp(torch.clamp(eta, -20.0, 20.0))
    lp = log_phi if isinstance(log_phi, torch.Tensor) else eta.new_full((), float(log_phi))
    return torch.sum(nb_log_likelihood_elem(y[None], mu, lp), dim=(1, 2))


def vmf_llik(y, eta, kappa=10.0):
    """von Mises-Fisher likelihood on unit-normalized responses:
    kappa * <y_unit, eta_unit>, constants dropped (kappa fixed)."""
    y_unit = y / torch.clamp_min(torch.linalg.vector_norm(y, dim=-1, keepdim=True), 1e-8)
    eta_unit = eta / torch.clamp_min(torch.linalg.vector_norm(eta, dim=-1, keepdim=True), 1e-8)
    return kappa * torch.sum(y_unit[None] * eta_unit, dim=(1, 2))


@dataclass
class RssDesign:
    """Eigenspace RSS design: a fixed-variance Gaussian regression of
    `y_tilde` on `x_tilde` (host arrays)."""

    x_tilde: np.ndarray  # [K, p] = Dreg V'
    y_tilde: np.ndarray  # [K, T] = Dreg^-1 V' z

    @classmethod
    def from_genotypes(
        cls, x_geno: np.ndarray, z: np.ndarray, *,
        rank: int | None = None, lam: float = 0.1,
        ldsc_intercept: bool = True,
        pve_adjust: bool = True,
    ):
        """SVD of X/sqrt(n) -> R = V D^2 V'; Dreg = sqrt(D^2 + lam).

        `ldsc_intercept` estimates the per-trait confounding intercept a
        from E[(V'z)^2_k] = h d^2_k + a (clamped >= 1) and rescales z by
        1/sqrt(a) when inflated. `pve_adjust` applies the winner's-curse
        shrinkage z * sqrt((n-1)/(z^2+n-2))."""
        n, p = x_geno.shape
        xs = (x_geno - x_geno.mean(0)) / np.maximum(x_geno.std(0), 1e-8)
        u, d, vt = np.linalg.svd(xs / np.sqrt(n), full_matrices=False)
        if rank is not None:
            d, vt = d[:rank], vt[:rank]
        z = np.atleast_2d(np.asarray(z, np.float64).T).T  # [p, T]
        if pve_adjust and n > 2:
            z = z * np.sqrt((n - 1.0) / (z * z + n - 2.0))
        if ldsc_intercept and len(d) > 2:
            d_sq = d * d
            y_raw = vt @ z  # [K, T]
            mean_x = d_sq.mean()
            var_x = ((d_sq - mean_x) ** 2).sum()
            y2 = y_raw**2  # [K, T]
            mean_y = y2.mean(0)
            cov = ((d_sq - mean_x)[:, None] * (y2 - mean_y[None, :])).sum(0)
            slope = np.where(np.abs(var_x) > 1e-12, cov / var_x, 0.0)
            intercept = np.maximum(mean_y - slope * mean_x, 1.0)  # [T]
            z = z / np.sqrt(intercept)[None, :]
        d_reg = np.sqrt(d * d + lam)
        x_tilde = d_reg[:, None] * vt  # [K, p]
        y_tilde = (vt @ z) / d_reg[:, None]  # [K, T]
        return cls(x_tilde=x_tilde.astype(np.float32), y_tilde=y_tilde.astype(np.float32))


# ----------------------------------------------------------------------------
# SGVB regression trainer
# ----------------------------------------------------------------------------


@dataclass
class SgvbConfig:
    num_steps: int = 1000
    num_samples: int = 8  # MC samples per step
    learning_rate: float = 0.01
    kl_weight: float = 1.0
    prior_var: float = 1.0
    seed: int = 0


def negative_elbo(q, eps, *, x, x_sq, y, moments, kl, llik, kl_weight: float):
    """-(E_s[llik(y, eta_s)] - kl_weight * kl(q)) at the draws `eps [S, n, k]`:

        eta_s = X mu_theta + sqrt(X^2 var_theta) * eps_s
    """
    mean, var = moments(q)
    eta_mean = x @ mean  # [n, k]
    eta_var = x_sq @ var
    eta = eta_mean[None] + torch.sqrt(torch.clamp_min(eta_var, 1e-12))[None] * eps
    ll = torch.mean(llik(y, eta))
    return -(ll - kl_weight * kl(q))


def _step_keys(seed: int, num_steps: int) -> tuple[np.ndarray, np.ndarray]:
    """(the init key, the `[num_steps, 2]` step keys) of `key(seed)`."""
    k_init, key = prng.split(prng.key(seed))
    keys = np.empty((num_steps, 2), np.uint32)
    for i in range(num_steps):
        key, keys[i] = prng.split(key)
    return k_init, keys


_B1, _B2, _ADAM_EPS = 0.9, 0.999, 1e-8  # optax's `adam` defaults


def _bias_scales(num_steps: int) -> np.ndarray:
    """[num_steps, 2] float32 1 / (1 - b^t) of Adam's two moments (optax
    takes the corrections in float32)."""
    f = np.float32
    return np.asarray([[f(1) / (f(1) - f(_B1) ** f(t)), f(1) / (f(1) - f(_B2) ** f(t))]
                       for t in range(1, num_steps + 1)], np.float32)


def _graphed(step, state):
    """`step` captured in a CUDA graph after two warm-up calls on a side
    stream, whose moves of `state` are undone: a function that replays the
    graph and returns the captured output."""
    saved = [t.clone() for t in state]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    for t, v in zip(state, saved):
        t.copy_(v)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = step()

    def replay():
        graph.replay()
        return out

    return replay


def _train(q0, loss_fn, *, cfg: SgvbConfig, step_keys: np.ndarray, draw_shape, device):
    """optax's `adam` on one flat buffer holding `q0`'s fields; returns
    (q, losses). A step is some hundreds of small kernels, so on the card it is
    captured once in a CUDA graph and replayed: the same kernels, without
    the host's launch cost for each."""
    cls, shapes = type(q0), [tuple(t.shape) for t in q0]
    theta = torch.cat([t.reshape(-1) for t in q0]).to(device)
    mu, nu = torch.zeros_like(theta), torch.zeros_like(theta)
    scales = torch.from_numpy(_bias_scales(cfg.num_steps)).to(device)
    eps_now = torch.zeros(draw_shape, device=device)
    scale_now = torch.ones(2, device=device)
    m = int(np.prod(draw_shape))
    block = max(1, min(len(step_keys), _DRAW_VALUES // max(m, 1)))

    def q_of(flat):
        out, off = [], 0
        for shp in shapes:
            n = int(np.prod(shp, dtype=np.int64))
            out.append(flat[off : off + n].view(shp))
            off += n
        return cls(*out)

    def step():
        leaf = theta.detach().requires_grad_(True)
        loss = loss_fn(q_of(leaf), eps_now)
        (g,) = torch.autograd.grad(loss, leaf)
        with torch.no_grad():
            mu.mul_(_B1).add_(g * (1.0 - _B1))
            nu.mul_(_B2).add_(g * g * (1.0 - _B2))
            upd = (mu * scale_now[0]) / (torch.sqrt(nu * scale_now[1]) + _ADAM_EPS)
            theta.add_(upd * -cfg.learning_rate)
        return loss.detach()

    run = _graphed(step, (theta, mu, nu)) if device.type == "cuda" else step
    losses = []
    for lo in range(0, cfg.num_steps, block):
        eps_blk = prng.normal_exact_keys(step_keys[lo : lo + block], m, device)
        for j in range(eps_blk.shape[0]):
            i = lo + j
            eps_now.copy_(eps_blk[j].view(draw_shape))
            scale_now.copy_(scales[i])
            loss = run()
            if i % 50 == 0:
                losses.append(float(loss))
    return q_of(theta.clone()), losses


def _final_elbo(q, loss_fn, seed: int, draw_shape, device) -> float:
    eps = prng.normal_exact_keys(prng.key(seed ^ 0x5EED)[None], int(np.prod(draw_shape)), device)
    with torch.no_grad():
        return -float(loss_fn(q, eps[0].view(draw_shape)))


def _as_design(x, y, device):
    k = y.shape[1] if y.ndim > 1 else 1
    x_t = torch.from_numpy(np.asarray(x, np.float32)).to(device)
    y_t = torch.from_numpy(np.asarray(y, np.float32).reshape(-1, k)).to(device)
    return x_t, x_t * x_t, y_t, k


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def fit_regression(
    x: np.ndarray,  # [n, p] design
    y: np.ndarray,  # [n, k] responses
    *,
    family: str = "susie",
    L: int = 5,
    llik: Callable = gaussian_llik,
    config: SgvbConfig | None = None,
    with_null: bool = True,
    groups: np.ndarray | None = None,  # ml-susie: variant -> LD block
    device="cuda",
):
    """Fit q(theta) by maximizing the local-reparameterized ELBO:

        eta_s = X mu_theta + sqrt(X^2 var_theta) * eps_s
        ELBO  = E_s[llik(y, eta_s)] - kl_weight * KL(q || prior)
    """
    cfg = config or SgvbConfig()
    device = torch.device(device)
    p = x.shape[1]
    x_t, x_sq, y_t, k = _as_design(x, y, device)
    k_init, step_keys = _step_keys(cfg.seed, cfg.num_steps)

    onehot = None
    if family == "susie":
        q = susie_init(k_init, L, p, k, with_null=with_null, device=device)
        moments, kl_fn = susie_moments, susie_kl
    elif family == "ml-susie":
        g = groups if groups is not None else contiguous_ld_blocks(p)
        g = np.asarray(g, np.int32)
        n_blocks = int(g.max()) + 1
        onehot = torch.from_numpy(np.eye(n_blocks, dtype=np.float32)[g]).to(device)  # [p, B]
        q = ml_susie_init(k_init, L, p, k, n_blocks, device=device)
        moments = lambda q: ml_susie_moments(q, onehot)  # noqa: E731
        kl_fn = lambda q, prior_var: ml_susie_kl(q, onehot, prior_var=prior_var)  # noqa: E731
    elif family == "bisusie":
        q = bisusie_init(k_init, L, p, k, with_null=with_null, device=device)
        moments, kl_fn = bisusie_moments, bisusie_kl
    elif family == "spike-slab":
        q = spike_slab_init(k_init, p, k, device=device)
        moments, kl_fn = spike_slab_moments, spike_slab_kl
    else:
        q = gaussian_var_init(k_init, p, k, device=device)
        moments, kl_fn = gaussian_var_moments, gaussian_var_kl

    def loss_fn(q, eps):
        return negative_elbo(q, eps, x=x_t, x_sq=x_sq, y=y_t, moments=moments,
                             kl=lambda q: kl_fn(q, prior_var=cfg.prior_var), llik=llik,
                             kl_weight=cfg.kl_weight)

    draw_shape = (cfg.num_samples, x_t.shape[0], k)
    q, losses = _train(q, loss_fn, cfg=cfg, step_keys=step_keys, draw_shape=draw_shape,
                       device=device)
    # final ELBO on a fixed key (comparable across prior-var grid points)
    result = {"q": q, "losses": losses,
              "elbo": _final_elbo(q, loss_fn, cfg.seed, draw_shape, device)}
    mean, var = moments(q)
    result["theta_mean"] = _np(mean)
    result["theta_var"] = _np(var)
    if family == "susie":
        result["pip"] = _np(susie_pip(q))
        result["alpha"] = _np(susie_alpha(q, p))
    elif family == "ml-susie":
        result["pip"] = _np(ml_susie_pip(q, onehot))
        result["alpha"] = _np(_ml_susie_alpha(q, onehot))
    elif family == "bisusie":
        result["pip"] = _np(bisusie_pip(q))[:, None]
    elif family == "spike-slab":
        result["pip"] = _np(smoothed_sigmoid(q.gate_logits))
    return result


def fit_regression_grid(
    x: np.ndarray,
    y: np.ndarray,
    *,
    prior_vars,
    family: str = "susie",
    L: int = 5,
    llik: Callable = gaussian_llik,
    config: SgvbConfig | None = None,
    with_null: bool = True,
    groups: np.ndarray | None = None,
    device="cuda",
) -> dict:
    """Single-Gaussian prior with a grid search over prior variances: fit
    once per grid value and keep the max-ELBO fit. Adds `prior_var` and
    `grid_elbos`."""
    cfg = config or SgvbConfig()
    best = None
    grid_elbos = []
    for v in prior_vars:
        out = fit_regression(
            x, y, family=family, L=L, llik=llik,
            config=dataclasses.replace(cfg, prior_var=float(v)),
            with_null=with_null, groups=groups, device=device,
        )
        grid_elbos.append(out["elbo"])
        if best is None or out["elbo"] > best["elbo"]:
            best = out
            best["prior_var"] = float(v)
    best["grid_elbos"] = grid_elbos
    return best


class AshVarParams(NamedTuple):
    """Spike-slab q plus per-coordinate mixture responsibilities over the
    prior-variance grid (mixture-of-Gaussians prior, learnable weights)."""

    gate_logits: torch.Tensor  # [p, k]
    beta_mean: torch.Tensor  # [p, k]
    beta_ln_std: torch.Tensor  # [p, k]
    resp_logits: torch.Tensor  # [p, k, C] component responsibilities
    mix_logits: torch.Tensor  # [C] shared mixture weights


def ash_kl(q: AshVarParams, prior_vars: torch.Tensor, prior_pi: float = 0.1):
    """KL of the component-augmented model:
    sum_j sum_c r_jc [KL(q_j || N(0, v_c)) + log r_jc - log pi_c] plus the
    Bernoulli gate term."""
    a = smoothed_sigmoid(q.gate_logits)
    var_b = torch.exp(2.0 * q.beta_ln_std)
    kl_c = 0.5 * (
        (var_b[..., None] + q.beta_mean[..., None] ** 2) / prior_vars
        - 1.0
        + torch.log(prior_vars)
        - 2.0 * q.beta_ln_std[..., None]
    )
    r = _softmax(q.resp_logits, dim=-1)
    log_pi = _log_softmax(q.mix_logits, dim=0)
    kl_slab_mix = torch.sum(
        a * torch.sum(r * (kl_c + torch.log(torch.clamp_min(r, 1e-12)) - log_pi), dim=-1)
    )
    return _gate_kl(a, prior_pi) + kl_slab_mix


def fit_regression_ash(
    x: np.ndarray,
    y: np.ndarray,
    *,
    prior_vars,
    llik: Callable = gaussian_llik,
    config: SgvbConfig | None = None,
    prior_pi: float = 0.1,
    device="cuda",
) -> dict:
    """Spike-slab SGVB with an adaptive-shrinkage (ash) mixture prior over
    the effect-size variance grid; returns `mix_weights` over the grid."""
    cfg = config or SgvbConfig()
    device = torch.device(device)
    p = x.shape[1]
    x_t, x_sq, y_t, k = _as_design(x, y, device)
    c = len(prior_vars)
    pv = torch.from_numpy(np.asarray(prior_vars, np.float32)).to(device)
    k_init, step_keys = _step_keys(cfg.seed, cfg.num_steps)
    ss = spike_slab_init(k_init, p, k, device=device)
    q = AshVarParams(
        gate_logits=ss.gate_logits,
        beta_mean=ss.beta_mean,
        beta_ln_std=ss.beta_ln_std,
        resp_logits=torch.zeros((p, k, c), device=device),
        mix_logits=torch.zeros(c, device=device),
    )

    def moments(q):
        return spike_slab_moments(SpikeSlabVarParams(q.gate_logits, q.beta_mean, q.beta_ln_std))

    def loss_fn(q, eps):
        return negative_elbo(q, eps, x=x_t, x_sq=x_sq, y=y_t, moments=moments,
                             kl=lambda q: ash_kl(q, pv, prior_pi), llik=llik,
                             kl_weight=cfg.kl_weight)

    draw_shape = (cfg.num_samples, x_t.shape[0], k)
    q, losses = _train(q, loss_fn, cfg=cfg, step_keys=step_keys, draw_shape=draw_shape,
                       device=device)
    mean, var = moments(q)
    return {
        "q": q,
        "losses": losses,
        "elbo": _final_elbo(q, loss_fn, cfg.seed, draw_shape, device),
        "theta_mean": _np(mean),
        "theta_var": _np(var),
        "pip": _np(smoothed_sigmoid(q.gate_logits)),
        "mix_weights": _np(_softmax(q.mix_logits, dim=0)),
        "prior_vars": _np(pv),
    }


def fit_susie_rss(
    design: RssDesign,
    *,
    L: int = 5,
    config: SgvbConfig | None = None,
    device="cuda",
) -> dict:
    """SuSiE fine-mapping on GWAS summary statistics (`fagioli
    map-sumstat`'s core)."""
    return fit_regression(
        design.x_tilde, design.y_tilde, family="susie", L=L, llik=gaussian_llik,
        config=config, device=device,
    )
