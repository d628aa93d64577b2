"""Pseudobulk-level posterior MCMC over the bilinear embedding and the
spike-slab feature-selection pass (the port of the JAX package's
`embedding/posterior.py`; `senna bge --posterior`).

- `pb_posterior_ess`: per-anchor elliptical-slice chains under the
  Poisson likelihood with the feature side frozen; all anchors step in
  lockstep through the batched ESS (`ops/mcmc.py`).
- `selection_pass`: blocked Gibbs over per-(feature, dim) binary gates on
  the expected-NCE objective, one dim at a time.
- `gem_gibbs`: gem's three-block sweep (beta, the nested velocity gate
  delta, the pb side) over both tracks (`faba gem --posterior`).
- `pb_gibbs`: the alternating two-sided Gibbs sampler: per-dim
  spike-and-slab on the gene side (the slab by lockstep ESS over all
  genes), a lockstep ESS over the anchors on the pb side, and per-dim
  slab variances under half-Cauchy hyperpriors between them.

The sweeps and dims run as a plain loop over device tensors. The
uniform, normal and Bernoulli draws are the JAX package's threefry
streams, split as it splits them. The Gamma draws of the half-Cauchy
hyperpriors are not: `jax.random.gamma` is a vmapped rejection loop over
per-element keys, and the port draws Marsaglia-Tsang from the same
threefry key in its own order (`_gamma`). So chains match the JAX
package's in distribution, not draw for draw.

The anchor-axis `mesh` of the JAX package waits for the port's
multi-GPU layer and raises `NotImplementedError`.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.mcmc import elliptical_slice_step_batched, ess, run_ess_chains, split_rhat
from ..utils import prng
from .nce import _log_sigmoid


def _no_mesh(mesh):
    if mesh is not None:
        raise NotImplementedError("the anchor-axis mesh of the posterior samplers is not ported")


def _t(x, device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)


def pb_posterior_ess(
    counts_pd: np.ndarray,  # [P, D]
    feat_e: np.ndarray,  # [D, H] frozen feature embeddings
    feat_b: np.ndarray,  # [D] frozen feature biases
    *,
    num_samples: int = 45,
    burn_in: int = 10,
    prior_sd: float = 1.0,
    seed: int = 0,
    mesh=None,
    device="cuda",
) -> dict:
    """Posterior draws of pb embeddings (and bias) under
    y_pg ~ Poisson(exp(e_p . f_g + b_g + b_p)), with split-Rhat and ESS
    of the first 20 anchors' first coordinate."""
    _no_mesh(mesh)
    device = torch.device(device)
    p, _ = counts_pd.shape
    h = feat_e.shape[1]
    y, f, fb = _t(counts_pd, device), _t(feat_e, device), _t(feat_b, device)

    def lnpdf(state, idx):  # [n, H+1] states of anchors idx -> [n]
        eta = state[:, :h] @ f.T + fb[None, :] + state[:, h][:, None]
        eta = torch.clamp(eta, -20.0, 20.0)
        return ((y if idx is None else y[idx]) * eta - torch.exp(eta)).sum(dim=1)

    def prior_draw(k, shape):
        return prior_sd * prng.normal_keys(k[None], int(np.prod(shape)), device)[0].reshape(shape)

    samples, lnp = run_ess_chains(
        prng.key(seed), torch.zeros(p, h + 1, device=device), prior_draw, lnpdf,
        num_samples=num_samples, burn_in=burn_in,
    )
    draws = samples.cpu().numpy()  # [T, P, H+1]
    return {
        "e_mean": draws[:, :, :h].mean(0),
        "b_mean": draws[:, :, h].mean(0),
        "draws": draws,
        "rhat": np.asarray([split_rhat(draws[:, i, 0]) for i in range(min(p, 20))]),
        "ess": np.asarray([ess(draws[:, i, 0]) for i in range(min(p, 20))]),
        "lnpdf": lnp.cpu().numpy(),
    }


def _gate_dim_delta(e_feat, b_feat, gates, dim, axis_e, axis_b, counts_pd, q_d, m_p, k_neg):
    """Per-feature objective delta [D] of turning gate[:, dim] on against
    off, all else fixed."""
    gated = e_feat * gates
    gated[:, dim] = 0.0
    scores_off = axis_e @ gated.T + b_feat[None, :] + axis_b[:, None]
    scores_on = scores_off + torch.outer(axis_e[:, dim], e_feat[:, dim])
    negw = k_neg * m_p[:, None] * q_d[None, :]

    def obj(scores):
        return (counts_pd * _log_sigmoid(scores) + negw * _log_sigmoid(-scores)).sum(dim=0)

    return obj(scores_on) - obj(scores_off)


def selection_pass(
    e_feat: np.ndarray,  # [D, H]
    b_feat: np.ndarray,
    axis_e: np.ndarray,  # [P, H] pb embeddings
    axis_b: np.ndarray,
    counts_pd: np.ndarray,
    *,
    gates: np.ndarray | None = None,
    prior_logit: float = -1.0,
    n_sweeps: int = 3,
    k_neg: float = 5.0,
    neg_alpha: float = 0.75,
    temperature: float = 1.0,
    q_marginal: np.ndarray | None = None,
    seed: int = 0,
    device="cuda",
) -> np.ndarray:
    """Gibbs-sample per-(feature, dim) gates: p(gate = 1) =
    sigmoid(delta-objective / T + prior_logit). Returns the gates [D, H]
    in {0, 1}. `q_marginal` overrides the negative distribution."""
    device = torch.device(device)
    d, h = e_feat.shape
    if q_marginal is not None:
        q = np.asarray(q_marginal, np.float32)
    else:
        q = counts_pd.sum(0) ** neg_alpha
        q = (q / max(q.sum(), 1e-30)).astype(np.float32)
    q, m_p = _t(q, device), _t(counts_pd.sum(1), device)
    y, ef, bf = _t(counts_pd, device), _t(e_feat, device), _t(b_feat, device)
    ae, ab = _t(axis_e, device), _t(axis_b, device)
    g = torch.ones(d, h, device=device) if gates is None else _t(gates, device)
    for k in prng.split(prng.key(seed), n_sweeps):
        for dim in range(h):
            delta = _gate_dim_delta(ef, bf, g, dim, ae, ab, y, q, m_p, k_neg)
            logit = delta / temperature + prior_logit
            k, kd = prng.split(k)
            on = prng.uniform_keys(kd[None], d, device)[0] < torch.sigmoid(logit)
            g[:, dim] = on.float()
    return g.cpu().numpy()


# ---- hierarchical hyperpriors ---------------------------------------------


class HalfCauchyVar:
    """A variance with a half-Cauchy(scale) prior on its SD, carried as
    the Inverse-Gamma scale mixture (Wand et al. 2011):

        sigma^2 | a ~ IG((n+1)/2, Sum x^2 / 2 + 1/a)
        a | sigma^2 ~ IG(1, 1/A^2 + 1/sigma^2)
    """

    LOG_SD_CLAMP = 8.0

    def __init__(self, scale: float = 1.0):
        self.scale = float(scale)
        self.aux = scale * scale

    @staticmethod
    def _inv_gamma(rng, shape, rate):
        return 1.0 / max(rng.gamma(shape, 1.0 / max(rate, 1e-30)), 1e-30)

    def sample(self, sum_sq: float, n: int, rng: np.random.Generator) -> float:
        lo = np.exp(-2.0 * self.LOG_SD_CLAMP)
        hi = np.exp(2.0 * self.LOG_SD_CLAMP)
        shape = (n + 1.0) / 2.0
        rate = 0.5 * sum_sq + 1.0 / self.aux
        sigma2 = float(np.clip(self._inv_gamma(rng, shape, rate), lo, hi))
        self.aux = self._inv_gamma(rng, 1.0, 1.0 / (self.scale * self.scale) + 1.0 / sigma2)
        return sigma2


def sample_pi0(n_null: int, n_total: int, a: float, b: float, rng: np.random.Generator) -> float:
    """Beta-Binomial global sparsity draw, clamped off {0, 1}."""
    p = rng.beta(a + n_null, b + max(n_total - n_null, 0))
    return float(np.clip(p, 1e-4, 1.0 - 1e-4))


def ibp_pi0(alpha: float, h: int) -> np.ndarray:
    """Per-dim exclusion rates of a truncated Indian Buffet Process at the
    stick-breaking prior mean: 1 - (alpha / (alpha + 1))^(h+1)."""
    v = alpha / (alpha + 1.0)
    return 1.0 - v ** (np.arange(1, h + 1, dtype=np.float64))


def _gamma(key: np.ndarray, alpha: torch.Tensor) -> torch.Tensor:
    """Gamma(alpha, 1) draws (float32, on alpha's device) by Marsaglia and
    Tsang's squeeze from the threefry stream of `key`: round r draws one
    normal and one uniform per element under `split(k_rounds_r)`, and an
    element takes its first accepted round; shapes below 1 draw at
    alpha + 1 and scale by U^(1/alpha) (`key`'s second half)."""
    dev, n = alpha.device, alpha.shape[0]
    k_rounds, k_boost = prng.split(key)
    a = torch.where(alpha >= 1.0, alpha, alpha + 1.0)
    d = a - 1.0 / 3.0
    c = 1.0 / torch.sqrt(9.0 * d)
    out = torch.zeros_like(a)
    done = torch.zeros(n, dtype=torch.bool, device=dev)
    while True:
        k_rounds, k_r = prng.split(k_rounds)
        k_x, k_u = prng.split(k_r)
        x = prng.normal_keys(k_x[None], n, dev)[0]
        u = prng.uniform_keys(k_u[None], n, dev)[0]
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v + d * torch.log(torch.clamp_min(v, 1e-30)))
        take = ok & ~done
        out = torch.where(take, d * v, out)
        done = done | ok
        if bool(done.all()):
            break
    boost = prng.uniform_keys(k_boost[None], n, dev, float(np.finfo(np.float32).tiny), 1.0)[0]
    return torch.where(alpha >= 1.0, out, out * boost ** (1.0 / alpha))


def _poisson_ll_cols(y_pd, eta_pd):
    """Per-column Poisson log-likelihood given the full eta plane (which
    it overwrites)."""
    eta = torch.clamp_(eta_pd, -20.0, 20.0)
    return (y_pd * eta).sum(dim=0) - torch.exp_(eta).sum(dim=0)


@dataclass
class PbGibbsResult:
    e_feat_mean: np.ndarray  # [D, H]
    pip: np.ndarray  # [D, H] per-(gene, dim) inclusion probability
    e_pb_mean: np.ndarray  # [P, H]
    b_pb_mean: np.ndarray  # [P]
    sigma2_trace: np.ndarray  # [S, H] per-dim slab variances
    rhat: np.ndarray  # [P] per-anchor split-Rhat of the pb chains
    ess: np.ndarray  # [P]


def _ess_run(key, init, scale, lnpdf, transitions, stats):
    """`transitions` ESS steps from `init` with prior draws scale * N(0, 1)."""
    cur, cur_ln = init, lnpdf(init, None)
    n = cur.numel()
    for k in prng.split(key, transitions):
        k1, k2 = prng.split(k)
        nu = scale * prng.normal_keys(k1[None], n, cur.device)[0].reshape(cur.shape)
        cur, cur_ln = elliptical_slice_step_batched(k2, cur, nu, lnpdf, cur_ln, stats=stats)
    return cur


def pb_gibbs(
    counts_pd: np.ndarray,  # [P, D] pseudobulk counts
    e_feat: np.ndarray,  # [D, H] warm start (phase-1 point estimate)
    b_feat: np.ndarray,  # [D]
    e_pb: np.ndarray,  # [P, H]
    b_pb: np.ndarray,  # [P]
    *,
    n_sweeps: int = 20,
    burnin: int = 5,
    transitions_per_dim: int = 2,
    stick_alpha: float | None = 2.0,
    half_cauchy_scale: float = 1.0,
    seed: int = 0,
    mesh=None,
    device="cuda",
    stats: dict | None = None,
) -> PbGibbsResult:
    """Alternating two-sided Gibbs over the bilinear Poisson model:

        genes | pb   per-dim spike-and-slab (slab by lockstep ESS on the
                     dim coordinate of all genes at once; inclusion gates
                     against the IBP exclusion ladder or a flat prior)
        pb | genes   lockstep ESS over the anchors' [H + 1] states

    with per-dim slab variances under half-Cauchy hyperpriors resampled
    between the blocks, warm-started from the NCE point estimate. The
    full eta plane is carried through the dim loop and rank-1 updated.
    `stats` (if given) receives the ESS step and shrink-iteration counts."""
    _no_mesh(mesh)
    device = torch.device(device)
    p, d = counts_pd.shape
    h = e_feat.shape[1]
    y = _t(counts_pd, device)
    ep, bp = _t(e_pb, device), _t(b_pb, device)
    ef, bf = _t(e_feat, device), _t(b_feat, device)
    gates = torch.ones(d, h, device=device)
    pi0 = ibp_pi0(stick_alpha, h) if stick_alpha is not None else np.full(h, 0.5)
    log_odds = np.log((1 - pi0) / np.maximum(pi0, 1e-12)).astype(np.float32)
    lo_s2 = float(np.exp(-2.0 * HalfCauchyVar.LOG_SD_CLAMP))
    hi_s2 = float(np.exp(2.0 * HalfCauchyVar.LOG_SD_CLAMP))
    hc_rate0 = 1.0 / float(half_cauchy_scale**2)
    sigma2 = torch.full((h,), half_cauchy_scale**2, device=device)
    aux = torch.full((h,), half_cauchy_scale**2, device=device)
    fa = torch.zeros(d, h, device=device)
    pa = torch.zeros(d, h, device=device)
    ea = torch.zeros(p, h, device=device)
    ba = torch.zeros(p, device=device)
    sig_tr, chain = [], []
    key = prng.key(seed & 0x7FFFFFFF)
    for sweep in range(burnin + n_sweeps):
        # ---- gene block: per-dim spike-and-slab, all genes in lockstep
        eta_full = ep @ (ef * gates).T + bf[None, :] + bp[:, None]
        key, k_d = prng.split(key)
        sd = torch.sqrt(sigma2).cpu().numpy()
        for dim in range(h):
            contrib = ep[:, dim]
            cur = ef[:, dim] * gates[:, dim]
            eta_off = eta_full - torch.outer(contrib, cur)

            def lnpdf(state, idx, eta_off=eta_off, contrib=contrib):
                # chains are genes: the columns idx of the plane
                if idx is None:
                    return _poisson_ll_cols(y, torch.addr(eta_off, contrib, state[:, 0]))
                return _poisson_ll_cols(y[:, idx], torch.addr(eta_off[:, idx], contrib, state[:, 0]))

            k_d, k_e, k_g = prng.split(k_d, 3)
            new = _ess_run(k_e, cur[:, None], float(sd[dim]), lnpdf, transitions_per_dim,
                           stats)[:, 0]
            ll_on = lnpdf(new[:, None], None)
            ll_off = lnpdf(torch.zeros_like(new)[:, None], None)
            u = prng.uniform_keys(k_g[None], d, device)[0]
            on = (u < torch.sigmoid(ll_on - ll_off + float(log_odds[dim]))).float()
            gates[:, dim] = on
            ef[:, dim] = new
            eta_full = eta_off + torch.outer(contrib, new * on)

        # ---- per-dim slab variances (half-Cauchy inverse-gamma mixture)
        key, k_s, k_a = prng.split(key, 3)
        n_act = gates.sum(0)
        ssq = ((ef * gates) ** 2).sum(0)
        rate1 = 0.5 * ssq + 1.0 / aux
        g1 = torch.clamp_min(_gamma(k_s, (n_act + 1.0) / 2.0), 1e-30)
        sigma2 = torch.clamp(rate1 / g1, lo_s2, hi_s2)
        g2 = torch.clamp_min(_gamma(k_a, torch.ones(h, device=device)), 1e-30)
        aux = (hc_rate0 + 1.0 / sigma2) / g2

        # ---- pb block: anchors in lockstep
        gated = ef * gates

        def lnpdf_pb(state, idx, gated=gated):  # chains are anchors: the rows idx
            eta = torch.clamp(state[:, :h] @ gated.T + bf[None, :] + state[:, h][:, None],
                              -20.0, 20.0)
            return ((y if idx is None else y[idx]) * eta - torch.exp(eta)).sum(dim=1)

        key, k_p = prng.split(key)
        last = _ess_run(k_p, torch.cat([ep, bp[:, None]], dim=1), 1.0, lnpdf_pb,
                        transitions_per_dim, stats)
        ep, bp = last[:, :h].contiguous(), last[:, h].contiguous()
        if sweep >= burnin:
            fa += ef * gates
            pa += gates
            ea += ep
            ba += bp
        sig_tr.append(sigma2)
        chain.append(ep[:, 0])

    kept = max(n_sweeps, 1)
    sigma2_trace = torch.stack(sig_tr).cpu().numpy()[burnin:]
    chain_np = torch.stack(chain).cpu().numpy()[burnin:]
    if len(chain_np) == 0:
        chain_np = np.zeros((1, p))
    return PbGibbsResult(
        e_feat_mean=fa.cpu().numpy() / kept,
        pip=pa.cpu().numpy() / kept,
        e_pb_mean=ea.cpu().numpy() / kept,
        b_pb_mean=ba.cpu().numpy() / kept,
        sigma2_trace=sigma2_trace if len(sigma2_trace) else np.zeros((0, h)),
        rhat=_split_rhat_all(chain_np),
        ess=np.asarray([ess(chain_np[:, i]) for i in range(chain_np.shape[1])]),
    )


def _split_rhat_all(x_sp: np.ndarray) -> np.ndarray:
    """Split-Rhat of every column of `x_sp [S, P]`."""
    s, pp = x_sp.shape
    n = s // 2
    if n < 2:
        return np.ones(pp)
    halves = np.stack([x_sp[:n], x_sp[n : 2 * n]])  # [2, n, P]
    w = halves.var(axis=1, ddof=1).mean(0)
    b = n * halves.mean(axis=1).var(axis=0, ddof=1)
    out = np.sqrt((w * (n - 1) / n + b / n) / np.maximum(w, 1e-30))
    return np.where(w <= 0, 1.0, out)


@dataclass
class GemGibbsResult:
    """Two-gate splice posterior (`faba gem --posterior`;
    posterior/pb_gibbs/splice.rs SpliceGibbsResult)."""

    beta_mean: np.ndarray  # [D, H]
    beta_pip: np.ndarray  # [D, H]
    delta_mean: np.ndarray  # [D, H]
    delta_pip: np.ndarray  # [D, H]
    e_pb_mean: np.ndarray  # [P, H]
    b_pb_mean: np.ndarray  # [P]
    delta_identified: np.ndarray  # [D] bool: gene has spliced counts
    beta_sigma2_trace: np.ndarray  # [S, H]
    delta_sigma2_trace: np.ndarray  # [S, H]
    rhat: np.ndarray  # [P] pb-anchor split-Rhat
    ess: np.ndarray  # [P]


def gem_gibbs(
    s_pd: np.ndarray,  # [P, D] SPLICED pseudobulk counts
    u_pd: np.ndarray,  # [P, D] UNSPLICED pseudobulk counts
    beta: np.ndarray,  # [D, H] warm start (gem point estimate)
    delta: np.ndarray,  # [D, H]
    b_s: np.ndarray,  # [D] spliced gene bias
    b_u: np.ndarray,  # [D] unspliced gene bias
    e_pb: np.ndarray,  # [P, H]
    b_pb: np.ndarray,  # [P]
    *,
    n_sweeps: int = 20,
    burnin: int = 5,
    transitions_per_dim: int = 2,
    stick_alpha: float | None = 2.0,
    half_cauchy_scale: float = 1.0,
    seed: int = 0,
    mesh=None,
    mesh_axis: str = "dp",
    device="cuda",
    stats: dict | None = None,
) -> GemGibbsResult:
    """gem's three-block sweep (splice.rs): one beta_g per gene shared by
    both tracks, a velocity deviation delta_g carried only by the
    unspliced rows, and the pb side:

        beta  | delta, pb   2 likelihood terms (spliced + unspliced)
        delta | beta, pb    1 term (unspliced)
        pb    | beta, delta joint over both tracks

    delta's gate is nested in beta's (z_delta = 1 only where z_beta = 1),
    and delta is identified only for genes with spliced counts. Both eta
    planes are carried through the dim loops and rank-1 updated, as
    `pb_gibbs` carries its one. The keys split as the JAX package's
    scan splits them; the Gamma draws of the hyperpriors are the port's
    own (`_gamma`)."""
    _no_mesh(mesh)
    device = torch.device(device)
    p, d = s_pd.shape
    h = beta.shape[1]
    ys, yu = _t(s_pd, device), _t(u_pd, device)
    bs, bu = _t(b_s, device), _t(b_u, device)
    beta_t, delta_t = _t(beta, device).clone(), _t(delta, device).clone()
    ep, bp = _t(e_pb, device), _t(b_pb, device)
    gb = torch.ones(d, h, device=device)
    gd = torch.ones(d, h, device=device)
    lo_s2 = float(np.exp(-2.0 * HalfCauchyVar.LOG_SD_CLAMP))
    hi_s2 = float(np.exp(2.0 * HalfCauchyVar.LOG_SD_CLAMP))
    hc_rate0 = 1.0 / float(half_cauchy_scale**2)
    pi0 = ibp_pi0(stick_alpha, h) if stick_alpha is not None else np.full(h, 0.5)
    log_odds = np.log((1 - pi0) / np.maximum(pi0, 1e-12)).astype(np.float32)
    identified = np.asarray(s_pd).sum(0) > 0
    sig_b = torch.full((h,), half_cauchy_scale**2, device=device)
    aux_b = sig_b.clone()
    sig_d = sig_b.clone()
    aux_d = sig_b.clone()
    bm, bpip, dm, dpip = (torch.zeros(d, h, device=device) for _ in range(4))
    ea = torch.zeros(p, h, device=device)
    ba = torch.zeros(p, device=device)
    sb_tr, sd_tr, chain = [], [], []

    def gate_dim(k, cur, contrib, lnpdf, sd, lop):
        """ESS on one dim's coordinates of all genes, then the gate draw."""
        k_e, k_g = k
        new = _ess_run(k_e, cur[:, None], sd, lnpdf, transitions_per_dim, stats)[:, 0]
        ll_on = lnpdf(new[:, None], None)
        ll_off = lnpdf(torch.zeros_like(new)[:, None], None)
        u = prng.uniform_keys(k_g[None], d, device)[0]
        return new, (u < torch.sigmoid(ll_on - ll_off + float(lop))).float()

    def resample_hyper(key, coef, gates, aux):
        k_s, k_a = prng.split(key)
        n_act = gates.sum(0)
        ssq = ((coef * gates) ** 2).sum(0)
        g1 = torch.clamp_min(_gamma(k_s, (n_act + 1.0) / 2.0), 1e-30)
        sig = torch.clamp((0.5 * ssq + 1.0 / aux) / g1, lo_s2, hi_s2)
        g2 = torch.clamp_min(_gamma(k_a, torch.ones(h, device=device)), 1e-30)
        return sig, (hc_rate0 + 1.0 / sig) / g2

    key = prng.key(seed & 0x7FFFFFFF)
    for sweep in range(burnin + n_sweeps):
        eta_s = ep @ (beta_t * gb).T + bs[None, :] + bp[:, None]
        eta_u = ep @ (beta_t * gb + delta_t * gd).T + bu[None, :] + bp[:, None]

        # ---- beta block: 2 terms (spliced + unspliced)
        key, k_b = prng.split(key)
        sd = torch.sqrt(sig_b).cpu().numpy()
        for dim in range(h):
            contrib = ep[:, dim]
            cur = beta_t[:, dim] * gb[:, dim]
            eta_s_off = eta_s - torch.outer(contrib, cur)
            eta_u_off = eta_u - torch.outer(contrib, cur)

            def lnpdf(state, idx, es=eta_s_off, eu=eta_u_off, contrib=contrib):
                if idx is None:
                    return (_poisson_ll_cols(ys, torch.addr(es, contrib, state[:, 0]))
                            + _poisson_ll_cols(yu, torch.addr(eu, contrib, state[:, 0])))
                return (_poisson_ll_cols(ys[:, idx], torch.addr(es[:, idx], contrib, state[:, 0]))
                        + _poisson_ll_cols(yu[:, idx], torch.addr(eu[:, idx], contrib, state[:, 0])))

            k_b, k_e, k_g = prng.split(k_b, 3)
            new, on = gate_dim((k_e, k_g), cur, contrib, lnpdf, float(sd[dim]), log_odds[dim])
            gb[:, dim] = on
            beta_t[:, dim] = new
            eta_s = eta_s_off + torch.outer(contrib, new * on)
            eta_u = eta_u_off + torch.outer(contrib, new * on)

        # ---- delta block: 1 term (unspliced), gate nested in beta's
        key, k_d = prng.split(key)
        sd = torch.sqrt(sig_d).cpu().numpy()
        for dim in range(h):
            contrib = ep[:, dim]
            cur = delta_t[:, dim] * gd[:, dim]
            eta_u_off = eta_u - torch.outer(contrib, cur)

            def lnpdf_d(state, idx, eu=eta_u_off, contrib=contrib):
                if idx is None:
                    return _poisson_ll_cols(yu, torch.addr(eu, contrib, state[:, 0]))
                return _poisson_ll_cols(yu[:, idx], torch.addr(eu[:, idx], contrib, state[:, 0]))

            k_d, k_e, k_g = prng.split(k_d, 3)
            new, on = gate_dim((k_e, k_g), cur, contrib, lnpdf_d, float(sd[dim]), log_odds[dim])
            on = on * gb[:, dim]
            gd[:, dim] = on
            delta_t[:, dim] = new
            eta_u = eta_u_off + torch.outer(contrib, new * on)

        # ---- hypers: separate half-Cauchy ladders per gate
        key, k_hb, k_hd = prng.split(key, 3)
        sig_b, aux_b = resample_hyper(k_hb, beta_t, gb, aux_b)
        sig_d, aux_d = resample_hyper(k_hd, delta_t, gd, aux_d)

        # ---- pb block: joint over both tracks, anchors in lockstep
        gated_b = beta_t * gb
        gated_u = gated_b + delta_t * gd

        def lnpdf_pb(state, idx):
            e, b = state[:, :h], state[:, h][:, None]
            y_s, y_u = (ys, yu) if idx is None else (ys[idx], yu[idx])
            eta_s_ = torch.clamp(e @ gated_b.T + bs[None, :] + b, -20.0, 20.0)
            eta_u_ = torch.clamp(e @ gated_u.T + bu[None, :] + b, -20.0, 20.0)
            return ((y_s * eta_s_ - torch.exp(eta_s_)).sum(dim=1)
                    + (y_u * eta_u_ - torch.exp(eta_u_)).sum(dim=1))

        key, k_p = prng.split(key)
        last = _ess_run(k_p, torch.cat([ep, bp[:, None]], dim=1), 1.0, lnpdf_pb,
                        transitions_per_dim, stats)
        ep, bp = last[:, :h].contiguous(), last[:, h].contiguous()
        if sweep >= burnin:
            bm += beta_t * gb
            bpip += gb
            dm += delta_t * gd
            dpip += gd
            ea += ep
            ba += bp
        sb_tr.append(sig_b)
        sd_tr.append(sig_d)
        chain.append(ep[:, 0])

    kept = max(n_sweeps, 1)
    chain_np = torch.stack(chain).cpu().numpy()[burnin:]
    if len(chain_np) == 0:
        chain_np = np.zeros((1, p))
    return GemGibbsResult(
        beta_mean=bm.cpu().numpy() / kept,
        beta_pip=bpip.cpu().numpy() / kept,
        delta_mean=dm.cpu().numpy() / kept,
        delta_pip=dpip.cpu().numpy() / kept,
        e_pb_mean=ea.cpu().numpy() / kept,
        b_pb_mean=ba.cpu().numpy() / kept,
        delta_identified=identified,
        beta_sigma2_trace=torch.stack(sb_tr).cpu().numpy()[burnin:],
        delta_sigma2_trace=torch.stack(sd_tr).cpu().numpy()[burnin:],
        rhat=_split_rhat_all(chain_np),
        ess=np.asarray([ess(chain_np[:, i]) for i in range(chain_np.shape[1])]),
    )
