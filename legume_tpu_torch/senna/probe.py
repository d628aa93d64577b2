"""`senna probe` — read-only drift probe for a trained model (the port of
the JAX package's `senna/probe.py`; `senna/src/probe.rs`).

Per-cell fit = predictive log-likelihood / count (depth-invariant)
under the FROZEN model; an in-distribution `--calibration` backend
sets the null, query cells below its lower `alpha` tail are flagged,
and a one-sided binomial test yields the batch covered/novel verdict
(the CAMLU reconstruction-null strategy, probe.rs:1-16).

`--counterfactual` (probe.rs:96-117) estimates first-order
benefit/forgetting WITHOUT training: split calibration and query cells
into fit/eval halves, build the pull direction
g = grad_dict(query_fit) - grad_dict(calib_fit) on the frozen
dictionary (torch autograd), and read the directional derivative of
held-out fit along g (its closed form): `benefit` = fit gained on
held-out query, `forgetting` = fit lost on held-out calibration. It
reports magnitudes and no verdict on that axis.

The encoder and the fit products run on `device` (default `cuda`).
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from ..data.visitors import visit_columns_by_block
from ..utils.precision import full_f32_matmul

log = logging.getLogger(__name__)


@dataclass
class ModelProbeResult:
    verdict: str  # covered | novel
    flag_rate: float
    binom_p: float
    threshold: float
    q_fit: np.ndarray  # [N_query]
    cal_fit: np.ndarray
    counterfactual: dict | None = None


def _percell_fit(log_dict_dk: torch.Tensor, z: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """[N] multinomial llik / count of counts `x` [N, D] under
    proportions exp(z) [N, K] and the log dictionary [D, K]."""
    log_recon = torch.log(torch.exp(z) @ torch.exp(log_dict_dk).T + 1e-30)
    return (x * log_recon).sum(1) / torch.clamp_min(x.sum(1), 1.0)


@torch.no_grad()
def _dense_fit_scores(vec, encoder, remap, log_dict, *, block_size=2048, device="cuda"):
    """Per-cell multinomial fit llik/count under the frozen dictionary
    (probe.rs per_cell_fit) and the encoder's log proportions [N, K]:
    theta from the encoder at eval, scored on the training gene axis,
    one [B, D_train] block at a time."""
    from .predict import _dense_block

    ld = torch.from_numpy(np.asarray(log_dict, np.float32)).to(device)
    fits, zs = [], []
    encoder.eval()
    with full_f32_matmul():
        for blk in visit_columns_by_block(vec, block_size=block_size):
            x = _dense_block(blk, remap, device)
            log_z, _ = encoder(x, None, train=False)
            fit = _percell_fit(ld, log_z, x)
            fits.append(torch.where(x.sum(1) > 0, fit, torch.zeros_like(fit)))
            zs.append(log_z)
    if not fits:
        return np.zeros(0, np.float32), np.zeros((0, ld.shape[1]), np.float32)
    return torch.cat(fits).cpu().numpy(), torch.cat(zs).cpu().numpy()


def _dense_counts(vec, remap, idx=None) -> np.ndarray:
    """[len(idx), D_train] counts scattered onto the training gene axis."""
    if idx is None:
        idx = np.arange(vec.num_columns)
    coo = vec.read_columns_csc(np.asarray(idx)).tocoo()
    mapped = remap.row_map[coo.row]
    keep = mapped < remap.d_train
    out = sp.coo_matrix(
        (coo.data[keep], (coo.col[keep], mapped[keep])),
        shape=(len(idx), remap.d_train),
    ).toarray()
    return np.asarray(out, np.float32)


def probe_model(
    model_prefix: str,
    query_files,
    calibration_file: str | None,
    *,
    alpha: float = 0.05,
    block_size: int = 2048,
    counterfactual: bool = False,
    cf_seed: int = 42,
    query_vec=None,
    calibration_vec=None,
    device="cuda",
) -> ModelProbeResult:
    """`query_vec` / `calibration_vec` override the files (cells held in
    memory)."""
    from scipy.stats import binomtest

    from .predict import _load_log_dictionary, build_gene_remap
    from .topic import build_encoder, load_data_vec, load_model

    meta, flat, train_genes = load_model(model_prefix)
    encoder = build_encoder(meta, flat, device=device)
    log_dict = _load_log_dictionary(model_prefix, train_genes)

    qvec = query_vec if query_vec is not None else load_data_vec(list(query_files))
    cvec = calibration_vec if calibration_vec is not None else load_data_vec([calibration_file])
    q_remap = build_gene_remap(train_genes, qvec.row_names())
    c_remap = build_gene_remap(train_genes, cvec.row_names())

    q_fit, q_z = _dense_fit_scores(qvec, encoder, q_remap, log_dict, block_size=block_size,
                                   device=device)
    cal_fit, c_z = _dense_fit_scores(cvec, encoder, c_remap, log_dict, block_size=block_size,
                                     device=device)

    # null lower tail -> flag -> one-sided binomial batch test
    thr = float(np.quantile(cal_fit, alpha))
    flagged = q_fit < thr
    rate = float(flagged.mean()) if len(q_fit) else 0.0
    test = binomtest(int(flagged.sum()), max(len(q_fit), 1), alpha, "greater")
    verdict = "novel" if test.pvalue < 0.01 else "covered"
    log.info(
        "probe: %d/%d query cells below the %.0f%% null tail (p=%.2e) -> %s",
        int(flagged.sum()), len(q_fit), 100 * alpha, test.pvalue, verdict,
    )

    cf = None
    if counterfactual:
        cf = _counterfactual(q_z, qvec, q_remap, c_z, cvec, c_remap, log_dict, seed=cf_seed,
                             device=device)
    return ModelProbeResult(
        verdict=verdict,
        flag_rate=rate,
        binom_p=float(test.pvalue),
        threshold=thr,
        q_fit=q_fit,
        cal_fit=cal_fit,
        counterfactual=cf,
    )


def _counterfactual(
    q_z, qvec, q_remap, c_z, cvec, c_remap, log_dict,
    *, seed: int, max_cells_per_half: int = 4096, device="cuda",
) -> dict:
    """First-order benefit/forgetting (counterfactual.rs via
    probe.rs:96-117): fit halves build the pull direction
    g = grad(query) - grad(calib) on the dictionary logits; eval halves
    read the directional derivative of per-cell fit along g. Each half
    is subsampled to `max_cells_per_half` so only four bounded
    [<=cap, D_train] slabs densify, never the full backends."""
    rng = np.random.default_rng(seed)

    def halves(n):
        perm = rng.permutation(n)
        a, b = perm[: n // 2], perm[n // 2 :]
        return a[:max_cells_per_half], b[:max_cells_per_half]

    qf, qe = halves(len(q_z))
    cf_, ce = halves(len(c_z))
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device)  # noqa: E731
    ld = t(log_dict)  # [D, K]

    def grad_fit(z, x):
        ld_var = ld.clone().requires_grad_(True)
        with full_f32_matmul():
            total = _percell_fit(ld_var, t(z), t(x)).mean()
        (g,) = torch.autograd.grad(total, ld_var)
        return g

    g = grad_fit(q_z[qf], _dense_counts(qvec, q_remap, qf)) - grad_fit(
        c_z[cf_], _dense_counts(cvec, c_remap, cf_))
    pull = float(torch.linalg.norm(g))
    g_unit = g / max(pull, 1e-30)

    @torch.no_grad()
    def dir_stats(z, x):
        # d/dt of each cell's fit at ld + t g_unit, t = 0:
        # sum_d x_d (theta @ (exp(ld) * g_unit).T)_d / recon_d / tot
        theta, x, e = torch.exp(t(z)), t(x), torch.exp(ld)
        with full_f32_matmul():
            recon = theta @ e.T + 1e-30
            d_recon = theta @ (e * g_unit).T
        per_cell = ((x * d_recon / recon).sum(1) / torch.clamp_min(x.sum(1), 1.0)).cpu().numpy()
        se = float(per_cell.std() / np.sqrt(max(len(per_cell), 1)))
        return float(per_cell.mean()), se

    benefit, b_se = dir_stats(q_z[qe], _dense_counts(qvec, q_remap, qe))
    forget_gain, f_se = dir_stats(c_z[ce], _dense_counts(cvec, c_remap, ce))
    forgetting = -forget_gain  # fit LOST on the reference along g
    per_topic = torch.linalg.norm(g, dim=0).cpu().numpy()
    log.info(
        "counterfactual: benefit=%+.4e (SE %.3e)  forgetting=%+.4e (SE %.3e)  ||g||=%.4e",
        benefit, b_se, forgetting, f_se, pull,
    )
    return {
        "benefit": benefit,
        "benefit_se": b_se,
        "forgetting": forgetting,
        "forgetting_se": f_se,
        "pull_norm": pull,
        "pull_norm_per_topic": per_topic.tolist(),
        "n_fit_query": int(len(qf)),
        "n_fit_calib": int(len(cf_)),
        "n_eval_query": int(len(qe)),
        "n_eval_calib": int(len(ce)),
    }
