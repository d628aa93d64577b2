"""`senna resolve-embedding-space` (`senna rest`): map embeddings of
different runs into one shared space (the port of the JAX package's
`embedding/resolve.py`).

- `procrustes_transform` / `resolve_embedding_spaces` (numpy): anchored
  orthogonal Procrustes on the shared features; the same transform
  carries each run's cell embeddings into the reference run's space.
- `rest_fit` (torch, on the device): freeze a topic run's cell
  proportions theta and learn a shared cell + gene H-space against the
  raw counts, score(c, g) = (theta_c alpha) . rho_g + b_g, by full-batch
  AdamW on the exact expected-NCE objective, then place each gene at the
  softmax-over-cells average of the cell embeddings (SIMBA's co-embedding).
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils import prng
from .nce import _Adam, _flat, _log_sigmoid


def procrustes_transform(
    source: np.ndarray, target: np.ndarray, *, allow_scale: bool = True
) -> tuple[np.ndarray, float]:
    """(R, s): the orthogonal map and scale minimising ||s A R - B||_F for
    centred A, B."""
    a = source - source.mean(0)
    b = target - target.mean(0)
    u, sv, vt = np.linalg.svd(a.T @ b)
    r = u @ vt
    s = sv.sum() / max((a * a).sum(), 1e-12) if allow_scale else 1.0
    return r, float(s)


def resolve_embedding_spaces(
    runs: list[dict], *, reference: int = 0, allow_scale: bool = True
) -> list[dict]:
    """Each run: {"feat_names", "e_feat" [D_r, H], optional "e_cell"}.
    Returns the runs with aligned embeddings (the reference unchanged)."""
    ref = runs[reference]
    ref_pos = {n: i for i, n in enumerate(ref["feat_names"])}
    out = []
    for i, run in enumerate(runs):
        if i == reference:
            out.append(dict(run))
            continue
        shared = [(j, ref_pos[n]) for j, n in enumerate(run["feat_names"]) if n in ref_pos]
        if len(shared) < run["e_feat"].shape[1] + 1:
            raise ValueError(f"run {i}: too few shared features to resolve")
        src_idx, ref_idx = map(np.asarray, zip(*shared))
        r, s = procrustes_transform(
            run["e_feat"][src_idx], ref["e_feat"][ref_idx], allow_scale=allow_scale
        )
        mu_src = run["e_feat"][src_idx].mean(0)
        mu_ref = ref["e_feat"][ref_idx].mean(0)

        def xform(e):
            return (e - mu_src) @ r * s + mu_ref

        aligned = dict(run)
        aligned["e_feat"] = xform(run["e_feat"])
        if run.get("e_cell") is not None:
            aligned["e_cell"] = xform(run["e_cell"])
        out.append(aligned)
    return out


def rest_fit(
    theta_nk: np.ndarray,  # [N, K] frozen topic proportions (linear)
    data,  # backend / vec: [D, N] counts
    *,
    embedding_dim: int | None = None,  # H (default K)
    epochs: int = 400,
    learning_rate: float = 0.05,
    n_negatives: float = 5.0,
    neg_alpha: float = 0.75,
    seed: int = 0,
    device="cuda",
) -> dict:
    """Learn alpha [K, H], rho [D, H] and b [D] against the counts with
    the cell proportions frozen: full batch, one AdamW step an epoch
    (optax's defaults, decoupled weight decay 0.01 on every parameter),
    the gradients written out in torch ops. `alpha` and `rho` start at
    the JAX package's threefry draws under `split(key(seed))`. Returns
    the cell embedding theta alpha, the co-embedded gene embedding,
    alpha, the raw rho and b, and every 50th epoch's loss."""
    device = torch.device(device)
    n, k = theta_nk.shape
    d = data.num_rows
    h = embedding_dim or k

    x_dn = data.read_columns_csc(np.arange(n))
    x = torch.from_numpy(np.ascontiguousarray(x_dn.T.toarray(), np.float32)).to(device)  # [N, D]
    m_c = x.sum(1)
    q = x.sum(0).double().cpu().numpy() ** neg_alpha
    q = torch.from_numpy((q / max(q.sum(), 1e-30)).astype(np.float32)).to(device)
    total = torch.clamp_min(x.sum(), 1.0)
    negw = (n_negatives * m_c[:, None]) * q[None, :]

    k1, k2 = prng.split(prng.key(seed))
    theta, (alpha, rho, b) = _flat(
        [0.1 * prng.normal(k1, (k, h)), 0.1 * prng.normal(k2, (d, h)), np.zeros(d, np.float32)],
        device,
    )
    th = torch.from_numpy(np.ascontiguousarray(theta_nk, np.float32)).to(device)
    opt = _Adam(theta, learning_rate, weight_decay=0.01)
    losses = torch.zeros(epochs, dtype=torch.float32, device=device)
    for ep in range(epochs):
        z = th @ alpha  # [N, H]
        s = z @ rho.T + b[None, :]  # [N, D]
        ls_pos, ls_neg = _log_sigmoid(s), _log_sigmoid(-s)
        losses[ep] = -((x * ls_pos).sum() + (negw * ls_neg).sum()) / total
        # dL/ds = -(x sigmoid(-s) - w sigmoid(s)) / total
        sig = torch.sigmoid(s)
        g_s = (negw * sig - x * (1.0 - sig)) / total
        del s, sig, ls_pos, ls_neg
        g_rho = g_s.T @ z
        g_b = g_s.sum(0)
        g_alpha = th.T @ (g_s @ rho)
        del g_s
        opt.step(torch.cat([g_alpha.reshape(-1), g_rho.reshape(-1), g_b]))

    with torch.no_grad():
        z = th @ alpha
        s = z @ rho.T + b[None, :]
        w = torch.exp(s - s.max(dim=0, keepdim=True).values)
        w = w / torch.clamp_min(w.sum(dim=0, keepdim=True), 1e-30)
        e_gene = w.T @ z  # [D, H] on the cell manifold
        del s, w
    return {
        "cell_embedding": z.cpu().numpy().astype(np.float32),
        "feature_embedding": e_gene.cpu().numpy().astype(np.float32),
        "topic_embedding": alpha.cpu().numpy().astype(np.float32),
        "rho_raw": rho.cpu().numpy().astype(np.float32),
        "bias": b.cpu().numpy().astype(np.float32),
        "losses": losses.cpu().numpy()[::50].tolist(),
    }
