"""chickpea: peak-to-gene cis-regulatory linkage (the port of the JAX
package's `chickpea/p2g.py`).

Paired RNA + ATAC pseudobulks -> rSVD ATAC embedding (the port's
`ops/rsvd.py`, on the device) -> per-(gene, peak) marginal z-scores and
peak-peak LD from the embedding -> SuSiE-RSS fine-mapping per gene over
its cis peaks (the port's SGVB trainer) -> linkage table, with an
optional GhostKnockoff FDR filter.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import torch

from ..models.sgvb import RssDesign, SgvbConfig, fit_susie_rss
from ..ops.rsvd import rsvd
from ..utils.prng import key_from_seed

log = logging.getLogger(__name__)


@dataclass
class PeakGeneLinks:
    gene: list
    peak: list
    pip: np.ndarray
    effect: np.ndarray
    knockoff_selected: np.ndarray | None = None  # optional FDR filter mask


def peak_to_gene(
    rna_pg: np.ndarray,  # [P_samples, G] pseudobulk RNA
    atac_pp: np.ndarray,  # [P_samples, K_peaks] pseudobulk ATAC
    cis_peaks: dict[int, np.ndarray],  # gene -> candidate peak indices
    *,
    rank: int = 20,
    L: int = 3,
    lam: float = 0.1,
    num_steps: int = 600,
    knockoff_fdr: float | None = None,
    prior_var: float = 5.0,  # SuSiE effect prior
    pve_adjust: bool = True,  # winner's-curse z shrinkage
    ko_ridge: float = 1e-4,
    ko_s: str = "equi",
    seed: int = 0,
    device="cuda",
) -> PeakGeneLinks:
    """Fine-map each gene's expression on its cis peaks."""
    n, g = rna_pg.shape
    k = atac_pp.shape[1]

    # standardize both sides; low-rank ATAC embedding for LD compression
    ys = (rna_pg - rna_pg.mean(0)) / np.maximum(rna_pg.std(0), 1e-8)
    xs = (atac_pp - atac_pp.mean(0)) / np.maximum(atac_pp.std(0), 1e-8)
    x_dev = torch.from_numpy(np.asarray(xs / np.sqrt(n), np.float32)).to(device)
    _, d, vt = rsvd(x_dev, min(rank, min(n, k) - 1), key=key_from_seed(seed))

    genes, peaks, pips, effects = [], [], [], []
    for gene, pk in cis_peaks.items():
        pk = np.asarray(pk)
        if len(pk) == 0:
            continue
        # marginal z within the cis window
        z = (xs[:, pk] * ys[:, [gene]]).sum(0) / np.sqrt(n)
        if pve_adjust and n > 2:
            z = z * np.sqrt((n - 1.0) / (z * z + n - 2.0))
        # eigenspace design restricted to the cis peaks
        d_reg = np.sqrt(d * d + lam)
        x_tilde = d_reg[:, None] * vt[:, pk]
        y_tilde = (vt[:, pk] @ z)[:, None] / d_reg[:, None]
        design = RssDesign(x_tilde=x_tilde.astype(np.float32), y_tilde=y_tilde.astype(np.float32))
        out = fit_susie_rss(
            design, L=min(L, len(pk)),
            config=SgvbConfig(num_steps=num_steps, prior_var=prior_var, seed=seed),
            device=device,
        )
        genes.extend([gene] * len(pk))
        peaks.extend(pk.tolist())
        pips.append(out["pip"][:, 0])
        effects.append(out["theta_mean"][:, 0])

    pip_all = np.concatenate(pips) if pips else np.zeros(0)
    eff_all = np.concatenate(effects) if effects else np.zeros(0)

    selected = None
    if knockoff_fdr is not None and len(eff_all):
        # GhostKnockoff-style FDR filter: W = |z| - |z~| on [real | knockoff]
        from ..ops.knockoff import knockoff_filter, second_order_knockoffs

        xs_k = second_order_knockoffs(xs, seed=seed + 1, eps=ko_ridge, s_method=ko_s)
        w_all = np.zeros(len(eff_all))
        off = 0
        for gene, pk in cis_peaks.items():
            pk = np.asarray(pk)
            if len(pk) == 0:
                continue
            aug = np.concatenate([xs[:, pk], xs_k[:, pk]], axis=1)
            z_aug = (aug * ys[:, [gene]]).sum(0) / np.sqrt(n)
            w = np.abs(z_aug[: len(pk)]) - np.abs(z_aug[len(pk) :])
            w_all[off : off + len(pk)] = w
            off += len(pk)
        _, selected = knockoff_filter(w_all, fdr=knockoff_fdr)

    return PeakGeneLinks(
        gene=genes,
        peak=peaks,
        pip=pip_all,
        effect=eff_all,
        knockoff_selected=selected,
    )
