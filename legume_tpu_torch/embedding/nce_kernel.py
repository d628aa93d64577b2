"""One expected-NCE epoch through kernel K4 (the counterpart of the JAX
package's `embedding/nce_pallas.py::nce_epoch_grads`).

K4 (`ops/kernels.py::nce_epoch`, `csrc/nce_epoch.cu`) returns the
unscaled loss sum and the four gradients of

    sum_pg c*s - (c + w)*softplus(s),   s = e_a.e_f^T + b_f + b_a,
                                        w = k_neg * m_p * q_g,

in one pass over the count plane. This wrapper applies the objective's
sign and normalisation (-1/total) and the ridge term, as the JAX wrapper
does. Nothing is padded: P, D and H are the caller's own.
"""

from __future__ import annotations

import torch

from ..ops import kernels


def nce_epoch_grads(
    e_feat: torch.Tensor,  # [D, H] f32
    b_feat: torch.Tensor,  # [D]
    e_axis: torch.Tensor,  # [P, H]
    b_axis: torch.Tensor,  # [P]
    c: torch.Tensor,  # [P, D] counts, f32 or bf16
    q: torch.Tensor,  # [D] f32 negative marginal
    m: torch.Tensor,  # [P] f32 row masses
    *,
    k_neg: float,
    total: torch.Tensor,  # scalar f32, max(sum of counts, 1)
    ridge: float = 0.0,
    d_real: int | None = None,  # rows of e_feat in the ridge mean
):
    """`(loss, g_e_feat, g_b_feat, g_e_axis, g_b_axis)` of one level:
    `value_and_grad` of `embedding/nce.py::expected_nce_loss` (dense,
    unstratified q) in one fused pass."""
    if e_feat.shape[1] > kernels.MAX_H:
        raise ValueError(f"H={e_feat.shape[1]} exceeds the kernel's {kernels.MAX_H}")
    loss_sum, gef, gbf, gea, gba = kernels.nce_epoch(
        c, q, e_feat, b_feat, e_axis, b_axis, m, k_neg
    )
    scale = -1.0 / total
    loss = scale * loss_sum
    g_e_feat = scale * gef
    if ridge > 0:
        dr = d_real if d_real is not None else e_feat.shape[0]
        loss = loss + ridge * (e_feat * e_feat).sum() / dr
        g_e_feat = g_e_feat + (2.0 * ridge / dr) * e_feat
    return loss, g_e_feat, scale * gbf, scale * gea, scale * gba
