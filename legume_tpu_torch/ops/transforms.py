"""The encoder input transform (the port of the JAX package's
`ops/transforms.py`):

    clean = y / max(x0 * mu, EPS_DIV)        # multiplicative batch/gene-mean null
    a     = 2 sqrt(clean + 3/8)              # Anscombe stabilize
    r     = a - mean_g(a)                    # per-cell center
    s_g   = K * std_n(r) + eps               # per-gene clip scale
    out   = s_g * tanh(r / s_g)              # soft winsorize
"""

from __future__ import annotations

import torch

TANH_K = 4.0
EPS = 1e-6
EPS_DIV = 0.1


def anscombe(t: torch.Tensor) -> torch.Tensor:
    return 2.0 * torch.sqrt(t + 0.375)


def count_rate_clean(values, values_null=None, values_mean=None) -> torch.Tensor:
    """Divide by the composed multiplicative null, floored at EPS_DIV."""
    if values_null is not None and values_mean is not None:
        divisor = values_null * values_mean
    elif values_null is not None:
        divisor = values_null
    elif values_mean is not None:
        divisor = values_mean
    else:
        return values
    return values / torch.clamp(divisor, min=EPS_DIV)


def anscombe_lite(values, values_null=None, values_mean=None) -> torch.Tensor:
    """Anscombe of the cleaned count rate."""
    return anscombe(count_rate_clean(values, values_null, values_mean))


def anscombe_residual(y_nf, x0_nf=None, mu_f=None, *, mesh=None) -> torch.Tensor:
    """Full encoder-input transform of [N, D] counts. The clip scale is a
    statistic of the N rows; with a data-parallel `mesh` of more than one
    rank, of the rows of every rank (`parallel/mesh.py::row_moments`)."""
    a = anscombe(count_rate_clean(y_nf, x0_nf, mu_f))
    r = a - a.mean(dim=-1, keepdim=True)
    if mesh is not None:
        from ..parallel.mesh import row_moments

        var = row_moments(r, mesh)[1][None, :]
    else:
        var = r.var(dim=0, keepdim=True, correction=0)
    std_1f = torch.sqrt(var + EPS)
    scale_1f = TANH_K * std_1f
    return scale_1f * torch.tanh(r / scale_1f)
