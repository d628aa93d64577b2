"""Poisson-Gamma posterior parameter planes (the port of the JAX
package's `ops/gamma.py`).

A pair of sufficient-statistic planes `(a, b)` with posterior summaries

    mean      = a / b
    sd        = sqrt(a) / b
    log_mean  = digamma(a) - log(b)
    log_sd    = 1 / sqrt(a - 1)  (a > 1, else 0)
"""

from __future__ import annotations

from typing import NamedTuple

import torch


def digamma(x: torch.Tensor) -> torch.Tensor:
    """Digamma via a 6-step upward recurrence and the asymptotic series
    (the JAX package's formula, so both packages agree to rounding)."""
    shift = 0.0
    for i in range(6):
        shift = shift + 1.0 / (x + i)
    z = x + 6.0
    inv = 1.0 / z
    inv2 = inv * inv
    series = torch.log(z) - 0.5 * inv - inv2 * (1.0 / 12.0 - inv2 * (1.0 / 120.0 - inv2 / 252.0))
    return series - shift


class GammaParam(NamedTuple):
    """Gamma(a, rate b) posterior planes; `a` and `b` share one shape."""

    a: torch.Tensor
    b: torch.Tensor
    a0: float = 1.0
    b0: float = 1.0

    @property
    def shape(self):
        return self.a.shape

    def mean(self) -> torch.Tensor:
        return self.a / self.b

    def sd(self) -> torch.Tensor:
        return torch.sqrt(self.a) / self.b

    def log_mean(self) -> torch.Tensor:
        return digamma(self.a) - torch.log(self.b)

    def log_sd(self) -> torch.Tensor:
        return torch.where(
            self.a > 1.0, 1.0 / torch.sqrt(torch.clamp(self.a - 1.0, min=1e-12)), 0.0
        )

    def sample(self, generator: torch.Generator) -> torch.Tensor:
        """Posterior draw Gamma(a, rate=b) from `generator` (same
        distribution as the JAX package's draw, not the same numbers)."""
        eps = 1e-8
        return torch._standard_gamma(self.a + eps, generator=generator) / (self.b + eps)
