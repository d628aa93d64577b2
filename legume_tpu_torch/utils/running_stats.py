"""Streaming statistics utilities (matrix-util `running_quantile.rs` +
`sparse_stat.rs` equivalents): P2-style running quantiles and Welford
moments for one-pass passes over cell blocks.
"""

from __future__ import annotations

import numpy as np


class RunningQuantile:
    """P-square (Jain & Chlamtac 1985) single-quantile estimator —
    O(1) memory, no buffering (running_quantile.rs)."""

    def __init__(self, q: float):
        assert 0.0 < q < 1.0
        self.q = q
        self._init: list = []
        self._n = None

    def update(self, x: float):
        if self._n is None:
            self._init.append(float(x))
            if len(self._init) == 5:
                self._init.sort()
                self._h = np.asarray(self._init, float)
                self._n = np.arange(1.0, 6.0)
                q = self.q
                self._np = np.asarray([1, 1 + 2 * q, 1 + 4 * q, 3 + 2 * q, 5])
                self._dn = np.asarray([0, q / 2, q, (1 + q) / 2, 1])
            return
        h, n = self._h, self._n
        k = np.searchsorted(h, x)
        if k == 0:
            h[0] = x
            k = 1
        elif k == 5:
            h[4] = x
            k = 4
        n[k:] += 1
        self._np += self._dn
        for i in (1, 2, 3):
            d = self._np[i] - n[i]
            if (d >= 1 and n[i + 1] - n[i] > 1) or (d <= -1 and n[i - 1] - n[i] < -1):
                s = np.sign(d)
                hp = h[i] + s / (n[i + 1] - n[i - 1]) * (
                    (n[i] - n[i - 1] + s) * (h[i + 1] - h[i]) / (n[i + 1] - n[i])
                    + (n[i + 1] - n[i] - s) * (h[i] - h[i - 1]) / (n[i] - n[i - 1])
                )
                if h[i - 1] < hp < h[i + 1]:
                    h[i] = hp
                else:  # linear fallback
                    j = i + int(s)
                    h[i] = h[i] + s * (h[j] - h[i]) / (n[j] - n[i])
                n[i] += s

    def update_many(self, xs):
        for x in np.asarray(xs).ravel():
            self.update(float(x))

    def value(self) -> float:
        if self._n is None:
            if not self._init:
                return float("nan")
            return float(np.quantile(self._init, self.q))
        return float(self._h[2])


class RunningMoments:
    """Welford mean/variance over streamed arrays (sparse_stat.rs)."""

    def __init__(self, shape=()):
        self.n = 0
        self.mean = np.zeros(shape)
        self.m2 = np.zeros(shape)

    def update(self, x: np.ndarray):
        x = np.asarray(x, np.float64)
        self.n += 1
        delta = x - self.mean
        self.mean += delta / self.n
        self.m2 += delta * (x - self.mean)

    @property
    def var(self):
        return self.m2 / max(self.n - 1, 1)

    @property
    def std(self):
        return np.sqrt(self.var)
