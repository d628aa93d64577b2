"""Feature coarsening: gene -> meta-feature aggregation (the port of the
JAX package's `ops/feature_coarsening.py`).

Coarse groups come from binary-sorting the features by their [D, S]
pseudobulk profiles, with the same rSVD sign codes as the cell sort
(on the device). The aggregations are float32 segment sums on the host
(`index_add_`, as JAX's `jax.ops.segment_sum`): they run once a fit on
[P, D] planes. The log-dictionary expansion spreads a group's mass
evenly over its members (the `- ln g` correction).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from . import random_projection as rp


@dataclass
class FeatureCoarsening:
    fine_to_coarse: np.ndarray  # [D] group index per feature
    num_coarse: int

    def _segment_sum(self, data: np.ndarray, axis: int) -> np.ndarray:
        """float32 sums over the feature axis `axis` of a 2-d array by group."""
        t = torch.from_numpy(np.asarray(data, np.float32))
        shape = list(t.shape)
        shape[axis] = self.num_coarse
        f2c = torch.from_numpy(self.fine_to_coarse.astype(np.int64))
        return torch.zeros(shape, dtype=torch.float32).index_add_(axis, f2c, t).numpy()

    def aggregate_columns_nd(self, data_nd: np.ndarray) -> np.ndarray:
        """[N, D] -> [N, d] by summing features within groups."""
        return self._segment_sum(data_nd, 1)

    def aggregate_rows_ds(self, data_ds: np.ndarray) -> np.ndarray:
        """[D, S] -> [d, S]."""
        return self._segment_sum(data_ds, 0)

    def expand_log_dict_dk(self, log_dict_ck: np.ndarray) -> np.ndarray:
        """[d, K] coarse log-dictionary -> [D, K]: fine feature f in a
        group of size g gets coarse[c] - ln(g)."""
        sizes = self.group_sizes()
        out = np.asarray(log_dict_ck)[self.fine_to_coarse]
        return out - np.log(np.maximum(sizes[self.fine_to_coarse], 1))[:, None]

    def group_sizes(self) -> np.ndarray:
        return np.bincount(self.fine_to_coarse, minlength=self.num_coarse)


def compute_feature_coarsening(
    profile_ds: np.ndarray, max_features: int, *, seed: int = 0, device="cuda"
) -> FeatureCoarsening:
    """Group D features into <= ~max_features by binary-sorting their
    [S]-dim pseudobulk profiles. The rSVD's signs are arbitrary, so the
    groups match the JAX package's as a set partition, not by number."""
    d, s = profile_ds.shape
    if max_features >= d:
        return FeatureCoarsening(fine_to_coarse=np.arange(d), num_coarse=d)
    sort_dim = min(int(np.ceil(np.log2(max(max_features, 2)))), s)
    # binary_sort_columns sorts the columns of an [S, D] "projection"
    codes = rp.binary_sort_columns(
        np.asarray(profile_ds, np.float32).T.copy(), sort_dim, seed=seed, device=device
    )
    groups, num = rp.compact_group_codes(codes)
    return FeatureCoarsening(fine_to_coarse=groups.astype(np.int64), num_coarse=num)
