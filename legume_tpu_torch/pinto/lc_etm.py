"""`pinto lc-etm`: indexed-VAE link communities (the port of the JAX
package's `pinto/lc_etm.py`): the masked embedded-topic model on the
spatial edges' expression profiles. Edge topics are the link
communities; a cell's propensity sums its edges' topic proportions. On
the card the trainer's gathers by gene id take their backward through
K3 (`models/indexed.py::gather_rows`)."""

from __future__ import annotations

import logging
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp

from ..models.indexed import (
    IndexedData,
    MaskedTopicModel,
    MaskedTrainConfig,
    encode_all,
    masked_keys,
    selection_log_q,
    train_masked,
)
from ..utils import prng
from ..utils.prng import DEFAULT_PROJECTION_SEED

log = logging.getLogger(__name__)


@dataclass
class LcEtmResult:
    edge_theta: np.ndarray  # [E, K]
    propensity: np.ndarray  # [N, K]
    edges: np.ndarray
    loss_trace: list


def edge_windows(profiles: sp.csr_matrix, window: int) -> IndexedData:
    """Each edge's top-`window` genes by count, in the order of the JAX
    package's `np.argsort(-row.data)` (the same call on the same row, so
    ties fall alike), and the selection-frequency log q."""
    e, d = profiles.shape
    ids = np.full((e, window), d, np.int32)
    vals = np.zeros((e, window), np.float32)
    ptr, ind, dat = profiles.indptr, profiles.indices, profiles.data
    for i in range(e):
        s, t = ptr[i], ptr[i + 1]
        if s == t:
            continue
        order = np.argsort(-dat[s:t])[:window]
        ids[i, : len(order)] = ind[s:t][order]
        vals[i, : len(order)] = dat[s:t][order]
    return IndexedData(ids=ids, vals=vals, log_q=selection_log_q(ids, d), n_genes=d)


def fit_lc_etm(
    data,
    coords: np.ndarray,
    *,
    n_communities: int = 10,
    knn: int = 8,
    window: int = 64,
    embed_dim: int = 32,
    epochs: int = 60,
    minibatch: int = 256,
    seed: int = DEFAULT_PROJECTION_SEED,
    device="cuda",
) -> LcEtmResult:
    from .lc import edge_profiles, spatial_knn_edges

    edges = spatial_knn_edges(coords, knn, device=device)
    profiles = edge_profiles(data, edges).tocsr()  # [E, D]
    d = profiles.shape[1]
    data_idx = edge_windows(profiles, window)
    train_seed = seed & 0x7FFFFFFF
    model = MaskedTopicModel(
        d, n_communities, embed_dim=embed_dim,
        generator=prng.generator_from_key(masked_keys(train_seed)[0]),
    )
    model, trace, _eval_loss = train_masked(
        model, data_idx, MaskedTrainConfig(epochs=epochs, minibatch=minibatch, seed=train_seed),
        device=device,
    )
    theta = np.exp(encode_all(model, data_idx, device=device))
    n = data.num_columns
    prop = np.zeros((n, n_communities))
    np.add.at(prop, edges[:, 0], theta)
    np.add.at(prop, edges[:, 1], theta)
    prop = prop / np.maximum(prop.sum(1, keepdims=True), 1e-12)
    return LcEtmResult(
        edge_theta=theta, propensity=prop.astype(np.float32), edges=edges, loss_trace=trace,
    )
