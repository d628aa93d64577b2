"""Pre-trained gene-side tables (the port's own copy of
`FrozenFeatures` / `load_frozen_features` from the JAX package's
`data/knowledge.py`; the ontology and gene-set readers of that module
are not ported yet)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..utils.output import read_table


@dataclass
class FrozenFeatures:
    """A pre-trained gene-side table aligned to a target feature axis.

    `keep_target_indices` are the positions of the caller's axis that
    matched a source row; the caller restricts to them."""

    e_feat: np.ndarray  # [|keep|, H]
    b_feat: np.ndarray  # [|keep|]
    keep_target_indices: np.ndarray
    h: int


def _keys(name: str) -> set[str]:
    """Lower-cased name and its `_`, `:`, `|` parts (`ENSG..._SYMBOL`)."""
    n = name.lower()
    out = {n}
    for sep in ("_", ":", "|"):
        if sep in n:
            out.update(n.split(sep))
    return out


def load_frozen_features(embedding_path: str, target_names: list, *,
                         bias_path: str | None = None) -> FrozenFeatures:
    """Read a `{prefix}.feature_embedding` table (first column the names,
    the rest the embedding) and intersect it with `target_names`,
    resolving composite `ENSG..._SYMBOL` names against bare symbols
    either way (the first source row of a key wins)."""
    table = read_table(embedding_path)
    cols = list(table)
    src_names = [str(x) for x in table[cols[0]]]
    emb = np.stack([np.asarray(table[c], np.float32) for c in cols[1:]], 1)
    src_pos: dict[str, int] = {}
    for i, n in enumerate(src_names):
        for k in _keys(n):
            src_pos.setdefault(k, i)
    keep, rows = [], []
    for j, n in enumerate(target_names):
        # the JAX package tries the keys in set order; the first hit wins
        hit = next((src_pos[k] for k in _keys(str(n)) if k in src_pos), None)
        if hit is not None:
            keep.append(j)
            rows.append(hit)
    b = np.zeros(len(rows), np.float32)
    if bias_path:
        bias = read_table(bias_path)
        b = np.asarray(bias[list(bias)[-1]], np.float32)[rows]
    e = emb[rows]
    return FrozenFeatures(e_feat=e, b_feat=b, keep_target_indices=np.asarray(keep, np.int64),
                          h=e.shape[1])
