"""Knowledge bases (the port's own copy of the JAX package's
`data/knowledge.py`; auxiliary-data `ontology.rs` / `gene_sets.rs`
equivalents): the OBO ontology DAG, GMT / GAF gene sets, cell
annotations, bundled marker panels and pre-trained gene-side tables.

The OBO parser builds an `is_a`/`part_of` parent DAG with ancestor
closure; the GAF reader applies true-path propagation (a gene annotated
to a term belongs to every ancestor term).
"""

from __future__ import annotations

import gzip
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

from ..utils.output import read_table


@dataclass
class Ontology:
    terms: dict  # id -> name
    parents: dict  # id -> set of parent ids (is_a + part_of)
    obsolete: set = field(default_factory=set)

    def ancestors(self, term: str) -> set:
        """Transitive closure up the DAG (ontology.rs is_a/part_of)."""
        out, stack = set(), [term]
        while stack:
            t = stack.pop()
            for p in self.parents.get(t, ()):
                if p not in out:
                    out.add(p)
                    stack.append(p)
        return out

    def roots(self) -> set:
        return {t for t in self.terms if not self.parents.get(t)}


def parse_obo(path: str) -> Ontology:
    opener = gzip.open if str(path).endswith(".gz") else open
    terms, parents, obsolete = {}, {}, set()
    cur = None
    with opener(path, "rt") as f:
        for line in f:
            line = line.strip()
            if line == "[Term]":
                cur = None
            elif line.startswith("id: "):
                cur = line[4:]
                parents.setdefault(cur, set())
            elif cur and line.startswith("name: "):
                terms[cur] = line[6:]
            elif cur and line.startswith("is_a: "):
                parents[cur].add(line[6:].split(" ")[0])
            elif cur and line.startswith("relationship: part_of "):
                parents[cur].add(line.split(" ")[2])
            elif cur and line.startswith("is_obsolete: true"):
                obsolete.add(cur)
    return Ontology(terms=terms, parents=parents, obsolete=obsolete)


def read_gmt(path: str) -> dict[str, list[str]]:
    """GMT gene sets: name <tab> desc <tab> genes... (gene_sets.rs)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    out = {}
    with opener(path, "rt") as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            if len(parts) >= 3:
                out[parts[0]] = [g for g in parts[2:] if g]
    return out


def read_gaf(path: str, ontology: Ontology | None = None) -> dict[str, set]:
    """GAF annotations term -> genes with true-path propagation up the
    ontology when provided (gene_sets.rs:1-20)."""
    opener = gzip.open if str(path).endswith(".gz") else open
    term_genes: dict[str, set] = {}
    with opener(path, "rt") as f:
        for line in f:
            if line.startswith("!"):
                continue
            parts = line.rstrip("\n").split("\t")
            if len(parts) < 5:
                continue
            gene, term = parts[2], parts[4]
            term_genes.setdefault(term, set()).add(gene)
    if ontology is not None:
        propagated: dict[str, set] = {t: set(g) for t, g in term_genes.items()}
        for t, genes in term_genes.items():
            for anc in ontology.ancestors(t):
                propagated.setdefault(anc, set()).update(genes)
        return propagated
    return term_genes


# ----------------------------------------------------------------------------
# Cell annotations (auxiliary-data/src/cell_annotations.rs)
# ----------------------------------------------------------------------------


@dataclass
class CellAnnotations:
    """cell -> individual (and optional cell type) annotations."""

    cell_to_individual: dict
    individual_ids: list

    def to_column_aligned(self, column_names, missing: str = "NA") -> list:
        """Individual label per backend column, `missing` for unmatched
        cells (cell_annotations.rs to_column_aligned_vec)."""
        return [
            self.individual_ids[self.cell_to_individual[n]]
            if n in self.cell_to_individual
            else missing
            for n in column_names
        ]


def read_cell_annotations(path: str, *, cell_col: int = 0, indv_col: int = 1) -> CellAnnotations:
    """Delimited (TSV/CSV/space, .gz ok) cell -> individual table
    (cell_annotations.rs reader); parquet accepted too."""
    rows = []
    if str(path).endswith(".parquet"):
        import pandas as pd

        df = pd.read_parquet(path)
        rows = list(zip(df.iloc[:, cell_col].astype(str), df.iloc[:, indv_col].astype(str)))
    else:
        opener = gzip.open if str(path).endswith(".gz") else open
        with opener(path, "rt") as f:
            for line in f:
                if line.startswith("#") or not line.strip():
                    continue
                p = line.replace(",", "\t").split()
                if len(p) > max(cell_col, indv_col):
                    rows.append((p[cell_col], p[indv_col]))
    ids: list = []
    pos: dict = {}
    c2i: dict = {}
    for cell, indv in rows:
        if indv not in pos:
            pos[indv] = len(ids)
            ids.append(indv)
        c2i[cell] = pos[indv]
    return CellAnnotations(cell_to_individual=c2i, individual_ids=ids)


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


def bundled_panel(name: str = "blood") -> dict:
    """Bundled marker panels (auxiliary-data/data role): marker GMT sets
    plus the label -> Cell Ontology id map."""
    base = Path(__file__).parent / "panels"
    markers = read_gmt(str(base / f"{name}_markers.gmt"))
    label_cl = {}
    with open(base / f"{name}_label_cl.tsv") as f:
        for line in f:
            if line.startswith("#") or not line.strip():
                continue
            p = line.split()
            if len(p) >= 2:
                label_cl[p[0]] = p[1]
    return {"markers": markers, "label_cl": label_cl}
