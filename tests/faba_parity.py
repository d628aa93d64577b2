"""Helpers shared by the `faba` parity tests (`tests/test_torch_faba_*.py`):
exact equality of nested results and of the files two runs wrote, and the
planted wild-type / control pair both packages read."""

import dataclasses
import gzip
import json
from pathlib import Path

import numpy as np
import pandas as pd
import scipy.sparse as sp

from legume_tpu_torch.data.sparse_io import open_sparse_matrix
from legume_tpu_torch.faba.bam_sim import simulate_edit_pair


def same(a, b, path="out"):
    """Exact equality of nested results: arrays (NaN where NaN), sparse
    matrices, data frames, dataclasses, dicts, sequences and scalars."""
    if dataclasses.is_dataclass(a):
        assert type(a).__name__ == type(b).__name__, path
        for f in dataclasses.fields(a):
            same(getattr(a, f.name), getattr(b, f.name), f"{path}.{f.name}")
    elif sp.issparse(a):
        assert sp.issparse(b) and a.shape == b.shape, path
        assert (sp.csr_matrix(a) != sp.csr_matrix(b)).nnz == 0, path
    elif isinstance(a, pd.DataFrame):
        pd.testing.assert_frame_equal(a, b, check_exact=True, obj=path)
    elif isinstance(a, dict):
        assert list(a) == list(b), path
        for k in a:
            same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (path, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=path)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            same(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and np.isnan(a):
        assert np.isnan(b), path
    else:
        assert a == b, (path, a, b)


def _store(path: str):
    b = open_sparse_matrix(path)
    return b.row_names(), b.column_names(), b.read_columns_csc(np.arange(b.num_columns))


def same_file(a: str, b: str, roots: tuple = ("", "")) -> None:
    """Two outputs hold the same content: stores decode equal with equal
    names, parquet tables equal, gzip text equal, JSON manifests equal but
    for their timings and engine (paths under `roots[0]` read as under
    `roots[1]`), other files byte-equal."""
    if a.endswith((".zarr", ".zarr.zip", ".h5")):
        same(_store(a), _store(b), a)
    elif a.endswith(".parquet"):
        same(pd.read_parquet(a), pd.read_parquet(b), a)
    elif a.endswith(".gz"):
        assert gzip.open(a).read() == gzip.open(b).read(), a
    elif a.endswith(".json"):
        ja = json.loads(Path(a).read_text().replace(roots[0], roots[1]))
        jb = json.loads(Path(b).read_text())
        for doc in (ja, jb):
            for key in ("timings", "engine"):
                doc.pop(key, None)
        same(ja, jb, a)
    else:
        assert Path(a).read_bytes() == Path(b).read_bytes(), a


def same_outputs(dir_a: Path, dir_b: Path, stem_a: str, stem_b: str) -> list:
    """Every output of the run with prefix `stem_a` in `dir_a` has its
    counterpart under `stem_b` in `dir_b` with the same content (and no
    more); returns the compared names."""
    def listing(d: Path, stem: str) -> dict:
        out = {}
        for p in sorted(d.iterdir()):
            if p.name.startswith(stem):
                if p.is_dir() and not p.name.endswith(".zarr"):
                    for q in sorted(p.iterdir()):
                        out[f"{p.name[len(stem):]}/{q.name}"] = str(q)
                else:
                    out[p.name[len(stem):]] = str(p)
        return out

    la, lb = listing(Path(dir_a), stem_a), listing(Path(dir_b), stem_b)
    assert list(la) == list(lb), (list(la), list(lb))
    for k in la:
        same_file(la[k], lb[k], (str(dir_a), str(dir_b)))
    return list(la)


def planted_pair(tmp: Path, **size) -> tuple[dict, dict]:
    """The port's planted pair under `tmp`: (paths, truth)."""
    paths = {k: str(tmp / v) for k, v in (("wt", "wt.bam"), ("ct", "ct.bam"),
                                           ("gff", "g.gff3"), ("fa", "g.fa"))}
    kw = dict(n_cells=120, n_genes=24, umis_per_cell=150, atoi_sites=12, m6a_sites=12, snps=12,
              seed=5)
    kw.update(size)
    truth = simulate_edit_pair(paths["wt"], paths["ct"], paths["gff"], paths["fa"], **kw)
    return paths, truth
