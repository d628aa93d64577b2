"""The port's `senna fne` against the JAX package's on the same edges, on
the CPU: each epoch is K4's expected-NCE objective with tied weights
(here its plain version), followed by optax's Adam, from JAX's threefry
init, so the loss trace and the embedding follow JAX's within 1e-4 over
50 epochs; and `data/vec.py::read_data_on_shared_rows`, the row
alignment of the same test family (`tests/test_prop_fne_align.py`)."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp
import torch

from legume_tpu.cli import main as jcli
from legume_tpu.senna import fne as jfne
from legume_tpu_torch.cli import main as tcli
from legume_tpu_torch.ops import kernels
from legume_tpu_torch.senna import fne as tfne


def _sbm_edges(n=90, k=3, seed=0):
    """A weighted stochastic-block graph of `n` named nodes in `k` modules."""
    rng = np.random.default_rng(seed)
    block = rng.integers(0, k, n)
    edges = []
    for i in range(n):
        for j in range(i + 1, n):
            if rng.random() < (0.3 if block[i] == block[j] else 0.02):
                edges.append((f"gene{i}", f"gene{j}", float(rng.integers(1, 4))))
    return edges, block


def test_fne_follows_jax_trace():
    edges, _ = _sbm_edges()
    kw = dict(embedding_dim=8, epochs=50, seed=3, learning_rate=0.05, n_negatives=5.0,
              neg_alpha=0.75)
    j = jfne.fit_fne(edges, **kw)
    t = tfne.fit_fne(edges, device="cpu", **kw)
    assert t.names == j.names
    np.testing.assert_allclose(t.losses, j.losses, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.embedding, j.embedding, rtol=0, atol=1e-4)
    np.testing.assert_allclose(t.bias, j.bias, rtol=0, atol=1e-4)


def test_tied_k4_gradients_are_the_loss_gradients():
    """K4's four gradients summed pairwise are autograd's gradients of
    JAX's fne loss `-(sum c logsig(s) + k m q logsig(-s)) / total` with
    `s = e e^T + b + b^T`."""
    edges, _ = _sbm_edges(n=40, seed=1)
    _, plane, q_np = tfne.fne_plane(edges, 0.75)
    c, q = torch.from_numpy(plane), torch.from_numpy(q_np)
    m = c.sum(1)
    rng = np.random.default_rng(2)
    e = torch.tensor(rng.normal(0, 0.3, (len(plane), 6)), dtype=torch.float32, requires_grad=True)
    b = torch.tensor(rng.normal(0, 0.1, len(plane)), dtype=torch.float32, requires_grad=True)
    s = e @ e.T + b[None, :] + b[:, None]
    ls = torch.nn.functional.logsigmoid
    loss = -((c * ls(s)).sum() + (5.0 * m[:, None] * q[None, :] * ls(-s)).sum()) / c.sum()
    loss.backward()
    with torch.no_grad():
        lsum, g_ef, g_bf, g_ea, g_ba = kernels.nce_epoch(c, q, e, b, e, b, m, 5.0)
    scale = -1.0 / float(c.sum())
    assert abs(scale * float(lsum) - loss.item()) <= 1e-5 * abs(loss.item())
    np.testing.assert_allclose(scale * (g_ea + g_ef), e.grad, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(scale * (g_ba + g_bf), b.grad, rtol=1e-4, atol=1e-6)


def test_fne_cli_matches(tmp_path):
    edges, _ = _sbm_edges(n=60, seed=4)
    path = tmp_path / "edges.tsv"
    path.write_text("".join(f"{a}\t{b}\t{w}\n" for a, b, w in edges))
    out = {}
    for tag, run, extra in (("j", jcli.run_senna, []), ("t", tcli.run_senna, ["--device", "cpu"])):
        run(["fne", "--edges", str(path), "--out", str(tmp_path / tag), "-d", "6",
             "--epochs", "50", "--seed", "1"] + extra)
        out[tag] = pd.read_parquet(tmp_path / f"{tag}.embedding.parquet")
    j, t = out["j"], out["t"]
    assert list(t.columns) == list(j.columns) == ["node"] + [f"h{k}" for k in range(6)]
    assert list(t["node"]) == list(j["node"])
    np.testing.assert_allclose(t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy(),
                               rtol=0, atol=1e-4)


@pytest.mark.parametrize("mode", ["union", "intersection"])
def test_shared_row_alignment_matches(mode):
    """`read_data_on_shared_rows`: backends with overlapping, reordered
    feature names stacked on the same row axis as the JAX package's."""
    from legume_tpu.data import sparse_io as jio
    from legume_tpu.data.vec import read_data_on_shared_rows as jread
    from legume_tpu_torch.data import sparse_io as tio
    from legume_tpu_torch.data.vec import read_data_on_shared_rows as tread

    rng = np.random.default_rng(5)
    specs = [([f"g{i}" for i in (3, 0, 1, 7)], 6), ([f"g{i}" for i in (1, 2, 3, 9, 7)], 4),
             ([f"g{i}" for i in (7, 1, 3)], 5)]
    mats = [sp.random(len(rows), n, density=0.5, format="csc", random_state=rng,
                      dtype=np.float32) for rows, n in specs]
    vecs = [read(
        [pkg.MemoryBackend(m, rows, [f"c{k}_{j}" for j in range(n)])
         for k, (m, (rows, n)) in enumerate(zip(mats, specs))], mode=mode)
        for read, pkg in ((jread, jio), (tread, tio))]
    j, t = vecs
    assert t.row_names() == j.row_names() and t.shape == j.shape
    assert t.column_names() == j.column_names()
    cols = np.arange(j.num_columns)
    np.testing.assert_array_equal(t.read_columns_csc(cols).toarray(),
                                  j.read_columns_csc(cols).toarray())
