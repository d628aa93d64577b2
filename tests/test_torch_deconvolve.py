"""The port's `senna deconvolve` against the JAX package's on the same
inputs, on the CPU. The Gibbs chains draw from different generators
(torch's against `jax.random`), so posterior-mean fractions are held
within 0.03 absolute of JAX's and both to `tests/test_deconvolve.py`'s
recovery bar; the archetype reference (Leiden membership on the same
embedding, K3's per-community sums) is held exactly and within 1e-5."""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as sp

from legume_tpu.cli import main as jcli
from legume_tpu.data.sparse_io import MemoryBackend as JMemoryBackend
from legume_tpu.senna import deconvolve as jdec
from legume_tpu_torch.cli import main as tcli
from legume_tpu_torch.data import MemoryBackend
from legume_tpu_torch.senna import deconvolve as tdec


def _mixture(seed=0, d=300, r=4, s=6):
    rng = np.random.default_rng(seed)
    mu = rng.gamma(0.3, 1.0, size=(d, r)) * 5.0
    for m in range(r):
        mu[m * 60 : (m + 1) * 60, m] *= 10.0  # marker blocks
    frac_true = rng.dirichlet(np.ones(r), size=s)
    lam = frac_true @ mu.T
    lam = lam / lam.sum(1, keepdims=True) * 50_000
    return rng.poisson(lam).astype(np.float32), mu / mu.sum(0, keepdims=True), frac_true


def test_fractions_match_jax_and_recover_truth():
    y, mu, frac_true = _mixture()
    kw = dict(n_sweeps=400, burn_in=150, seed=1)
    j = jdec.deconvolve(y, mu, config=jdec.DeconvConfig(**kw))
    t = tdec.deconvolve(y, mu, config=tdec.DeconvConfig(**kw), device="cpu")
    assert t.fractions.shape == j.fractions.shape == frac_true.shape
    np.testing.assert_allclose(t.fractions.sum(1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(t.fractions, j.fractions, rtol=0, atol=0.03)
    for res in (j, t):
        for si in range(len(frac_true)):
            assert np.corrcoef(res.fractions[si], frac_true[si])[0, 1] > 0.9
    assert t.rhat.max() < 1.5 and np.isfinite(t.ess).all()


def test_readout_maps_components_like_jax():
    """Two components to each cell type, on a mixture the posterior pins
    down (two chains of different generators agree there to their Monte
    Carlo error)."""
    y, mu, frac_true = _mixture(seed=2, s=3)
    readout = np.asarray([[1, 0], [1, 0], [0, 1], [0, 1]], np.float32)
    kw = dict(n_sweeps=300, burn_in=100, seed=4)
    j = jdec.deconvolve(y, mu, readout, jdec.DeconvConfig(**kw))
    t = tdec.deconvolve(y, mu, readout, tdec.DeconvConfig(**kw), device="cpu")
    assert t.fractions.shape == (3, 2)
    np.testing.assert_allclose(t.fractions.sum(1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(t.fractions, j.fractions, rtol=0, atol=0.03)
    np.testing.assert_allclose(t.fractions, frac_true @ readout, rtol=0, atol=0.1)


@pytest.fixture(scope="module")
def sc_cells():
    from legume_tpu_torch.data.sim import simulate_topic

    sim = simulate_topic(rows=90, cols=700, factors=3, batches=1, pve_topic=0.9,
                         depth=3000, seed=17)
    rng = np.random.default_rng(3)
    emb = (sim.theta + rng.normal(0, 0.03, sim.theta.shape)).astype(np.float32)
    return sim, emb


def test_archetype_reference_matches(sc_cells):
    sim, emb = sc_cells
    true_k = sim.theta.argmax(1)
    ann = np.asarray([f"type{k}" if j % 5 else "" for j, k in enumerate(true_k)], dtype=object)
    kw = dict(n_archetypes=8, min_cells=5, seed=2, block_size=256)
    j = jdec.build_archetype_reference(
        JMemoryBackend(sim.counts, sim.row_names, sim.col_names), emb, ann, **kw)
    t = tdec.build_archetype_reference(
        MemoryBackend(sim.counts, sim.row_names, sim.col_names), emb, ann, device="cpu", **kw)
    np.testing.assert_array_equal(t.membership, j.membership)
    np.testing.assert_array_equal(t.n_cells, j.n_cells)
    np.testing.assert_allclose(t.mu_gm, j.mu_gm, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(t.readout, j.readout)
    assert t.celltype_names == j.celltype_names and t.gene_names == j.gene_names


def test_deconvolve_cli_both_modes_match(sc_cells, tmp_path):
    """`senna deconvolve --reference` and `--from` (archetypes at two
    granularities) through both CLIs on the same files."""
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    sim, emb = sc_cells
    true_k = sim.theta.argmax(1)
    store = str(tmp_path / "sc.zarr")
    create_sparse_from_csc(sim.counts, store, sim.row_names, sim.col_names)
    lat = tmp_path / "run.latent.parquet"
    pd.DataFrame({"cell": sim.col_names, **{f"z{k}": emb[:, k] for k in range(3)}}).to_parquet(lat)
    (tmp_path / "run.senna.json").write_text(
        '{"command": "topic", "inputs": {"data_files": ["%s"]}, '
        '"outputs": {"latent": "%s"}}' % (store, lat))
    ann = tmp_path / "ann.tsv"
    ann.write_text("".join(f"{c}\ttype{k}\n" for c, k in zip(sim.col_names, true_k)))
    rng = np.random.default_rng(5)
    full = sp.csc_matrix(sim.counts)
    planted = np.asarray([[0.6, 0.3, 0.1], [0.1, 0.2, 0.7], [0.34, 0.33, 0.33]])
    bulk_rows = []
    for s in range(3):
        cols = np.concatenate([
            rng.choice(np.nonzero(true_k == k)[0], int(planted[s, k] * 220), replace=True)
            for k in range(3)])
        bulk_rows.append(np.asarray(full[:, cols].sum(1)).ravel())
    bulk = str(tmp_path / "bulk.tsv")
    pd.DataFrame(np.stack(bulk_rows), index=[f"s{j}" for j in range(3)],
                 columns=sim.row_names).to_csv(bulk, sep="\t")
    # direct mode: a reference of rates and bulk samples mixed from it
    y, mu, frac_ref = _mixture(seed=3, s=3)
    genes = [f"g{i}" for i in range(len(mu))]
    ref = str(tmp_path / "ref.parquet")
    pd.DataFrame(mu, index=genes, columns=[f"type{k}" for k in range(4)]).reset_index(
        names="gene").to_parquet(ref)
    bulk_ref = str(tmp_path / "bulk_ref.tsv")
    pd.DataFrame(y, index=[f"s{j}" for j in range(3)], columns=genes).to_csv(bulk_ref, sep="\t")

    base = ["--sweeps", "300", "--burn-in", "100", "--seed", "2"]
    for tag, run, extra in (("j", jcli.run_senna, []), ("t", tcli.run_senna, ["--device", "cpu"])):
        run(["deconvolve", "--bulk", bulk_ref, "--reference", ref,
             "--out", str(tmp_path / f"ref_{tag}")] + base + extra)
    j, t = (pd.read_parquet(tmp_path / f"ref_{tag}.fractions.parquet") for tag in "jt")
    assert list(t.columns) == list(j.columns) == ["sample"] + [f"type{k}" for k in range(4)]
    est = t.iloc[:, 1:].to_numpy()
    np.testing.assert_allclose(est.sum(1), 1.0, atol=1e-3)
    np.testing.assert_allclose(est, j.iloc[:, 1:].to_numpy(), rtol=0, atol=0.03)
    assert np.abs(est - frac_ref).mean() < 0.15

    # archetype mode on overlapping types: 300 sweeps leave both packages'
    # chains unmixed here (split R-hat near 3 over near-duplicate
    # archetypes), so its fractions are held to the simplex, and its
    # reference by the membership, which is the reference
    # `test_archetype_reference_matches` holds to JAX's; the fractions are
    # held by value in `test_deconvolve_from_separated_types_matches_jax`
    tcli.run_senna(["deconvolve", "--bulk", bulk, "--from", str(tmp_path / "run"),
                    "--annotation", str(ann), "--archetypes", "6", "12",
                    "--archetype-min-cells", "5", "--out", str(tmp_path / "arch"), "--device",
                    "cpu"] + base)
    frac = pd.read_parquet(tmp_path / "arch.fractions.parquet")
    assert list(frac.columns) == ["sample", "type0", "type1", "type2"]
    np.testing.assert_allclose(frac.iloc[:, 1:].to_numpy().sum(1), 1.0, atol=1e-3)
    memb = pd.read_parquet(tmp_path / "arch.membership.parquet")
    assert list(memb["cell"]) == list(sim.col_names)
    ann_arr = np.asarray([f"type{k}" for k in true_k], dtype=object)
    for gi, n_arch in enumerate((6, 12)):
        ref_g = tdec.build_archetype_reference(
            MemoryBackend(sim.counts, sim.row_names, sim.col_names), emb, ann_arr,
            n_archetypes=n_arch, min_cells=5, seed=2 + gi, device="cpu")
        np.testing.assert_array_equal(memb[f"archetype_k{n_arch}"], ref_g.membership)


def test_deconvolve_from_separated_types_matches_jax(tmp_path):
    """`senna deconvolve --from` through both CLIs where the posterior is
    identified: three cell types of marker-block profiles, one archetype
    each, bulk samples mixed from the types at planted fractions. The
    measured profiles are at a cell's scale, so a chain started from
    u ~ Gamma(a0, b0) takes several hundred sweeps to reach it: 1,500
    sweeps with 750 burned in. Fractions within 0.03 of JAX's, both
    within 0.05 of the planted ones."""
    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    rng = np.random.default_rng(0)
    d, r, per = 300, 3, 30
    mu = rng.gamma(0.3, 1.0, size=(d, r)) * 5.0
    for m in range(r):
        mu[m * 60 : (m + 1) * 60, m] *= 10.0  # marker blocks
    prof = mu / mu.sum(0, keepdims=True)
    k = np.repeat(np.arange(r), per)
    counts = rng.poisson(prof[:, k] * 2000).astype(np.float32)
    emb = (np.eye(r)[k] + rng.normal(0, 0.03, (len(k), r))).astype(np.float32)
    genes, cells = [f"g{i}" for i in range(d)], [f"c{j}" for j in range(len(k))]
    store = str(tmp_path / "sc.zarr")
    create_sparse_from_csc(sp.csc_matrix(counts), store, genes, cells)
    lat = tmp_path / "run.latent.parquet"
    pd.DataFrame({"cell": cells, **{f"z{i}": emb[:, i] for i in range(r)}}).to_parquet(lat)
    (tmp_path / "run.senna.json").write_text(
        '{"command": "topic", "inputs": {"data_files": ["%s"]}, '
        '"outputs": {"latent": "%s"}}' % (store, lat))
    ann = tmp_path / "ann.tsv"
    ann.write_text("".join(f"{c}\ttype{t}\n" for c, t in zip(cells, k)))
    planted = np.asarray([[0.6, 0.3, 0.1], [0.1, 0.2, 0.7], [0.34, 0.33, 0.33]])
    bulk = np.stack([rng.poisson(prof @ p * 200_000) for p in planted]).astype(np.float32)
    pd.DataFrame(bulk, index=[f"s{j}" for j in range(3)], columns=genes).to_csv(
        tmp_path / "bulk.tsv", sep="\t")

    argv = ["deconvolve", "--bulk", str(tmp_path / "bulk.tsv"), "--from", str(tmp_path / "run"),
            "--annotation", str(ann), "--archetypes", "3", "--archetype-min-cells", "5",
            "--sweeps", "1500", "--burn-in", "750", "--seed", "2"]
    for tag, run, extra in (("j", jcli.run_senna, []), ("t", tcli.run_senna, ["--device", "cpu"])):
        run(argv + ["--out", str(tmp_path / tag)] + extra)
    j, t = (pd.read_parquet(tmp_path / f"{tag}.fractions.parquet") for tag in "jt")
    assert list(t.columns) == list(j.columns) == ["sample", "type0", "type1", "type2"]
    est, ref = t.iloc[:, 1:].to_numpy(), j.iloc[:, 1:].to_numpy()
    np.testing.assert_allclose(est.sum(1), 1.0, atol=1e-3)
    np.testing.assert_allclose(est, ref, rtol=0, atol=0.03)
    for frac in (est, ref):
        np.testing.assert_allclose(frac, planted, rtol=0, atol=0.05)
    mj, mt = (pd.read_parquet(tmp_path / f"{tag}.membership.parquet") for tag in "jt")
    np.testing.assert_array_equal(mt["archetype_k3"], mj["archetype_k3"])
