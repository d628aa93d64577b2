"""Cases shared by the port's multi-GPU tests and the rank processes
that `tests/test_torch_multiprocess.py` starts (no JAX here: the ranks
import this module)."""

import numpy as np

TRAINER = dict(p=53, d=40, k=4, epochs=20, mb=15)  # 15 rows: uneven shares of 8 and 7
# `senna topic`'s flags in the JAX package's two-process test
# (`tests/test_multiprocess.py`), on `two_batch_store`'s cells
TOPIC_ARGV = ["-k", "4", "--epochs", "20", "--minibatch-size", "32", "--encoder-layers", "16",
              "16", "--proj-dim", "8", "--sort-dim", "3", "--num-levels", "2", "--block-size",
              "64", "--hvg-genes", "30", "--knn-cells", "4", "--qc", "--qc-min-total", "1",
              "--seed", "11"]


def two_batch_store(tmp) -> list[str]:
    """The JAX package's two-process test data: two backends (one batch
    each) of 150 and 130 cells x 40 genes, the second shifted."""
    import scipy.sparse as sp

    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    rng = np.random.default_rng(7)
    files = []
    for b, (n_b, shift) in enumerate([(150, 0.0), (130, 0.6)]):
        base = rng.gamma(2.0, 1.0, (40, 1)) * np.exp(shift * rng.normal(0, 1, (40, 1)))
        dense = rng.poisson(base * rng.gamma(3.0, 0.5, (1, n_b))).astype(np.float32)
        files.append(str(tmp / f"b{b}.zarr"))
        create_sparse_from_csc(sp.csc_matrix(dense), files[-1], [f"g{i}" for i in range(40)],
                               [f"b{b}c{j}" for j in range(n_b)])
    return files


def dist_inputs(rank: int):
    """Rank `rank`'s rows of the [7, 3] plane (3 and 4 rows), its partial
    sums (float32, float64, int64, bool) and a `CollapsedStat` of its own."""
    from legume_tpu_torch.ops.collapse import CollapsedStat

    rng = np.random.default_rng(100 + rank)
    bounds = np.asarray([0, 3, 7])
    rows = rng.normal(size=(bounds[rank + 1] - bounds[rank], 3)).astype(np.float32)
    sums = [rng.normal(size=(5, 4)).astype(np.float32), rng.normal(size=6),
            rng.integers(0, 9, 3), rng.random(4) > 0.5]
    stat = CollapsedStat.zeros(6, 5, 2)
    for name, v in vars(stat).items():
        setattr(stat, name, rng.random(v.shape).astype(np.float32))
    return rows, bounds, sums, stat


def trainer_fit(device, mesh: bool):
    """A `MixedTrainer` fit, its latent and last llik (a mesh over the
    live world when `mesh`)."""
    import torch

    from legume_tpu_torch.models.decoders import NbTopicDecoder
    from legume_tpu_torch.models.encoders import LogSoftmaxEncoder
    from legume_tpu_torch.models.train import LevelData, MixedTrainer, TrainConfig
    from legume_tpu_torch.parallel.mesh import make_mesh

    t = TRAINER
    x = np.random.default_rng(5).poisson(2.0, (t["p"], t["d"])).astype(np.float32)
    g = torch.Generator().manual_seed(3)
    enc = LogSoftmaxEncoder(t["d"], t["k"], (16,), generator=g)
    dec = NbTopicDecoder(t["d"], t["k"], generator=g)
    cfg = TrainConfig(epochs=t["epochs"], minibatch_size=t["mb"], learning_rate=0.01)
    trainer = MixedTrainer(enc, [dec], cfg, mesh=make_mesh(device) if mesh else None,
                           device=device)
    scores = trainer.train([LevelData(x, None)], torch.Generator().manual_seed(11))
    return trainer.encode(x), np.float64(scores.llik[-1])


# ---- the multi-GPU layer's other paths: the same inputs for the rank
# processes, the world of one in the parent and the JAX references ----


def knn_inputs():
    """`tests/test_cocoa_mesh.py::test_knn_search_mesh_and_tail_padding`'s
    points and queries (a tail chunk that one rank of two finds empty)."""
    rng = np.random.default_rng(3)
    return rng.normal(size=(77, 9)).astype(np.float32), rng.normal(size=(203, 9)).astype(np.float32)


def cocoa_inputs():
    """Eight individuals of 30 cells x 60 genes, three topics, four
    pseudobulk samples and T = 6 exposure rows (the observed and five
    permutations)."""
    rng = np.random.default_rng(11)
    n_indv, per, d = 8, 30, 60
    n = n_indv * per
    cell_indv = np.repeat(np.arange(n_indv), per)
    counts = rng.poisson(2.0, (d, n)).astype(np.float32)
    counts[:8, cell_indv % 2 == 1] *= 3
    proj = rng.normal(size=(n, 12)).astype(np.float32)
    z = rng.dirichlet(np.ones(3), size=n).astype(np.float32)
    pb = (np.arange(n) % 4).astype(np.int64)
    exposure = np.tile([0, 1], n_indv // 2)
    exposures = np.stack([exposure] + [rng.permutation(exposure) for _ in range(5)])
    return counts, proj, cell_indv, z, pb, exposures


def pb_gibbs_inputs():
    """`tests/test_posterior.py::test_pb_gibbs_dp_sharded_recovers`' data
    and sweeps with P = 13 (odd: one pad anchor on two ranks)."""
    rng = np.random.default_rng(0)
    d, p, h = 40, 13, 2
    z_true = np.zeros((d, h))
    active = rng.random((d, h)) < 0.3
    z_true[active] = rng.normal(0, 1.2, active.sum())
    e_pb = rng.normal(0, 1.0, (p, h))
    y = rng.poisson(np.exp(np.clip(e_pb @ z_true.T + 0.5, -8, 8))).astype(np.float64)
    args = (y, z_true + rng.normal(0, 0.3, z_true.shape), np.full(d, 0.5),
            e_pb + rng.normal(0, 0.3, e_pb.shape), np.zeros(p))
    kw = dict(n_sweeps=12, burnin=4, transitions_per_dim=2, stick_alpha=2.0, seed=1)
    return args, kw, dict(active=active, e_pb=e_pb, z_true=z_true)


def gem_gibbs_inputs():
    """`tests/test_posterior.py::test_gem_gibbs_dp_sharded_recovers`' data
    and sweeps with P = 35 (odd)."""
    rng = np.random.default_rng(3)
    p, d, h = 35, 60, 4
    beta = rng.normal(0, 0.5, (d, h)).astype(np.float32)
    delta_true = np.zeros((d, h), np.float32)
    delta_true[:10] = rng.normal(0, 1.0, (10, h))
    ep = rng.normal(0, 0.5, (p, h)).astype(np.float32)
    bs, bu = np.full(d, -0.5, np.float32), np.full(d, -1.0, np.float32)
    bp = np.zeros(p, np.float32)
    s = rng.poisson(np.exp(np.clip(ep @ beta.T + bs, -8, 5)) * 20).astype(np.float32)
    u = rng.poisson(np.exp(np.clip(ep @ (beta + delta_true).T + bu, -8, 5)) * 20).astype(np.float32)
    return (s, u, beta, np.zeros_like(delta_true), bs, bu, ep, bp), \
        dict(n_sweeps=15, burnin=5, seed=4)


def ess_inputs():
    """`tests/test_posterior.py::test_pb_posterior_ess_dp_sharded`'s data
    and draws with P = 15 (odd)."""
    rng = np.random.default_rng(0)
    p, d, h = 15, 100, 2
    feat = rng.normal(0, 0.8, size=(d, h)).astype(np.float32)
    feat_b = np.full(d, -1.0, np.float32)
    e_true = rng.normal(0, 0.8, size=(p, h)).astype(np.float32)
    y = rng.poisson(np.exp(e_true @ feat.T + feat_b[None, :])).astype(np.float32)
    return (y, feat, feat_b), dict(num_samples=150, burn_in=50, seed=1), e_true


def su_planes():
    """`tests/test_trainer_mesh.py`'s spliced / unspliced planes, P = 47."""
    rng = np.random.default_rng(3)
    return (rng.poisson(3.0, (47, 90)).astype(np.float32),
            rng.poisson(1.5, (47, 90)).astype(np.float32))


def bge_inputs():
    """`tests/test_trainer_mesh.py::test_nce_phase2_mesh_parity`'s planes
    with P = 31 (one zero pad row on two ranks) and 200 cells in blocks
    of 64 (the last of 8)."""
    rng = np.random.default_rng(0)
    pb = rng.poisson(4.0, (31, 64)).astype(np.float32)
    y = rng.poisson(2.0, (200, 64)).astype(np.float32)
    return pb, y, dict(embedding_dim=6, epochs=80, learning_rate=0.05, phase2_epochs=40,
                       cell_batch=64)


def lc_inputs():
    """`tests/test_pinto.py::test_lc_gibbs_dp_sharded_matches_quality`'s
    planted communities: E = 301 edges (odd), 40 genes, K = 3."""
    import scipy.sparse as sp

    rng = np.random.default_rng(0)
    e, g, k = 301, 40, 3
    true = rng.integers(0, k, e)
    rates = rng.gamma(2.0, 1.0, (k, g)) * (rng.random((k, g)) < 0.25)
    prof = rng.poisson(rates[true] * 4.0).astype(np.float32)
    return sp.csr_matrix(prof), true, dict(n_genes=g, n_sweeps=15, n_greedy=10, seed=3)


def masked_fit(mesh, device="cpu"):
    """A masked-topic fit on a two-topic Poisson plane of 150 cells x 100
    genes, 8 epochs (minibatches of 50: shares of 25 on two ranks);
    returns (rho, trace)."""
    import scipy.sparse as sp
    import torch

    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.models.indexed import (MaskedTopicModel, MaskedTrainConfig,
                                                 build_topk_windows, train_masked)

    rng = np.random.default_rng(5)
    topics = rng.dirichlet(np.full(100, 0.3), 2)
    theta = rng.dirichlet([1.0, 1.0], 150)
    x = rng.poisson(40 * theta @ topics).astype(np.float32)  # [N, D]
    data = build_topk_windows(MemoryBackend(sp.csc_matrix(x.T)), 16, block_size=64,
                              device=device)
    model = MaskedTopicModel(100, 3, embed_dim=16, hidden=32,
                             generator=torch.Generator().manual_seed(2))
    cfg = MaskedTrainConfig(epochs=8, minibatch=50, learning_rate=3e-3, union_size=128,
                            feature_embedding_l2=1e-3, grad_clip=5.0, mesh=mesh)
    model, trace, _ = train_masked(model, data, cfg, device=device)
    return model.rho.detach().cpu().numpy(), np.asarray(trace)


def _knn_case(mesh, device):
    from legume_tpu_torch.ops.knn import knn_search

    q, pts = knn_inputs()
    d, i = knn_search(q, pts, 6, chunk=32, mesh=mesh, device=device)
    return {"knn_dist": d, "knn_idx": i}


def _cocoa_case(mesh, device, replay: bool):
    import scipy.sparse as sp

    from legume_tpu_torch.cocoa.collapse import build_match_cache, collect_cocoa_stat_multi
    from legume_tpu_torch.data import MemoryBackend

    counts, proj, cell_indv, z, pb, exposures = cocoa_inputs()
    cache = build_match_cache(proj, cell_indv, 8, 4, mesh=mesh, device=device)
    if not replay:
        return {f"cache_{name}": getattr(cache, name) for name in ("idx", "dist", "valid")}
    out = {}
    be = MemoryBackend(sp.csc_matrix(counts))
    for tag, t_chunk in (("replay", None), ("replay3", 3)):
        stats = collect_cocoa_stat_multi(be, z, cell_indv, pb, 4, exposures, cache,
                                         t_chunk=t_chunk, mesh=mesh, device=device)
        for plane in ("y1_sum_kdp", "y0_sum_kdp", "y1_sum_kdi", "size_kp", "size_kip"):
            out[f"{tag}_{plane}"] = np.stack([getattr(st, plane) for st in stats])
    return out


def _posterior_case(mesh, device, short: bool = False):
    """The three samplers at the JAX tests' chain lengths, or with `short`
    at 3 sweeps after 1 (`pb_gibbs`, `gem_gibbs`) and 20 draws after 5."""
    from legume_tpu_torch.embedding.posterior import gem_gibbs, pb_gibbs, pb_posterior_ess

    out = {}
    sweeps = dict(n_sweeps=3, burnin=1) if short else {}
    args, kw, _ = pb_gibbs_inputs()
    res = pb_gibbs(*args, **{**kw, **sweeps}, mesh=mesh, device=device)
    for name in ("e_feat_mean", "pip", "e_pb_mean", "b_pb_mean", "rhat"):
        out[f"pb_gibbs_{name}"] = getattr(res, name)
    args, kw = gem_gibbs_inputs()
    res = gem_gibbs(*args, **{**kw, **sweeps}, mesh=mesh, device=device)
    for name in ("beta_pip", "delta_pip", "delta_mean", "e_pb_mean"):
        out[f"gem_gibbs_{name}"] = getattr(res, name)
    args, kw, _ = ess_inputs()
    if short:
        kw.update(num_samples=20, burn_in=5)
    res = pb_posterior_ess(*args, **kw, mesh=mesh, device=device)
    out["ess_e_mean"], out["ess_lnpdf"] = res["e_mean"], res["lnpdf"]
    return out


def _gem_case(mesh, device):
    from legume_tpu_torch.embedding.gem import fit_gem, fit_gem_encoder

    s, u = su_planes()
    res = fit_gem(s, u, embedding_dim=6, epochs=60, learning_rate=0.02, seed=5, grad_clip=1.0,
                  mesh=mesh, device=device)
    out = {"gem_e_feat": res.e_feat, "gem_delta": res.delta, "gem_pb_e": res.pb_e,
           "gem_losses": np.asarray(res.losses)}
    res = fit_gem_encoder(s, u, latent_dim=6, epochs=40, learning_rate=0.01, seed=5,
                          mesh=mesh, device=device)
    out["gem_enc_rho"], out["gem_enc_losses"] = res.rho, np.asarray(res.losses)
    return out


def _bge_case(mesh, device):
    import scipy.sparse as sp

    from legume_tpu_torch.data import MemoryBackend
    from legume_tpu_torch.embedding.nce import NceConfig, fit_bge

    pbp, y, cfg = bge_inputs()
    res = fit_bge([pbp], data=MemoryBackend(sp.csc_matrix(y.T)), config=NceConfig(**cfg),
                  mesh=mesh, device=device)
    return {"bge_e_feat": res.e_feat, "bge_pb": res.pb_embeddings[0], "bge_e_cell": res.e_cell,
            "bge_p1": np.asarray(res.phase1_losses), "bge_p2": np.asarray(res.phase2_losses)}


def _masked_case(mesh, device):
    rho, trace = masked_fit(mesh, device)
    return {"masked_rho": rho, "masked_trace": trace}


def _lc_case(mesh, device):
    from legume_tpu_torch.pinto.lc import _fit_edge_labels

    prof, _, kw = lc_inputs()
    labels, trace = _fit_edge_labels(prof, 3, **kw, mesh=mesh, device=device)
    return {"lc_labels": labels, "lc_trace": np.asarray([v for _, v in trace])}


# each function-level path of the multi-GPU layer's second slice, by the
# item of the work it ports: mesh (None: the plain run), device -> arrays
SLICE19_CASES = {
    "knn_search": _knn_case,
    "build_match_cache": lambda mesh, device: _cocoa_case(mesh, device, False),
    "replay": lambda mesh, device: _cocoa_case(mesh, device, True),
    "posterior_samplers": _posterior_case,
    "gem_fits": _gem_case,
    "fit_bge": _bge_case,
    "train_masked": _masked_case,
    "fit_edge_labels": _lc_case,
}


# a world of one runs the plain code draw for draw, so its check needs no
# chain long enough to recover anything: the samplers' chains are short
WORLD_OF_ONE_CASES = {**SLICE19_CASES,
                      "posterior_samplers": lambda mesh, device: _posterior_case(mesh, device,
                                                                                 short=True)}


def slice19_cases(mesh, device="cpu", items=tuple(SLICE19_CASES)) -> dict:
    """The cases `items` of `SLICE19_CASES` on `mesh`, as one flat dict."""
    out = {}
    for item in items:
        out.update(SLICE19_CASES[item](mesh, device))
    return out


def slice19_stores(tmp, tag: str) -> dict:
    """The inputs of the five commands (`cocoa diff`, `senna bge`, `faba
    gem` / `gem-encoder`, `senna masked-topic`, `pinto lc`), written under
    `tmp` with file names ending in `tag` (each world its own copies: the
    match cache lands beside the cocoa store)."""
    import scipy.sparse as sp

    from legume_tpu_torch.data.sparse_io import create_sparse_from_csc

    def store(name, counts_dn):
        path = str(tmp / f"{name}{tag}.zarr")
        d, n = counts_dn.shape
        create_sparse_from_csc(sp.csc_matrix(counts_dn), path, [f"g{i}" for i in range(d)],
                               [f"c{j}" for j in range(n)])
        return path

    out = {}
    counts, _, cell_indv, z, _, exposures = cocoa_inputs()
    out["cocoa"] = store("cocoa", counts)
    (tmp / f"indv{tag}.txt").write_text("".join(f"i{v}\n" for v in cell_indv))
    (tmp / f"exp{tag}.tsv").write_text("".join(f"i{i}\t{x}\n" for i, x in enumerate(exposures[0])))
    (tmp / f"topic{tag}.txt").write_text("".join(f"t{v}\n" for v in z.argmax(1)))
    rng = np.random.default_rng(21)
    topics = rng.dirichlet(np.full(50, 0.3), 3)
    theta = rng.dirichlet(np.ones(3), 301)
    out["cells"] = store("cells", rng.poisson(30 * theta @ topics).astype(np.float32).T)
    s, u = su_planes()
    out["spliced"], out["unspliced"] = store("s", s.T), store("u", u.T)
    # pinto: a 14 x 14 lattice in three stripes, ten marker genes each
    side, k, d = 14, 3, 36
    xs, ys = np.meshgrid(np.arange(side), np.arange(side))
    coords = np.stack([xs.ravel(), ys.ravel()], 1).astype(float)
    domain = np.minimum((coords[:, 0] * k // side).astype(int), k - 1)
    rates = np.full((k, d), 0.6)
    for c in range(k):
        rates[c, 10 * c : 10 * c + 10] = 5.0
    out["lattice"] = store("lattice", rng.poisson(rates[domain]).astype(np.float32).T)
    out["coords"] = str(tmp / f"xy{tag}.tsv")
    with open(out["coords"], "w") as f:
        f.write("".join(f"c{j}\t{x:.1f}\t{y:.1f}\n" for j, (x, y) in enumerate(coords)))
    out["domain"] = domain
    return out


def slice19_commands(st: dict, prefix, device: str = "cpu", data_parallel: bool = True) -> dict:
    """argv of each command on `slice19_stores`' inputs, writing under
    `prefix` (a directory), on `device`, with `--data-parallel` unless
    `data_parallel` is False."""
    tail = ["--data-parallel"] * data_parallel + ["--device", device]
    return {
        "cocoa": ["cocoa", "diff", "--data-files", st["cocoa"], "--indv",
                  st["cocoa"].replace("cocoa", "indv").replace(".zarr", ".txt"),
                  "--exposure", st["cocoa"].replace("cocoa", "exp").replace(".zarr", ".tsv"),
                  "--topic-assignment",
                  st["cocoa"].replace("cocoa", "topic").replace(".zarr", ".txt"),
                  "--n-pb-samples", "4", "--knn", "4", "--iter-opt", "20", "--permutations",
                  "5", "--proj-dim", "12", "--out", f"{prefix}/cocoa", *tail],
        "bge": ["senna", "bge", "--data-files", st["cells"], "-d", "4", "--epochs", "40",
                "--sort-dim", "4", "--proj-dim", "8", "--skip-etm", "--posterior", "3",
                "--out", f"{prefix}/bge", *tail],
        "gem": ["faba", "gem", "--spliced", st["spliced"], "--unspliced", st["unspliced"],
                "-d", "6", "--epochs", "60", "--seed", "5", "--posterior", "3",
                "--output", f"{prefix}/gem", *tail],
        "gem_encoder": ["faba", "gem-encoder", "--spliced", st["spliced"], "--unspliced",
                        st["unspliced"], "-d", "6", "--epochs", "40", "--seed", "5",
                        "--output", f"{prefix}/gem_encoder", *tail],
        "masked": ["senna", "masked-topic", "--data-files", st["cells"], "-k", "3", "--window",
                   "16", "--embed-dim", "8", "--epochs", "4", "--minibatch-size", "50",
                   "--out", f"{prefix}/masked", *tail],
        "lc": ["pinto", "lc", "--data-files", st["lattice"], "--coords", st["coords"], "-k", "3",
               "--out", f"{prefix}/lc", *tail],
    }
