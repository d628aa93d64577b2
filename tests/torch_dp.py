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
